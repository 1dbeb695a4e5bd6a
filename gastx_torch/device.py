"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is given.

    With no device asked for and no GPU present this raises instead of
    carrying on quietly on the CPU; pass ``device="cpu"`` for the plain
    PyTorch path.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gastx_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def check_f32_matmul(t: torch.Tensor) -> None:
    """Plain products on the card must be full float32: no TF32."""
    if t.is_cuda and (torch.get_float32_matmul_precision() != "highest"
                      or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "the plain float32 path needs torch.get_float32_matmul_precision"
            "() == 'highest' and torch.backends.cuda.matmul.allow_tf32 == "
            "False on the card")
