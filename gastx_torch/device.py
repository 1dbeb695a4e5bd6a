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
    """Plain products on the card must sum in full float32: no TF32 for
    float32 operands, and for bf16 ones (bf16 storage) no reduced-precision
    reduction (:func:`check_bf16_matmul`)."""
    if t.dtype == torch.bfloat16:
        check_bf16_matmul(t.device)
        return
    if t.is_cuda and (torch.get_float32_matmul_precision() != "highest"
                      or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "the plain float32 path needs torch.get_float32_matmul_precision"
            "() == 'highest' and torch.backends.cuda.matmul.allow_tf32 == "
            "False on the card")


def check_f32_conv(device: Union[str, torch.device]) -> None:
    """Plain convolutions on the card must be full float32: cuDNN's TF32,
    which PyTorch turns on by default, is refused. Takes the device (not a
    tensor) so that the check is testable without a card."""
    if torch.device(device).type == "cuda" and torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "the plain float32 convolutions need torch.backends.cudnn."
            "allow_tf32 == False on the card (PyTorch's default is True)")


def check_bf16_matmul(device: Union[str, torch.device]) -> None:
    """Plain bf16 products on the card must accumulate in float32, as the
    JAX package's do: cuBLAS's reduced-precision bf16 reduction, which
    PyTorch turns on by default, is refused. Takes the device (not a
    tensor) so that the check is testable without a card."""
    if (torch.device(device).type == "cuda" and torch.backends.cuda.matmul
            .allow_bf16_reduced_precision_reduction):
        raise RuntimeError(
            "plain bf16 products need torch.backends.cuda.matmul."
            "allow_bf16_reduced_precision_reduction == False on the card "
            "(PyTorch's default is True)")
