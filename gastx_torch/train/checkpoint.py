"""Training checkpoints in the port's own format.

One ``torch.save`` file of a dict: the format tag, ``epoch``, ``lr``, the
model's ``state_dict`` (weights and BN running statistics), the
optimizer's ``state_dict`` (the amsgrad moments and step counts), the
training batcher's numpy ``RandomState`` state (as tensors and numbers)
and ``extra``. It mirrors ``gastx.train.checkpoint`` and restores the
same resume state (epoch, lr, optimizer, batcher RNG); the dropout masks
need none, since each step seeds its generator from (epoch, batch).
Everything in it is a tensor or a plain Python value, so it loads with
``torch.load(weights_only=True)``.

The JAX package's ``.ckpt`` is a pickle of optax and JAX objects; the port
imports nothing of JAX, so it cannot read one (:func:`load_checkpoint`
raises). Upstream ``.bin`` weights load through
:func:`gastx_torch.io.load_torch_checkpoint`.
"""
from __future__ import annotations

import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

FORMAT = "gastx-torch-checkpoint-v1"


def save_checkpoint(path: str, *, epoch: int, lr: float,
                    model: torch.nn.Module, optimizer=None,
                    batcher_random_state: Optional[np.random.RandomState]
                    = None, extra: Optional[Dict[str, Any]] = None) -> None:
    rs = None
    if batcher_random_state is not None:
        name, keys, pos, has_gauss, cached = batcher_random_state.get_state()
        rs = {"name": name, "keys": torch.from_numpy(keys.astype(np.int64)),
              "pos": int(pos), "has_gauss": int(has_gauss),
              "cached_gaussian": float(cached)}
    torch.save({
        "format": FORMAT,
        "epoch": int(epoch),
        "lr": float(lr),
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": (optimizer.state_dict() if optimizer is not None
                      else None),
        "random_state": rs,
        "extra": extra or {},
    }, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint written by :func:`save_checkpoint`, tensors on the
    CPU."""
    if not zipfile.is_zipfile(path):
        raise ValueError(
            f"{path} is not a gastx_torch checkpoint (a torch.save file); "
            f"the JAX package's pickled .ckpt cannot be read by the port")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} file")
    return blob


def restore_batcher_random_state(blob: Dict[str, Any]
                                 ) -> Optional[np.random.RandomState]:
    """The training batcher's RandomState, for a resume that reshuffles
    as the straight run does."""
    rs = blob.get("random_state")
    if rs is None:
        return None
    state = np.random.RandomState()
    state.set_state((rs["name"], rs["keys"].numpy().astype(np.uint32),
                     rs["pos"], rs["has_gauss"], rs["cached_gaussian"]))
    return state
