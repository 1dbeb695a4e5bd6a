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

The JAX package's ``.ckpt`` is another format: a pickle of host numpy
arrays in two NamedTuples of ``gastx`` (its train state and amsgrad
state). :func:`gastx_torch.io.load_jax_checkpoint` reads it, with an
allow-list of the classes it may name, into the same dict as
:func:`load_checkpoint` returns; :func:`load_checkpoint` itself takes the
port's own files alone and refuses any other. Upstream ``.bin`` weights
load through :func:`gastx_torch.io.load_torch_checkpoint`.
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
    torch.save({
        "format": FORMAT,
        "epoch": int(epoch),
        "lr": float(lr),
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": (optimizer.state_dict() if optimizer is not None
                      else None),
        "random_state": random_state_entry(
            None if batcher_random_state is None
            else batcher_random_state.get_state()),
        "extra": extra or {},
    }, path)


def random_state_entry(state) -> Optional[Dict[str, Any]]:
    """A numpy ``RandomState.get_state()`` tuple as a checkpoint's
    ``random_state`` (tensors and numbers; None stays None)."""
    if state is None:
        return None
    name, keys, pos, has_gauss, cached = state
    return {"name": name,
            "keys": torch.from_numpy(np.asarray(keys).astype(np.int64)),
            "pos": int(pos), "has_gauss": int(has_gauss),
            "cached_gaussian": float(cached)}


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint written by :func:`save_checkpoint`, tensors on the
    CPU."""
    if not zipfile.is_zipfile(path):
        raise ValueError(
            f"{path} is not a gastx_torch checkpoint (a torch.save file): "
            f"a JAX package .ckpt cannot be read by load_checkpoint; read "
            f"it with gastx_torch.io.load_jax_checkpoint")
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
