"""Reading the JAX package's training checkpoint (``.ckpt``).

``gastx.train.save_checkpoint`` pickles one dict: ``format``
(``"gastx-checkpoint-v1"``), ``epoch``, ``lr``, ``train_state``,
``random_state`` (the training batcher's ``RandomState.get_state()``) and
``extra``. ``train_state`` is a ``TrainState(params, bn_state,
opt_state)`` of host numpy arrays, its ``opt_state`` an
``AmsgradState(count, m, v, vmax)``. So the pickle names two NamedTuple
classes of ``gastx`` and numpy's array reconstructors, nothing of JAX or
optax.

The port imports nothing of ``gastx``, and a pickle may call any
function it names. So the reader's unpickler takes an allow-list
(:data:`ALLOWED`): it maps the two ``gastx`` classes, by name, onto local
NamedTuples of the same fields, resolves numpy's reconstructors under
their numpy-2 or numpy-1 module names to the installed numpy's, and
raises ``pickle.UnpicklingError`` on any other class.

:func:`load_jax_checkpoint` returns the dict that
:func:`gastx_torch.train.load_checkpoint` returns for the port's ``.pt``:
the model's ``state_dict`` through :func:`params_from_jax`, the batcher
RNG in the ``.pt`` form, which
:func:`gastx_torch.train.restore_batcher_random_state` takes, and under
``optimizer`` the amsgrad moments by parameter name
(``count`` as ``step``); :func:`adam_state_dict` places them on a
``torch.optim.Adam(amsgrad=True)`` in the order of
``model.parameters()``.
"""
from __future__ import annotations

import importlib
import pickle
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from gastx_torch.io.torch_import import params_from_jax
from gastx_torch.models.config import GastNetConfig
from gastx_torch.train.checkpoint import random_state_entry

JAX_FORMAT = "gastx-checkpoint-v1"


class TrainState(NamedTuple):
    """``gastx.train.loop.TrainState``'s fields."""
    params: Any
    bn_state: Any
    opt_state: Any


class AmsgradState(NamedTuple):
    """``gastx.train.optimizer.AmsgradState``'s fields."""
    count: Any
    m: Any
    v: Any
    vmax: Any


_NUMPY_2 = int(np.__version__.split(".")[0]) >= 2

# Every class a JAX .ckpt may name: (module, name) -> the local class, or
# None for a numpy reconstructor (resolved in the installed numpy).
ALLOWED = {
    ("gastx.train.loop", "TrainState"): TrainState,
    ("gastx.train.optimizer", "AmsgradState"): AmsgradState,
    ("numpy._core.numeric", "_frombuffer"): None,
    ("numpy.core.numeric", "_frombuffer"): None,
    ("numpy._core.multiarray", "_reconstruct"): None,
    ("numpy.core.multiarray", "_reconstruct"): None,
    ("numpy", "ndarray"): None,
    ("numpy", "dtype"): None,
}

# Adam's state keys of AmsgradState's moments (``count`` is ``step``).
MOMENTS = {"m": "exp_avg", "v": "exp_avg_sq", "vmax": "max_exp_avg_sq"}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) not in ALLOWED:
            raise pickle.UnpicklingError(
                f"a gastx .ckpt names only gastx's TrainState and "
                f"AmsgradState and numpy's array reconstructors; "
                f"{module}.{name} is refused")
        local = ALLOWED[module, name]
        if local is not None:
            return local
        if _NUMPY_2:
            module = module.replace("numpy.core.", "numpy._core.")
        else:
            module = module.replace("numpy._core.", "numpy.core.")
        return getattr(importlib.import_module(module), name)


def _read_pickle(path: str) -> Dict[str, Any]:
    """The ``.ckpt``'s dict as pickled, through the allow-list."""
    with open(path, "rb") as f:
        blob = _Unpickler(f).load()
    if not isinstance(blob, dict) or blob.get("format") != JAX_FORMAT:
        raise ValueError(f"{path} is not a {JAX_FORMAT} file")
    if not isinstance(blob.get("train_state"), TrainState):
        raise ValueError(f"{path} holds no gastx TrainState")
    return blob


def _adam_moments(opt_state, cfg: GastNetConfig) -> Dict[str, Any]:
    """``AmsgradState(count, m, v, vmax)`` -> Adam's per-parameter state:
    ``step`` (``count`` as a float32 CPU tensor, as Adam keeps it) and the
    three moments by parameter name, each through the weights' own layout
    transforms (:func:`params_from_jax` with no BN state)."""
    if not isinstance(opt_state, AmsgradState):
        raise ValueError("the .ckpt's optimizer state is not gastx's "
                         "AmsgradState")
    out: Dict[str, Any] = {"step": torch.tensor(
        float(np.asarray(opt_state.count)), dtype=torch.float32)}
    for field, key in MOMENTS.items():
        out[key] = params_from_jax(getattr(opt_state, field), None, cfg)
    return out


def load_jax_checkpoint(path: str, cfg: GastNetConfig) -> Dict[str, Any]:
    """A ``.ckpt`` of ``gastx.train.save_checkpoint`` for a model of
    ``cfg``, as :func:`gastx_torch.train.load_checkpoint`'s dict: format,
    epoch, lr, ``model`` (the ``state_dict``), ``optimizer`` (Adam's
    ``step`` and moments by parameter name), ``random_state`` and
    ``extra``. Tensors on the CPU."""
    blob = _read_pickle(path)
    ts = blob["train_state"]
    return {
        "format": JAX_FORMAT,
        "epoch": int(blob["epoch"]),
        "lr": float(blob["lr"]),
        "model": params_from_jax(ts.params, ts.bn_state, cfg),
        "optimizer": _adam_moments(ts.opt_state, cfg),
        "random_state": random_state_entry(blob.get("random_state")),
        "extra": blob.get("extra") or {},
    }


def adam_state_dict(moments: Dict[str, Any], model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer``'s ``state_dict`` with the ``.ckpt``'s moments
    (:func:`load_jax_checkpoint`'s ``optimizer``) as its state, for
    ``optimizer.load_state_dict``. ``optimizer`` is one group over
    ``model.parameters()`` (as ``make_optimizer`` builds it); the moments
    are placed by the names of ``model.named_parameters()``."""
    names = [n for n, _ in model.named_parameters()]
    sd = optimizer.state_dict()
    if ([g["params"] for g in sd["param_groups"]]
            != [list(range(len(names)))]):
        raise ValueError("the optimizer is not one group over "
                         "model.parameters()")
    for key in MOMENTS.values():
        if set(moments[key]) != set(names):
            raise ValueError(f"the .ckpt's {key} does not match the "
                             f"model's parameters")
    sd["state"] = {i: {"step": moments["step"].clone(),
                       **{key: moments[key][n] for key in MOMENTS.values()}}
                   for i, n in enumerate(names)}
    return sd
