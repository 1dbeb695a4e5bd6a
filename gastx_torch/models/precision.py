"""bf16 storage helpers, the port of ``gastx/models/precision.py``.

float32 is the parity mode. bf16 storage halves the bytes the eval
forward moves; the model's kernels read and write bf16 and compute in
float32, and its plain sites run bf16 products with float32 sums. Casting
the weights and the input is the whole switch (``GastNet``'s
``storage_dtype`` does it per level, with its cast copies cached);
outputs come back in float32.
"""
from __future__ import annotations

import copy

import torch
from torch import nn


def cast_floating(tree, dtype: torch.dtype):
    """Cast every floating tensor of a tree of dicts, lists and tuples (a
    ``state_dict`` among them) to ``dtype``; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return type(tree)((k, cast_floating(v, dtype))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree


def cast_module(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``module`` with every floating parameter and buffer cast
    to ``dtype``, in eval mode and without gradients; ``module`` itself is
    untouched."""
    out = copy.deepcopy(module).to(dtype).eval()
    return out.requires_grad_(False)


def bf16_inference_fn(forward):
    """Wrap a ``(model, x) -> y`` forward into bf16 compute with a float32
    boundary: the model's weights and statistics cast to bf16 (a copy),
    ``x`` cast to bf16, the output returned in float32."""
    def wrapped(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
        y = forward(cast_module(model, torch.bfloat16),
                    x.to(torch.bfloat16))
        return y.to(torch.float32)

    return wrapped
