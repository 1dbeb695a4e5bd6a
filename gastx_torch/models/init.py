"""Random GastNet weights, drawn from a ``torch.Generator``.

The distributions are those of ``gastx.models.init`` (torch's initializers
as the upstream model uses them); the numbers differ, since the generators
differ:

  * expand_conv and the attention projections: ``kaiming_normal_``
    (std = sqrt(2/fan_in));
  * other convs: torch's Conv2d default ``kaiming_uniform_(a=sqrt(5))``
    (bound = 1/sqrt(fan_in));
  * SemCHGraphConv W: ``xavier_uniform_(gain=1.414)`` over the (2, in, out)
    tensor; edge logits e = 1;
  * C_k and the projection biases: zeros; BatchNorm: scale 1, bias 0,
    running mean 0, var 1.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from gastx_torch.device import resolve_device
from gastx_torch.models.config import GastNetConfig
from gastx_torch.models.gastnet import GastNet


def _normal(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    t.copy_(torch.randn(t.shape, generator=gen) * math.sqrt(2.0 / fan_in))


def _uniform(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    t.copy_((torch.rand(t.shape, generator=gen) * 2.0 - 1.0) * bound)


@torch.no_grad()
def init_gastnet(model: GastNet, gen: torch.Generator) -> GastNet:
    """Draw every weight of ``model`` (on the CPU) from ``gen``."""
    cfg = model.cfg
    fw = cfg.filter_widths
    _normal(model.expand_conv.weight, cfg.in_features * fw[0], gen)
    for i in range(1, cfg.num_levels):
        c = cfg.block_channels(i)
        _uniform(model.layers_conv[2 * i - 2].weight,
                 math.sqrt(1.0 / (c * cfg.conv_width(i))), gen)
        _uniform(model.layers_conv[2 * i - 1].weight, math.sqrt(1.0 / c), gen)
    for block in model.layers_graph_conv:
        loc, glb = block.local_graph_layer, block.global_graph_layer
        c = loc.gcn_sym.W.shape[1]
        for gcn in (loc.gcn_sym, loc.gcn_con):
            bound = 1.414 * math.sqrt(6.0 / (c * c + 2 * c))
            _uniform(gcn.W, bound, gen)
            gcn.e.fill_(1.0)
        _uniform(loc.cat_conv.weight, math.sqrt(1.0 / (2 * c)), gen)
        for head in glb.attentions:
            for proj in (head.theta, head.phi, head.g):
                _normal(proj.weight, c, gen)
                proj.bias.zero_()
            w = head.concat_project[0].weight
            _normal(w, w.shape[1], gen)
            head.C_k.zero_()
        _uniform(glb.cat_conv.weight,
                 math.sqrt(1.0 / glb.cat_conv.weight.shape[1]), gen)
        _uniform(block.cat_conv.weight, math.sqrt(1.0 / (3 * c)), gen)
    _uniform(model.shrink.weight, math.sqrt(1.0 / cfg.out_channels), gen)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


def build_gastnet(cfg: GastNetConfig, *, seed: int = 0,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> GastNet:
    """A GastNet with random weights from ``torch.Generator`` seed
    ``seed``, in eval mode on ``device`` (``cuda`` unless given)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return init_gastnet(GastNet(cfg), gen).to(dev).eval()


@torch.no_grad()
def randomize_eval_statistics(model: GastNet, gen: torch.Generator
                              ) -> GastNet:
    """Draw what the default init leaves at identity or zero: every BN's
    scale, bias, running mean and variance, the edge logits ``e``, the
    attention biases ``C_k`` and the projection biases. Checks of the
    folded kernels use it, since identity BN and zero biases would hide a
    folding bug."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            for t, lo, hi in ((m.weight, 0.5, 1.5), (m.running_var, 0.5, 1.5)):
                t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=gen))
            for t in (m.bias, m.running_mean):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    for name, p in model.named_parameters():
        if name.endswith(".e"):
            p.copy_(torch.randn(p.shape, generator=gen))
        elif name.endswith(".C_k") or (name.endswith(".bias")
                                       and "attentions" in name):
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return model
