"""Weight interchange: upstream ``.bin`` checkpoints and the JAX weights.

The port's ``GastNet`` has the upstream ``state_dict`` key layout, so an
upstream checkpoint loads with ``load_state_dict``. :func:`params_from_jax`
is the bridge from the JAX package: it takes the JAX ``(params, state)``
trees as numpy arrays and returns the port's ``state_dict``; with no
``state`` it maps a params-shaped tree alone (a gradient or an optimizer
moment), so that one mapping serves both. The JAX ``.ckpt`` is read by
:mod:`gastx_torch.io.jax_checkpoint`. The mapping
is this module's own (channels-last (fw, Cin, Cout) / (Cin, Cout) JAX
weights to torch's (Cout, Cin, kh, kw)); it calls nothing of ``gastx``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from gastx_torch.models.config import GastNetConfig


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.bin`` as a flat state dict on the CPU.

    Accepts the training-checkpoint dict ``{..., 'model_pos': sd}`` or a
    bare state dict; ``module.`` DataParallel prefixes are stripped.
    """
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model_pos" in blob:
        blob = blob["model_pos"]
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in blob.items()}


def params_from_jax(params: Mapping, state: Optional[Mapping],
                    cfg: GastNetConfig) -> Dict[str, torch.Tensor]:
    """JAX ``(params, state)`` trees (numpy leaves) -> the port's
    ``state_dict`` (float32 tensors; ``num_batches_tracked`` int64 0).
    With ``state`` None, a tree shaped as ``params`` (the weights, a
    gradient or an optimizer moment) -> the port's parameters by name
    through the same layout transforms, with no BN buffers.
    """
    sd: Dict[str, torch.Tensor] = {}

    def sub(s, *keys):  # a branch of ``state``; None without one
        for k in keys:
            s = None if s is None else s[k]
        return s

    def put(key, arr):  # a copy: a JAX host array or .ckpt leaf is read-only
        sd[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))

    def put_bn(prefix, p, s):
        put(f"{prefix}.weight", p["scale"])
        put(f"{prefix}.bias", p["bias"])
        if s is None:
            return
        put(f"{prefix}.running_mean", s["mean"])
        put(f"{prefix}.running_var", s["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0,
                                                           dtype=torch.int64)

    def put_tconv(key, w):  # (fw, Cin, Cout) -> (Cout, Cin, fw, 1)
        put(key, np.transpose(np.asarray(w), (2, 1, 0))[:, :, :, None])

    def put_pconv(key, w):  # (Cin, Cout) -> (Cout, Cin, 1, 1)
        put(key, np.transpose(np.asarray(w), (1, 0))[:, :, None, None])

    put_bn("init_bn", params["init_bn"], sub(state, "init_bn"))
    put_tconv("expand_conv.weight", params["expand_conv"]["w"])
    put_bn("expand_bn", params["expand_bn"], sub(state, "expand_bn"))

    if len(params["temporal"]) != cfg.num_levels - 1:
        raise ValueError("the JAX tree does not match the config's levels")
    for i, blk_p in enumerate(params["temporal"]):
        blk_s = sub(state, "temporal", i)
        put_tconv(f"layers_conv.{2 * i}.weight", blk_p["conv_t"]["w"])
        put_pconv(f"layers_conv.{2 * i + 1}.weight", blk_p["conv_1"]["w"])
        put_bn(f"layers_bn.{2 * i}", blk_p["bn_t"], sub(blk_s, "bn_t"))
        put_bn(f"layers_bn.{2 * i + 1}", blk_p["bn_1"], sub(blk_s, "bn_1"))

    for i, gab_p in enumerate(params["gabs"]):
        gab_s = sub(state, "gabs", i)
        g = f"layers_graph_conv.{i}"
        lp, ls = gab_p["local"], sub(gab_s, "local")
        lg = f"{g}.local_graph_layer"
        for name in ("sym", "con"):
            put(f"{lg}.gcn_{name}.W",
                np.stack([np.asarray(lp[name]["W0"]),
                          np.asarray(lp[name]["W1"])]))
            put(f"{lg}.gcn_{name}.e", lp[name]["e"])
        put_bn(f"{lg}.bn_1", lp["bn_sym"], sub(ls, "bn_sym"))
        put_bn(f"{lg}.bn_2", lp["bn_con"], sub(ls, "bn_con"))
        put_pconv(f"{lg}.cat_conv.weight", lp["cat_w"])
        put_bn(f"{lg}.cat_bn", lp["cat_bn"], sub(ls, "cat_bn"))

        gp, gs = gab_p["global"], sub(gab_s, "global")
        for k in range(np.asarray(gp["theta_w"]).shape[0]):
            a = f"{g}.global_graph_layer.attentions.{k}"
            for name in ("theta", "phi", "g"):  # (C, W) -> (W, C, 1)
                put(f"{a}.{name}.weight",
                    np.transpose(np.asarray(gp[f"{name}_w"][k]),
                                 (1, 0))[:, :, None])
                put(f"{a}.{name}.bias", gp[f"{name}_b"][k])
            put(f"{a}.C_k", gp["C_k"][k])
            proj = np.concatenate([np.asarray(gp["proj_theta"][k]),
                                   np.asarray(gp["proj_phi"][k])])
            put(f"{a}.concat_project.0.weight", proj[None, :, None, None])
        put_pconv(f"{g}.global_graph_layer.cat_conv.weight", gp["cat_w"])
        put_bn(f"{g}.global_graph_layer.cat_bn", gp["cat_bn"],
               sub(gs, "cat_bn"))

        put_pconv(f"{g}.cat_conv.weight", gab_p["cat_w"])
        put_bn(f"{g}.cat_bn", gab_p["cat_bn"], sub(gab_s, "cat_bn"))

    put_pconv("shrink.weight", params["shrink"]["w"])
    return sd


def ablation_params_from_jax(params: Mapping, state: Optional[Mapping] = None
                             ) -> Dict[str, torch.Tensor]:
    """The JAX parameter dict (and BN state) of one ablation module of
    ``gastx.ops.ablations`` -> the ``state_dict`` of its port in
    ``gastx_torch.ops.ablations``, told apart by its keys:
    ``sem_graph_conv``'s (W0, W1, e[, bias]) -> ``SemGraphConv``,
    ``local_graph_simple``'s (sym, con, bn_sym, bn_con, cat_w, cat_bn) ->
    ``LocalGraphSimple``, ``single_global_graph``'s (theta_w, ...,
    C_k, bn) -> ``SingleGlobalGraph``. Without ``state`` the BN buffers
    are left out (load with ``strict=False``)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        sd[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))

    def put_sem(prefix, p):
        put(f"{prefix}W", np.stack([np.asarray(p["W0"]),
                                    np.asarray(p["W1"])]))
        put(f"{prefix}e", np.asarray(p["e"]).reshape(1, -1))
        if "bias" in p:
            put(f"{prefix}bias", p["bias"])

    def put_bn(prefix, p, s):
        put(f"{prefix}.weight", p["scale"])
        put(f"{prefix}.bias", p["bias"])
        if s is not None:
            put(f"{prefix}.running_mean", s["mean"])
            put(f"{prefix}.running_var", s["var"])
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(
                0, dtype=torch.int64)

    def sub(key):
        return None if state is None else state[key]

    if "W0" in params:
        put_sem("", params)
    elif "sym" in params:
        put_sem("gcn_sym.", params["sym"])
        put_sem("gcn_con.", params["con"])
        put_bn("bn_1", params["bn_sym"], sub("bn_sym"))
        put_bn("bn_2", params["bn_con"], sub("bn_con"))
        put("cat_conv.weight",
            np.transpose(np.asarray(params["cat_w"]))[:, :, None, None])
        put_bn("cat_bn", params["cat_bn"], sub("cat_bn"))
    elif "theta_w" in params:
        for name in ("theta", "phi", "g"):  # (C, W) -> (W, C, 1)
            put(f"attentions.{name}.weight",
                np.transpose(np.asarray(params[f"{name}_w"]))[:, :, None])
            put(f"attentions.{name}.bias", params[f"{name}_b"])
        proj = np.concatenate([np.asarray(params["proj_theta"]),
                               np.asarray(params["proj_phi"])])
        put("attentions.concat_project.0.weight", proj[None, :, None, None])
        put("attentions.C_k", params["C_k"])
        put_bn("bn", params["bn"], sub("bn"))
    else:
        raise ValueError(f"not an ablation module's parameters: "
                         f"{sorted(params)}")
    return sd
