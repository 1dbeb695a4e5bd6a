"""Weight interchange: upstream ``.bin`` checkpoints and the JAX weights.

The port's ``GastNet`` has the upstream ``state_dict`` key layout, so an
upstream checkpoint loads with ``load_state_dict``. :func:`params_from_jax`
is the bridge from the JAX package: it takes the JAX ``(params, state)``
trees as numpy arrays and returns the port's ``state_dict``. The mapping
is this module's own (channels-last (fw, Cin, Cout) / (Cin, Cout) JAX
weights to torch's (Cout, Cin, kh, kw)); it calls nothing of ``gastx``.
"""
from __future__ import annotations

from typing import Dict, Mapping

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


def params_from_jax(params: Mapping, state: Mapping, cfg: GastNetConfig
                    ) -> Dict[str, torch.Tensor]:
    """JAX ``(params, state)`` trees (numpy leaves) -> the port's
    ``state_dict`` (float32 tensors; ``num_batches_tracked`` int64 0)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        sd[key] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(arr, np.float32)))

    def put_bn(prefix, p, s):
        put(f"{prefix}.weight", p["scale"])
        put(f"{prefix}.bias", p["bias"])
        put(f"{prefix}.running_mean", s["mean"])
        put(f"{prefix}.running_var", s["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0,
                                                           dtype=torch.int64)

    def put_tconv(key, w):  # (fw, Cin, Cout) -> (Cout, Cin, fw, 1)
        put(key, np.transpose(np.asarray(w), (2, 1, 0))[:, :, :, None])

    def put_pconv(key, w):  # (Cin, Cout) -> (Cout, Cin, 1, 1)
        put(key, np.transpose(np.asarray(w), (1, 0))[:, :, None, None])

    put_bn("init_bn", params["init_bn"], state["init_bn"])
    put_tconv("expand_conv.weight", params["expand_conv"]["w"])
    put_bn("expand_bn", params["expand_bn"], state["expand_bn"])

    if len(params["temporal"]) != cfg.num_levels - 1:
        raise ValueError("the JAX tree does not match the config's levels")
    for i, (blk_p, blk_s) in enumerate(zip(params["temporal"],
                                           state["temporal"])):
        put_tconv(f"layers_conv.{2 * i}.weight", blk_p["conv_t"]["w"])
        put_pconv(f"layers_conv.{2 * i + 1}.weight", blk_p["conv_1"]["w"])
        put_bn(f"layers_bn.{2 * i}", blk_p["bn_t"], blk_s["bn_t"])
        put_bn(f"layers_bn.{2 * i + 1}", blk_p["bn_1"], blk_s["bn_1"])

    for i, (gab_p, gab_s) in enumerate(zip(params["gabs"], state["gabs"])):
        g = f"layers_graph_conv.{i}"
        lp, ls = gab_p["local"], gab_s["local"]
        lg = f"{g}.local_graph_layer"
        for name in ("sym", "con"):
            put(f"{lg}.gcn_{name}.W",
                np.stack([np.asarray(lp[name]["W0"]),
                          np.asarray(lp[name]["W1"])]))
            put(f"{lg}.gcn_{name}.e", lp[name]["e"])
        put_bn(f"{lg}.bn_1", lp["bn_sym"], ls["bn_sym"])
        put_bn(f"{lg}.bn_2", lp["bn_con"], ls["bn_con"])
        put_pconv(f"{lg}.cat_conv.weight", lp["cat_w"])
        put_bn(f"{lg}.cat_bn", lp["cat_bn"], ls["cat_bn"])

        gp, gs = gab_p["global"], gab_s["global"]
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
        put_bn(f"{g}.global_graph_layer.cat_bn", gp["cat_bn"], gs["cat_bn"])

        put_pconv(f"{g}.cat_conv.weight", gab_p["cat_w"])
        put_bn(f"{g}.cat_bn", gab_p["cat_bn"], gab_s["cat_bn"])

    put_pconv("shrink.weight", params["shrink"]["w"])
    return sd
