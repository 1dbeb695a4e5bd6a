"""Compare checkouts of the port on one GPU, in turns: the default float32
eval forwards and the kernels whose loads and stores the bf16-I/O forms
touch.

    python3 scripts/torch_default_forwards.py TREE [TREE ...] [--json F]

Each tree (a checkout's root, e.g. a ``git archive`` of the parent commit
unpacked under ``build/``) runs in a process of its own, in the order
T1 .. Tn, Tn .. T1, so that a drift of the card over the call weighs on
every tree alike. Each run, on that tree's ``gastx_torch`` and
``chip_smoke.py`` (its kernels built into its own ``build/``):

* the forwards of ``chip_smoke.FORWARDS`` (phase 4's cells, the default
  tiers, random weights from seeds): ms (CUDA events, ``cuda_ms``) and the
  output, which must be bitwise the first tree's;
* the float32 ``gemm_epilogue`` at every ``chip_smoke.GEMM_SHAPES`` line;
  ``gemm_tc``'s ``general`` body on float32 operands (the ragged phase-2
  cases it takes) at ``default`` and ``high``, also its kernel's device
  time alone (``device_ms``: at these shapes the wrapper's host time and
  its W split can exceed the kernel's); ``gab_narrow`` at the 243f
  model's C=32 GAB, T=241, B=256;
* where the tree has them, the bf16-I/O ``gemm_tc`` at every tier on
  ``chip_smoke.BF16_GEMM_CASES[0]`` at B=1024 (bf16 x piece, bf16 out),
  held to its plain version (``check_bf16``).

Prints each row's ms per tree (the mean of its two turns) and writes all
turns, the card's name and power limit to ``chiprun_out/`` (``--json``,
default ``default_forwards.json``). Exit 1 if an output differs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_tree(tree: str, out: str) -> None:
    """Time ``tree``'s rows and save them (and its forwards' outputs)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    import gastx_torch
    from gastx_torch.models import build_gastnet, config_for_frames
    from gastx_torch.ops.cuda import kernels as K
    from gastx_torch.ops.cuda.fused_gab import gab_tables

    for mod in (cs, gastx_torch):
        if not os.path.abspath(mod.__file__).startswith(tree):
            raise SystemExit(f"{mod.__name__} came from {mod.__file__}")
    # As chip_smoke.main: plain convolutions and bf16 products in float32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    ms, ys = {}, {}
    models = {}
    for cell, rf, b, route in cs.FORWARDS:
        cfg = dataclasses.replace(config_for_frames(rf), **route)
        model = models[cell] = build_gastnet(cfg, seed=rf, device=dev)
        x = torch.from_numpy(np.random.default_rng(rf).standard_normal(
            (b, rf, 17, 2)).astype(np.float32)).to(dev)
        ys[cell] = model(x).cpu()
        ms[f"forward {cell} B={b}"] = cs.cuda_ms(lambda: model(x))
        del x
    for i, spec in enumerate(cs.GEMM_SHAPES):
        pieces, m, kw = cs.gemm_case(spec, dev, 300 + i)
        ms[f"gemm_epilogue {spec[0]}"] = cs.cuda_ms(
            lambda: K.gemm_epilogue(pieces, m, **kw), reps=20)
    for label, pieces, m, kw, _ in cs.gemm_ragged_cases(dev):
        if K.tc_variant(pieces, pieces[0][1].shape[1],
                        kw.get("res")) != "general":
            continue
        for tier in ("default", "high"):
            kt = dict(kw, tier=tier)
            row = f"gemm_tc general {tier} {label}"
            ms[row] = cs.cuda_ms(lambda: K.gemm_epilogue(pieces, m, **kt),
                                 reps=20)
            ms[f"{row}, device"] = cs.device_ms(
                lambda: K.gemm_epilogue(pieces, m, **kt), "gemm_tc_kernel")
    m243 = models["243f"]
    t = gab_tables(m243.layers_graph_conv[0], m243.statics)
    gen = torch.Generator(device=dev).manual_seed(421)
    x = torch.randn((256 * 241 * 17, 32), generator=gen, device=dev)
    ms["gab_narrow C=32 T=241 B=256"] = cs.cuda_ms(
        lambda: K.gab_narrow(x, t), reps=20)
    del x, models
    torch.cuda.empty_cache()
    if hasattr(cs, "BF16_GEMM_CASES"):
        label, spec_i, cast, res_bf16, _ = cs.BF16_GEMM_CASES[0]
        pieces, m, kw = cs.bf16_gemm_case(K, dev, spec_i, cast, res_bf16,
                                          None, 420)
        kw["out_dtype"] = torch.bfloat16
        for tier in K.TC_TIERS:
            kt = dict(kw, tier=tier)
            name = f"gemm_tc bf16 I/O {tier} {label}"
            cs.check_bf16(name, K.gemm_epilogue(pieces, m, **kt),
                          K.gemm_epilogue_plain(pieces, m, **kt))
            ms[name] = cs.cuda_ms(lambda: K.gemm_epilogue(pieces, m, **kt),
                                  reps=20)
    torch.save({"ms": ms, "y": ys}, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--one", nargs=2, metavar=("TREE", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--json", default="default_forwards.json")
    args = ap.parse_args(argv)
    if args.one:
        one_tree(*args.one)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.trees:
        print("needs a CUDA device and at least one tree", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    order = list(range(len(args.trees)))
    turns = {i: [] for i in order}
    with tempfile.TemporaryDirectory() as tmp:
        for n, i in enumerate(order + order[::-1]):
            path = os.path.join(tmp, f"{n}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", args.trees[i], path], check=True)
            turns[i].append(torch.load(path))
    ys0 = turns[0][0]["y"]
    same = True
    for i in order:
        for run in turns[i]:
            for cell, y in run["y"].items():
                if not torch.equal(y, ys0[cell]):
                    same = False
                    d = float((y - ys0[cell]).abs().max())
                    print(f"{args.trees[i]} {cell}: DIFFERENT, max|d| "
                          f"{d:.3e}")
    print(f"forwards bitwise equal across trees and turns: {same}")
    rows = {}
    names = list(dict.fromkeys(k for i in order for r in turns[i]
                               for k in r["ms"]))
    for name in names:
        rows[name] = {args.trees[i]: [r["ms"][name] for r in turns[i]
                                      if name in r["ms"]] for i in order}
        means = [sum(v) / len(v) if v else None
                 for v in rows[name].values()]
        print(f"{name}: " + " | ".join(
            "-" if v is None else f"{v:.4f}" for v in means))
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", args.json), "w") as f:
        json.dump({"card": smi.strip(), "trees": args.trees,
                   "order": [args.trees[i] for i in order + order[::-1]],
                   "bitwise_equal": same, "ms_turns": rows}, f, indent=1)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
