"""Compare checkouts of the port on one GPU, in turns: the default float32
eval forwards, the float32 kernels, and the JAX package's shipped bf16
routes with a profiled breakdown.

    python3 scripts/torch_default_forwards.py TREE [TREE ...]
        [--tiered [all]] [--rounds N] [--json F]

Each tree (a checkout's root, e.g. a ``git archive`` of the parent commit
unpacked under ``build/``) runs in a process of its own, in the order
T1 .. Tn, Tn .. T1 (``--rounds`` times over), so that a drift of the card
over the call weighs on every tree alike. Each run times that tree's ``gastx_torch`` (its kernels
built into its own ``build/``) with this checkout's ``chip_smoke.py`` as
the harness:

* the forwards of ``chip_smoke.FORWARDS`` (phase 4's cells, the default
  tiers, random weights from seeds): ms (CUDA events, ``cuda_ms``) and the
  output, which must be bitwise the first tree's;
* the float32 ``gemm_epilogue`` at every ``chip_smoke.GEMM_SHAPES`` line;
  ``gemm_tc``'s ``general`` body on float32 operands (the ragged phase-2
  cases it takes) at ``default`` and ``high``, also its kernel's device
  time alone (``device_ms``: at these shapes the wrapper's host time and
  its W split can exceed the kernel's); ``gab_narrow`` at the 243f
  model's C=32 GAB, T=241, B=256;
* the float32 ``gemm_tc`` ``vec16`` rows: every tier at the
  ``chip_smoke.TIER_GEMM_CASES`` shapes it takes, also its kernel's
  device time alone;
* the level-0 expand conv of each shipped model
  (``chip_smoke.EXPAND_SHAPES``) at ``"highest"`` and every tier
  (``chip_smoke.expand_table``): the device time of the kernel that
  computes it (``gemm_smallk``, or in a tree without it the general
  ``gemm_epilogue`` / ``gemm_tc``) and the call's CUDA-event time;
* the tiered forwards of phase 10 (d) (``chip_smoke.TIER_FORWARDS`` at
  all "high" and at the JAX preset, ``chip_smoke.tier_configs``): ms
  (``chip_smoke.issue_ms`` over 10 forwards: CUDA events and the host's
  issue time);
* phase 8's streaming cells (``chip_smoke.STREAM_CELLS``, causal models,
  ``chip_smoke.streaming_cell``): push p50 and p99; and the outputs,
  bitwise the first tree's, of a push's strided forward (27f and 81f, 256
  streams), a request's dilated forward on a whole sequence (27f and
  243f) and the 27f dense forward;
* ``chip_smoke.SHIPPED_CELLS`` (the JAX package's shipped bf16 routes:
  the 243f preset with fold at B=256, the 81f preset at B=1024 with level
  3 float32) at float32 and bf16 storage through ``chip_smoke.pair_turns``,
  phase 13's own timing: ms in turns, the host's issue time and one
  profiled forward a side (``chip_smoke.breakdown``).

``--tiered`` times only the 27f model's tiered forwards
(``TIERED_27F``: "high" and the preset at B=1024 and B=256), each also
with its device busy ms from one profiled forward
(``chip_smoke.breakdown``), so that a run of several rounds costs minutes;
``--tiered all`` those of phase 10 (d) (``chip_smoke.TIER_FORWARDS``: 27f
and 81f at B=1024, 243f at B=256) in the same way.

The bf16-I/O ``gemm_tc`` rows are ``scripts/torch_gemm_tc.py --bf16``'s
(``--tree`` for another checkout). Prints each row's ms per tree (the mean
of its two runs) and writes all runs, the card's name and power limit to
``chiprun_out/`` (``--json``, default ``default_forwards.json``). Exit 1 if
an output differs.
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

# --tiered: the 27f model's tiered forwards, (frames, batch of windows).
TIERED_27F = ((27, 1024), (27, 256))


def tiered_forwards(cs, dev, cells, busy: bool) -> dict:
    """ms of the "high" and preset forwards of each (frames, windows) in
    ``cells`` (one model a frame count, random weights from it as seed),
    with the host's issue ms and, with ``busy``, the device's busy ms of
    one profiled forward."""
    import numpy as np
    import torch

    from gastx_torch.models import build_gastnet

    ms, models = {}, {}
    for frames, b in cells:
        cfgs = cs.tier_configs(frames)
        if frames not in models:
            models[frames] = build_gastnet(cfgs["highest"], seed=frames,
                                           device=dev)
        model = models[frames]
        x = torch.from_numpy(np.random.default_rng(frames).standard_normal(
            (b, frames, 17, 2)).astype(np.float32)).to(dev)
        for name in ("high", "preset"):
            cs.with_config(model, cfgs[name])
            row = f"forward {frames}f {name} B={b}"
            ms[row], ms[f"{row}, host issue"] = cs.issue_ms(
                lambda: model(x), reps=10)
            if busy:
                ms[f"{row}, device busy"] = cs.breakdown(
                    lambda: model(x))["busy_ms"]
        del x
    del models
    torch.cuda.empty_cache()
    return ms


def one_tree(tree: str, out: str, tiered=None) -> None:
    """Time ``tree``'s rows and save them (and its forwards' outputs);
    with ``tiered`` only the tiered forwards (``"27f"``: ``TIERED_27F``'s,
    ``"all"``: ``chip_smoke.TIER_FORWARDS``')."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, REPO)
    import chip_smoke as cs  # the harness: this checkout's
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import gastx_torch
    from gastx_torch.models import build_gastnet, config_for_frames
    from gastx_torch.ops.cuda import kernels as K
    from gastx_torch.ops.cuda.fused_gab import gab_tables

    if not os.path.abspath(gastx_torch.__file__).startswith(tree + os.sep):
        raise SystemExit(f"gastx_torch came from {gastx_torch.__file__}")
    # As chip_smoke.main: plain convolutions and bf16 products in float32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    if tiered:
        cells = TIERED_27F if tiered == "27f" else cs.TIER_FORWARDS
        torch.save({"ms": tiered_forwards(cs, dev, cells, True),
                    "y": {}, "shipped": {}}, out)
        return
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
    for idx, windows in cs.TIER_GEMM_CASES:
        spec = cs.GEMM_SHAPES[idx]
        pieces, m, kw = cs.gemm_case(spec, dev, 300 + idx, windows=windows)
        if K.tc_variant(pieces, spec[4], kw["res"]) != "vec16":
            continue
        for tier in K.TC_TIERS:
            kt = dict(kw, tier=tier)
            row = f"gemm_tc vec16 {tier} {spec[0]} (B={windows})"
            ms[row] = cs.cuda_ms(lambda: K.gemm_epilogue(pieces, m, **kt),
                                 reps=20)
            ms[f"{row}, device"] = cs.device_ms(
                lambda: K.gemm_epilogue(pieces, m, **kt), "gemm_tc_kernel_ws")
        del pieces, kw
    for r in cs.expand_table(K, dev, plain=False):
        row = f"expand conv {r['tier']} {r['shape']}"
        ms[row] = r["call_ms"]
        ms[f"{row}, device"] = r["ms"]
    ms.update(tiered_forwards(cs, dev, cs.TIER_FORWARDS, False))
    for rf, persons in cs.STREAM_CELLS:
        cfg = dataclasses.replace(config_for_frames(rf), causal=True)
        r = cs.streaming_cell(K, build_gastnet(cfg, seed=rf, device=dev),
                              persons, f"{rf}f M={persons}")
        for q in ("p50", "p99"):
            ms[f"push {q} {rf}f M={persons}"] = float(r[f"push_{q}_ms"])
    # The float32 forwards of the other paths, held bit for bit too: a
    # push's strided forward (a causal model on windows of rf frames), a
    # phase-3 request's dilated forward on a 1000-frame sequence with its
    # flip (B=2), and the dense forward.
    for cell, rf, shape, variant, fields in (
            ("push 27f", 27, (256, 27), "strided", {"causal": True}),
            ("push 81f", 81, (256, 81), "strided", {"causal": True}),
            ("request 27f", 27, (2, 1026), "dilated", {}),
            ("request 243f", 243, (2, 1242), "dilated", {}),
            ("dense 27f", 27, (64, 27), "dilated", {"dense": True})):
        cfg = dataclasses.replace(config_for_frames(rf), **fields)
        model = build_gastnet(cfg, seed=rf + 1, device=dev)
        x = torch.from_numpy(np.random.default_rng(rf + 1).standard_normal(
            (*shape, 17, 2)).astype(np.float32)).to(dev)
        ys[cell] = model(x, variant).cpu()
        del model, x
    torch.cuda.empty_cache()
    m243 = models["243f"]
    t = gab_tables(m243.layers_graph_conv[0], m243.statics)
    gen = torch.Generator(device=dev).manual_seed(421)
    x = torch.randn((256 * 241 * 17, 32), generator=gen, device=dev)
    ms["gab_narrow C=32 T=241 B=256"] = cs.cuda_ms(
        lambda: K.gab_narrow(x, t), reps=20)
    del x, models
    torch.cuda.empty_cache()
    shipped = {}
    for cell in cs.SHIPPED_CELLS:
        label, _, b, _, (na, _), (nb, _) = cell
        r = shipped[label] = cs.pair_turns(cell, dev, profile=True)
        for name in (na, nb):
            ms[f"{label} {name} B={b}"] = r[name]["ms"]
    torch.save({"ms": ms, "y": ys, "shipped": shipped}, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--one", nargs=2, metavar=("TREE", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--tiered", nargs="?", const="27f",
                    choices=("27f", "all"),
                    help="time only the tiered forwards: the 27f model's "
                         "(default) or all of phase 10 (d)'s")
    ap.add_argument("--rounds", type=int, default=1,
                    help="times over the order T1 .. Tn, Tn .. T1")
    ap.add_argument("--json", default="default_forwards.json")
    args = ap.parse_args(argv)
    if args.one:
        one_tree(*args.one, tiered=args.tiered)
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
        for n, i in enumerate((order + order[::-1]) * args.rounds):
            path = os.path.join(tmp, f"{n}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", args.trees[i], path]
                           + (["--tiered", args.tiered] if args.tiered
                              else []), check=True)
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
    if not args.tiered:
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
    shipped = {args.trees[i]: [r["shipped"] for r in turns[i]]
               for i in order}
    for tree, runs in shipped.items():
        for run in runs:
            for cell, sides in run.items():
                for name, side in sides.items():
                    prof = side["breakdown"]
                    print(f"{tree} {cell} {name}: ms turns {side['turns']}, "
                          f"host issue ms {side['host_issue_ms']}; profiled: "
                          f"device busy {prof['busy_ms']:.3f} of "
                          f"{prof['wall_ms']:.3f} ms, idle "
                          f"{prof['idle_share']:.4f}; " + ", ".join(
                              f"{k} {v['ms']:.3f} ({v['launches']})"
                              for k, v in sorted(
                                  prof["classes"].items(),
                                  key=lambda kv: -kv[1]["ms"])))
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", args.json), "w") as f:
        json.dump({"card": smi.strip(), "trees": args.trees,
                   "order": [args.trees[i] for i in
                             (order + order[::-1]) * args.rounds],
                   "bitwise_equal": same, "ms_turns": rows,
                   "shipped": shipped}, f, indent=1)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
