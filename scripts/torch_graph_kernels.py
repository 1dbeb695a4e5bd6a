"""Time ``sem_graph`` and ``joint_attention`` at their main-path launches on
one GPU, beside each launch's bound.

The "graph kernels by shape" table (``graph_table``: the six launches of
``GRAPH_SHAPES``, each held to its plain version, device time per launch
from torch.profiler, bound, GB/s, the instantiation that launched; it was
``chip_smoke.py`` phase 4's until the script moved its one-off
measurements here), for the ``gastx_torch`` of this checkout or, with
``--tree``, of another one (e.g. a ``git archive``
of the parent commit, whose kernels keep the wrappers' Python signatures),
so that two versions of the kernels can be compared in one call:

    python3 scripts/torch_graph_kernels.py [--tree DIR] [--json F]

A tree whose package counts no launches by instantiation (one with a
single instantiation of each graph kernel) reports its launches under
the instantiation ``single``.

Prints one JSON object (the rows, the card's name and power limit, the
tree) and writes it to ``chiprun_out/`` (``--json``, default
``graph_kernels.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections.abc import Mapping

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# sem_graph and joint_attention by shape: their launches in one 27f B=1024
# and one 243f B=256 forward, (label, receptive field, GAB level, windows,
# frames at the GAB); J = 17.
GRAPH_SHAPES = (("27f L0", 27, 0, 1024, 25), ("27f L1", 27, 1, 1024, 19),
                ("27f L2", 27, 2, 1024, 1), ("243f L2", 243, 2, 256, 217),
                ("243f L3", 243, 3, 256, 163), ("243f L4", 243, 4, 256, 1))


def graph_table(K, models, dev) -> list:
    """The "graph kernels by shape": ``sem_graph`` and
    ``joint_attention`` at each ``GRAPH_SHAPES`` launch of ``models``
    (keyed by receptive field), each held to its plain version, with its
    device time per launch, bound, GB/s and the instantiation that
    launched."""
    import torch

    import chip_smoke as cs
    from gastx_torch.ops.cuda.fused_gab import gab_tables

    print("graph kernels by shape (device ms per launch)")
    out = []
    for i, (label, rf, level, b, t_gab) in enumerate(GRAPH_SHAPES):
        m = models[rf]
        t = gab_tables(m.layers_graph_conv[level], m.statics)
        c, k, inter, g_ch, j, d = K.gab_shape(t)
        rows = b * t_gab * j
        sem, attn = cs.graph_operands(K, t, rows, dev, seed=200 + i)
        for name, fn, plain, args, work in (
                ("sem_graph", K.sem_graph, K.sem_graph_plain, sem,
                 cs.sem_work(rows, c, j, d)),
                ("joint_attention", K.joint_attention,
                 K.joint_attention_plain, attn,
                 cs.attn_work(rows, j, k, inter, g_ch))):
            variant, got = cs.launched_variant(K, name, lambda: fn(*args))
            err = cs.check(f"{name} {label} [{variant}]", got, plain(*args))
            del got
            ms = cs.device_ms(lambda: fn(*args), f"{name}_kernel")
            bms, by = cs.bound(*work)
            out.append({"kernel": name, "shape": label, "rows": rows, "c": c,
                        "variant": variant, "ms": ms, "bound_ms": bms,
                        "bound_by": by, "gb_per_s": work[1] / ms / 1e6,
                        "max_abs_err": err})
            print(f"  {name} {label} ({rows} rows, C={c}) [{variant}]: "
                  f"{ms:.4f} ms, {work[1] / ms / 1e6:.1f} GB/s; bound "
                  f"{bms:.4f} by {by} ({bms / ms:.0%})")
        del sem, attn
        torch.cuda.empty_cache()
    return out


class _SingleVariant(Mapping):
    """A live view of ``LAUNCHES[kernel]`` as the counts of one
    instantiation, for a package with no ``VARIANT_LAUNCHES``."""

    def __init__(self, launches, kernel):
        self.launches, self.kernel = launches, kernel

    def __getitem__(self, variant):
        if variant != "single":
            raise KeyError(variant)
        return self.launches[self.kernel]

    def __iter__(self):
        return iter(("single",))

    def __len__(self):
        return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO,
                    help="checkout whose gastx_torch is timed")
    ap.add_argument("--json", default="graph_kernels.json",
                    help="file name of the result under chiprun_out/")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, tree)
    from gastx_torch.models import (GastNet, config_for_frames,
                                    init_gastnet, randomize_eval_statistics)
    from gastx_torch.ops.cuda import kernels as K

    if not K.__file__.startswith(tree + os.sep):
        raise SystemExit(f"imported {K.__file__}, not the tree {tree}")
    if not hasattr(K, "VARIANT_LAUNCHES"):
        K.VARIANT_LAUNCHES = {
            name: _SingleVariant(K.LAUNCHES, name)
            for name in ("sem_graph", "joint_attention")}
    K.build_kernels()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    models = {}
    for frames in (27, 243):
        gen = torch.Generator().manual_seed(frames)
        m = init_gastnet(GastNet(config_for_frames(frames)), gen)
        models[frames] = randomize_eval_statistics(m, gen).cuda().eval()
    rows = graph_table(K, models, torch.device("cuda"))
    result = {"card": card, "tree": tree, "rows": rows}
    path = os.path.join(REPO, "chiprun_out", args.json)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
