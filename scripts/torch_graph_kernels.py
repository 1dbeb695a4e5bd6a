"""Time ``sem_graph`` and ``joint_attention`` at their main-path launches on
one GPU, beside each launch's bound.

The same table as ``chip_smoke.py`` phase 4's "graph kernels by shape"
(``chip_smoke.graph_table``: the six launches of ``GRAPH_SHAPES``, each
held to its plain version, device time per launch from torch.profiler,
bound, GB/s, the instantiation that launched), for the ``gastx_torch`` of
this checkout or, with ``--tree``, of another one (e.g. a ``git archive``
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
    import chip_smoke
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
    rows = chip_smoke.graph_table(K, models, torch.device("cuda"))
    result = {"card": card, "tree": tree, "rows": rows}
    path = os.path.join(REPO, "chiprun_out", args.json)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
