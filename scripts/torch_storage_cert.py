"""The bf16 storage cert on one GPU: how far bf16 storage moves the eval
forward from float32, worst of 24 seeds, in mm.

For each cell (``CELLS``) and seed 0-23: the port's init of the shipped
model (``build_gastnet(config_for_frames(f), seed)``, h36m17, dilated,
non-causal, dropout 0), the input ``np.random.default_rng(seed)
.standard_normal((64, f, 17, 2))`` (the harness of ``chip_smoke.py``
phase 10 (b), after the JAX package's ``scripts/perf_lab13.py``), and
max |y_storage - y_float32| of the card's eval forward x 1000 (mm). The
cells: ``storage_dtype="bfloat16"`` at 27f, 81f and 243f (every level),
the 81f mixed levels (``config_for_frames(81)``'s
``storage_dtype_levels``, the C=512 tail level float32), and
``gab_io_dtype="bfloat16"`` at 27f. The budget is the JAX package's 0.1
mm; a cell over it is a finding (no default changes with this script):

    python3 scripts/torch_storage_cert.py [--seeds N]

Writes ``chiprun_out/storage_cert.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET_MM = 0.1
BATCH = 64
# (cell, receptive field, fields on config_for_frames(f, dropout=0.0)).
CELLS = (("27f bf16", 27, {"storage_dtype": "bfloat16"}),
         ("81f bf16", 81, {"storage_dtype": "bfloat16",
                           "storage_dtype_levels": ()}),
         ("243f bf16", 243, {"storage_dtype": "bfloat16"}),
         ("81f mixed", 81, {"storage_dtype": "bfloat16"}),
         ("27f gab_io_dtype", 27, {"gab_io_dtype": "bfloat16"}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=24)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from gastx_torch.models import build_gastnet, config_for_frames
    from gastx_torch.ops.cuda import kernels as K

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    K.build_kernels()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.time()
    out = {"card": card, "budget_mm": BUDGET_MM, "batch": BATCH,
           "seeds": args.seeds, "cells": {}}
    per_seed = {cell: [] for cell, _, _ in CELLS}
    for frames in sorted({f for _, f, _ in CELLS}):
        base = config_for_frames(frames, dropout=0.0)
        cells = [(c, dataclasses.replace(base, **fields))
                 for c, f, fields in CELLS if f == frames]
        for seed in range(args.seeds):
            model = build_gastnet(base, seed=seed, device=dev)
            x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
                (BATCH, frames, 17, 2)).astype(np.float32)).to(dev)
            exact = model(x)
            for cell, cfg in cells:
                model.cfg = cfg
                y = model(x)
                if not bool(torch.isfinite(y).all()):
                    raise SystemExit(f"{cell} seed {seed}: non-finite")
                per_seed[cell].append(float((y - exact).abs().max()) * 1e3)
            model.cfg = base
            del model, x, exact
        torch.cuda.empty_cache()
    for cell, _, _ in CELLS:
        mm = per_seed[cell]
        worst = max(mm)
        out["cells"][cell] = {
            "worst_mm": worst, "seed": int(np.argmax(mm)),
            "median_mm": float(np.median(mm)), "per_seed_mm": mm,
            "within_budget": worst <= BUDGET_MM}
        print(f"{cell}: worst {worst:.4f} mm (seed {int(np.argmax(mm))}), "
              f"median {float(np.median(mm)):.4f} mm; "
              f"{'within' if worst <= BUDGET_MM else 'OVER'} the "
              f"{BUDGET_MM} mm budget")
    out["s"] = time.time() - t0
    path = os.path.join(REPO, "chiprun_out", "storage_cert.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"{card}; {out['s']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
