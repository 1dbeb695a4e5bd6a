"""The convergence gate's held-out MPJPE from several seeded inits.

Runs the recipe of ``tests/test_torch_train.py::
test_training_converges_below_30mm`` (arc 3,3, C=32, dropout 0; 520
strided amsgrad steps at B=128 with ``convergence_lr`` on
``wellposed_batch`` from ``np.random.default_rng(7)``) from the port's
``build_gastnet`` init of each seed, and prints the held-out MPJPE before
and after. ``--permute SEED`` also runs each with the rows of every batch
in a seeded random order, which changes nothing but the order of the
float32 sums. One process per run, all started together::

    python3 scripts/torch_convergence_seeds.py --seeds 0 1 2 3 --permute 5
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(seed: int, permute, device: str) -> dict:
    import numpy as np
    import torch

    from gastx_torch.data import synthetic
    from gastx_torch.eval.metrics import mpjpe
    from gastx_torch.models import GastNetConfig, build_gastnet
    from gastx_torch.train import make_optimizer, train_step

    torch.set_num_threads(1)
    cfg = GastNetConfig(filter_widths=(3, 3), channels=32, dropout=0.0)
    model = build_gastnet(cfg, seed=seed, device=device)
    rf = cfg.receptive_field()
    rng = np.random.default_rng(7)
    ex2d, ex3d = (torch.from_numpy(a).to(device)
                  for a in synthetic.wellposed_batch(rng, 256, rf))

    def held_out_mm():
        model.eval()
        return float(mpjpe(model(ex2d, "strided"), ex3d)) * 1000.0

    before = held_out_mm()
    n, batch = synthetic.CONVERGENCE_STEPS, synthetic.CONVERGENCE_BATCH
    x2d, x3d = (torch.from_numpy(a).to(device)
                for a in synthetic.wellposed_batch(rng, n * batch, rf))
    order = (torch.randperm(batch, generator=torch.Generator().manual_seed(
        permute)) if permute is not None else torch.arange(batch))
    order = order.to(device)
    opt = make_optimizer(model.parameters())
    w = torch.ones(batch, device=device)
    for i in range(n):
        sl = slice(i * batch, (i + 1) * batch)
        train_step(model, opt, x2d[sl][order], x3d[sl][order], w,
                   synthetic.convergence_lr(i), None, "strided")
    return {"seed": seed, "permute": permute, "device": device,
            "before_mm": before, "after_mm": held_out_mm()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--permute", type=int, default=None,
                    help="also run each seed with batch rows in this "
                         "seed's random order")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--one", type=str, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        seed, permute = json.loads(args.one)
        print(json.dumps(run(seed, permute, args.device)))
        return 0
    jobs = [(s, None) for s in args.seeds]
    if args.permute is not None:
        jobs += [(s, args.permute) for s in args.seeds]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--device", args.device,
         "--one", json.dumps(job)], stdout=subprocess.PIPE, text=True,
        env=env) for job in jobs]
    for p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            return p.returncode
        r = json.loads(out.strip().splitlines()[-1])
        print(f"seed {r['seed']} permute {r['permute']} on {r['device']}: "
              f"{r['before_mm']:.2f} -> {r['after_mm']:.2f} mm")
    return 0


if __name__ == "__main__":
    sys.exit(main())
