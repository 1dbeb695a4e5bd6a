"""The JAX package's convergence gate (``tests/test_golden.py``) on the
port's training stack, on the CPU. It takes the longest of the training
tests, so it has a file of its own (the parallel runner gives each file
one worker).
"""
import numpy as np
import torch

from gastx_torch.data import synthetic
from gastx_torch.eval import metrics as TM
from gastx_torch.models import build_gastnet
from gastx_torch.train import make_optimizer, train_step
from gastx_torch.train.loop import root_relative


# -- the convergence gate ------------------------------------------------------

def test_training_converges_below_30mm():
    """The JAX package's convergence gate (tests/test_golden.py) on the
    port: 520 strided steps at B=128 with convergence_lr from the port's
    seeded init take held-out MPJPE from above 400 mm to under 30 mm (the
    JAX package measured 28.1 mm from its own init)."""
    from gastx_torch.models import GastNetConfig

    cfg = GastNetConfig(filter_widths=(3, 3), channels=32, dropout=0.0)
    model = build_gastnet(cfg, seed=synthetic.CONVERGENCE_SEED, device="cpu")
    rf = cfg.receptive_field()
    rng = np.random.default_rng(7)
    ex2d, ex3d = (torch.from_numpy(a) for a in
                  synthetic.wellposed_batch(rng, 256, rf))

    def held_out_mm():
        model.eval()
        pred = model(ex2d, "strided")
        return TM.mpjpe(pred, root_relative(ex3d)).item() * 1000.0

    before = held_out_mm()
    n, batch = synthetic.CONVERGENCE_STEPS, synthetic.CONVERGENCE_BATCH
    x2d, x3d = synthetic.wellposed_batch(rng, n * batch, rf)
    opt = make_optimizer(model.parameters())
    w = torch.ones(batch)
    for i in range(n):
        sl = slice(i * batch, (i + 1) * batch)
        train_step(model, opt, torch.from_numpy(x2d[sl]),
                   torch.from_numpy(x3d[sl]), w,
                   synthetic.convergence_lr(i), None, "strided")
    after = held_out_mm()
    assert before > 400.0, before
    assert after < synthetic.CONVERGENCE_GATE_MM, (before, after)
