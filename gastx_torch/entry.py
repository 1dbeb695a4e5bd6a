"""Entry points of the port: the flagship forward and the data-parallel dry
run (the counterpart of ``__graft_entry__.py``).

    python -m gastx_torch.entry          # on the card: entry, dryrun(1)
"""
from __future__ import annotations

import numpy as np
import torch


def entry(device=None):
    """(fn, args) of the flagship 27-frame 17-joint lifting model:
    ``fn(model, x)`` is the eval-mode dilated forward on the hand-written
    kernels (flip-TTA lifting wraps the same forward), ``x`` 8 windows of
    27 frames, on ``device`` (``cuda`` unless given). The config is the
    port's ``config_for_frames(27, dropout=0.05)``, float32: the JAX
    package's mixed-precision preset waits on a cert on trained weights
    (``ROADMAP.md`` queue 1 item 2.1) before it becomes the port's
    default."""
    from gastx_torch.models import build_gastnet, config_for_frames

    model = build_gastnet(config_for_frames(27, dropout=0.05), seed=0,
                          device=device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 27, 17, 2)).astype(np.float32)).to(next(model.parameters())
                                               .device)

    def fn(model, x):
        return model(x, "dilated")

    return fn, (model, x)


def _dryrun_rank(rank: int, n: int, address: str, device) -> list:
    """One rank of :func:`dryrun_multichip`; returns its two losses."""
    from gastx_torch.device import resolve_device
    from gastx_torch.infer import lift_sequences
    from gastx_torch.models import GastNetConfig, build_gastnet
    from gastx_torch.parallel import (init_distributed, make_mesh,
                                      replicate, shard_batch)
    from gastx_torch.train import make_optimizer, train_step

    device = resolve_device(device)
    init_distributed(address, n, rank, device=device)
    mesh = make_mesh(None if device.type == "cuda" else [device] * n)

    # The whole step (every layer, the loss, the gradients, amsgrad, the
    # BN updates) at a small width and receptive field.
    cfg = GastNetConfig(filter_widths=(3, 3), channels=16, dropout=0.05)
    model = build_gastnet(cfg, seed=0, device=mesh.device)
    ddp = replicate(mesh, model)
    opt = make_optimizer(ddp.parameters())

    rng = np.random.default_rng(1)
    batch = 2 * n
    rf = cfg.receptive_field()
    x2d = rng.standard_normal((batch, rf, 17, 2)).astype(np.float32)
    x3d = rng.standard_normal((batch, 1, 17, 3)).astype(np.float32)
    w = np.ones((batch,), np.float32)
    (x2d_s, x3d_s, w_s), _ = shard_batch(mesh, x2d, x3d, w)
    generator = torch.Generator(device=mesh.device)
    # Two steps, not one: the second consumes the optimizer state and BN
    # statistics the first left on every rank.
    losses = []
    for i in range(2):
        generator.manual_seed(2 + i)
        losses.append(float(train_step(
            ddp, opt, x2d_s, x3d_s, w_s, 1e-3, generator, "strided",
            mesh=mesh, weight_sum=float(w.sum()))))
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite loss {losses}")

    # Serving-style lifting: flip-TTA lift with each bucket's rows split
    # over the ranks, held to this rank's own one-process lift.
    seqs = [rng.standard_normal((rf + 3 + i, 17, 2)).astype(np.float32)
            for i in range(2)]
    lifted = lift_sequences(model, seqs, tta=True, mesh=mesh)
    alone = lift_sequences(model, seqs, tta=True)
    for a, b in zip(lifted, alone):
        if not (np.isfinite(a).all() and np.allclose(a, b, atol=1e-5,
                                                     rtol=0)):
            raise RuntimeError("the sharded lift differs from the "
                               "one-process lift")
    if rank == 0:
        print(f"dryrun_multichip({n}): two DP train steps OK, "
              f"losses={[round(v, 4) for v in losses]}; sharded TTA lift "
              f"OK, shapes={[tuple(a.shape) for a in lifted]}", flush=True)
    return losses


def dryrun_multichip(n: int, device=None) -> list:
    """Two data-parallel train steps over ``n`` ranks, then the sharded
    flip-TTA lift held to the one-rank lift, on small shapes. The ranks
    are processes of this host started by the spawn method; on the card
    (``device`` None) they take NCCL, one rank a card, or gloo where they
    share one; with ``device="cpu"`` gloo on the CPU. Returns rank 0's
    two losses."""
    from gastx_torch.parallel import spawn

    return spawn(_dryrun_rank, n, device)[0]


if __name__ == "__main__":
    fn, args = entry()
    print("entry forward:", tuple(fn(*args).shape))
    dryrun_multichip(1)
