"""The ranks of tests/test_torch_parallel.py: what each of two gloo ranks on
the CPU computes. It imports torch and the port only (no JAX), since the
ranks are fresh processes started by the spawn method; the parent holds
the results to JAX and to the port's one-process paths.
"""
from __future__ import annotations

import torch


def _model(cfg, state_dict, mesh):
    from gastx_torch.models import GastNet
    from gastx_torch.parallel import replicate

    model = GastNet(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model, replicate(mesh, model)


def _step(cfg, state_dict, mesh, batch, seed):
    """One DP strided step from ``state_dict`` on this rank's rows of
    ``batch`` (x2d, x3d, w): the global loss, the parameters' gradients
    (DDP's mean), the parameters after amsgrad and every buffer."""
    from gastx_torch.parallel import shard_batch
    from gastx_torch.train import make_optimizer, train_step

    model, ddp = _model(cfg, state_dict, mesh)
    opt = make_optimizer(ddp.parameters())
    (x2d, x3d, w), _ = shard_batch(mesh, *batch)
    gen = torch.Generator().manual_seed(seed)
    loss = train_step(ddp, opt, x2d, x3d, w, 1e-3, gen, "strided",
                      mesh=mesh, weight_sum=float(batch[2].sum()))
    return {"loss": loss.numpy(),
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters()},
            "params": {n: p.detach().numpy()
                       for n, p in model.named_parameters()},
            "buffers": {n: b.numpy() for n, b in model.named_buffers()}}


def _bn_backward(mesh, x, r):
    """Global-batch BN in train mode on this rank's rows of ``x``; the
    gradient of sum(y * r) by this rank's rows, and by the BN's scale and
    bias summed over the ranks."""
    from gastx_torch.ops.batchnorm import batch_norm
    from gastx_torch.parallel import all_reduce_sum, batch_sharding

    rows = batch_sharding(mesh, x.shape[0])
    bn = torch.nn.BatchNorm2d(x.shape[-1])
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[-1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[-1]))
    xt = torch.from_numpy(x[rows]).requires_grad_(True)
    y = batch_norm(xt, bn, train=True, mesh=mesh)
    (y * torch.from_numpy(r[rows])).sum().backward()
    return {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
            "dscale": all_reduce_sum(bn.weight.grad, mesh).numpy(),
            "dbias": all_reduce_sum(bn.bias.grad, mesh).numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


def _replicated(cfg, mesh) -> float:
    """Every parameter and buffer set to this rank's index, then
    ``replicate``: the largest value left (rank 0's are zeros)."""
    from gastx_torch.models import GastNet
    from gastx_torch.parallel import replicate

    model = GastNet(cfg)
    with torch.no_grad():
        for t in (*model.parameters(), *model.buffers()):
            t.fill_(mesh.rank)
    replicate(mesh, model)
    return max(float(t.abs().max())
               for t in (*model.parameters(), *model.buffers()))


def run(rank: int, n: int, address: str, cases: dict) -> dict:
    """Every case of the parent's ``cases`` on this rank."""
    from gastx_torch.infer import lift_sequences
    from gastx_torch.parallel import init_distributed, make_mesh

    torch.set_num_threads(1)
    init_distributed(address, n, rank, device="cpu")
    mesh = make_mesh(["cpu"] * n)
    out = {name: _step(case["cfg"], case["state_dict"], mesh, case["batch"],
                       case["seed"])
           for name, case in cases["steps"].items()}
    out["bn"] = _bn_backward(mesh, *cases["bn"])
    out["replicated"] = _replicated(cases["steps"]["full"]["cfg"], mesh)
    lift = cases["lift"]
    model, _ = _model(lift["cfg"], lift["state_dict"], mesh)
    out["lift"] = lift_sequences(model.eval(), lift["sequences"], tta=True,
                                 mesh=mesh)
    return out
