"""Time ``gemm_wgrad`` at every weight gradient of the tiered train steps on
one GPU, and (``--steps``) the tiered train steps themselves.

The weight-gradient table: every distinct ``gemm_wgrad`` call of one
tiered strided train step of the 27f model at B=1024 and of the 243f
model at B=256 windows, at all ``"high"`` and at the JAX preset
(``chip_smoke.wgrad_step_calls``), each held to its plain version and
timed (CUDA events) beside its plain version, its bound (bytes: A's rows,
G and dW once; operations: 2 M K N a bf16 pass at the bf16 peak) and, at
the one-pass tier, a bf16 ``torch.matmul`` of the gathered A^T and G; with
its calls a step. ``--steps`` adds ``chip_smoke.py`` phase 9 (e): the
tiered train cells beside the float32 ones, and the tiered steps against
their plain-version steps. The one-off measurements live here so that
``chip_smoke.py`` keeps one row a tier. ``--highest-against DIR`` instead
runs one float32 (``"highest"``, the port's default) strided train step of
the 27f model at B=128, dropout 0.05, in this checkout and in another one
(e.g. a ``git archive`` of the parent under ``build/``), each in a process
of its own, and holds the two bit for bit (loss, every gradient, every
parameter after amsgrad, the BN statistics; no kernel launched in either):

    python3 scripts/torch_train_tiers.py [--steps] [--json F]
    python3 scripts/torch_train_tiers.py --highest-against DIR

Prints one JSON object (the rows, the card's name and power limit) and
writes it to ``chiprun_out/`` (``--json``, default ``train_tiers.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def wgrad_table(K, dev) -> list:
    """Every distinct gemm_wgrad call of the tiered steps, timed."""
    import torch

    import chip_smoke as cs

    rows = []
    for frames, batch in cs.WGRAD_STEPS:
        for name in cs.TRAIN_TIER_NAMES:
            calls = {}

            def keep(site, pieces, g, m, kw, out):
                ks = tuple(a.shape[1] for a, _ in pieces)
                key = (site.op, site.tier, ks, g.shape[1], m,
                       kw.get("s_out"))
                if key in calls:
                    calls[key][-1] += 1
                else:
                    # dW as it was made: autograd may add into it later
                    calls[key] = [site, pieces, g, m, kw, out.clone(), 1]

            cs.wgrad_step_calls(K, frames, batch, name, dev, keep)
            # The recorded activations require a gradient; the wrappers
            # take them under no_grad, as the backward hands them over.
            with torch.no_grad():
                rows += timed_rows(K, dev, cs, f"{frames}f B={batch} {name}",
                                   calls)
            del calls
            torch.cuda.empty_cache()
    return rows


def timed_rows(K, dev, cs, cell, calls) -> list:
    """The rows of one step's distinct calls (``wgrad_table``)."""
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for (op, tier, ks, n, m, _), (_, pieces, g, _, kw, out,
                                  count) in calls.items():
        plain = K.gemm_wgrad_plain(pieces, g, m, tier=tier, **kw)
        err = cs.max_err(out, plain)
        bound_ = cs.TOL * max(1.0, float(plain.abs().max()))
        if not err <= bound_:
            cs.fail(f"gemm_wgrad {op} {ks} x {n}: {err} > {bound_}")
        ms = cs.cuda_ms(lambda: K.gemm_wgrad(pieces, g, m, tier=tier, **kw))
        plain_ms = cs.cuda_ms(lambda: K.gemm_wgrad_plain(
            pieces, g, m, tier=tier, **kw), reps=3)
        library_ms = None
        if tier == "default":
            s_out = kw.get("s_out") or m
            a_s_in = kw.get("a_s_in") or s_out
            r = torch.arange(m, device=g.device)
            at = torch.cat([a[(r // s_out) * a_s_in + r % s_out + off]
                            for a, off in pieces],
                           dim=1).t().to(torch.bfloat16)
            gb = g.to(torch.bfloat16)
            library_ms = cs.cuda_ms(lambda: torch.matmul(at, gb))
            del at, gb
        bms, by = cs.tc_bound(2 * m * sum(ks) * n, cs.wgrad_bytes(m, ks, n),
                              cs.TC_PASSES[tier])
        splits, _ = K.wgrad_splits(
            m, sum(-(-k // K.WGRAD_TILE) for k in ks) * -(-n // K.WGRAD_TILE),
            sms)
        row = {"cell": cell, "op": op, "tier": tier, "m": m, "ks": list(ks),
               "n": n, "calls_a_step": count, "splits": splits, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
               "library_ms": library_ms, "max_abs_err": err}
        rows.append(row)
        print(f"  {cell} {op} ({tier}): M={m} K={ks} N={n} x{count}, "
              f"{splits} splits: {ms:.4f} ms (plain {plain_ms:.3f}, bound "
              f"{bms:.4f} by {by}, {bms / ms:.0%}"
              + (f"; bf16 torch.matmul {library_ms:.4f}" if library_ms
                 else "") + ")")
    return rows


def highest_step(tree: str, out: str) -> None:
    """One float32 strided train step of the 27f model (build_gastnet seed
    27, B=128, dropout 0.05, a seeded generator) with the ``gastx_torch``
    of ``tree``; its state and launch counts saved to ``out``."""
    import dataclasses

    import torch

    sys.path.insert(0, tree)
    from gastx_torch.models import build_gastnet, config_for_frames
    from gastx_torch.ops.cuda import kernels as K
    from gastx_torch.train import make_optimizer, train_step

    if not K.__file__.startswith(os.path.abspath(tree) + os.sep):
        raise SystemExit(f"imported {K.__file__}, not the tree {tree}")
    cfg = dataclasses.replace(config_for_frames(27), dropout=0.05)
    model = build_gastnet(cfg, seed=27, device="cuda")
    gen = torch.Generator().manual_seed(28)
    x2 = torch.randn((128, 27, 17, 2), generator=gen).cuda()
    x3 = (0.3 * torch.randn((128, 1, 17, 3), generator=gen)).cuda()
    K.reset_launches()
    loss = train_step(model, make_optimizer(model.parameters()), x2, x3,
                      torch.ones(128, device="cuda"), 1e-3,
                      torch.Generator(device="cuda").manual_seed(29),
                      "strided")
    state = {"loss": loss.detach().cpu()}
    for n, p in model.named_parameters():
        state[f"grad {n}"], state[f"param {n}"] = p.grad.cpu(), p.cpu()
    state.update({f"bn {n}": b.cpu() for n, b in model.named_buffers()})
    torch.save({"state": state, "launches": sum(K.LAUNCHES.values())}, out)


def highest_against(tree: str) -> int:
    """``--highest-against``: both trees' float32 steps, bit for bit."""
    import torch

    outs = []
    for i, t in enumerate((os.path.abspath(tree), REPO)):
        out = os.path.join(REPO, "build", "train_tiers",
                           f"highest_step_{i}.pt")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--dump-highest", out, "--tree", t], check=True,
                       cwd=t, timeout=600)
        outs.append(torch.load(out))
    (a, b) = outs
    differ = [n for n in a["state"]
              if not torch.equal(a["state"][n], b["state"].get(n))]
    print(f"float32 27f B=128 train step: {len(a['state'])} tensors, "
          f"{len(differ)} not bitwise equal ({differ[:5]}); kernel launches "
          f"{a['launches']} (other tree) / {b['launches']} (this one)")
    return 1 if differ or a["launches"] or b["launches"] else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", action="store_true",
                    help="also time the tiered train steps (phase 9 (e))")
    ap.add_argument("--json", default="train_tiers.json",
                    help="file name of the result under chiprun_out/")
    ap.add_argument("--highest-against", metavar="DIR",
                    help="hold this checkout's float32 step to DIR's")
    ap.add_argument("--dump-highest", metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("--tree", default=REPO, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if args.dump_highest:
        highest_step(args.tree, args.dump_highest)
        return 0
    if args.highest_against:
        return highest_against(args.highest_against)
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from gastx_torch.ops.cuda import kernels as K

    torch.backends.cudnn.allow_tf32 = False
    K.build_kernels()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    print(f"gemm_wgrad at the tiered train steps' calls on {card}")
    result = {"card": card, "wgrad": wgrad_table(K, dev)}
    if args.steps:
        f32 = {label: cs.train_cell(K, label, frames, b, dev)
               for label, frames, b in cs.TRAIN_CELLS}
        result["float32_cells"] = f32
        result["tiered"] = cs.tiered_train_phase(K, dev, f32)
    path = os.path.join(REPO, "chiprun_out", args.json)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"card": card, "rows": len(result["wgrad"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
