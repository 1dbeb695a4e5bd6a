"""Time ``gemm_wgrad`` at every weight gradient of the tiered train steps on
one GPU, and (``--steps``) the tiered train steps themselves.

The weight-gradient table: every distinct ``gemm_wgrad`` call of one
tiered strided train step of the 27f model at B=1024 and of the 243f
model at B=256 windows, at all ``"high"`` and at the JAX preset
(``chip_smoke.wgrad_step_calls``), each held to its plain version and
timed (CUDA events) beside its plain version, its bound (bytes: A's rows,
G and dW once; operations: 2 M K N a bf16 pass at the bf16 peak) and, at
the one-pass tier, a bf16 ``torch.matmul`` of the gathered A^T and G (and
that call with the two casts from float32); with its calls a step and its
instantiation (``kernels.wgrad_route``). ``--parent DIR`` also times each
call on the ``gemm_wgrad`` of another checkout (e.g. a ``git archive`` of
the parent under ``build/``, built from its own source and called through
its own wrapper) in turns, parent / this / this / parent, and with
``--steps`` times the tiered train cells (``chip_smoke.TRAIN_CELLS`` at
all ``high`` and the preset) with this checkout's and the other's
``gemm_wgrad`` in the same turns: ms a step, and the weight gradients'
device ms in one profiled step. ``--steps`` alone adds ``chip_smoke.py``
phase 9 (e): the tiered train cells beside the float32 ones, and the
tiered steps against their plain-version steps. The build's ``-Xptxas -v``
lines (registers, shared memory, spills) are printed for each
``gemm_wgrad`` instantiation. The one-off measurements live here so that
``chip_smoke.py`` keeps five rows. ``--highest-against DIR`` instead
runs one float32 (``"highest"``, the port's default) strided train step of
the 27f model at B=128, dropout 0.05, in this checkout and in another one
(e.g. a ``git archive`` of the parent under ``build/``), each in a process
of its own, and holds the two bit for bit (loss, every gradient, every
parameter after amsgrad, the BN statistics; no kernel launched in either):

    python3 scripts/torch_train_tiers.py [--steps] [--parent DIR] [--json F]
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


def wgrad_table(K, dev, parent=None) -> list:
    """Every distinct gemm_wgrad call of the tiered steps, timed (beside
    ``parent``'s kernels module, where given)."""
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
                                   calls, parent)
            del calls
            torch.cuda.empty_cache()
    return rows


def timed_rows(K, dev, cs, cell, calls, parent=None) -> list:
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

        def new():
            return K.gemm_wgrad(pieces, g, m, tier=tier, **kw)

        parent_ms = None
        if parent is not None:
            def old():
                return parent.gemm_wgrad(pieces, g, m, tier=tier, **kw)

            err_parent = cs.max_err(old(), plain)
            if not err_parent <= bound_:
                cs.fail(f"the parent's gemm_wgrad {op} {ks} x {n}: "
                        f"{err_parent} > {bound_}")
            turns = [cs.cuda_ms(f) for f in (old, new, new, old)]
            ms = (turns[1] + turns[2]) / 2
            parent_ms = (turns[0] + turns[3]) / 2
        else:
            ms = cs.cuda_ms(new)
        plain_ms = cs.cuda_ms(lambda: K.gemm_wgrad_plain(
            pieces, g, m, tier=tier, **kw), reps=3)
        library_ms = library_f32_ms = None
        if tier == "default":
            s_out = kw.get("s_out") or m
            a_s_in = kw.get("a_s_in") or s_out
            r = torch.arange(m, device=g.device)
            a32 = torch.cat([a[(r // s_out) * a_s_in + r % s_out + off]
                             for a, off in pieces], dim=1)
            at = a32.t().to(torch.bfloat16)
            gb = g.to(torch.bfloat16)
            library_ms = cs.cuda_ms(lambda: torch.matmul(at, gb))
            library_f32_ms = cs.cuda_ms(lambda: torch.matmul(
                a32.t().to(torch.bfloat16), g.to(torch.bfloat16)))
            del at, gb, a32
        bms, by = cs.tc_bound(2 * m * sum(ks) * n, cs.wgrad_bytes(m, ks, n),
                              cs.TC_PASSES[tier])
        variant = K.wgrad_route(pieces, g, kw.get("s_out"),
                                kw.get("a_s_in"))
        tiles, _ = K.wgrad_tiles(ks, n, variant)
        splits, _ = K.wgrad_splits(m, tiles, sms, variant)
        row = {"cell": cell, "op": op, "tier": tier, "m": m, "ks": list(ks),
               "n": n, "s_out": kw.get("s_out"), "calls_a_step": count,
               "variant": variant, "tiles": tiles, "splits": splits,
               "ms": ms, "parent_ms": parent_ms, "plain_ms": plain_ms,
               "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
               "library_f32_ms": library_f32_ms, "max_abs_err": err}
        rows.append(row)
        print(f"  {cell} {op} ({tier}): M={m} K={ks} N={n} x{count}, "
              f"{variant}, {tiles} tiles x {splits} splits: {ms:.4f} ms"
              + (f" (parent {parent_ms:.4f}, {parent_ms / ms:.2f}x)"
                 if parent_ms else "")
              + f" (plain {plain_ms:.3f}, bound {bms:.4f} by {by}, "
              f"{bms / ms:.0%}"
              + (f"; bf16 torch.matmul {library_ms:.4f}, with the casts "
                 f"{library_f32_ms:.4f}" if library_ms else "") + ")")
    return rows


def parent_kernels(tree: str):
    """The ``gastx_torch.ops.cuda.kernels`` module of checkout ``tree``
    (its own csrc/ and build/ directories), imported under another name
    with only its gemm_wgrad library built; its other modules are this
    checkout's."""
    import importlib.util

    path = os.path.join(os.path.abspath(tree), "gastx_torch", "ops", "cuda",
                        "kernels.py")
    spec = importlib.util.spec_from_file_location("parent_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._libraries = lambda: {"gemm_wgrad": ("gemm_wgrad", ())}
    mod.build_kernels()
    return mod


def step_turns(K, parent, dev) -> dict:
    """The tiered train cells with this checkout's gemm_wgrad and the
    parent's in turns (parent, this, this, parent): ms a step over
    TIER_TRAIN_STEPS after TRAIN_WARMUP (CUDA events), and the weight
    gradients' kernels' device ms in one profiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from gastx_torch.models import build_gastnet
    from gastx_torch.train import make_optimizer, train_step

    ours = K.gemm_wgrad
    out = {}
    for label, frames, b in cs.TRAIN_CELLS:
        for name in cs.TRAIN_TIER_NAMES:
            model = build_gastnet(cs.train_tier_cfg(frames, name),
                                  seed=frames, device=dev)
            opt = make_optimizer(model.parameters())
            gen = torch.Generator(device=dev).manual_seed(frames + b)
            x2, x3, w = cs.train_batch(frames, b, frames + b, dev)

            def step():
                return train_step(model, opt, x2, x3, w, cs.TRAIN_LR, gen,
                                  "strided")

            turns = []
            for side in ("parent", "this", "this", "parent"):
                K.gemm_wgrad = parent.gemm_wgrad if side == "parent" else ours
                try:
                    for _ in range(cs.TRAIN_WARMUP):
                        step()
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(cs.TIER_TRAIN_STEPS):
                        step()
                    end.record()
                    torch.cuda.synchronize()
                    ms = start.elapsed_time(end) / cs.TIER_TRAIN_STEPS
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        step()
                        torch.cuda.synchronize()
                finally:
                    K.gemm_wgrad = ours
                wgrad_ms = sum(
                    e.device_time_total for e in prof.key_averages()
                    if "wgrad" in e.key or "sum_slices" in e.key) / 1e3
                busy_ms = sum(e.self_device_time_total
                              for e in prof.key_averages()) / 1e3
                turns.append({"side": side, "ms": ms, "wgrad_device_ms":
                              wgrad_ms, "busy_ms": busy_ms})
            cell = f"{label} {name}"
            mean = {side: {k: sum(t[k] for t in turns if t["side"] == side)
                           / 2 for k in ("ms", "wgrad_device_ms",
                                         "busy_ms")}
                    for side in ("parent", "this")}
            out[cell] = {"turns": turns, **mean}
            print(f"  {cell}: ms a step parent {mean['parent']['ms']:.3f} / "
                  f"this {mean['this']['ms']:.3f}; gemm_wgrad device ms "
                  f"{mean['parent']['wgrad_device_ms']:.3f} / "
                  f"{mean['this']['wgrad_device_ms']:.3f}; busy ms "
                  f"{mean['parent']['busy_ms']:.3f} / "
                  f"{mean['this']['busy_ms']:.3f}; turns "
                  f"{[round(t['ms'], 3) for t in turns]}")
            del model, opt
            torch.cuda.empty_cache()
    return out


def ptxas_lines(log: str) -> dict:
    """``-Xptxas -v``'s registers, shared memory and spills of each kernel
    of the gemm_wgrad library, by a readable name."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            kind = next((k for k in ("hopper", "smallk", "general",
                                     "sum_slices_warp", "sum_slices")
                         if k in mangled), mangled)
            kind = {"hopper": "wgmma"}.get(kind, kind)
            targs = re.findall(r"ILi(\d+)ELi(\d+)E|ILi(\d+)E", mangled)
            name = kind + ("" if not targs else " <" + ", ".join(
                x for x in targs[0] if x) + ">")
            out[name] = []
        elif name and ("registers" in line or "spill" in line):
            out[name].append(line.split(":", 1)[-1].strip())
    return out


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
    ap.add_argument("--parent", metavar="DIR",
                    help="time another checkout's gemm_wgrad in turns")
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
    logs = K.build_kernels()
    ptxas = ptxas_lines(logs.get("gemm_wgrad", ""))
    for name, lines in ptxas.items():
        print(f"  ptxas {name}: {'; '.join(lines)}")
    parent = parent_kernels(args.parent) if args.parent else None
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    print(f"gemm_wgrad at the tiered train steps' calls on {card}")
    result = {"card": card, "ptxas": ptxas, "wgrad": wgrad_table(K, dev,
                                                                  parent)}
    if args.steps and parent is not None:
        result["step_turns"] = step_turns(K, parent, dev)
    elif args.steps:
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
