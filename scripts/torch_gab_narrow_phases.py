"""Time ``gab_narrow`` at the main-path shapes on one GPU, beside the
three-kernel chain and the bound, and phase by phase.

Builds a ``gab_narrow.cu`` (the checkout's, or the one ``--source`` names,
which must keep the C interface) as it is and, unless ``--no-cuts``, once
more with each phase of the checkout's design cut out; checks the whole
build against ``gab_narrow_plain``; and times every build with CUDA events
at the three narrow GABs of the shipped models:

  * C=32, T=241, B=256: the 243-frame model's level 0;
  * C=64, T=79, B=1024: the 81-frame model's level 0;
  * C=64, T=235, B=256: the 243-frame model's level 1.

A cut build computes garbage; only its time is read. The difference
between the whole kernel and a cut build is the time that phase costs,
overlap with the other phases included. Prints one JSON object (ms per
build and shape, the chain's ms, the bound, the card's name and power
limit) and writes it to ``chiprun_out/`` (``--json``, default
``gab_narrow_phases.json``).

``--tiered`` also times ``gab_narrow``'s tiered form (the checkout's
library, through ``kernels.gab_narrow(..., tiers=)``) beside the chain at
the same tiers, at the three shapes and at every width of
``kernels.NARROW_TIERED_WIDTHS`` (level 0 of a model of that many
channels), at
two sets of tiers: every class at "high" (three passes) and the JAX
preset's kernel tiers at the 243f model's GAB 1 (one pass each), with the
bound of each (``chip_smoke.narrow_bound``): the numbers
``kernels.NARROW_ROUTE_WIDTHS_TIERED`` follows.

``--tiered --tiered-cuts`` times the tiered form's builds with each
phase of its design cut out (``TIERED_CUTS``) at the 243f model's GAB 0
(v1 at "high", fold at the preset) and GAB 1 (v1 at "high").
``--tiered --tiered-variants`` times builds with one design choice
undone each (``TIERED_VARIANTS``) at GAB 0 and GAB 1, v1, "high" and the
preset.
``--tiered --tiered-parent TREE`` times it in turns with TREE's tiered
form (a checkout from before the scratch buffer, e.g. a ``git archive``
of the parent under ``build/``) at every width, form and
``chip_smoke.NARROW_TIERS`` entry, beside the tiered chain: the numbers
``kernels.NARROW_ROUTE_WIDTHS_TIERED`` and ``_FOLD_TIERED`` follow.

``--fold`` times ``gab_narrow``'s fold form (``gab_tables(..., "fold")``)
beside the fold chain and beside the v1 ``gab_narrow`` on the v1 tables
of the same GAB, at every width of ``kernels.NARROW_FOLD_WIDTHS`` (level
0 of a model of that many channels, 256 x 241 frames), in float32 and at
the two tier sets above, each held to its plain version first, with the
fold bound (``narrow_bound(..., fold=True)``): the numbers
``kernels.NARROW_ROUTE_WIDTHS_FOLD[_TIERED]`` follow.

    python3 scripts/torch_gab_narrow_phases.py [--source F.cu] [--no-cuts]
        [--widths] [--tiered [--tiered-cuts] [--tiered-variants]
        [--tiered-parent TREE]]
        [--fold] [--json F]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "gab_narrow_phases")

# Each cut of the checkout's gab_narrow.cu: (text of the phase in the
# source, what replaces it). The products are P1, P2 (the sym and con
# semantic columns), P3 (local cat), P4, P5 (theta/phi, g), P6 (global cat)
# and P7 (the block concat); a cut product still streams its weight slabs.
def _cut(tag):
    return (f"/*{tag}*/true", f"/*{tag}*/false")


PRODUCTS = ("P1", "P2", "P3", "P4", "P5", "P6")
CUTS = {
    "whole": [],
    "no products P1-P6": [_cut(p) for p in PRODUCTS],
    "no block concat P7": [_cut("P7")],
    "no semantic graph": [_cut("SEM")],
    "no attention": [_cut("ATTN")],
    "no x loads": [_cut("XLOAD")],
    "weight stream only": [_cut(t) for t in PRODUCTS + ("P7", "SEM", "ATTN",
                                                        "XLOAD")],
    # Run twice (on garbage the second time): a phase's cost apart from
    # what cutting it does to the rest of the kernel.
    "semantic graph twice": [("if (/*SEM*/true)",
                              "for (int rep_ = 0; rep_ < 2; ++rep_)")],
    "attention twice": [("if (/*ATTN*/true)",
                         "for (int rep_ = 0; rep_ < 2; ++rep_)")],
}
# --tiered --tiered-cuts: the tiered form's phases cut out, timed at the
# 243f GAB 0 (v1 at every class "high", fold at the preset) and GAB 1 (v1,
# "high"): the launch's split of the weights (the grid barrier stays),
# the slabs' copies into the ring, the products' mma passes (the slabs
# still stream), the semantic graph, the attention, its apply pass alone.
TIERED_CUTS = {
    "tiered whole": [],
    "tiered no split": [_cut("TPRE")],
    "tiered no slab copies": [_cut("TCOPY")],
    "tiered no mma": [_cut("TMMA")],
    "tiered no semantic graph": [_cut("TSEM")],
    "tiered no attention": [_cut("TATTN")],
    "tiered no apply": [_cut("TAPPLY")],
    "tiered weight stream only": [_cut(t) for t in ("TMMA", "TSEM",
                                                     "TATTN")],
}
# --tiered --tiered-variants: the tiered form's design choices undone one
# at a time, each a correct build, timed as the cuts are: one 512-thread
# block an SM on 256-row tiles at C = 32 in place of two of 256 threads on
# 128 rows; 16-row slabs (a barrier each) at C = 32 and 64 in place of
# 32-row ones.
TIERED_VARIANTS = {
    "tiered whole": [],
    "tiered one block at C=32": [
        ("using type = Cfg<32, 32, 4, 2, 32, 2>;",
         "using type = Cfg<32, 64, 4, 1, 32, 2>;")],
    "tiered 16-row slabs": [
        ("using type = Cfg<32, 32, 4, 2, 32, 2>;",
         "using type = Cfg<32, 32, 4, 2, 16, 3>;"),
        ("using type = Cfg<64, 32, 4, 1, 32, 2>;",
         "using type = Cfg<64, 32, 4, 1, 16, 3>;")],
}
# (label, model receptive field, its GAB level, windows, frames at the GAB)
SHAPES = (("C=32, T=241, B=256", 243, 0, 256, 241),
          ("C=64, T=79, B=1024", 81, 0, 1024, 79),
          ("C=64, T=235, B=256", 243, 1, 256, 235))
# --widths: every width gab_narrow is built for, on level 0 of a model of
# that many channels, at the 243-frame model's level-0 frame count.
WIDTH_FRAMES = 256 * 241


def build(K, source: str, cuts: dict, symbol: str = "gab_narrow",
          flags=(), argtypes=None, tag: str = "v") -> dict:
    src = open(source).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(cuts.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"cut {name!r}: the source no longer holds "
                                 f"{old!r}")
            text = text.replace(old, new)
        tag = "parent" if argtypes else tag
        cu = os.path.join(OUT, f"{symbol}_{tag}{i}.cu")
        lib = os.path.join(OUT, f"{symbol}_{tag}{i}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, *flags, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on build {name!r}:\n{out}")
        if name in ("whole", "tiered whole", "parent"):
            print("\n".join(line for line in out.splitlines()
                            if "registers" in line or "spill" in line
                            or "Function properties" in line))
        fn = getattr(ctypes.CDLL(lib), symbol)
        fn.argtypes = argtypes or K._ARGTYPES[symbol]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def time_widths(K, fn, cuda_ms) -> dict:
    """The whole kernel beside the chain at each of NARROW_WIDTHS (the
    numbers kernels.NARROW_ROUTE_WIDTHS follows)."""
    import torch

    out = {}
    for c in K.NARROW_WIDTHS:
        tab = _width_tables(K, c)
        _, k, inter, g_ch, j, d = K.gab_shape(tab)
        gen = torch.Generator(device="cuda").manual_seed(2)
        x = torch.randn(WIDTH_FRAMES * j, c, generator=gen, device="cuda")
        y = torch.empty(WIDTH_FRAMES * j, 2 * c, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            code = fn(x.data_ptr(), y.data_ptr(), WIDTH_FRAMES, j, c, d, k,
                      inter, g_ch, *K.narrow_table_ptrs(tab), stream, 0, 0,
                      0)
            if code != 0:
                raise SystemExit(f"launch failed at C={c} ({code})")

        call()
        plain = K.gab_narrow_plain(x, tab)
        err = float((y - plain).abs().max())
        if not err <= 1e-4 * max(1.0, float(plain.abs().max())):
            raise SystemExit(f"C={c}: gab_narrow disagrees with its plain "
                             f"version: {err}")
        del plain
        ms = cuda_ms(call)
        chain_ms = cuda_ms(lambda: K.gab_chain(
            x, tab, K.gemm_epilogue, K.sem_graph, K.joint_attention))
        out[f"C={c}"] = {"ms": ms, "chain_ms": chain_ms, "max_abs_err": err}
        print(f"C={c}, {WIDTH_FRAMES} frames: {ms:.3f} ms, chain "
              f"{chain_ms:.3f} ms, max|d| {err:.3e}", flush=True)
        del x, y
        torch.cuda.empty_cache()
    return out


# --tiered: the tier sets (chip_smoke.narrow_tier_dict's names).
TIER_SETS = ("high", "preset")


def _width_tables(K, c, form="v1"):
    """The GAB tables of level 0 of a 2-level model of ``c`` channels."""
    import torch
    from gastx_torch.models import (GastNet, GastNetConfig, init_gastnet,
                                    randomize_eval_statistics)
    from gastx_torch.ops.cuda.fused_gab import gab_tables

    gen = torch.Generator().manual_seed(c)
    m = GastNet(GastNetConfig(filter_widths=(3, 3), channels=c))
    m = randomize_eval_statistics(init_gastnet(m, gen), gen).cuda().eval()
    return gab_tables(m.layers_graph_conv[0], m.statics, form)


def time_fold(K) -> dict:
    """The fold gab_narrow beside the fold chain and the v1 gab_narrow at
    every width of NARROW_FOLD_WIDTHS, in float32 and at ``TIER_SETS``,
    each held to its plain version first (the float32 bound; at the tiers
    ``chip_smoke.tier_bound``)."""
    import torch
    from chip_smoke import (bound, cuda_ms, gab_work, max_err, narrow_bound,
                            narrow_tier_dict, tier_bound)

    out = {}
    for c in K.NARROW_FOLD_WIDTHS:
        tab, v1 = _width_tables(K, c, "fold"), _width_tables(K, c)
        _, k, inter, g_ch, j, d = K.gab_shape(tab)
        gen = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randn(WIDTH_FRAMES * j, c, generator=gen, device="cuda")
        f32 = K.gab_narrow_plain(x, tab)
        for name in (None,) + TIER_SETS:
            tiers = None if name is None else narrow_tier_dict(name)
            got = K.gab_narrow(x, tab, tiers=tiers)
            plain = f32 if tiers is None else K.gab_narrow_plain(
                x, tab, tiers=tiers)
            bound_ = tier_bound(plain, f32)[0]
            err = max_err(got, plain)
            label = f"C={c} {name or 'float32'}"
            if not err <= bound_:
                raise SystemExit(f"fold {label}: gab_narrow disagrees with "
                                 f"its plain version: {err} > {bound_}")
            del got, plain
            ms = cuda_ms(lambda: K.gab_narrow(x, tab, tiers=tiers))
            chain_ms = cuda_ms(lambda: K.gab_chain(
                x, tab, K.gemm_epilogue, K.sem_graph, K.joint_attention,
                tiers))
            v1_ms = (cuda_ms(lambda: K.gab_narrow(x, v1, tiers=tiers))
                     if tiers is None or c in K.NARROW_TIERED_WIDTHS
                     else None)
            if tiers is None:
                bms, by = bound(*gab_work(x.shape[0], c, j, k, inter, g_ch,
                                          d))
            else:
                bms, by = narrow_bound(x.shape[0], c, j, k, inter, g_ch, d,
                                       tiers, fold=True)
            out[label] = {"ms": ms, "chain_ms": chain_ms,
                          "v1_gab_narrow_ms": v1_ms, "bound_ms": bms,
                          "bound_by": by, "max_abs_err": err,
                          "route": K.gab_route(*K.gab_shape(tab), tiers,
                                               "fold")}
            print(f"fold {label}: {ms:.3f} ms, fold chain {chain_ms:.3f} "
                  f"ms, v1 gab_narrow "
                  f"{'-' if v1_ms is None else f'{v1_ms:.3f}'} ms, bound "
                  f"{bms:.3f} ms by {by}, max|d| {err:.3e}; routed to "
                  f"{out[label]['route']}", flush=True)
        del x, f32
        torch.cuda.empty_cache()
    return out


def time_tiered(K, cases) -> dict:
    """The tiered gab_narrow beside the tiered chain, (label, tables,
    frames) each, at every ``TIER_SETS`` entry, held to its plain version
    by ``chip_smoke.tier_bound`` first."""
    import torch
    from chip_smoke import (cuda_ms, max_err, narrow_bound,
                            narrow_tier_dict, tier_bound)

    out = {}
    for label, tab, frames in cases:
        c, k, inter, g_ch, j, d = K.gab_shape(tab)
        gen = torch.Generator(device="cuda").manual_seed(3)
        x = torch.randn(frames * j, c, generator=gen, device="cuda")
        f32_ms = cuda_ms(lambda: K.gab_narrow(x, tab))
        for name in TIER_SETS:
            tiers = narrow_tier_dict(name)
            got = K.gab_narrow(x, tab, tiers=tiers)
            plain = K.gab_narrow_plain(x, tab, tiers=tiers)
            bound_, _ = tier_bound(plain, K.gab_narrow_plain(x, tab))
            err = max_err(got, plain)
            if not err <= bound_:
                raise SystemExit(f"{label} {name}: the tiered gab_narrow "
                                 f"disagrees with its plain version: {err} "
                                 f"> {bound_}")
            del got, plain
            ms = cuda_ms(lambda: K.gab_narrow(x, tab, tiers=tiers))
            chain_ms = cuda_ms(lambda: K.gab_chain(
                x, tab, K.gemm_epilogue, K.sem_graph, K.joint_attention,
                tiers))
            bms, by = narrow_bound(frames * j, c, j, k, inter, g_ch, d,
                                   tiers)
            out[f"{label} {name}"] = {
                "ms": ms, "chain_ms": chain_ms, "bound_ms": bms,
                "bound_by": by, "float32_ms": f32_ms, "max_abs_err": err}
            print(f"tiered {label} {name}: {ms:.3f} ms, chain {chain_ms:.3f}"
                  f" ms, bound {bms:.3f} ms by {by} (float32 gab_narrow "
                  f"{f32_ms:.3f}), max|d| {err:.3e}", flush=True)
        del x
        torch.cuda.empty_cache()
    return out


def _tiered_call(K, fn, x, out, tab, tiers, fold, scratch=True):
    """A call of a tiered C function ``fn`` on x into out at ``tiers``,
    with the scratch buffer (this checkout's signature) or without (the
    parent's, from before the scratch buffer)."""
    c, k, inter, g_ch, j, d = K.gab_shape(tab)
    stream = torch_stream()
    extra = []
    if scratch:
        buf = K.narrow_scratch(x.device, stream)
        extra = [buf.data_ptr(), buf.numel()]
    args = [x.data_ptr(), out.data_ptr(), x.shape[0] // j, j, c, d, k, inter,
            g_ch, *K.narrow_table_ptrs(tab), stream, 0, 0, int(fold),
            *K.narrow_tier_codes(tiers), *extra]

    def call():
        code = fn(*args)
        if code != 0:
            raise SystemExit(f"tiered launch failed ({code})")
    return call


def torch_stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


def time_tiered_cuts(K, fns, cases) -> dict:
    """Each ``TIERED_CUTS`` build of the tiered form at each (label, tables,
    frames, tier set) of ``cases`` (a cut build computes garbage; only its
    time is read)."""
    import torch
    from chip_smoke import cuda_ms, narrow_tier_dict

    result = {}
    for label, tab, frames, tier in cases:
        c = tab.w_proj.shape[0]
        j = tab.c_k.shape[1]
        gen = torch.Generator(device="cuda").manual_seed(4)
        x = torch.randn(frames * j, c, generator=gen, device="cuda")
        out = torch.empty(frames * j, 2 * c, device="cuda")
        key = f"{label} {tab.form} {tier}"
        result[key] = {}
        for name, fn in fns.items():
            result[key][name] = cuda_ms(_tiered_call(
                K, fn, x, out, tab, narrow_tier_dict(tier),
                tab.form == "fold"))
            print(f"{key} {name}: {result[key][name]:.3f} ms", flush=True)
        del x, out
        torch.cuda.empty_cache()
    return result


def time_tiered_turns(K, parent) -> dict:
    """The tiered gab_narrow against the parent tree's (``parent``: its C
    function, without the scratch arguments) in turns (parent, change,
    change, parent) at every width of ``NARROW_TIERED_WIDTHS``, both
    forms, every ``chip_smoke.NARROW_TIERS`` entry, 256 x 241 frames,
    beside the tiered (fold) chain and the bound; each kernel held to its
    plain version first (``chip_smoke.tier_bound``), the change's
    scratch to ``kernels.narrow_split_plain`` bit for bit, and the two
    outputs compared bit for bit."""
    import torch
    from chip_smoke import (NARROW_TIERS, cuda_ms, max_err, narrow_bound,
                            narrow_tier_dict, tier_bound)

    out = {}
    for c in K.NARROW_TIERED_WIDTHS:
        for form in ("v1", "fold"):
            tab = _width_tables(K, c, form)
            _, k, inter, g_ch, j, d = K.gab_shape(tab)
            gen = torch.Generator(device="cuda").manual_seed(6)
            x = torch.randn(WIDTH_FRAMES * j, c, generator=gen, device="cuda")
            y = torch.empty(WIDTH_FRAMES * j, 2 * c, device="cuda")
            f32 = K.gab_narrow_plain(x, tab)
            fold = form == "fold"
            for name in NARROW_TIERS:
                tiers = narrow_tier_dict(name)
                label = f"C={c} {form} {name}"
                plain = K.gab_narrow_plain(x, tab, tiers=tiers)
                bound_ = tier_bound(plain, f32)[0]
                old = _tiered_call(K, parent, x, y, tab, tiers, fold,
                                   scratch=False)
                old()
                err_old = max_err(y, plain)
                got = K.gab_narrow(x, tab, tiers=tiers)
                err = max_err(got, plain)
                same = bool(torch.equal(got, y))
                if not (err <= bound_ and err_old <= bound_):
                    raise SystemExit(f"{label}: disagrees with its plain "
                                     f"version: {err} (parent {err_old}) > "
                                     f"{bound_}")
                off, words = K.narrow_split_plain(tab)
                buf = K.narrow_scratch(x.device, torch_stream())
                if not (torch.equal(buf[K.NARROW_SCRATCH_CTL + off], words)
                        and int(buf[:2].abs().sum()) == 0):
                    raise SystemExit(f"{label}: the scratch does not hold "
                                     f"narrow_split_plain's words")
                del got, plain
                new = lambda: K.gab_narrow(x, tab, tiers=tiers)  # noqa
                turns = [cuda_ms(old), cuda_ms(new), cuda_ms(new),
                         cuda_ms(old)]
                chain_ms = cuda_ms(lambda: K.gab_chain(
                    x, tab, K.gemm_epilogue, K.sem_graph, K.joint_attention,
                    tiers))
                bms, by = narrow_bound(x.shape[0], c, j, k, inter, g_ch, d,
                                       tiers, fold=fold)
                out[label] = {"ms": turns[1:3], "parent_ms": turns[::3],
                              "chain_ms": chain_ms, "bound_ms": bms,
                              "bound_by": by, "max_abs_err": err,
                              "parent_max_abs_err": err_old,
                              "bitwise_parent": same}
                print(f"tiered {label}: {turns[1]:.3f} / {turns[2]:.3f} ms, "
                      f"parent {turns[0]:.3f} / {turns[3]:.3f}, chain "
                      f"{chain_ms:.3f}, bound {bms:.3f} by {by}, max|d| "
                      f"{err:.3e} (parent {err_old:.3e}; bitwise the "
                      f"parent's: {same})", flush=True)
            del x, y, f32
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=os.path.join(
        REPO, "gastx_torch", "csrc", "gab_narrow.cu"))
    ap.add_argument("--no-cuts", action="store_true",
                    help="time the whole kernel alone (for a source of "
                         "another design)")
    ap.add_argument("--widths", action="store_true",
                    help="also time the whole kernel and the chain at "
                         "every width of kernels.NARROW_WIDTHS")
    ap.add_argument("--tiered", action="store_true",
                    help="also time the tiered form beside the tiered "
                         "chain at the shapes and every width")
    ap.add_argument("--tiered-cuts", action="store_true",
                    help="with --tiered, also time the tiered form with "
                         "each of its phases cut out (TIERED_CUTS)")
    ap.add_argument("--tiered-variants", action="store_true",
                    help="with --tiered, also time the tiered form's "
                         "design variants (TIERED_VARIANTS)")
    ap.add_argument("--tiered-parent", default=None, metavar="TREE",
                    help="with --tiered, time the tiered form in turns "
                         "with TREE's (a checkout before the scratch "
                         "argument) at every width, form and tier set")
    ap.add_argument("--fold", action="store_true",
                    help="also time the fold form beside the fold chain "
                         "at every width of kernels.NARROW_FOLD_WIDTHS")
    ap.add_argument("--json", default="gab_narrow_phases.json",
                    help="file name of the result under chiprun_out/")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import bound, cuda_ms, gab_work
    from gastx_torch.models import (GastNet, config_for_frames,
                                    init_gastnet, randomize_eval_statistics)
    from gastx_torch.ops.cuda import kernels as K
    from gastx_torch.ops.cuda.fused_gab import gab_tables

    K.build_kernels()
    fns = build(K, args.source,
                {"whole": []} if args.no_cuts else CUTS)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    result = {"card": card, "source": os.path.relpath(args.source, REPO),
              "ms": {}, "chain_ms": {}, "bound_ms": {}, "max_abs_err": {}}
    models = {}
    for label, frames, level, b, t in SHAPES:
        if frames not in models:
            gen = torch.Generator().manual_seed(frames)
            m = randomize_eval_statistics(
                init_gastnet(GastNet(config_for_frames(frames)), gen), gen)
            models[frames] = m.cuda().eval()
        m = models[frames]
        tab = gab_tables(m.layers_graph_conv[level], m.statics)
        c, k, inter, g_ch, j, d = K.gab_shape(tab)
        gen = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(b * t * j, c, generator=gen, device="cuda")
        out = torch.empty(b * t * j, 2 * c, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn):
            code = fn(x.data_ptr(), out.data_ptr(), b * t, j, c, d, k,
                      inter, g_ch, *K.narrow_table_ptrs(tab), stream, 0, 0,
                      0)
            if code != 0:
                raise SystemExit(f"launch failed ({code})")

        call(fns["whole"])
        plain = K.gab_narrow_plain(x, tab)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        tol = 1e-4 * max(1.0, float(plain.abs().max()))
        del plain
        if not err <= tol:
            raise SystemExit(f"{label}: gab_narrow disagrees with its plain "
                             f"version: {err} > {tol}")
        result["max_abs_err"][label] = err
        result["ms"][label] = {}
        for name, fn in fns.items():
            result["ms"][label][name] = cuda_ms(lambda fn=fn: call(fn))
            print(f"{label} {name}: {result['ms'][label][name]:.3f} ms",
                  flush=True)
        result["chain_ms"][label] = cuda_ms(lambda: K.gab_chain(
            x, tab, K.gemm_epilogue, K.sem_graph, K.joint_attention))
        result["bound_ms"][label] = bound(
            *gab_work(x.shape[0], c, j, k, inter, g_ch, d))[0]
        print(f"{label}: chain {result['chain_ms'][label]:.3f} ms, bound "
              f"{result['bound_ms'][label]:.3f} ms, max|d| {err:.3e}",
              flush=True)
        del x, out
        torch.cuda.empty_cache()
    if args.widths:
        result["widths"] = time_widths(K, fns["whole"], cuda_ms)
    if args.tiered:
        cases = [(label, gab_tables(models[frames].layers_graph_conv[level],
                                    models[frames].statics), b * t)
                 for label, frames, level, b, t in SHAPES]
        if args.tiered_cuts:
            c32, c64 = cases[0], cases[2]
            result["tiered_cuts"] = time_tiered_cuts(
                K, build(K, args.source, TIERED_CUTS, "gab_narrow_tiered",
                         K.TIERED_FLAGS),
                [(*c32, "high"), (c32[0], gab_tables(
                    models[243].layers_graph_conv[0], models[243].statics,
                    "fold"), c32[2], "preset"), (*c64, "high")])
        if args.tiered_variants:
            c32, c64 = cases[0], cases[2]
            result["tiered_variants"] = time_tiered_cuts(
                K, build(K, args.source, TIERED_VARIANTS, "gab_narrow_tiered",
                         K.TIERED_FLAGS, tag="variant"),
                [(*c32, "high"), (*c32, "preset"), (*c64, "high"),
                 (*c64, "preset")])
        if args.tiered_parent:
            parent = build(K, os.path.join(
                args.tiered_parent, "gastx_torch", "csrc", "gab_narrow.cu"),
                {"parent": []}, "gab_narrow_tiered", K.TIERED_FLAGS,
                argtypes=K._ARGTYPES["gab_narrow_tiered"][:-2])["parent"]
            result["tiered_turns"] = time_tiered_turns(K, parent)
        cases += [(f"C={c}", _width_tables(K, c), WIDTH_FRAMES)
                  for c in K.NARROW_TIERED_WIDTHS]
        result["tiered"] = time_tiered(K, cases)
    if args.fold:
        result["fold"] = time_fold(K)
    path = os.path.join(REPO, "chiprun_out", args.json)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
