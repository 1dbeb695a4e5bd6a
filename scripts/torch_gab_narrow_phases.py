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

    python3 scripts/torch_gab_narrow_phases.py [--source F.cu] [--no-cuts]
        [--widths] [--json F]
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
# (label, model receptive field, its GAB level, windows, frames at the GAB)
SHAPES = (("C=32, T=241, B=256", 243, 0, 256, 241),
          ("C=64, T=79, B=1024", 81, 0, 1024, 79),
          ("C=64, T=235, B=256", 243, 1, 256, 235))
# --widths: every width gab_narrow is built for, on level 0 of a model of
# that many channels, at the 243-frame model's level-0 frame count.
WIDTH_FRAMES = 256 * 241


def build(K, source: str, cuts: dict) -> dict:
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
        cu, lib = os.path.join(OUT, f"v{i}.cu"), os.path.join(OUT, f"v{i}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on build {name!r}:\n{out}")
        if name == "whole":
            print("\n".join(line for line in out.splitlines()
                            if "registers" in line or "spill" in line
                            or "Function properties" in line))
        fn = ctypes.CDLL(lib).gab_narrow
        fn.argtypes = K._ARGTYPES["gab_narrow"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def time_widths(K, fn, cuda_ms) -> dict:
    """The whole kernel beside the chain at each of NARROW_WIDTHS (the
    numbers kernels.NARROW_ROUTE_WIDTHS follows)."""
    import torch
    from gastx_torch.models import (GastNet, GastNetConfig, init_gastnet,
                                    randomize_eval_statistics)
    from gastx_torch.ops.cuda.fused_gab import gab_tables

    out = {}
    for c in K.NARROW_WIDTHS:
        gen = torch.Generator().manual_seed(c)
        m = GastNet(GastNetConfig(filter_widths=(3, 3), channels=c))
        m = randomize_eval_statistics(init_gastnet(m, gen), gen).cuda().eval()
        tab = gab_tables(m.layers_graph_conv[0], m.statics)
        _, k, inter, g_ch, j, d = K.gab_shape(tab)
        gen = torch.Generator(device="cuda").manual_seed(2)
        x = torch.randn(WIDTH_FRAMES * j, c, generator=gen, device="cuda")
        y = torch.empty(WIDTH_FRAMES * j, 2 * c, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            code = fn(x.data_ptr(), y.data_ptr(), WIDTH_FRAMES, j, c, d, k,
                      inter, g_ch, *(v.data_ptr() for v in tab), stream)
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
                      inter, g_ch, *(v.data_ptr() for v in tab), stream)
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
    path = os.path.join(REPO, "chiprun_out", args.json)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
