"""Time ``gemm_tc`` at every tier on its main-path shapes on one GPU, beside
its bound and two PyTorch calls.

For the ``gastx_torch`` of this checkout or, with ``--tree``, of another
one (e.g. a ``git archive`` of the parent commit under ``build/``, whose
``gemm_epilogue`` wrapper takes the same ``tier`` argument), so that two
versions of the kernel can be compared in one call, in turns:

    python3 scripts/torch_gemm_tc.py [--tree DIR] [--check] [--bf16]
        [--no-f32] [--cuts] [--smallk] [--json F]

Builds only ``gemm_tc``, the float32 ``gemm_epilogue`` and, where the tree
has it, ``gemm_smallk`` of that tree and
prints the compiler's registers, shared memory and spills of each
``gemm_tc`` instantiation. At each ``chip_smoke.TIER_GEMM_CASES`` shape
and tier: ms (CUDA events over 20 calls after 2, the wrapper's W split
included), the plain version's ms (3 calls), the bound
(``chip_smoke.tc_bound``), TFLOP/s, the instantiation that launched and
how A reaches shared memory (``chip_smoke.tc_a_route``);
at each shape once: a bf16 ``torch.matmul`` (bf16 out) and
``torch.addmm(shift, a16, w16, out_dtype=torch.float32)`` (one cuBLAS call
with bf16 operands, float32 output and the bias; null where the card
refuses it), the yardsticks only. ``--check`` first holds every tier on
``chip_smoke.tc_edge_cases`` and ``gemm_ragged_cases`` and the timed
shapes to ``gemm_epilogue_plain`` (``chip_smoke.check``).

``--bf16`` adds the bf16-I/O rows (the ``gemm_tc`` rows of
``chip_smoke.BF16_KERNEL_ROWS``: the 27f level-0 block
concat, bf16 x to bf16, at B=1024; the 243f GAB-0 block concat, N = 64,
at B=256; the 81f GAB-0 one, N = 128, at B=1024; the 27f level-0
projection, bf16 x to float32, at B=1024) at every tier beside
``chip_smoke.tc_bf16_bound`` and a bf16 ``torch.matmul``; with
``--check`` it first holds every tier on ``chip_smoke.BF16_GEMM_CASES``
(B=256), ``BF16_TC_RAGGED`` and the timed shapes (``chip_smoke.check_out``),
each on the instantiation the tree's ``tc_variant`` picks. ``--no-f32``
leaves out the float32 rows.

``--smallk`` adds the level-0 expand conv of each shipped model at
``"highest"`` and every tier (``chip_smoke.expand_table``: the device time
of the kernel that computes it, ``gemm_smallk`` or, in a tree without it,
the general ``gemm_epilogue`` / ``gemm_tc``, beside the bound, a float32
``torch.addmm`` and a bf16 ``torch.matmul``), and, where the tree has
``gemm_smallk.cu``, its variants (``SMALLK_CUTS``: plain ``st.global``
stores in place of evict-first ones, the stores or A's loads cut out, 2
or 8 rows a thread an iteration, the bf16 rounding in integer
instructions) timed in turns beside ``fill_`` of an output of the same
size.

It then times the 27f forwards at B=256 (``STORE_AB``: "highest", "high"
and the preset) on the evict-first and the plain-store builds in turns,
with the device time of ``gemm_smallk`` and of the first GEMM after it,
the first reader of its output (``store_forwards``); ``--stores`` runs
only that.

``--cuts`` then rebuilds this checkout's ``gemm_tc.cu`` once with each
part of its ``wgmma`` kernel cut out (``CUTS``: the epilogue stores, the
wgmmas, A's or W's loads) and times every build at the 27f level-1
projection at each tier; a cut build computes garbage, only its time is
read, and the difference from the whole kernel is what that part costs,
overlap included.

Prints one JSON object (rows, checks, cuts, the card's name and power
limit, the tree) and writes it to ``chiprun_out/`` (``--json``, default
``gemm_tc.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT_DIR = os.path.join(REPO, "build", "gemm_tc_cuts")

# The float32 library's store (the cuts build that library).
_STORE = ("if (issuer) tma_store(&map_out, box, col0 + 32 * b, "
          "row0 + 64 * wg);")
_WGMMA = '"wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"'
_A_TMA = "tma_load(slab, ma, full, k0, row0 + pick(args.a_off, p));"
_W_TMA = ("tma_load(slab + A_BYTES, &map_wh, full, kb * BK, col0);",
          "tma_load(slab + A_BYTES + W_BYTES, &map_wl, full, kb * BK, col0);")
_TX = "w_bytes + a_bytes"
_WAIT1 = '"wgmma.wait_group.sync.aligned 1;\\n"'
# Each cut of the wgmma kernel: (text in gemm_tc.cu, what replaces it). A
# cut store still stages its box in shared memory; a cut wgmma is a PTX
# comment.
CUTS = {
    "whole": [],
    "no output stores": [(_STORE, ";")],
    "no wgmma": [(_WGMMA, '"// cut: wgmma {"')],
    "loads only": [(_STORE, ";"), (_WGMMA, '"// cut: wgmma {"')],
    "no A loads": [(_A_TMA, ";"), (_TX, "w_bytes")],
    "no W loads": [(_W_TMA[0], ";"), (_W_TMA[1], ";"),
                   (_TX, "a_bytes")],
    # Not a cut: one wgmma group in flight instead of two (each slab's
    # split then waits for the slab before).
    "one wgmma group in flight": [(_WAIT1, _WAIT1.replace("1;", "0;"))],
}


def bf16_operands(K, cs, torch, dev, case, windows, seed):
    """One ``chip_smoke.BF16_GEMM_CASES`` entry's operands at ``windows``,
    its output dtype in the keyword arguments."""
    label, spec_i, cast, res_bf16, out_bf16 = case
    pieces, m, kw = cs.bf16_gemm_case(K, dev, spec_i, cast, res_bf16,
                                      windows, seed)
    kw["out_dtype"] = torch.bfloat16 if out_bf16 else torch.float32
    return f"{label} (B={windows})", pieces, m, kw


def bf16_checks(K, cs, torch, dev) -> tuple:
    """Every tier on the bf16 cases, each on the instantiation the tree's
    ``tc_variant`` picks: ({case: max |d|}, [failed cases])."""
    checks, failed = {}, []
    cases = [bf16_operands(K, cs, torch, dev, case, 256, 400 + i)
             for i, case in enumerate(cs.BF16_GEMM_CASES)]
    cases += cs.bf16_ragged_cases(
        dev, torch.Generator(device=dev).manual_seed(410))
    for tier in cs.TC_PASSES:
        for label, pieces, m, kw in cases:
            kt = {**kw, "tier": tier}
            want = K.tc_variant(pieces, pieces[0][1].shape[1], kw["res"],
                                kw["out_dtype"])
            taken, got = cs.launched_variant(
                K, "gemm_tc", lambda: K.gemm_epilogue(pieces, m, **kt))
            try:
                if taken != want:
                    cs.fail(f"gemm_tc {label}: took {taken}, not {want}")
                checks[f"bf16 {tier} {label}"] = cs.check_out(
                    f"gemm_tc {tier} {label} ({want})", got,
                    K.gemm_epilogue_plain(pieces, m, **kt))
            except SystemExit as e:  # report every case, then fail
                print(f"  {e}")
                failed.append(f"bf16 {tier} {label}")
            del got
    return checks, failed


def bf16_rows(K, cs, torch, dev, check) -> list:
    """ms of every tier at the gemm_tc rows of ``chip_smoke.
    BF16_KERNEL_ROWS`` beside the bound and a bf16
    ``torch.matmul``; ``check`` holds each to its plain version first."""
    rows = []
    for case_i, windows, kernel, _, _ in cs.BF16_KERNEL_ROWS:
        if kernel != "gemm_tc":
            continue
        shape, pieces, m, kw = bf16_operands(
            K, cs, torch, dev, cs.BF16_GEMM_CASES[case_i], windows, 420)
        n = pieces[0][1].shape[1]
        matmul_ms = cs.bf16_matmul_ms(pieces, m, kw)
        for tier in cs.TC_PASSES:
            kt = {**kw, "tier": tier}
            variant = K.tc_variant(pieces, n, kw["res"], kw["out_dtype"])
            taken, got = cs.launched_variant(
                K, "gemm_tc", lambda: K.gemm_epilogue(pieces, m, **kt))
            if taken != variant:
                cs.fail(f"gemm_tc {shape}: took {taken}, not {variant}")
            err = (cs.check_out(f"gemm_tc {tier} {shape}", got,
                                K.gemm_epilogue_plain(pieces, m, **kt))
                   if check else None)
            del got
            ms = cs.cuda_ms(lambda: K.gemm_epilogue(pieces, m, **kt),
                            reps=20)
            plain_ms = cs.cuda_ms(
                lambda: K.gemm_epilogue_plain(pieces, m, **kt), reps=3)
            bms, by = cs.tc_bf16_bound(pieces, m, n, kt, tier)
            rows.append({"shape": shape, "m": m, "n": n, "tier": tier,
                         "ks": [a.shape[1] for a, _, _ in pieces],
                         "variant": variant, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bms, "bound_by": by,
                         "matmul_bf16_ms": matmul_ms, "max_abs_err": err})
            print(f"  gemm_tc bf16 {tier:8s} {shape} [{variant}]: {ms:.4f} "
                  f"ms (plain {plain_ms:.4f}; bound {bms:.4f} by {by}, "
                  f"{bms / ms:.1%} of it; bf16 torch.matmul {matmul_ms:.4f})")
        del pieces, kw
        torch.cuda.empty_cache()
    return rows


def library_calls(torch, pieces, m, kw, cs):
    """(bf16 matmul ms, float32-out addmm ms or None) over the same
    product, its operands rounded to bf16 once outside the timing."""
    a_cat, w_cat = cs.gemm_library_operands(pieces, m, kw)
    a16, w16 = a_cat.to(torch.bfloat16), w_cat.to(torch.bfloat16)
    del a_cat, w_cat
    matmul_ms = cs.cuda_ms(lambda: torch.matmul(a16, w16), reps=20)
    try:
        addmm_ms = cs.cuda_ms(lambda: torch.addmm(
            kw["shift"], a16, w16, out_dtype=torch.float32), reps=20)
    except (RuntimeError, TypeError, NotImplementedError) as e:
        print(f"  torch.addmm(..., out_dtype=torch.float32) refused: "
              f"{str(e).splitlines()[0][:160]}")
        addmm_ms = None
    return matmul_ms, addmm_ms


# gemm_smallk.cu's variants: (text in the source, what replaces it). A
# cut build computes garbage; only its time is read. "whole" is the
# source as it is.
_SK_STORE = "__stcs(reinterpret_cast<float4*>(p), v);"
_SK_LOAD = ("__ldg(reinterpret_cast<const float*>(\n"
            "            args.a[k] + (size_t)in_row * args.a_stride[k]));")
_SK_ROWS = "constexpr int ROWS = 4;"
_SK_Q1 = "  return __bfloat162float(__float2bfloat16_rn(x));"
SMALLK_CUTS = {
    "whole": [],
    "plain st.global stores": [(_SK_STORE,
                                "*reinterpret_cast<float4*>(p) = v;")],
    "no stores": [(_SK_STORE, "if (v.x == -1.5e-38f) " + _SK_STORE)],
    "no A loads": [(_SK_LOAD, "(float)(in_row + k);")],
    "2 rows an iteration": [(_SK_ROWS, "constexpr int ROWS = 2;")],
    "8 rows an iteration": [(_SK_ROWS, "constexpr int ROWS = 8;")],
    # bf16 rounding in integer ALU instructions in place of F2F.
    "integer q1": [(_SK_Q1, "  const uint32_t u = __float_as_uint(x);\n"
                            "  return x != x ? x : __uint_as_float((u + "
                            "0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);")],
}
SMALLK_CUT_DIR = os.path.join(REPO, "build", "gemm_smallk_cuts")
# The rows the variants are timed at: (EXPAND_SHAPES index, tiers).
SMALLK_CUT_ROWS = ((0, ("highest", "high")), (1, ("high",)),
                   (2, ("highest", "high")), (3, ("highest", "high")))


def smallk_cuts(K, cs, torch, dev, tree) -> dict:
    """Every ``SMALLK_CUTS`` build of the tree's gemm_smallk.cu, all
    ``nvcc`` started together, timed at ``SMALLK_CUT_ROWS`` (device ms,
    ``chip_smoke.device_ms``) in turns (the builds in order, then "whole"
    again), beside ``fill_`` of an output of the same size (the card's
    write rate at that size): ({row: {build: [ms, ...]}}, {build:
    library})."""
    libs = build_variants(
        K, os.path.join(tree, "gastx_torch", "csrc", "gemm_smallk.cu"),
        SMALLK_CUTS, SMALLK_CUT_DIR, ("gemm_smallk",))
    whole = K._lib("gemm_smallk")
    out = {}
    for idx, tiers in SMALLK_CUT_ROWS:
        spec, windows = cs.EXPAND_SHAPES[idx]
        spec = cs.GEMM_SHAPES[spec] if isinstance(spec, int) else spec
        pieces, m, kw = cs.gemm_case(spec, dev, 500 + spec[4],
                                     windows=windows)
        shape = f"{spec[0]} (B={windows})"
        fill = torch.empty((m, spec[4]), device=dev)
        out.setdefault(shape, {})["fill_"] = [cs.device_ms(
            lambda: fill.fill_(1.0), "Fill")]
        del fill
        for tier in tiers:
            kt = dict(kw, tier=tier)
            rows = out.setdefault(f"{tier} {shape}", {})
            for name in list(SMALLK_CUTS) + ["whole"]:
                K._LIBS["gemm_smallk"] = libs[name]
                rows.setdefault(name, []).append(cs.device_ms(
                    lambda: K.gemm_epilogue(pieces, m, **kt),
                    "gemm_smallk_kernel"))
                print(f"  {tier:8s} {shape} {name:24s}: "
                      f"{rows[name][-1]:.4f} ms")
            K._LIBS["gemm_smallk"] = whole
        print(f"  fill_ of the {shape} output: "
              f"{out[shape]['fill_'][0]:.4f} ms")
        del pieces, kw
        torch.cuda.empty_cache()
    return out, libs


# The forwards of the store A/B (store_forwards): (frames, windows) and
# the tiers (chip_smoke.tier_configs); at B=256 the 27f expand output
# (56 MB) is about the size of the card's L2, which GAB 0's first GEMM
# reads next.
STORE_AB = ((27, 256), ("highest", "high", "preset"))
STORE_BUILDS = ("whole", "plain st.global stores")


def _after(prof, key: str, reader: str = "gemm_") -> tuple:
    """From a profile: the mean device ms of the kernels whose name holds
    ``key`` and of the first kernel after each whose name holds
    ``reader`` (its name)."""
    from torch.autograd import DeviceType

    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    pairs = [(a, next(b for b in evs[i + 1:]
                      if reader in b.name and key not in b.name))
             for i, a in enumerate(evs) if key in a.name]
    if not pairs:
        raise RuntimeError(f"the profiler recorded no kernel named *{key}*")
    return (sum(a.time_range.elapsed_us() for a, _ in pairs)
            / 1e3 / len(pairs),
            sum(b.time_range.elapsed_us() for _, b in pairs)
            / 1e3 / len(pairs), pairs[0][1].name[:80])


def store_forwards(K, cs, torch, dev, libs, all_sources) -> dict:
    """The 27f forwards of ``STORE_AB`` on each of ``STORE_BUILDS`` (the
    builds of ``SMALLK_CUTS``: evict-first stores, plain stores), in turns
    (a, b, b, a, a, b, b, a): per tier and build the forward's ms (CUDA
    events over 10 forwards), and from a profile of 5 forwards the mean
    device ms of ``gemm_smallk`` and of the first GEMM after it (GAB 0's
    projection, which reads its output); {tier: {build: {metric:
    [...]}}}."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from gastx_torch.models import build_gastnet

    K.KERNEL_SOURCES = all_sources  # a forward runs every kernel
    K.build_kernels()
    (frames, b), tiers = STORE_AB
    cfgs = cs.tier_configs(frames)
    model = build_gastnet(cfgs["highest"], seed=frames, device=dev)
    x = torch.from_numpy(np.random.default_rng(frames).standard_normal(
        (b, frames, 17, 2)).astype(np.float32)).to(dev)
    whole = K._lib("gemm_smallk")
    out = {}
    for name in (STORE_BUILDS + STORE_BUILDS[::-1]) * 2:
        K._LIBS["gemm_smallk"] = libs[name]
        for tier in tiers:
            cs.with_config(model, cfgs[tier])
            row = out.setdefault(tier, {}).setdefault(
                name, {"forward_ms": [], "smallk_ms": [], "next_ms": []})
            row["forward_ms"].append(cs.cuda_ms(lambda: model(x)))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    model(x)
                torch.cuda.synchronize()
            sk, nxt, row["next"] = _after(prof, "gemm_smallk_kernel")
            row["smallk_ms"].append(sk)
            row["next_ms"].append(nxt)
            print(f"  {frames}f B={b} {tier:8s} {name:24s}: forward "
                  f"{row['forward_ms'][-1]:.4f} ms, gemm_smallk {sk:.4f}, "
                  f"then {row['next']} {nxt:.4f}")
    K._LIBS["gemm_smallk"] = whole
    del model, x
    torch.cuda.empty_cache()
    return out


def build_variants(K, source: str, table: dict, out_dir: str,
                   symbols) -> dict:
    """Compile ``source`` once for each entry of ``table`` ({name: [(text
    in the source, what replaces it), ...]}) into ``out_dir``, all
    ``nvcc`` processes started together, and print each build's registers
    and spills; returns {name: library}, ``symbols`` bound as
    ``kernels._ARGTYPES`` gives them."""
    import ctypes

    src = open(source).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(table.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name!r}: the source no longer "
                                 f"holds {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"cut{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"libcut{i}.so")
        procs[name] = (subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name!r}:\n{out}")
        regs = [line.split(":")[-1].strip() for line in out.splitlines()
                if "registers" in line or "spill stores" in line]
        print(f"  variant {name}: {regs[:4]}")
        lib = ctypes.CDLL(so)
        for symbol in symbols:
            fn = getattr(lib, symbol)
            fn.argtypes = K._ARGTYPES[symbol]
            fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def time_cuts(K, cs, torch, dev) -> dict:
    """ms of every cut build at the 27f level-1 projection (B=1024), each
    tier, the builds in turns: whole, cuts..., whole."""
    libs = build_variants(
        K, os.path.join(REPO, "gastx_torch", "csrc", "gemm_tc.cu"), CUTS,
        CUT_DIR, ("gemm_tc", "gemm_tc_hopper"))
    spec = cs.GEMM_SHAPES[cs.TIER_GEMM_CASES[0][0]]
    pieces, m, kw = cs.gemm_case(spec, dev, 300,
                                 windows=cs.TIER_GEMM_CASES[0][1])
    whole = K._LIBS["gemm_tc"]
    out = {}
    order = list(CUTS) + ["whole"]
    for tier in cs.TC_PASSES:
        kw["tier"] = tier
        for i, name in enumerate(order):
            K._LIBS["gemm_tc"] = libs[name]
            ms = cs.cuda_ms(lambda: K.gemm_epilogue(pieces, m, **kw), reps=20)
            out.setdefault(tier, {}).setdefault(name, []).append(ms)
            print(f"  cut {tier:8s} {name:22s}: {ms:.4f} ms")
    K._LIBS["gemm_tc"] = whole
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO,
                    help="checkout whose gastx_torch is timed")
    ap.add_argument("--check", action="store_true",
                    help="hold every tier on the edge cases first")
    ap.add_argument("--bf16", action="store_true",
                    help="add the bf16-I/O checks and rows")
    ap.add_argument("--no-f32", action="store_true",
                    help="leave out the float32 rows and checks")
    ap.add_argument("--cuts", action="store_true",
                    help="time this checkout's kernel with parts cut out")
    ap.add_argument("--smallk", action="store_true",
                    help="add the expand convs and gemm_smallk's variants")
    ap.add_argument("--stores", action="store_true",
                    help="only the forwards' store A/B of --smallk")
    ap.add_argument("--json", default="gemm_tc.json",
                    help="file name of the result under chiprun_out/")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    sys.path.insert(0, tree)
    from gastx_torch.ops.cuda import kernels as K

    if not K.__file__.startswith(tree + os.sep):
        raise SystemExit(f"imported {K.__file__}, not the tree {tree}")
    all_sources = K.KERNEL_SOURCES
    K.KERNEL_SOURCES = tuple(  # only what is timed
        k for k in ("gemm_epilogue", "gemm_tc", "gemm_smallk")
        if k in K.KERNEL_SOURCES)
    logs = K.build_kernels()
    for lib in ("gemm_tc", "gemm_tc_io", "gemm_smallk"):
        for line in logs.get(lib, "").splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line or "Potential" in line \
                    or "warning" in line:
                print(f"  ptxas {lib}: {line.strip()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; tree {tree}")
    cs.card_state("gemm_tc")
    dev = torch.device("cuda")
    # As chip_smoke.main: the plain versions' bf16 products sum in float32.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    checks, failed = {}, []
    if args.check and args.bf16:
        checks, failed = bf16_checks(K, cs, torch, dev)
    if args.check and not args.no_f32:
        for tier in cs.TC_PASSES:
            for label, pieces, m, kw, _ in (cs.tc_edge_cases(dev)
                                            + cs.gemm_ragged_cases(dev)):
                kw = {**kw, "tier": tier}
                (kernel, want), taken, got = cs.launched_route(K, pieces, m,
                                                               kw)
                try:
                    if taken != want:
                        cs.fail(f"{kernel} {label}: took {taken}, not "
                                f"{want}")
                    checks[f"{tier} {label}"] = cs.check(
                        f"{kernel} {tier} {label} ({want})", got,
                        K.gemm_epilogue_plain(pieces, m, **kw))
                except SystemExit as e:  # report every case, then fail
                    print(f"  {e}")
                    failed.append(f"{tier} {label}")
                del got
    if failed:
        cs.fail(f"{len(failed)} cases disagree: {failed}")

    rows = bf16_rows(K, cs, torch, dev, args.check) if args.bf16 else []
    for idx, windows in ([] if args.no_f32 else cs.TIER_GEMM_CASES):
        spec = cs.GEMM_SHAPES[idx]
        label, _, _, ks, n, _, _, res = spec
        pieces, m, kw = cs.gemm_case(spec, dev, 300 + idx, windows=windows)
        shape = f"{label} (B={windows})"
        a_route = cs.tc_a_route(kw)
        matmul_ms, addmm_ms = library_calls(torch, pieces, m, kw, cs)
        print(f"  {shape}: bf16 torch.matmul {matmul_ms:.4f} ms; "
              f"float32-out torch.addmm "
              + (f"{addmm_ms:.4f} ms" if addmm_ms else "null"))
        for tier in cs.TC_PASSES:
            kw["tier"] = tier
            (kernel, variant), taken, got = cs.launched_route(K, pieces, m,
                                                              kw)
            if taken != variant:
                cs.fail(f"{kernel} {shape}: took {taken}, not {variant}")
            if args.check:
                checks[f"{tier} {shape}"] = cs.check(
                    f"gemm_tc {tier} {shape}", got,
                    K.gemm_epilogue_plain(pieces, m, **kw))
            del got
            ms = cs.cuda_ms(lambda: K.gemm_epilogue(pieces, m, **kw),
                            reps=20)
            plain_ms = cs.cuda_ms(
                lambda: K.gemm_epilogue_plain(pieces, m, **kw), reps=3)
            bms, by = cs.tc_bound(*cs.tc_work(m, ks, n, 1, res is not None,
                                              tier))
            tflops = 2 * m * n * sum(ks) * cs.TC_PASSES[tier] / ms / 1e9
            rows.append({"shape": shape, "m": m, "ks": list(ks), "n": n,
                         "tier": tier, "variant": variant,
                         "a_route": a_route, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bms,
                         "bound_by": by, "tflops_all_passes": tflops,
                         "matmul_bf16_ms": matmul_ms,
                         "addmm_f32_out_ms": addmm_ms})
            print(f"  gemm_tc {tier:8s} {shape} [{variant}, A by "
                  f"{a_route}]: {ms:.4f} ms (plain {plain_ms:.4f}; bound "
                  f"{bms:.4f} by {by}, "
                  f"{bms / ms:.1%} of it; {tflops:.1f} TFLOP/s all passes)")
        del pieces, kw
        torch.cuda.empty_cache()
    expand = variants = stores = None
    if args.stores:
        libs = build_variants(
            K, os.path.join(tree, "gastx_torch", "csrc", "gemm_smallk.cu"),
            {name: SMALLK_CUTS[name] for name in STORE_BUILDS},
            SMALLK_CUT_DIR, ("gemm_smallk",))
        stores = store_forwards(K, cs, torch, dev, libs, all_sources)
    elif args.smallk:
        expand = cs.expand_table(K, dev)
        if "gemm_smallk" in K.KERNEL_SOURCES:
            variants, libs = smallk_cuts(K, cs, torch, dev, tree)
            stores = store_forwards(K, cs, torch, dev, libs, all_sources)
    cuts = time_cuts(K, cs, torch, dev) if args.cuts else None
    result = {"card": card, "tree": tree, "rows": rows, "checks": checks,
              "expand": expand, "smallk_variants": variants,
              "store_forwards": stores, "cuts": cuts}
    path = os.path.join(REPO, "chiprun_out", args.json)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
