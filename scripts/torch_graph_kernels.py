"""Time ``sem_graph`` and ``joint_attention`` at their main-path launches on
one GPU, beside each launch's bound.

The "graph kernels by shape" table (``graph_table``: the six launches of
``GRAPH_SHAPES``, each held to its plain version, device time per launch
from torch.profiler, bound, GB/s, the instantiation that launched; it was
``chip_smoke.py`` phase 4's until the script moved its one-off
measurements here), for the ``gastx_torch`` of this checkout or, with
``--tree``, of another one (e.g. a ``git archive``
of the parent commit, whose kernels keep the wrappers' Python signatures),
so that two versions of the kernels can be compared in one call:

    python3 scripts/torch_graph_kernels.py [--tree DIR] [--json F]
    python3 scripts/torch_graph_kernels.py --tiers [--cuts] [--variants]
        [--tree DIR]

A tree whose package counts no launches by instantiation (one with a
single instantiation of each graph kernel) reports its launches under
the instantiation ``single``.

``--tiers`` times ``joint_attention`` at the tier pairs of ``TIER_PAIRS``
(float32 and the two shipped pairs, default/default of the JAX preset and
high/high of all "high") at the six ``GRAPH_SHAPES`` launches, whose 27f
L1 and L0 are ``chip_smoke.py`` phase 10 (a)'s C=256 and C=128 shapes.
This checkout's ``joint_attention.cu`` and, with ``--tree``, that
checkout's (the parent's, e.g. under ``build/``; the C interface is the
same) are each built into a library of their own and called alike through
``ctypes``, in turns (this, other, other, this; CUDA events over ``REPS``
launches each), each output first held to ``joint_attention_plain`` by
``chip_smoke.attn_tier_check`` (float32: the float32 bound, and bit for
bit the other tree's).

``--cuts`` builds this checkout's source once more with each phase of
the tiered design cut out (``CUTS``: ``/*SCORE*/`` etc. in the source; a
cut build computes garbage, only its time is read), and the ``--tree``
checkout's source with its phases cut out (``PARENT_CUTS``, text of the
parent's kernel); ``--variants`` builds it with one design choice
changed each (``VARIANTS``: correct builds, checked); every build is
timed at ``CUT_SHAPES`` and the two shipped pairs, in turns. The
difference between a whole build and a cut one is what that phase costs,
overlap included.

Prints one JSON object (the rows, the card's name and power limit, the
tree, ``ptxas -v``'s lines of each whole build) and writes it to
``chiprun_out/`` (``--json``, default ``graph_kernels.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections.abc import Mapping

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# sem_graph and joint_attention by shape: their launches in one 27f B=1024
# and one 243f B=256 forward, (label, receptive field, GAB level, windows,
# frames at the GAB); J = 17.
GRAPH_SHAPES = (("27f L0", 27, 0, 1024, 25), ("27f L1", 27, 1, 1024, 19),
                ("27f L2", 27, 2, 1024, 1), ("243f L2", 243, 2, 256, 217),
                ("243f L3", 243, 3, 256, 163), ("243f L4", 243, 4, 256, 1))


# --tiers: the tier pairs (score, apply) timed at every GRAPH_SHAPES launch;
# launches a timing.
TIER_PAIRS = (("highest", "highest"), ("default", "default"),
              ("high", "high"))
REPS = 20
# --cuts: the shapes (phase 10 (a)'s C=256 and C=128) and pairs of the cut
# builds.
CUT_SHAPES = ("27f L1", "27f L0")
CUT_PAIRS = (("default", "default"), ("high", "high"))


def _cut(tag):
    return (f"/*{tag}*/true", f"/*{tag}*/false")


# This checkout's tiered phases cut out: the tiered score loop (its loads,
# rounding and dots), the rounding of g into the mma's B words (truncated
# words, no lo half), the softmax, the apply's k steps (its ldmatrix, B
# loads and mmas; the zero sums are still stored).
_G_ROUND = ("            bh[0] = bf16x2(x[0], x[1]);\n"
            "            bh[1] = bf16x2(x[2], x[3]);\n"
            "            if (lo_g) {")
_G_TRUNC = ("            bh[0] = __byte_perm(__float_as_uint(x[0]), "
            "__float_as_uint(x[1]), 0x7632);\n"
            "            bh[1] = __byte_perm(__float_as_uint(x[2]), "
            "__float_as_uint(x[3]), 0x7632);\n"
            "            bl[0] = bh[0];\n"
            "            bl[1] = bh[1];\n"
            "            if (false) {")
CUTS = {
    "no scores": [_cut("SCORE")],
    "no g rounding": [(_G_ROUND, _G_TRUNC)],
    "no softmax": [_cut("SOFTMAX")],
    "no apply": [_cut("APPLY")],
}
# --variants: correct builds of this checkout's source with one design
# choice undone each (checked, then timed as the cuts are): the bf16
# rounding in integer instructions in place of cvt.rn.bf16x2.f32; tiles of
# one frame at C=256 (two at C=128) in place of two (three); 1.5 times the
# tile (three frames at C=256, five at C=128); tensor-core tiles of 27200
# bytes (four frames at C=128; C=256 and 512 as they are); one n-tile of 8
# channels a warp in the apply in place of two; 8 lanes a softmax row in place of 4; expf in the softmax in place of
# __expf; the attention words in an array apart in place of the tile's dead
# theta | phi columns; the tensor-core kernels' registers bounded for 3 or
# 5 blocks an SM in place of 4.
_BF16X2 = ("  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);\n"
           "  return *reinterpret_cast<const uint32_t*>(&h);\n")
_BF16X2_INT = (
    "  const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);\n"
    "  return ((u0 + 0x7fffu + ((u0 >> 16) & 1u)) >> 16) |\n"
    "         ((u1 + 0x7fffu + ((u1 >> 16) & 1u)) & 0xffff0000u);\n")
VARIANTS = {
    "integer rounding": [(_BF16X2, _BF16X2_INT)],
    "one-frame tiles": [("constexpr int TILE_BYTES = 27136;",
                         "constexpr int TILE_BYTES = 13600;")],
    "tiles x1.5": [("constexpr int TILE_BYTES = 27136;",
                    "constexpr int TILE_BYTES = 40704;")],
    "tc tiles of 27200 bytes": [(
        "int fpt = TILE_BYTES / frame_bytes;",
        "int fpt = (AT == HIGHEST ? TILE_BYTES : 27200) / frame_bytes;")],
    "one n-tile a warp": [("constexpr int NT = 2;", "constexpr int NT = 1;")],
    "8 lanes a softmax row": [("constexpr int SROW = 4;",
                               "constexpr int SROW = 8;")],
    "expf": [("/*EXP*/__expf(", "expf(")],
    "attention words apart": [("constexpr bool WORDS_IN_TILE = true;",
                               "constexpr bool WORDS_IN_TILE = false;")],
    "3 blocks an SM": [("constexpr int TC_BLOCKS = 4;",
                        "constexpr int TC_BLOCKS = 3;")],
    "5 blocks an SM": [("constexpr int TC_BLOCKS = 4;",
                        "constexpr int TC_BLOCKS = 5;")],
}
# The same phases of the parent's kernel (one kernel of runtime tier codes:
# its one-float-a-step tiered score loop, its shared-memory pass that
# rounds g in place, its softmax, its CUDA-core apply's key loop).
PARENT_CUTS = {
    "parent whole": [],
    "parent no scores": [
        ("for (int i = e * VEC; i < inter; i += GROUP * VEC)",
         "for (int i = inter; i < inter; i += GROUP * VEC)")],
    "parent no g pass": [("if (APPLY_HIGH || a_rhs != 0) {", "if (false) {")],
    "parent no softmax": [
        ("for (int base = warp * (32 / ROW); base < rows; base += THREADS / "
         "ROW) {", "for (int base = rows; base < rows; base += THREADS / "
         "ROW) {")],
    "parent no apply": [("for (int m = 0; m < j; ++m) {",
                         "for (int m = 0; m < 0; ++m) {")],
}


def build_attn(K, builds: dict) -> tuple:
    """Compile each ``builds`` entry, name -> (joint_attention.cu's path,
    text substitutions), into a library of its own (all ``nvcc`` started
    together); returns ({name: its C function joint_attention}, {name:
    ptxas -v's lines} of the builds that are not cuts)."""
    import ctypes

    out_dir = os.path.join(REPO, "build", "graph_kernels")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, (path, subs)) in enumerate(builds.items()):
        text = open(path).read()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"build {name!r}: {path} holds no {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"joint_attention_{i}.cu")
        lib = os.path.join(out_dir, f"joint_attention_{i}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib,
            " no " not in f" {name} ")
    fns, ptxas = {}, {}
    for name, (proc, lib, whole) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on build {name!r}:\n{out}")
        if whole:
            ptxas[name] = [line.strip() for line in out.splitlines()
                           if "registers" in line or "spill" in line
                           or "Compiling entry" in line]
            print(f"ptxas -v, {name}:")
            print("\n".join(ptxas[name]))
        fn = getattr(ctypes.CDLL(lib), "joint_attention")
        fn.argtypes = K._ARGTYPES["joint_attention"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, ptxas


def attn_call(K, fn, args, out, score_tier, apply_tier):
    """A launch of the C function ``fn`` on ``joint_attention``'s
    arguments ``args`` into ``out``, at a tier pair, as the wrapper makes
    it."""
    import torch

    theta, phi, g, proj_t, proj_p, c_k = args
    k, inter = proj_t.shape
    j = c_k.shape[1]
    g_ch = g.shape[1] // k
    codes = [K.ATTN_TIERS.index(t) for t in (score_tier, apply_tier)]
    vec16 = int(K.graph_variant((theta, phi, g), (inter, g_ch)) == "vec16")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        code = fn(theta.data_ptr(), phi.data_ptr(), g.data_ptr(),
                  theta.stride(0), proj_t.data_ptr(), proj_p.data_ptr(),
                  c_k.data_ptr(), out.data_ptr(), theta.shape[0] // j, j,
                  inter, g_ch, k, stream, *codes, vec16)
        if code != 0:
            raise SystemExit(f"joint_attention launch failed ({code})")
    return call


def attn_turns(K, models, dev, fns, shapes, pairs, checked) -> list:
    """Each build of ``fns`` at each ``GRAPH_SHAPES`` launch in ``shapes``
    and tier pair of ``pairs``, timed in turns (the builds in order, then
    in reverse; ms a launch by CUDA events over ``REPS``), the builds in
    ``checked`` first held to the plain version."""
    import torch

    import chip_smoke as cs
    from gastx_torch.ops.cuda.fused_gab import gab_tables

    rows_out = []
    for i, (label, rf, level, b, t_gab) in enumerate(GRAPH_SHAPES):
        if label not in shapes:
            continue
        m = models[rf]
        t = gab_tables(m.layers_graph_conv[level], m.statics)
        c, k, inter, g_ch, j, _ = K.gab_shape(t)
        rows = b * t_gab * j
        _, args = cs.graph_operands(K, t, rows, dev, seed=200 + i)
        outs = {name: torch.empty(rows, k * g_ch, device=dev) for name in fns}
        plain_f32 = K.joint_attention_plain(*args)
        ref = checked[0]
        attn_call(K, fns[ref], args, outs[ref], "highest", "highest")()
        noise = float((outs[ref] - plain_f32).pow(2).mean().sqrt())
        flops, nbytes = cs.attn_work(rows, j, k, inter, g_ch)
        bms, by = cs.bound(flops, nbytes)
        for st, at in pairs:
            pair = f"{st}/{at}"
            calls = {name: attn_call(K, fn, args, outs[name], st, at)
                     for name, fn in fns.items()}
            plain = (plain_f32 if pair == "highest/highest"
                     else K.joint_attention_plain(*args, score_tier=st,
                                                  apply_tier=at))
            errs = {}
            for name in checked:
                calls[name]()
                errs[name] = cs.attn_tier_check(
                    f"joint_attention {pair} {label} [{name}]", outs[name],
                    plain, plain_f32, noise, args[2], t.c_k, at)
            # The first two checked builds bit for bit (--tiers: this and
            # the other tree; --variants: cvt and integer rounding).
            bitwise = (bool(torch.equal(outs[checked[0]], outs[checked[1]]))
                       if len(checked) > 1 else None)
            del plain
            order = list(calls)
            ms = {name: [] for name in order}
            for name in order + order[::-1]:
                ms[name].append(cs.cuda_ms(calls[name], reps=REPS))
            row = {"shape": label, "rows": rows, "c": c, "pair": pair,
                   "ms": ms, "bound_ms": bms, "bound_by": by,
                   "max_abs_err": errs, "bitwise_equal": bitwise}
            rows_out.append(row)
            print(f"  joint_attention {pair} {label} ({rows} rows, C={c}; "
                  f"bound {bms:.4f} ms by {by}): " + "; ".join(
                      f"{name} {sum(v) / len(v):.4f}"
                      for name, v in ms.items())
                  + ("" if bitwise is None else f"; bitwise {bitwise}"))
        del args, outs, plain_f32
        torch.cuda.empty_cache()
    return rows_out


def graph_table(K, models, dev) -> list:
    """The "graph kernels by shape": ``sem_graph`` and
    ``joint_attention`` at each ``GRAPH_SHAPES`` launch of ``models``
    (keyed by receptive field), each held to its plain version, with its
    device time per launch, bound, GB/s and the instantiation that
    launched."""
    import torch

    import chip_smoke as cs
    from gastx_torch.ops.cuda.fused_gab import gab_tables

    print("graph kernels by shape (device ms per launch)")
    out = []
    for i, (label, rf, level, b, t_gab) in enumerate(GRAPH_SHAPES):
        m = models[rf]
        t = gab_tables(m.layers_graph_conv[level], m.statics)
        c, k, inter, g_ch, j, d = K.gab_shape(t)
        rows = b * t_gab * j
        sem, attn = cs.graph_operands(K, t, rows, dev, seed=200 + i)
        for name, fn, plain, args, work in (
                ("sem_graph", K.sem_graph, K.sem_graph_plain, sem,
                 cs.sem_work(rows, c, j, d)),
                ("joint_attention", K.joint_attention,
                 K.joint_attention_plain, attn,
                 cs.attn_work(rows, j, k, inter, g_ch))):
            variant, got = cs.launched_variant(K, name, lambda: fn(*args))
            err = cs.check(f"{name} {label} [{variant}]", got, plain(*args))
            del got
            ms = cs.device_ms(lambda: fn(*args), f"{name}_kernel")
            bms, by = cs.bound(*work)
            out.append({"kernel": name, "shape": label, "rows": rows, "c": c,
                        "variant": variant, "ms": ms, "bound_ms": bms,
                        "bound_by": by, "gb_per_s": work[1] / ms / 1e6,
                        "max_abs_err": err})
            print(f"  {name} {label} ({rows} rows, C={c}) [{variant}]: "
                  f"{ms:.4f} ms, {work[1] / ms / 1e6:.1f} GB/s; bound "
                  f"{bms:.4f} by {by} ({bms / ms:.0%})")
        del sem, attn
        torch.cuda.empty_cache()
    return out


class _SingleVariant(Mapping):
    """A live view of ``LAUNCHES[kernel]`` as the counts of one
    instantiation, for a package with no ``VARIANT_LAUNCHES``."""

    def __init__(self, launches, kernel):
        self.launches, self.kernel = launches, kernel

    def __getitem__(self, variant):
        if variant != "single":
            raise KeyError(variant)
        return self.launches[self.kernel]

    def __iter__(self):
        return iter(("single",))

    def __len__(self):
        return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO,
                    help="checkout whose gastx_torch is timed")
    ap.add_argument("--json", default="graph_kernels.json",
                    help="file name of the result under chiprun_out/")
    ap.add_argument("--tiers", action="store_true",
                    help="joint_attention at TIER_PAIRS, this checkout's "
                         "source in turns with --tree's")
    ap.add_argument("--cuts", action="store_true",
                    help="with --tiers: the cut builds (CUTS, PARENT_CUTS)")
    ap.add_argument("--variants", action="store_true",
                    help="with --tiers: the design variants (VARIANTS)")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if args.tiers:
        return tiers_main(args, tree)
    sys.path.insert(0, tree)
    from gastx_torch.models import (GastNet, config_for_frames,
                                    init_gastnet, randomize_eval_statistics)
    from gastx_torch.ops.cuda import kernels as K

    if not K.__file__.startswith(tree + os.sep):
        raise SystemExit(f"imported {K.__file__}, not the tree {tree}")
    if not hasattr(K, "VARIANT_LAUNCHES"):
        K.VARIANT_LAUNCHES = {
            name: _SingleVariant(K.LAUNCHES, name)
            for name in ("sem_graph", "joint_attention")}
    K.build_kernels()
    card = card_name()
    models = {}
    for frames in (27, 243):
        gen = torch.Generator().manual_seed(frames)
        m = init_gastnet(GastNet(config_for_frames(frames)), gen)
        models[frames] = randomize_eval_statistics(m, gen).cuda().eval()
    rows = graph_table(K, models, torch.device("cuda"))
    result = {"card": card, "tree": tree, "rows": rows}
    path = os.path.join(REPO, "chiprun_out", args.json)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def tiers_main(args, tree: str) -> int:
    """``--tiers`` (and ``--cuts``): this checkout's package and its
    ``joint_attention.cu`` beside ``tree``'s source."""
    import torch

    from gastx_torch.models import (GastNet, config_for_frames,
                                    init_gastnet, randomize_eval_statistics)
    from gastx_torch.ops.cuda import kernels as K

    source = os.path.join(REPO, "gastx_torch", "csrc", "joint_attention.cu")
    other = os.path.join(tree, "gastx_torch", "csrc", "joint_attention.cu")
    builds = {"this": (source, [])}
    if tree != REPO:
        builds["other"] = (other, [])
    if args.variants:
        builds.update({f"this {name}": (source, subs)
                       for name, subs in VARIANTS.items()})
    if args.cuts:
        builds.update({f"this {name}": (source, subs)
                       for name, subs in CUTS.items()})
        if tree != REPO:
            builds.update({name: (other, subs)
                           for name, subs in PARENT_CUTS.items() if subs})
    fns, ptxas = build_attn(K, builds)
    card = card_name()
    dev = torch.device("cuda")
    models = {}
    for frames in (27, 243):
        gen = torch.Generator().manual_seed(frames)
        m = init_gastnet(GastNet(config_for_frames(frames)), gen)
        models[frames] = randomize_eval_statistics(m, gen).cuda().eval()
    main_fns = {name: fns[name] for name in ("this", "other") if name in fns}
    print(f"joint_attention by tier pair, in turns ({card})")
    result = {"card": card, "tree": REPO, "other": tree, "ptxas": ptxas,
              "tiers": attn_turns(K, models, dev, main_fns,
                                  [s[0] for s in GRAPH_SHAPES], TIER_PAIRS,
                                  list(main_fns))}
    if args.cuts or args.variants:
        print(f"joint_attention's cut builds and variants, in turns ({card})")
        checked = ["this"] + [f"this {n}" for n in VARIANTS
                              if f"this {n}" in fns]
        result["cuts"] = attn_turns(K, models, dev, fns, CUT_SHAPES,
                                    CUT_PAIRS, checked)
    path = os.path.join(REPO, "chiprun_out", args.json)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "ptxas"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
