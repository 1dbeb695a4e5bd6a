"""Build, binding and launch wrappers of the port's CUDA kernels.

Seven kernels, each a CUDA C++ source under ``gastx_torch/csrc/`` with a
plain C interface:

  * ``gemm_epilogue`` — pipelined f32 GEMM over up to three pieces with a
    tap row map and a BN (scale/shift) / ReLU / residual epilogue, in two
    instantiations (:func:`gemm_variant`), the ``"highest"`` tier;
  * ``gemm_tc`` — the same function at the bf16 tiers
    (``gastx_torch.ops.precision``) on the tensor cores, one
    instantiation per tier (``TC_TIERS``) and alignment and I/O dtype
    (:func:`tc_variant`): ``vec16`` a persistent warp-specialised
    ``wgmma`` kernel fed by TMA (W as :func:`tc_weights` lays it out),
    ``vec16_bf16`` the same kernel with bf16 TMA boxes (bf16 A pieces,
    residual or output), ``general`` an ``mma.sync`` one for the ragged
    rest; the :func:`gemm_epilogue` wrapper launches it for every tier
    but ``"highest"``;
  * ``gemm_smallk`` — the same function for GEMMs whose K is tiny (the
    level-0 expand conv, K = 2 a tap), on the CUDA cores at ``"highest"``
    and at every tier, instantiated by tier: the :func:`gemm_epilogue`
    wrapper launches it wherever :func:`smallk_ok` holds
    (:func:`gemm_variant` and :func:`tc_variant` then return
    ``"smallk"``; :func:`gemm_route` names the kernel each call takes);
  * ``sem_graph`` — the local branch's semantic graph aggregation, and
  * ``joint_attention`` — per-frame multi-head attention over the joints,
    its score dots at their tier (operands rounded as loaded) and, below
    ``"highest"``, its apply as ``precision.tiered``'s bf16 passes on
    ``mma.sync``, instantiated by tier pair
    (:func:`attn_instantiation`) and alignment (:func:`graph_variant`);
  * ``gemm_wgrad`` — the weight gradient ``A_p^T G`` of a plain site's
    product over its row map at the ``"default"`` and ``"high"`` tiers
    (:func:`gemm_wgrad`; the train step's backward,
    ``gastx_torch.ops.cuda.site_grad``), rows split across blocks and the
    partial sums added in a fixed order;
  * ``gab_narrow`` — the whole eval GAB at the narrow widths
    (``NARROW_WIDTHS``, C = 16 .. 96 in steps of 16) in one launch, every
    intermediate in shared memory; in float32, or in its tiered form
    (``NARROW_TIERED_WIDTHS``, C <= 64) with its products as bf16
    ``mma.sync`` passes at each class's tier (:func:`narrow_form`), its
    launch splitting the weights once into a scratch buffer
    (:func:`narrow_scratch`, :func:`narrow_split_plain`); each also in the
    fold form of the tables (``NARROW_FOLD_WIDTHS``), its scores folded
    into the projection.

``gemm_epilogue``, ``gemm_tc`` and ``gab_narrow`` also read and write
bf16 (bf16 storage, ``gastx_torch.models.config``): each A piece of a GEMM
and its residual float32 or bf16 (the dtype is the tensor's), its output
float32 or bf16 (``out_dtype``); ``gab_narrow``'s x and output likewise.
They upcast on load and compute in float32, as the TPU kernels do; the
weights stay float32, and so do the intermediates between the chain's
kernels. ``gemm_tc`` takes an aligned bf16 operand on its ``vec16_bf16``
instantiation and a ragged one on ``general``. A launch with a bf16
operand goes to the source's bf16-I/O library (``IO_SOURCES``). Each
plain version upcasts, runs the float32 plain chain and rounds the
output.

The first three chain into the GAB (:func:`gab_chain`) wherever
:func:`gab_route` does not pick ``gab_narrow``, and into its two
branches alone (:func:`local_chain`, projection ->
``sem_graph`` -> cat; :func:`global_chain`, projection ->
``joint_attention`` -> cat), which ``gab_chain`` runs on one shared
projection; the chain of their plain versions is also ``gab_narrow``'s
plain version.

The entry points that replace the TPU kernels (``ENTRY_POINTS``) wrap
these: ``fused_level0``/``fused_level`` (``fused_level.py``), ``fused_gab``
(``fused_gab.py``; counted as ``fused_gab_pbatch``, ``fused_gab`` or
``fused_gab_split`` by width), ``fused_gab_packed`` (``fused_gab`` on the
(B, T, J*C) view), ``fused_local_branch`` (``local_chain``),
``head_attention`` (``head_attn.py``: ``joint_attention`` with one head)
and ``fused_global_attention`` (``global_attn.py``: ``global_chain``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library under ``build/gastx_torch/`` at the root of the checkout (named
by a hash of the source and flags, so an edited source is rebuilt), at
first use, all ``nvcc`` processes started together (``gab_narrow.cu``'s
libraries in two parts each, ``PART_SOURCES``, linked after), and loaded
with ``ctypes``. Kernels launch on PyTorch's current stream and allocate
nothing: the wrappers allocate outputs with ``torch.empty`` (and the
tiered ``gab_narrow``'s scratch buffer once a stream).

Every wrapper checks device, dtype, shape and contiguity, and raises
(:func:`check_no_grad`) when grad mode is on and an input requires a
gradient: the kernels have no backward, and a wrapper never detaches its
inputs quietly. On a CUDA tensor
it launches its kernel (and raises if the launch fails; a tier below
``"highest"`` launches a tensor-core or rounding instantiation, never a
float32 one); on a CPU tensor it runs the plain PyTorch version beside it,
at the tier it is given, which is also what the card runs to hold the
kernel to. ``LAUNCHES`` counts kernel launches by kernel,
``VARIANT_LAUNCHES`` those of the kernels with alignment
instantiations (and ``gemm_smallk``'s one, ``"smallk"``; ``gemm_wgrad``'s
three, :func:`wgrad_route`) by kernel and instantiation, ``TIER_LAUNCHES``
the
launches of ``gemm_tc`` and ``gemm_smallk`` by tier and the tiered ones of
``joint_attention`` (by score/apply tier pair) and ``gab_narrow`` (by its
classes' tiers), ``DTYPE_LAUNCHES`` every
kernel's launches by the dtypes of its I/O (``IO_LABELS``);
``ENTRY_LAUNCHES`` counts the kernel launches made inside each entry point
(:func:`entry_point`). All are counted in
``_launch`` alone, after the launch succeeded. ``SITE_PRODUCTS`` counts
the plain sites' products by class and tier (:func:`site_gemm`), and
``SITE_GRADS`` their backward's products by class, gradient and tier.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from gastx_torch.device import check_f32_matmul
from gastx_torch.ops.precision import check_tier, split_bf16, tiered, \
    tiered_mm

KERNEL_SOURCES = ("gemm_epilogue", "sem_graph", "joint_attention",
                  "gab_narrow", "gemm_tc", "gemm_smallk", "gemm_wgrad")
CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "gastx_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The sources with bf16-I/O forms, each also built with IO_FLAGS into a
# library of its own ("<name>_io"): every bf16 launch goes there, so the
# float32 library has no dtype code, and the two compile side by side.
IO_SOURCES = ("gemm_epilogue", "gab_narrow", "gemm_tc")
IO_FLAGS = ("-DGASTX_BF16_IO",)
# The sources whose tiered form is built from the same file with
# TIERED_FLAGS into libraries of its own ("<name>_tiered", and its
# bf16-I/O "<name>_tiered_io"): the forms compile side by side, and the
# float32 library keeps its code.
TIERED_SOURCES = ("gab_narrow",)
TIERED_FLAGS = ("-DGASTX_TIERED_FORM",)
# The sources whose every library is compiled in parts, one ``nvcc -c`` a
# part with its flags, all started with the other libraries, and linked
# into the one library: gab_narrow.cu's v1 instantiations and C functions
# (part 1) and its fold instantiations (part 2), its longest compiles.
NARROW_PARTS = ("-DGASTX_NARROW_PART=1", "-DGASTX_NARROW_PART=2")
PART_SOURCES = {"gab_narrow": NARROW_PARTS}

# The port's entry points that replace TPU kernels. The one ``fused_gab``
# counts under the TPU kernel it stands for: ``fused_gab_pbatch`` for
# C < 128, ``fused_gab`` for 128 <= C <= 256, ``fused_gab_split`` above.
ENTRY_POINTS = ("fused_level0", "fused_level", "fused_gab_pbatch",
                "fused_gab", "fused_gab_split", "fused_gab_packed",
                "fused_local_branch", "head_attention",
                "fused_global_attention")

# The two instantiations of gemm_epilogue, sem_graph and joint_attention:
# 16-byte copies, loads and stores, and 4-byte ones for the rest
# (gemm_variant, graph_variant); each C function's last argument picks one
# (1: vec16).
VARIANTS = ("vec16", "general")
VARIANT_KERNELS = ("gemm_epilogue", "sem_graph", "joint_attention",
                   "gemm_tc", "gemm_smallk", "gemm_wgrad", "gab_narrow")
# gemm_tc's instantiations: its wgmma kernel on float32 I/O (vec16) and
# on bf16 I/O (vec16_bf16, the bf16-I/O library), and the mma.sync one.
TC_VARIANTS = ("vec16", "vec16_bf16", "general")
# gemm_smallk's one (its tiers are TIER_LAUNCHES'), the name gemm_variant
# and tc_variant give it.
SMALLK_VARIANTS = ("smallk",)
# gemm_wgrad's instantiations (wgrad_route): its wgmma kernel, its
# CUDA-core kernel for sum K_p <= WGRAD_SMALLK_MAX_K, and the mma.sync one.
WGRAD_VARIANTS = ("wgmma", "smallk", "general")
# gab_narrow's by the form of its tables (``fused_gab.GabTables.form``),
# in the float32 kernel and the tiered one alike.
NARROW_FORMS = ("v1", "fold")
# gemm_tc's tiers, in the order of its C tier code; "kdefault" is the
# "default" instantiation (one bf16 pass in a kernel, as on the TPU).
TC_TIERS = ("default", "high_lhs", "high_rhs", "high")
# joint_attention's tier codes, for its score and its apply dot; also
# gemm_smallk's, whose launches TIER_LAUNCHES counts by them ("kdefault"
# as "default").
ATTN_TIERS = ("highest", "default", "high_lhs", "high_rhs", "high")
# The tier pairs joint_attention has an instantiation of its own for (the
# shipped routes' pairs); every other pair below "highest" runs on runtime
# tier codes.
ATTN_OWN_PAIRS = (("default", "default"), ("high", "high"))
# gemm_wgrad's tiers (the plain sites' XLA tiers below "highest"), in the
# C function's codes, TC_TIERS' indices.
WGRAD_TIERS = ("default", "high")
# gemm_smallk's shape rule (smallk_ok): the sum of K_p at most this.
SMALLK_MAX_K = 16
# The graph kernels' shape rule (their C entry points check it too): J <= 32
# joints and, for sem_graph, D <= 8 neighbour slots a joint.
MAX_JOINTS = 32
MAX_SLOTS = 8

# Kernel launches by kernel, by kernel and instantiation, and by the entry
# points open at the launch.
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_SOURCES}
VARIANT_LAUNCHES: Dict[str, Dict[str, int]] = {
    name: {v: 0 for v in {"gemm_tc": TC_VARIANTS,
                          "gemm_smallk": SMALLK_VARIANTS,
                          "gemm_wgrad": WGRAD_VARIANTS,
                          "gab_narrow": NARROW_FORMS}.get(name, VARIANTS)}
    for name in VARIANT_KERNELS}
# Launches by tier: gemm_tc by tier, gemm_smallk by tier ("highest"
# too), joint_attention by "score/apply" pair (a pair of "highest" is its
# float32 path and is not counted here), gab_narrow's tiered form by its
# classes' tiers (NARROW_TIER_CLASSES, "/"-joined; "fold " before them for
# the fold form).
TIER_LAUNCHES: Dict[str, Dict[str, int]] = {
    "gemm_tc": {t: 0 for t in TC_TIERS},
    "gemm_smallk": {t: 0 for t in ATTN_TIERS}, "joint_attention": {},
    "gab_narrow": {}, "gemm_wgrad": {t: 0 for t in WGRAD_TIERS}}
ENTRY_LAUNCHES: Dict[str, int] = {name: 0 for name in ENTRY_POINTS}
_OPEN_ENTRIES: List[str] = []
# The products of the plain sites (the JAX package's XLA sites:
# ``ops.temporal``, ``ops.graph``) on CUDA tensors, by op class and the
# tier they computed (:func:`site_gemm`, :func:`count_site`): "highest" a
# float32 torch product, "bf16" a bf16 one, any other tier a GEMM launch
# or, for the J x J classes, a torch product of tier-rounded operands.
SITE_PRODUCTS: Dict[str, Dict[str, int]] = {}
# The products of the plain sites' backward on CUDA tensors, by op class
# and "dA <tier>" (the input gradient: a GEMM launch) or "dW <tier>" (the
# weight gradient: a gemm_wgrad launch), or for the J x J classes "da
# <tier>" / "db <tier>" (torch products of tier-rounded operands).
SITE_GRADS: Dict[str, Dict[str, int]] = {}
# Launches by the dtypes of a launch's activations in and out: all float32,
# a bf16 input (an A piece, the residual or x), a bf16 output, or both.
IO_LABELS = ("float32", "bf16_in", "bf16_out", "bf16_io")
DTYPE_LAUNCHES: Dict[str, Dict[str, int]] = {
    name: {io: 0 for io in IO_LABELS} for name in KERNEL_SOURCES}
# The C functions' dtype bits: A piece p bf16 (bit p), the residual (bit
# 3) and the output (bit 4).
_RES_BF16, _OUT_BF16 = 8, 16

_LIBS: Dict[str, ctypes.CDLL] = {}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "gemm_epilogue": [_P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _I, _I,
                      _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _I, _P, _P,
                      _I, _I],
    "sem_graph": [_P, _I, _P, _LL, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I],
    "joint_attention": [_P, _P, _P, _I, _P, _P, _P, _P, _LL, _I, _I, _I,
                        _I, _P, _I, _I, _I],
    # per piece (a, w_hi, w_lo, K, a_off) x 3, then as gemm_epilogue's
    # from npieces on, tier code, dtype bits (the general instantiation)
    "gemm_tc": [_P, _P, _P, _I, _I] * 3 + [_I, _I, _I, _I, _I, _I, _P, _P,
                                          _I, _P, _I, _P, _P, _I, _I],
    # per piece (a, K, rows, a_off) x 3, npieces, W^T's halves and their
    # padded K, then as gemm_epilogue's from m on, tier code, dtype bits
    # (vec16, vec16_bf16)
    "gemm_tc_hopper": [_P, _I, _I, _I] * 3 + [_I, _P, _P, _I, _I, _I, _I,
                                              _I, _I, _P, _P, _I, _P, _I,
                                              _P, _P, _I, _I],
    # as gemm_epilogue's up to the stream, then the tier code (ATTN_TIERS)
    "gemm_smallk": [_P, _P, _I, _I] * 3 + [_I, _I, _I, _I, _I, _I, _P, _P,
                                          _I, _P, _I, _P, _P, _I],
    # x, out, frames, J, C, D, K, I, G, the 20 tables of a GabTables in
    # its field order (narrow_table_ptrs), stream, x bf16, out bf16, fold
    "gab_narrow": [_P, _P, _LL, _I, _I, _I, _I, _I, _I] + [_P] * 21
    + [_I, _I, _I],
    # as gab_narrow's, then the tier codes of NARROW_TIER_CLASSES, the
    # scratch buffer and its size in words (narrow_scratch)
    "gab_narrow_tiered": [_P, _P, _LL, _I, _I, _I, _I, _I, _I] + [_P] * 21
    + [_I, _I, _I] + [_I] * 7 + [_P, _LL],
    # per piece (a, K, a_off) x 3, npieces, g, m, n, s_out, a_s_in, the
    # workspace, splits, chunk, out, stream, tier code (TC_TIERS): the
    # general and the smallk instantiations
    "gemm_wgrad": [_P, _I, _I] * 3 + [_I, _P, _I, _I, _I, _I, _P, _I, _I,
                                      _P, _P, _I],
    "gemm_wgrad_smallk": [_P, _I, _I] * 3 + [_I, _P, _I, _I, _I, _I, _P,
                                             _I, _I, _P, _P, _I],
    # per piece (a, K, rows, a_off) x 3, then as gemm_wgrad's from npieces
    # on, the output tile's width (the wgmma instantiation)
    "gemm_wgrad_hopper": [_P, _I, _I, _I] * 3 + [_I, _P, _I, _I, _I, _I,
                                                 _P, _I, _I, _P, _P, _I,
                                                 _I],
}


# The C functions of each library (its bf16-I/O form's too) where they
# are not the one named after it.
_SYMBOLS = {"gemm_tc": ("gemm_tc", "gemm_tc_hopper"),
            "gemm_wgrad": ("gemm_wgrad", "gemm_wgrad_hopper",
                           "gemm_wgrad_smallk"),
            "gab_narrow_tiered": ("gab_narrow_tiered",)}


def reset_launches() -> None:
    for counts in (LAUNCHES, ENTRY_LAUNCHES, *VARIANT_LAUNCHES.values(),
                   TIER_LAUNCHES["gemm_tc"], TIER_LAUNCHES["gemm_smallk"],
                   TIER_LAUNCHES["gemm_wgrad"], *DTYPE_LAUNCHES.values()):
        for name in counts:
            counts[name] = 0
    TIER_LAUNCHES["joint_attention"].clear()
    TIER_LAUNCHES["gab_narrow"].clear()
    SITE_PRODUCTS.clear()
    SITE_GRADS.clear()


def count_site(op: str, tier: str, t: torch.Tensor) -> None:
    """Count one product of the plain site ``op`` at ``tier`` in
    ``SITE_PRODUCTS`` where its operand ``t`` lies on the card (``"bf16"``
    for a bf16 operand, whatever the tier)."""
    if t.is_cuda:
        key = "bf16" if t.dtype == torch.bfloat16 else tier
        counts = SITE_PRODUCTS.setdefault(op, {})
        counts[key] = counts.get(key, 0) + 1


def count_site_grad(op: str, key: str, t: torch.Tensor) -> None:
    """Count one backward product of the plain site ``op`` in
    ``SITE_GRADS`` under ``key`` (``"dA high"``, ...) where ``t`` lies on
    the card."""
    if t.is_cuda:
        counts = SITE_GRADS.setdefault(op, {})
        counts[key] = counts.get(key, 0) + 1


def site_gemm(op: str, pieces: Sequence["Piece"], m: int, tier: str,
              plain: bool = False, **kw) -> torch.Tensor:
    """The row-wide product of the plain site ``op`` below ``"highest"``:
    :func:`gemm_epilogue` (``gemm_tc`` or ``gemm_smallk`` by its route)
    at ``tier``, or with ``plain`` its plain version; ``kw`` as
    :func:`gemm_epilogue`'s."""
    if tier == "highest":
        raise ValueError(f"the plain site {op} computes 'highest' in torch")
    count_site(op, tier, pieces[0][0])
    gemm = gemm_epilogue_plain if plain else gemm_epilogue
    return gemm(pieces, m, tier=tier, **kw)


@contextlib.contextmanager
def entry_point(name: str):
    """Attribute the kernel launches made inside the block to the entry
    point ``name`` as well (entry points nest: a level's GAB counts under
    both)."""
    if name not in ENTRY_LAUNCHES:
        raise ValueError(f"unknown entry point {name}")
    _OPEN_ENTRIES.append(name)
    try:
        yield
    finally:
        _OPEN_ENTRIES.pop()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the gastx_torch kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _libraries() -> Dict[str, Tuple[str, Tuple[str, ...]]]:
    """Every library of ``KERNEL_SOURCES``: its name -> (source, the nvcc
    flags beyond ``NVCC_FLAGS``)."""
    libs = {name: (name, ()) for name in KERNEL_SOURCES}
    libs.update({f"{name}_io": (name, IO_FLAGS) for name in IO_SOURCES
                 if name in KERNEL_SOURCES})
    for name in TIERED_SOURCES:
        libs[f"{name}_tiered"] = (name, TIERED_FLAGS)
        if name in IO_SOURCES:
            libs[f"{name}_tiered_io"] = (name, IO_FLAGS + TIERED_FLAGS)
    return libs


def _library_path(name: str) -> Path:
    source, flags = _libraries()[name]
    src = (CSRC_DIR / f"{source}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(
        NVCC_FLAGS + flags + PART_SOURCES.get(source, ())).encode()
    ).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _compile_commands(source: str, flags: Tuple[str, ...], tmp: Path
                      ) -> List[List[str]]:
    """The ``nvcc`` commands that build one library into ``tmp``: one
    command, or, for a source of ``PART_SOURCES``, one ``-c`` a part (its
    object beside ``tmp``) that ``_link_command`` links."""
    src = str(CSRC_DIR / f"{source}.cu")
    if source not in PART_SOURCES:
        return [[_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), src]]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    return [[_nvcc(), *compile_flags, *flags, part, "-c", "-o",
             f"{tmp}.part{i}.o", src]
            for i, part in enumerate(PART_SOURCES[source])]


def _link_command(source: str, tmp: Path) -> List[str]:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp)] + [f"{tmp}.part{i}.o"
                               for i in range(len(PART_SOURCES[source]))]


def build_kernels() -> Dict[str, str]:
    """Compile every library whose file is missing, one ``nvcc`` each (or
    one a part, ``PART_SOURCES``, then a link), all started together, and
    load them all. Returns the compiler output (``ptxas -v``: registers,
    shared memory, spills; and each command's seconds) of each library
    built."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        start = time.perf_counter()
        for name, (source, flags) in _libraries().items():
            lib = _library_path(name)
            if lib.exists():
                continue
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            procs[name] = ([subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for cmd in _compile_commands(source, flags, tmp)],
                source, tmp, lib)
        logs = {}
        for name, (parts, source, tmp, lib) in procs.items():
            outs = []
            for i, proc in enumerate(parts):
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {name}.cu:\n{out}")
                outs.append(f"{out}[{name} part {i}: "
                            f"{time.perf_counter() - start:.1f} s]\n")
            if source in PART_SOURCES:
                link = subprocess.run(_link_command(source, tmp),
                                      capture_output=True, text=True)
                if link.returncode != 0:
                    raise RuntimeError(f"linking {name} failed:\n"
                                       f"{link.stdout}{link.stderr}")
                for i in range(len(parts)):
                    os.remove(f"{tmp}.part{i}.o")
            os.replace(tmp, lib)
            logs[name] = "".join(outs) + (
                f"[{name}: {time.perf_counter() - start:.1f} s]\n")
        for name in _libraries():
            _lib(name)
        return logs
    finally:
        for parts, _, _, _ in procs.values():
            for proc in parts:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        path = _library_path(name)
        if not path.exists():
            build_kernels()
        lib = ctypes.CDLL(str(path))
        base = name.removesuffix("_io")
        for symbol in _SYMBOLS.get(base, (base,)):
            fn = getattr(lib, symbol)
            fn.argtypes = _ARGTYPES[symbol]
            fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def _launch(name: str, *args, tier: Optional[str] = None,
            symbol: Optional[str] = None,
            variant: Optional[str] = None, io: str = "float32",
            library: Optional[str] = None) -> None:
    """Launch kernel ``name`` through its C function ``symbol`` (default
    ``name``) of ``library`` (default ``name``); ``tier``: the tiered
    instantiation's label, for ``TIER_LAUNCHES``; ``variant``: the
    alignment instantiation (default: ``"vec16"`` where the last argument
    is 1); ``io``: the launch's ``IO_LABELS`` entry (a bf16 launch goes to
    the library's bf16-I/O form)."""
    library = library or name
    lib = _lib(library if io == "float32" else f"{library}_io")
    code = getattr(lib, symbol or name)(*args)
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.error_string(code).decode()} ({code})")
    LAUNCHES[name] += 1
    DTYPE_LAUNCHES[name][io] += 1
    if name in VARIANT_LAUNCHES:
        VARIANT_LAUNCHES[name][variant or ("vec16" if args[-1]
                                           else "general")] += 1
    if tier is not None:
        counts = TIER_LAUNCHES[name]
        counts[tier] = counts.get(tier, 0) + 1
    for entry in _OPEN_ENTRIES:
        ENTRY_LAUNCHES[entry] += 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# The dtypes an activation of the bf16-I/O kernels may have.
IO_DTYPES = (torch.float32, torch.bfloat16)


def _check(device: torch.device, dtypes=(torch.float32,), **tensors
           ) -> None:
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} must be "
                             f"{' or '.join(map(str, dtypes))}, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def io_label(inputs: Sequence[Optional[torch.Tensor]],
             out_dtype: torch.dtype) -> str:
    """The ``IO_LABELS`` entry of a launch reading ``inputs`` and writing
    ``out_dtype``."""
    b_in = any(t is not None and t.dtype == torch.bfloat16 for t in inputs)
    b_out = out_dtype == torch.bfloat16
    return IO_LABELS[int(b_in) + 2 * int(b_out)]


def _check_out_dtype(out_dtype: torch.dtype) -> None:
    if out_dtype not in IO_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")


def _dtype_bits(pieces, res, out_dtype) -> int:
    """The C functions' dtype bits (A pieces, residual, output)."""
    bits = sum(1 << p for p, (a, _, _) in enumerate(pieces)
               if a.dtype == torch.bfloat16)
    if res is not None and res.dtype == torch.bfloat16:
        bits |= _RES_BF16
    if out_dtype == torch.bfloat16:
        bits |= _OUT_BF16
    return bits


def upcast(t: torch.Tensor) -> torch.Tensor:
    """A bf16 weight (bf16 storage) as float32 before any table
    arithmetic, as the TPU kernels' ``_ensure_f32`` does; other dtypes
    as they are."""
    return t.to(torch.float32) if t.dtype == torch.bfloat16 else t


def as_table(t: torch.Tensor) -> torch.Tensor:
    """A host-folded weight table as the wrappers take it: detached,
    float32, contiguous."""
    return t.detach().to(torch.float32).contiguous()


def check_no_grad(name: str, *args) -> None:
    """Raise if grad mode is on and a tensor among ``args`` (tensors, or
    sequences and tables of them) requires a gradient: the kernels and
    their entry points are eval-only, and the train forward runs the plain
    ops instead."""
    if not torch.is_grad_enabled():
        return
    stack = list(args)
    while stack:
        a = stack.pop()
        if isinstance(a, torch.Tensor):
            if a.requires_grad:
                raise RuntimeError(
                    f"{name} has no backward: it was called with an input "
                    f"that requires a gradient while grad mode is on; run "
                    f"it under torch.no_grad() (the model's eval mode) or "
                    f"train through the plain ops")
        elif isinstance(a, (tuple, list)):
            stack.extend(a)


def use_kernel(device: torch.device) -> bool:
    """True for the kernel (a CUDA tensor), False for the plain version
    (a CPU tensor); anything else raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"gastx_torch kernels run on cuda or cpu, not {device}")


# --------------------------------------------------------------------------
# gemm_epilogue
# --------------------------------------------------------------------------

Piece = Tuple[torch.Tensor, torch.Tensor, int]


def _check_gemm(pieces, m, s_out, a_s_in, scale, shift, res, res_s_in,
                res_off):
    if not 1 <= len(pieces) <= 3:
        raise ValueError(f"gemm_epilogue takes 1 to 3 pieces, got "
                         f"{len(pieces)}")
    device = pieces[0][0].device
    n = pieces[0][1].shape[1]
    if m < 1 or s_out < 1 or m % s_out:
        raise ValueError(f"rows {m} must be a positive multiple of the "
                         f"sequence's output rows {s_out}")
    seqs = m // s_out
    for i, (a, w, off) in enumerate(pieces):
        _check(device, IO_DTYPES, **{f"a{i}": a})
        _check(device, **{f"w{i}": w})
        if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
            raise ValueError(f"piece {i}: a {tuple(a.shape)} and w "
                             f"{tuple(w.shape)} do not multiply")
        if w.shape[1] != n:
            raise ValueError(f"piece {i} has {w.shape[1]} columns, not {n}")
        if off < 0 or (seqs - 1) * a_s_in + s_out + off > a.shape[0]:
            raise ValueError(f"piece {i}: the row map reads past the "
                             f"{a.shape[0]} rows of a")
    for name, v in (("scale", scale), ("shift", shift)):
        if v is not None:
            _check(device, **{name: v})
            if v.shape != (n,):
                raise ValueError(f"{name} must be ({n},), got "
                                 f"{tuple(v.shape)}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    if res is not None:
        _check(device, IO_DTYPES, res=res)
        if (res.dim() != 2 or res.shape[1] != n or res_off < 0
                or (seqs - 1) * res_s_in + s_out + res_off > res.shape[0]):
            raise ValueError(f"residual {tuple(res.shape)} does not cover "
                             f"the row map")
    return device, n


def _row_map(m, s_out, s_in, off, device):
    r = torch.arange(m, device=device)
    return (r // s_out) * s_in + r % s_out + off


def gemm_epilogue_plain(pieces: Sequence[Piece], m: int, *,
                        s_out: Optional[int] = None,
                        a_s_in: Optional[int] = None,
                        scale=None, shift=None, relu: bool = False,
                        res=None,
                        res_s_in: Optional[int] = None,
                        res_off: int = 0,
                        tier: str = "highest",
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Plain PyTorch version of :func:`gemm_epilogue` (same arguments):
    bf16 operands upcast, each piece's product by ``precision.tiered_mm``
    at ``tier``, the output rounded to ``out_dtype``."""
    check_tier(tier)
    _check_out_dtype(out_dtype)
    s_out = m if s_out is None else s_out
    a_s_in = s_out if a_s_in is None else a_s_in
    res_s_in = s_out if res_s_in is None else res_s_in
    _check_gemm(pieces, m, s_out, a_s_in, scale, shift, res, res_s_in,
                res_off)
    check_f32_matmul(pieces[0][0])
    device = pieces[0][0].device
    acc = None
    for a, w, off in pieces:
        rows = _row_map(m, s_out, a_s_in, off, device)
        term = tiered_mm(a[rows].to(torch.float32), w, tier)
        acc = term if acc is None else acc + term
    if scale is not None:
        acc = acc * scale + shift
    if relu:
        acc = torch.relu(acc)
    if res is not None:
        acc = acc + res[_row_map(m, s_out, res_s_in, res_off,
                                 device)].to(torch.float32)
    return acc.to(out_dtype)


def gemm_epilogue(pieces: Sequence[Piece], m: int, *,
                  s_out: Optional[int] = None, a_s_in: Optional[int] = None,
                  scale=None, shift=None, relu: bool = False, res=None,
                  res_s_in: Optional[int] = None, res_off: int = 0,
                  tier: str = "highest",
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """out (m, N) = epi(sum_p A_p[in_row(r, p)] @ W_p).

    ``pieces``: up to three (a (rows, K_p), w (K_p, N), a_off). Rows are
    grouped in sequences of ``s_out`` output rows (default: one sequence
    of ``m``); output row r = s*s_out + q reads row s*a_s_in + q + a_off of
    ``a``. The epilogue applies ``scale``/``shift`` (a bias is scale 1),
    ReLU, then adds ``res`` row s*res_s_in + q + res_off. ``tier``: the
    products' precision tier (``gastx_torch.ops.precision``); on the card
    ``"highest"`` launches the float32 ``gemm_epilogue`` kernel and every
    other tier ``gemm_tc``, each W split here into its bf16 halves (laid
    out by :func:`tc_weights` for the ``wgmma`` instantiations), except
    where :func:`smallk_ok` holds: then every tier launches
    ``gemm_smallk``, W as it is.
    Each A piece and ``res`` may be float32 or bf16, and the output is
    ``out_dtype`` (float32 or bf16); W, scale and shift are float32.
    """
    check_no_grad("gemm_epilogue", pieces, scale, shift, res)
    check_tier(tier)
    _check_out_dtype(out_dtype)
    s_out = m if s_out is None else s_out
    a_s_in = s_out if a_s_in is None else a_s_in
    res_s_in = s_out if res_s_in is None else res_s_in
    device, n = _check_gemm(pieces, m, s_out, a_s_in, scale, shift, res,
                            res_s_in, res_off)
    if not use_kernel(device):
        return gemm_epilogue_plain(
            pieces, m, s_out=s_out, a_s_in=a_s_in, scale=scale, shift=shift,
            relu=relu, res=res, res_s_in=res_s_in, res_off=res_off,
            tier=tier, out_dtype=out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=device)
    kernel, variant = gemm_route(pieces, n, res, out_dtype, tier)
    if kernel == "gemm_smallk":
        _gemm_smallk(pieces, m, n, s_out, a_s_in, res_s_in, scale, shift,
                     relu, res, res_off, out, tier)
        return out
    io = io_label([a for a, _, _ in pieces] + [res], out_dtype)
    if kernel == "gemm_tc":
        _gemm_tc(pieces, m, n, s_out, a_s_in, res_s_in, scale, shift, relu,
                 res, res_off, out, tier, io, variant)
        return out
    _launch("gemm_epilogue", *_flat_pieces(pieces), len(pieces), m, n,
            s_out, a_s_in, res_s_in, _ptr(scale), _ptr(shift), int(relu),
            _ptr(res), res_off, out.data_ptr(), _stream(),
            _dtype_bits(pieces, res, out_dtype), int(variant == "vec16"),
            io=io)
    return out


def gemm_route(pieces: Sequence[Piece], n: int,
               res: Optional[torch.Tensor],
               out_dtype: torch.dtype = torch.float32,
               tier: str = "highest") -> Tuple[str, str]:
    """(kernel, instantiation) that :func:`gemm_epilogue` launches on the
    card for these operands at ``tier``: ``gemm_epilogue`` on
    :func:`gemm_variant`'s at ``"highest"``, ``gemm_tc`` on
    :func:`tc_variant`'s below it, and ``gemm_smallk`` where either says
    ``"smallk"``. The wrapper and the launch checks read it."""
    if tier == "highest":
        kernel, variant = "gemm_epilogue", gemm_variant(pieces, n, res,
                                                         out_dtype)
    else:
        kernel, variant = "gemm_tc", tc_variant(pieces, n, res, out_dtype)
    return ("gemm_smallk" if variant == "smallk" else kernel), variant


def _flat_pieces(pieces) -> list:
    """(a, w, K_p, a_off) of each of the three piece slots, None and 0 in
    the slots past ``pieces``: the C functions' first twelve arguments."""
    flat = []
    for i in range(3):
        if i < len(pieces):
            a, w, off = pieces[i]
            flat += [a.data_ptr(), w.data_ptr(), a.shape[1], off]
        else:
            flat += [None, None, 0, 0]
    return flat


def _gemm_smallk(pieces, m, n, s_out, a_s_in, res_s_in, scale, shift,
                 relu, res, res_off, out, tier) -> None:
    """Launch ``gemm_smallk`` at ``tier`` into ``out`` (the operands meet
    :func:`smallk_ok`)."""
    label = "default" if tier == "kdefault" else tier
    _launch("gemm_smallk", *_flat_pieces(pieces), len(pieces), m, n, s_out,
            a_s_in, res_s_in, _ptr(scale), _ptr(shift), int(relu),
            _ptr(res), res_off, out.data_ptr(), _stream(),
            ATTN_TIERS.index(label), tier=label, variant="smallk")


def smallk_ok(pieces: Sequence[Piece], n: int,
              res: Optional[torch.Tensor],
              out_dtype: torch.dtype = torch.float32) -> bool:
    """``gemm_smallk``'s shape rule, the same as its C entry point's: every
    A piece, the residual and the output float32, the sum of K_p from 1 to
    ``SMALLK_MAX_K``, N a multiple of 4, the residual 16-byte aligned (the
    output is a fresh tensor, so it is too). W may lie anywhere."""
    tensors = [a for a, _, _ in pieces] + ([] if res is None else [res])
    return (out_dtype == torch.float32
            and all(t.dtype == torch.float32 for t in tensors)
            and 1 <= sum(a.shape[1] for a, _, _ in pieces) <= SMALLK_MAX_K
            and n % 4 == 0
            and (res is None or res.data_ptr() % 16 == 0))


def _gemm_tc(pieces, m, n, s_out, a_s_in, res_s_in, scale, shift, relu,
             res, res_off, out, tier, io, variant) -> None:
    """Launch ``gemm_tc`` at ``tier`` into ``out``, on ``variant`` (what
    :func:`tc_variant` picks); W's lo half is made and passed only where
    the tier multiplies it (``"high"``, ``"high_rhs"``)."""
    tc = "default" if tier == "kdefault" else tier
    lo = tc in ("high", "high_rhs")
    tail = [m, n, s_out, a_s_in, res_s_in, _ptr(scale), _ptr(shift),
            int(relu), _ptr(res), res_off, out.data_ptr(), _stream(),
            TC_TIERS.index(tc)]
    dtypes = _dtype_bits(pieces, res, out.dtype)
    if variant != "general":
        hi, lo_t = tc_weights(pieces, lo)
        flat = []
        for i in range(3):
            if i < len(pieces):
                a, _, off = pieces[i]
                flat += [a.data_ptr(), a.shape[1], a.shape[0], off]
            else:
                flat += [None, 0, 0, 0]
        _launch("gemm_tc", *flat, len(pieces), hi.data_ptr(), _ptr(lo_t),
                hi.shape[1], *tail, dtypes, tier=tc, symbol="gemm_tc_hopper",
                variant=variant, io=io)
        return
    flat, halves = [], []
    for i in range(3):
        if i < len(pieces):
            a, w, off = pieces[i]
            hi, lo_t = split_bf16(w)
            halves.append((hi, lo_t))
            flat += [a.data_ptr(), hi.data_ptr(),
                     lo_t.data_ptr() if lo else None, a.shape[1], off]
        else:
            flat += [None, None, None, 0, 0]
    _launch("gemm_tc", *flat, len(pieces), *tail, dtypes, tier=tc,
            variant="general", io=io)


def tc_variant(pieces: Sequence[Piece], n: int,
               res: Optional[torch.Tensor],
               out_dtype: torch.dtype = torch.float32) -> str:
    """The instantiation of ``gemm_tc`` for these operands: the ``wgmma``
    kernel (TMA or 16-byte row gathers of A, TMA of W's halves, TMA
    stores of the output) when every float32 K_p is a multiple of 4, every
    bf16 K_p of 8 (16-byte rows), N of 8, and every a_p and ``res`` start
    16-byte aligned (W's halves and the output are fresh tensors):
    ``"vec16"`` where every activation and the output are float32,
    ``"vec16_bf16"`` (its bf16 TMA boxes, in the bf16-I/O library) where
    any is bf16; else ``"general"``. Where :func:`smallk_ok` holds,
    ``"smallk"``: the wrapper launches ``gemm_smallk`` instead."""
    if smallk_ok(pieces, n, res, out_dtype):
        return "smallk"
    tensors = [a for a, _, _ in pieces] + ([] if res is None else [res])
    if not (n % 8 == 0
            and all(a.shape[1] % (8 if a.dtype == torch.bfloat16 else 4)
                    == 0 for a, _, _ in pieces)
            and all(t.data_ptr() % 16 == 0 for t in tensors)):
        return "general"
    if (out_dtype == torch.bfloat16
            or any(t.dtype == torch.bfloat16 for t in tensors)):
        return "vec16_bf16"
    return "vec16"


# The k of a slab of the wgmma gemm_tc (gemm_tc.cu, hopper::BK).
TC_BK = 32
# The k order of W within every 16 k of a float32 piece's slabs: column l
# of W^T holds W's row TC_K_ORDER[l], so that the four k of a thread's
# wgmma fragment (l = 2c, 2c+1, 2c+8, 2c+9) are A's k 4c .. 4c+3, one
# float4 in shared memory.
TC_K_ORDER = (0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15)
# The same within every 32 k of a bf16 piece's slabs: a thread's fragments
# of both k16 steps (l = 16j + 2c, +1, +8, +9 for j = 0, 1) are A's k
# 8c .. 8c+7, one 16-byte load of a bf16 row.
TC_K_ORDER_BF16 = tuple(
    8 * ((l % 16 % 8) // 2) + 4 * (l // 16) + 2 * (l % 16 // 8) + l % 2
    for l in range(32))
_TC_INDEX: Dict[Tuple[Tuple[int, ...], Tuple[bool, ...], str],
                torch.Tensor] = {}


def tc_weight_index(ks: Sequence[int], device,
                    bf16: Sequence[bool] = ()) -> torch.Tensor:
    """For each k column of the wgmma ``gemm_tc``'s W^T, the row of
    ``[W_0; W_1; W_2; 0]`` (pieces of K_p rows, then one zero row) it
    holds: piece p's columns padded with the zero row to a multiple of
    ``TC_BK``, every 16 in ``TC_K_ORDER``, or every 32 in
    ``TC_K_ORDER_BF16`` where ``bf16[p]`` (piece p's A is bf16; missing
    entries are float32). Cached per (ks, bf16, device)."""
    flags = tuple(bool(f) for f in bf16)
    flags += (False,) * (len(ks) - len(flags))
    key = (tuple(ks), flags, str(device))
    if key not in _TC_INDEX:
        idx, base, zero = [], 0, sum(ks)
        for k, bf in zip(ks, flags):
            for q in range(-(-k // TC_BK) * TC_BK):
                src = (q - q % TC_BK + TC_K_ORDER_BF16[q % TC_BK] if bf
                       else q - q % 16 + TC_K_ORDER[q % 16])
                idx.append(base + src if src < k else zero)
            base += k
        _TC_INDEX[key] = torch.tensor(idx, dtype=torch.long, device=device)
    return _TC_INDEX[key]


def tc_weights(pieces: Sequence[Piece], lo: bool
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """W of every piece as the wgmma ``gemm_tc`` reads it: the bf16 halves
    (hi, and lo where ``lo``, else None) of W^T, (N, K_pad) K-major, its
    columns by :func:`tc_weight_index` for the pieces' A dtypes."""
    ws = [w for _, w, _ in pieces]
    stacked = torch.cat(ws + [ws[0].new_zeros(1, ws[0].shape[1])])
    wt = stacked.t().index_select(1, tc_weight_index(
        [w.shape[0] for w in ws], stacked.device,
        [a.dtype == torch.bfloat16 for a, _, _ in pieces]))
    if not lo:
        return wt.to(torch.bfloat16), None
    return split_bf16(wt)


def gemm_variant(pieces: Sequence[Piece], n: int,
                 res: Optional[torch.Tensor],
                 out_dtype: torch.dtype = torch.float32) -> str:
    """The instantiation of ``gemm_epilogue`` for these operands:
    ``"smallk"`` where :func:`smallk_ok` holds (the wrapper launches
    ``gemm_smallk`` instead), else ``"vec16"`` (16-byte loads, copies and
    epilogue) when every K_p and N are multiples of 4 and every a_p, w_p
    and ``res`` starts 16-byte aligned (then so does every row, with its
    offset a_off * K_p, and the fresh output), else ``"general"``."""
    if smallk_ok(pieces, n, res, out_dtype):
        return "smallk"
    ptrs = [t.data_ptr() for a, w, _ in pieces for t in (a, w)]
    if res is not None:
        ptrs.append(res.data_ptr())
    if (n % 4 == 0 and all(a.shape[1] % 4 == 0 for a, _, _ in pieces)
            and all(p % 16 == 0 for p in ptrs)):
        return "vec16"
    return "general"


def graph_variant(views: Sequence[torch.Tensor], widths: Sequence[int]
                  ) -> str:
    """The instantiation of ``sem_graph`` (views ``(p,)``, widths
    ``(C,)``) or ``joint_attention`` (``(theta, phi, g)``, ``(I, G)``) for
    these operands: ``"vec16"`` (16-byte copies, loads and stores) when
    every width and every view's row stride are multiples of 4 and every
    view starts 16-byte aligned (then so does every row and column group
    the kernel reads, and the fresh output), else ``"general"``."""
    if (all(w % 4 == 0 for w in widths)
            and all(v.stride(0) % 4 == 0 and v.data_ptr() % 16 == 0
                    for v in views)):
        return "vec16"
    return "general"


# --------------------------------------------------------------------------
# gemm_wgrad
# --------------------------------------------------------------------------

# gemm_wgrad.cu's general tile (rows of dW, columns) and its slab of rows
# (every instantiation's rows a split are a multiple of it).
WGRAD_TILE = 64
WGRAD_ROWS = 32
# The wgmma instantiation's tile: rows of dW (the pieces' K, each padded to
# WGRAD_PAD), and the widths it is built for (the narrowest that holds N).
WGRAD_TC_ROWS = 128
WGRAD_PAD = 32
WGRAD_TC_WIDTHS = (64, 128, 256)
# ... and the rows of a gathered A block in shared memory (the runs of the
# row map that one slab of WGRAD_ROWS rows may meet, wgrad_gather_rows).
WGRAD_GATHER_ROWS = 64
# The smallk instantiation's shape rule: sum K_p at most this, N a multiple
# of 4 up to WGRAD_SMALLK_MAX_N.
WGRAD_SMALLK_MAX_K = 16
WGRAD_SMALLK_MAX_N = 1024
# The row split of each instantiation (wgrad_splits): the blocks an SM a
# launch aims at, and the fewest rows a split sums.
WGRAD_SPLIT_RULES = {"general": (4, 512), "wgmma": (1, 256),
                     "smallk": (2, 512)}
# A piece of the weight gradient: (a (rows, K_p), a_off).
WPiece = Tuple[torch.Tensor, int]


def _check_wgrad(pieces, g, m, s_out, a_s_in, tier):
    if not 1 <= len(pieces) <= 3:
        raise ValueError(f"gemm_wgrad takes 1 to 3 pieces, got "
                         f"{len(pieces)}")
    if tier not in WGRAD_TIERS:
        raise ValueError(f"gemm_wgrad computes the tiers {WGRAD_TIERS}, not "
                         f"{tier!r} ('highest' is a float32 torch product)")
    device = g.device
    _check(device, g=g)
    if g.dim() != 2 or g.shape[0] != m:
        raise ValueError(f"g must be ({m}, N), got {tuple(g.shape)}")
    if m < 1 or s_out < 1 or m % s_out:
        raise ValueError(f"rows {m} must be a positive multiple of the "
                         f"sequence's rows {s_out}")
    seqs = m // s_out
    for i, (a, off) in enumerate(pieces):
        _check(device, **{f"a{i}": a})
        if a.dim() != 2 or a.shape[1] < 1:
            raise ValueError(f"piece {i}: a must be (rows, K), got "
                             f"{tuple(a.shape)}")
        if off < 0 or (seqs - 1) * a_s_in + s_out + off > a.shape[0]:
            raise ValueError(f"piece {i}: the row map reads past the "
                             f"{a.shape[0]} rows of a")
    return device


def wgrad_splits(m: int, tiles: int, sms: int,
                 variant: str = "general") -> Tuple[int, int]:
    """(splits, rows a split) of a ``gemm_wgrad`` launch of ``variant``'s
    ``tiles`` output tiles over ``m`` rows on ``sms`` SMs: as many splits
    as its ``WGRAD_SPLIT_RULES`` blocks an SM hold whole tiles' blocks (one
    wave), at least its fewest rows a split, each split a multiple of
    ``WGRAD_ROWS`` rows and none empty. A function of the shape alone, so a
    launch sums in the same order on every run."""
    per_sm, min_rows = WGRAD_SPLIT_RULES[variant]
    splits = max(1, min(per_sm * sms // tiles, m // min_rows))
    chunk = -(-m // splits)
    chunk = -(-chunk // WGRAD_ROWS) * WGRAD_ROWS
    return -(-m // chunk), chunk


def wgrad_gather_rows(s_out: int) -> int:
    """The rows of a gathered A block that the wgmma instantiation stages
    for a slab of ``WGRAD_ROWS`` rows over runs of ``s_out`` rows: the
    most runs it can meet, min(s_out, 32) rows each (gemm_wgrad.cu's
    ``gather_rows``)."""
    box = min(s_out, 32)
    return box * -(-(s_out - 1 + WGRAD_ROWS) // s_out)


def wgrad_route(pieces: Sequence[WPiece], g: torch.Tensor,
                s_out: Optional[int] = None,
                a_s_in: Optional[int] = None) -> str:
    """The instantiation of ``gemm_wgrad`` for these operands and row map
    (its C entry points check the same rule): ``"smallk"`` where the sum
    of K_p is at most ``WGRAD_SMALLK_MAX_K`` and N a multiple of 4 up to
    ``WGRAD_SMALLK_MAX_N`` with G 16-byte aligned (the expand conv's K = 2
    taps); else ``"wgmma"`` where every K_p and N are multiples of 8,
    every a_p and G start 16-byte aligned (then so does every row) and,
    for a row map of runs (``s_out != a_s_in``: the conv taps), a slab's
    runs fit ``WGRAD_GATHER_ROWS`` (:func:`wgrad_gather_rows`: runs of up
    to 21 rows, the 15-19 joint layouts' strided taps among them, and of
    31 rows or more); else ``"general"``."""
    n = g.shape[1]
    ks = [a.shape[1] for a, _ in pieces]
    g_ok = g.data_ptr() % 16 == 0
    if (sum(ks) <= WGRAD_SMALLK_MAX_K and n % 4 == 0
            and n <= WGRAD_SMALLK_MAX_N and g_ok):
        return "smallk"
    runs_ok = (s_out is None or a_s_in in (None, s_out)
               or wgrad_gather_rows(s_out) <= WGRAD_GATHER_ROWS)
    if (n % 8 == 0 and all(k % 8 == 0 for k in ks) and g_ok and runs_ok
            and all(a.data_ptr() % 16 == 0 for a, _ in pieces)):
        return "wgmma"
    return "general"


def wgrad_tiles(ks: Sequence[int], n: int, variant: str
                ) -> Tuple[int, int]:
    """(output tiles, tile width) of a ``gemm_wgrad`` launch of
    ``variant`` on pieces of ``ks`` rows of dW and N columns: the general
    kernel's 64 x 64 tiles a piece; the wgmma kernel's WGRAD_TC_ROWS rows
    of the padded K (every piece padded to WGRAD_PAD) by the narrowest of
    WGRAD_TC_WIDTHS that holds N (else 256); the smallk kernel's one."""
    if variant == "smallk":
        return 1, n
    if variant == "general":
        return (sum(-(-k // WGRAD_TILE) for k in ks) * -(-n // WGRAD_TILE),
                WGRAD_TILE)
    width = next((w for w in WGRAD_TC_WIDTHS if n <= w), WGRAD_TC_WIDTHS[-1])
    pad = sum(-(-k // WGRAD_PAD) * WGRAD_PAD for k in ks)
    return -(-pad // WGRAD_TC_ROWS) * -(-n // width), width


def gemm_wgrad_plain(pieces: Sequence[WPiece], g: torch.Tensor, m: int, *,
                     s_out: Optional[int] = None,
                     a_s_in: Optional[int] = None,
                     tier: str = "high") -> torch.Tensor:
    """Plain PyTorch version of :func:`gemm_wgrad` (same arguments): each
    piece's rows gathered by the row map, ``A_p^T G`` by
    ``precision.tiered_mm`` at ``tier`` (float32 matmuls of bf16-valued
    operands), the pieces' rows stacked."""
    s_out = m if s_out is None else s_out
    a_s_in = s_out if a_s_in is None else a_s_in
    _check_wgrad(pieces, g, m, s_out, a_s_in, tier)
    check_f32_matmul(g)
    return torch.cat([
        tiered_mm(a[_row_map(m, s_out, a_s_in, off, g.device)].t(), g, tier)
        for a, off in pieces])


def gemm_wgrad(pieces: Sequence[WPiece], g: torch.Tensor, m: int, *,
               s_out: Optional[int] = None, a_s_in: Optional[int] = None,
               tier: str = "high") -> torch.Tensor:
    """dW (sum_p K_p, N) = [A_0^T G; A_1^T G; ...] at ``tier``.

    ``pieces``: up to three (a (rows, K_p), a_off); ``g`` (m, N). Row m of
    the product reads row (m // s_out) * a_s_in + m % s_out + a_off of
    ``a`` (as :func:`gemm_epilogue`'s row map; default one sequence of
    ``m``). ``tier``: ``"default"`` (one bf16 pass) or ``"high"`` (three),
    both operands split by ``precision.split_bf16``; any other tier raises.
    Every tensor float32 and contiguous; K_p and N any size. On the card
    one call of the C function of :func:`wgrad_route`'s instantiation: its
    tile kernel over the rows split :func:`wgrad_splits` ways into a
    workspace allocated here, then the fixed-order sum of its slices."""
    check_no_grad("gemm_wgrad", pieces, g)
    s_out = m if s_out is None else s_out
    a_s_in = s_out if a_s_in is None else a_s_in
    device = _check_wgrad(pieces, g, m, s_out, a_s_in, tier)
    if not use_kernel(device):
        return gemm_wgrad_plain(pieces, g, m, s_out=s_out, a_s_in=a_s_in,
                                tier=tier)
    n = g.shape[1]
    ks = [a.shape[1] for a, _ in pieces]
    variant = wgrad_route(pieces, g, s_out, a_s_in)
    tiles, width = wgrad_tiles(ks, n, variant)
    splits, chunk = wgrad_splits(
        m, tiles, torch.cuda.get_device_properties(device)
        .multi_processor_count, variant)
    out = torch.empty((sum(ks), n), dtype=torch.float32, device=device)
    ws = (torch.empty((splits, sum(ks), n), dtype=torch.float32,
                      device=device) if splits > 1 else None)
    tail = [len(pieces), g.data_ptr(), m, n, s_out, a_s_in, _ptr(ws),
            splits, chunk, out.data_ptr(), _stream(), TC_TIERS.index(tier)]
    flat = []
    for i in range(3):
        if i < len(pieces):
            a, off = pieces[i]
            flat += ([a.data_ptr(), a.shape[1], a.shape[0], off]
                     if variant == "wgmma" else
                     [a.data_ptr(), a.shape[1], off])
        else:
            flat += [None, 0, 0, 0] if variant == "wgmma" else [None, 0, 0]
    if variant == "wgmma":
        tail.append(width)
    symbol = {"wgmma": "gemm_wgrad_hopper",
              "smallk": "gemm_wgrad_smallk"}.get(variant, "gemm_wgrad")
    _launch("gemm_wgrad", *flat, *tail, tier=tier, symbol=symbol,
            variant=variant)
    return out


# --------------------------------------------------------------------------
# sem_graph
# --------------------------------------------------------------------------

def _check_sem(p, c, w_self, w_nbr, col, scale, shift):
    device = p.device
    _check(device, w_self=w_self, w_nbr=w_nbr, scale=scale, shift=shift)
    if p.dtype != torch.float32 or p.dim() != 2 or p.stride(1) != 1:
        raise ValueError("p must be a float32 (rows, ld) matrix with unit "
                         "column stride")
    _, j, d = col.shape
    if (col.device != device or col.dtype != torch.int32
            or not col.is_contiguous() or col.shape != (2, j, d)):
        raise ValueError("col must be a contiguous int32 (2, J, D) table")
    if w_self.shape != (2, j, c) or w_nbr.shape != (2, j, d, c):
        raise ValueError("w_self/w_nbr must be (2, J, C)/(2, J, D, C)")
    if scale.shape != (2 * c,) or shift.shape != (2 * c,):
        raise ValueError(f"scale/shift must be ({2 * c},)")
    if p.shape[1] < 4 * c or p.shape[0] % j:
        raise ValueError(f"p {tuple(p.shape)} must hold whole frames of "
                         f"{j} rows and at least {4 * c} columns")
    if j > MAX_JOINTS or d > MAX_SLOTS:
        raise ValueError(f"sem_graph takes J <= {MAX_JOINTS} joints and D <= "
                         f"{MAX_SLOTS} neighbour slots, got J={j}, D={d}")
    return device, j, d


def sem_graph_plain(p, c, w_self, w_nbr, col, scale, shift):
    """Plain PyTorch version of :func:`sem_graph` (same arguments)."""
    _, j, _ = _check_sem(p, c, w_self, w_nbr, col, scale, shift)
    frames = p.shape[0] // j
    outs = []
    for b in range(2):
        h0 = p[:, 2 * b * c:2 * b * c + c].reshape(frames, j, c)
        h1 = p[:, 2 * b * c + c:2 * b * c + 2 * c].reshape(frames, j, c)
        nbr = h1[:, col[b].long(), :] * w_nbr[b]          # (F, J, D, C)
        outs.append(h0 * w_self[b] + nbr.sum(dim=2))
    out = torch.cat(outs, dim=-1).reshape(frames * j, 2 * c)
    return torch.relu(out * scale + shift)


def sem_graph(p: torch.Tensor, c: int, w_self, w_nbr, col, scale,
              shift) -> torch.Tensor:
    """Local-branch aggregation of both semantic graph convs.

    ``p``: (rows, ld) projection output whose columns [0, 4C) are
    [W0_sym | W1_sym | W0_con | W1_con] (any row stride, unit column
    stride). Tables: ``w_self`` (2, J, C), ``w_nbr`` (2, J, D, C), ``col``
    (2, J, D) int32 with entries in [0, J) (``gab_tables`` checks them on
    the host), ``scale``/``shift`` (2C,) — branch 0 sym, 1 con; J <= 32,
    D <= 8. Returns relu(BN([sym | con])) as (rows, 2C).
    """
    check_no_grad("sem_graph", p, w_self, w_nbr, scale, shift)
    device, j, d = _check_sem(p, c, w_self, w_nbr, col, scale, shift)
    if not use_kernel(device):
        return sem_graph_plain(p, c, w_self, w_nbr, col, scale, shift)
    rows = p.shape[0]
    out = torch.empty((rows, 2 * c), dtype=torch.float32, device=device)
    _launch("sem_graph", p.data_ptr(), p.stride(0), out.data_ptr(), rows, j,
            c, d, w_self.data_ptr(), w_nbr.data_ptr(), col.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), _stream(),
            int(graph_variant((p,), (c,)) == "vec16"))
    return out


# --------------------------------------------------------------------------
# joint_attention
# --------------------------------------------------------------------------

def _check_attn(theta, phi, g, proj_t, proj_p, c_k):
    device = theta.device
    _check(device, proj_t=proj_t, proj_p=proj_p, c_k=c_k)
    k, inter = proj_t.shape
    j = c_k.shape[1]
    for name, t in (("theta", theta), ("phi", phi), ("g", g)):
        if (t.device != device or t.dtype != torch.float32 or t.dim() != 2
                or t.stride(1) != 1 or t.stride(0) != theta.stride(0)
                or t.shape[0] != theta.shape[0]):
            raise ValueError(f"{name} must be a float32 (rows, width) view "
                             f"sharing theta's rows and row stride")
    if theta.shape[1] != k * inter or phi.shape[1] != k * inter:
        raise ValueError("theta/phi must hold K*I columns")
    if proj_p.shape != (k, inter) or c_k.shape != (k, j, j):
        raise ValueError("proj_p must be (K, I) and c_k (K, J, J)")
    if g.shape[1] % k or theta.shape[0] % j or j > MAX_JOINTS:
        raise ValueError(f"g must hold K*G columns, rows whole frames of "
                         f"J <= {MAX_JOINTS} joints")
    return device, k, inter, j, g.shape[1] // k


def _dot_last(a, b):
    return (a * b).sum(-1)


def joint_attention_plain(theta, phi, g, proj_t, proj_p, c_k, *,
                          score_tier: str = "highest",
                          apply_tier: str = "highest"):
    """Plain PyTorch version of :func:`joint_attention`: the score dots
    (theta/phi by proj_t/proj_p) at ``score_tier`` and the apply dots
    (softmax + C_k by g) at ``apply_tier``, by ``precision.tiered``."""
    _, k, inter, j, g_ch = _check_attn(theta, phi, g, proj_t, proj_p, c_k)
    check_tier(score_tier)
    check_tier(apply_tier)
    check_f32_matmul(theta)
    frames = theta.shape[0] // j
    sa = tiered(_dot_last, theta.reshape(frames, j, k, inter), proj_t,
                score_tier)                                     # (F, J, K)
    sb = tiered(_dot_last, phi.reshape(frames, j, k, inter), proj_p,
                score_tier)
    sa, sb = sa.transpose(1, 2), sb.transpose(1, 2)             # (F, K, J)
    f = F.leaky_relu(sa[..., :, None] + sb[..., None, :], 0.2)
    attn = torch.softmax(f, dim=-1) + c_k                       # (F,K,J,J)
    gk = g.reshape(frames, j, k, g_ch).transpose(1, 2)          # (F,K,J,G)
    out = tiered_mm(attn, gk, apply_tier).transpose(1, 2)       # (F,J,K,G)
    return out.reshape(frames * j, k * g_ch)


def attn_instantiation(score_tier: str, apply_tier: str) -> str:
    """The instantiation of ``joint_attention.cu`` that a tier pair
    launches (its C function picks the same, ``pick``): ``"float32"``;
    ``"tiered score"`` (a tiered score, the float32 apply); a pair of
    ``ATTN_OWN_PAIRS`` by name; ``"runtime tiers"`` for every other pair
    (the tensor-core apply on runtime tier codes)."""
    pair = tuple("default" if t == "kdefault" else t
                 for t in (score_tier, apply_tier))
    for t in pair:
        check_tier(t)
    if pair[1] == "highest":
        return "float32" if pair[0] == "highest" else "tiered score"
    return "/".join(pair) if pair in ATTN_OWN_PAIRS else "runtime tiers"


def joint_attention(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor,
                    proj_t, proj_p, c_k, *, score_tier: str = "highest",
                    apply_tier: str = "highest") -> torch.Tensor:
    """Per-frame multi-head attention over the joints.

    ``theta``/``phi`` (rows, K*I) and ``g`` (rows, K*G): column views of
    one projection output (same row stride). ``proj_t``/``proj_p`` (K, I)
    rank-1 score vectors, ``c_k`` (K, J, J) additive attention biases.
    Returns the head-major (rows, K*G) head outputs. ``score_tier`` and
    ``apply_tier``: the tiers of the score and apply dots; the kernel
    rounds the score's operands as it loads them, and runs the apply
    below ``"highest"`` as the tier's bf16 passes on the tensor cores,
    each summing in float32.
    """
    check_no_grad("joint_attention", theta, phi, g, proj_t, proj_p, c_k)
    device, k, inter, j, g_ch = _check_attn(theta, phi, g, proj_t, proj_p,
                                            c_k)
    check_tier(score_tier)
    check_tier(apply_tier)
    if not use_kernel(device):
        return joint_attention_plain(theta, phi, g, proj_t, proj_p, c_k,
                                     score_tier=score_tier,
                                     apply_tier=apply_tier)
    codes = [ATTN_TIERS.index("default" if t == "kdefault" else t)
             for t in (score_tier, apply_tier)]
    rows = theta.shape[0]
    out = torch.empty((rows, k * g_ch), dtype=torch.float32, device=device)
    _launch("joint_attention", theta.data_ptr(), phi.data_ptr(),
            g.data_ptr(), theta.stride(0), proj_t.data_ptr(),
            proj_p.data_ptr(), c_k.data_ptr(), out.data_ptr(), rows // j, j,
            inter, g_ch, k, _stream(), *codes,
            int(graph_variant((theta, phi, g), (inter, g_ch)) == "vec16"),
            tier=(None if codes == [0, 0] else
                  "/".join(ATTN_TIERS[c] for c in codes)))
    return out


# --------------------------------------------------------------------------
# The chains: the GAB and its two branches through the kernels above
# --------------------------------------------------------------------------

def _tier(tiers: Optional[Dict[str, str]], op: str) -> dict:
    """The ``tier`` keyword of one product, none without ``tiers`` (so the
    chains also take functions with no tier argument)."""
    return {} if tiers is None else {"tier": tiers[op]}


def _attn_tiers(tiers: Optional[Dict[str, str]]) -> dict:
    return {} if tiers is None else {"score_tier": tiers["attn_score"],
                                     "apply_tier": tiers["attn_apply"]}


def local_chain(x: torch.Tensor, t, gemm, sem, p=None,
                tiers: Optional[Dict[str, str]] = None) -> torch.Tensor:
    """Steps 1-3 of the GAB chain, the eval local branch: (rows, C) ->
    (rows, C). ``p`` is a projection output whose first 4C columns are
    [W0_sym | W1_sym | W0_con | W1_con] (the GAB chain's); without it,
    step 1 projects x onto ``t.w_sem``. ``t`` is a ``fused_gab.
    LocalTables`` or ``GabTables``; ``gemm``/``sem`` the kernels or their
    plain versions; ``tiers`` ({op_class: tier}, None: all ``"highest"``)
    gives the products' tiers, ``local_sem`` and ``local_cat``."""
    rows, c = x.shape
    if p is None:
        p = gemm([(x, t.w_sem, 0)], rows, **_tier(tiers, "local_sem"))
    ab = sem(p, c, t.w_self, t.w_nbr, t.col, t.sem_scale, t.sem_shift)
    return gemm([(ab, t.lcat_w, 0)], rows, scale=t.lcat_scale,
                shift=t.lcat_shift, relu=True, **_tier(tiers, "local_cat"))


def global_chain(x: torch.Tensor, t, gemm, attn, p=None,
                 tiers: Optional[Dict[str, str]] = None) -> torch.Tensor:
    """Steps 1, 4 and 5 of the GAB chain, the eval multi-head global
    branch with its cat, BN and ReLU: (rows, C) -> (rows, C). ``p`` is a
    (rows, 2KI + KG) view [theta | phi | g] of a projection output (the
    GAB chain's); without it, step 1 projects x onto ``t.w_attn`` plus
    its biases. ``t`` is a ``global_attn.GlobalTables`` or ``fused_gab.
    GabTables``; ``tiers``: ``attn_proj``, ``attn_score``, ``attn_apply``
    and ``attn_cat``."""
    rows = x.shape[0]
    ki = t.proj_t.numel()
    if p is None:
        p = gemm([(x, t.w_attn, 0)], rows, scale=t.attn_scale,
                 shift=t.attn_shift, **_tier(tiers, "attn_proj"))
    heads = attn(p[:, :ki], p[:, ki:2 * ki], p[:, 2 * ki:], t.proj_t,
                 t.proj_p, t.c_k, **_attn_tiers(tiers))
    return gemm([(heads, t.acat_w, 0)], rows, scale=t.acat_scale,
                shift=t.acat_shift, relu=True, **_tier(tiers, "attn_cat"))


def _proj_launches(t, c: int, tiers: Optional[Dict[str, str]]) -> list:
    """The GAB projection's launches: (first column, end column, tier
    keyword) of each, its column groups merged where their tiers agree.
    The groups are the 4C sem columns (``local_sem``) and the attention
    columns (``attn_proj``); in the fold form the score columns sa | sb
    (``attn_score``, merged with a neighbour whose tier runs the same
    instantiation, ``"kdefault"`` as ``"default"``) before g."""
    n = t.w_proj.shape[1]
    fold = t.form == "fold"
    if not fold:
        groups = [(0, 4 * c, _tier(tiers, "local_sem")),
                  (4 * c, n, _tier(tiers, "attn_proj"))]
    else:
        ks = 4 * c + 2 * t.proj_t.shape[0]
        groups = [(0, 4 * c, _tier(tiers, "local_sem")),
                  (4 * c, ks, _tier(tiers, "attn_score")),
                  (ks, n, _tier(tiers, "attn_proj"))]

    def key(tier: dict) -> dict:
        return {k: "default" if fold and v == "kdefault" else v
                for k, v in tier.items()}

    launches = [groups[0]]
    for g in groups[1:]:
        if key(launches[-1][2]) == key(g[2]):
            launches[-1] = (launches[-1][0], g[1], launches[-1][2])
        else:
            launches.append(g)
    return launches


def gab_chain(x: torch.Tensor, t, gemm, sem, attn,
              tiers: Optional[Dict[str, str]] = None,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The eval GAB on (rows, C) activations through the given GEMM, graph
    and attention functions (the kernels, or their plain versions); ``t``
    is a ``fused_gab.GabTables``, ``tiers`` the {op_class: tier} of
    ``fused_gab.KERNEL_OPS`` (None: all ``"highest"``). One projection
    feeds both branches: one launch over its 7C columns where
    ``local_sem`` and ``attn_proj`` share a tier, else one launch a tier
    (:func:`_proj_launches`), each into an output of its own
    (``sem_graph`` and ``joint_attention`` read any row stride, so
    nothing is copied; x is read once a launch). In the fold form
    (``t.form == "fold"``) the attention columns are [sa | sb | g], the
    scores already projected, so ``joint_attention`` runs at I = 1 with
    unit score vectors and its score dot at ``"highest"``; where sa | sb
    and g come from two launches they are joined into one output.
    ``x`` may be bf16 (read by the projection and the block concat), and
    the block's output is ``out_dtype``; every intermediate is float32."""
    rows, c = x.shape
    outs = []
    for lo, hi, tier in _proj_launches(t, c, tiers):
        whole = (lo, hi) == (0, t.w_proj.shape[1])
        w = t.w_proj if whole else t.w_proj[:, lo:hi].contiguous()
        if lo == 0 and hi == 4 * c:  # the sem shift is zero: no epilogue
            outs.append((lo, gemm([(x, w, 0)], rows, **tier)))
        else:
            outs.append((lo, gemm([(x, w, 0)], rows,
                                  scale=t.proj_scale[lo:hi],
                                  shift=t.proj_shift[lo:hi], **tier)))
    p_sem = outs[0][1]
    attn_parts = [p[:, max(4 * c - lo, 0):] for lo, p in outs
                  if lo + p.shape[1] > 4 * c]
    p_attn = (attn_parts[0] if len(attn_parts) == 1
              else torch.cat(attn_parts, dim=1))
    local = local_chain(x, t, gemm, sem, p_sem, tiers)
    if t.form == "fold" and tiers is not None:
        tiers = {**tiers, "attn_score": "highest"}
    globl = global_chain(x, t, gemm, attn, p_attn, tiers)
    return gemm([(x, t.gcat_w[0:c], 0), (local, t.gcat_w[c:2 * c], 0),
                 (globl, t.gcat_w[2 * c:3 * c], 0)], rows,
                scale=t.gcat_scale, shift=t.gcat_shift, relu=True,
                out_dtype=out_dtype, **_tier(tiers, "gab_cat"))


def check_blocks(x: torch.Tensor, c: int, j: int, max_channels: int,
                 name: str, dtypes=(torch.float32,)) -> None:
    """An entry point's (B, T, J, C) contiguous activations, of a dtype
    among ``dtypes`` (bf16 only where the kernels have a bf16-I/O form)."""
    if (x.dim() != 4 or x.shape[-1] != c or x.shape[-2] != j
            or x.dtype not in dtypes or not x.is_contiguous()):
        kinds = " or ".join(str(d).split(".")[-1] for d in dtypes)
        raise ValueError(f"x must be a contiguous {kinds} (B, T, {j}, {c}) "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if c > max_channels:
        raise ValueError(f"{name} supports C <= {max_channels}, got {c}")


# --------------------------------------------------------------------------
# gab_narrow
# --------------------------------------------------------------------------


# Widths below this count as narrow (the TPU's fused_gab_pbatch class).
NARROW_MAX_CHANNELS = 127
# The widths gab_narrow.cu is instantiated for, and those of its tiered
# form (where the float32 kernel still beat the chain).
NARROW_WIDTHS = (16, 32, 48, 64, 80, 96)
NARROW_TIERED_WIDTHS = (16, 32, 48, 64)
# The widths at which gab_narrow beat the three-kernel chain on the card
# (scripts/torch_gab_narrow_phases.py --widths; PERF.md section 6): 0.83
# against 2.13 ms at C=16, 1.94 / 3.20 at 32, 4.47 / 4.49 at 48, 5.91 /
# 5.94 at 64 (a tie since the graph kernels' redesign), but 13.62 / 9.17
# at 80 and 14.26 / 11.05 at 96 (its tile holds 3 frames there). Every
# other width runs the chain.
NARROW_ROUTE_WIDTHS = (16, 32, 48, 64)
# The widths at which gab_narrow's tiered form (its GEMM classes on the
# tensor cores) beat the tiered chain on the card
# (scripts/torch_gab_narrow_phases.py --tiered --tiered-parent, 256 x 241
# frames of J=17; NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): since
# its redesign every width, at each tier set of
# chip_smoke.NARROW_TIERS; all "high" / the JAX preset's tiers, two turns:
# 0.755-0.765 / 0.701-0.706 ms against the chain's 2.562 / 1.945 at C=16,
# 1.430-1.438 / 1.322-1.337 against 2.692 / 2.363 at C=32, 2.778-2.802 /
# 2.471-2.490 against 3.822 / 3.113 at C=48 and 3.499-3.583 / 3.102
# against 4.424 / 3.754 at C=64 (its first design lost at C=48, 64:
# 4.320 / 3.928 against 3.673 / 3.075, 6.583 / 5.940 against 4.436 /
# 3.774).
NARROW_ROUTE_WIDTHS_TIERED = (16, 32, 48, 64)
# The widths gab_narrow.cu instantiates the fold form for, in both forms
# (the v1 kernel loses to the chain above C = 64).
NARROW_FOLD_WIDTHS = (16, 32, 48, 64)
# The widths at which the fold form beat the fold chain on the card
# (scripts/torch_gab_narrow_phases.py --fold, 256 x 241 frames of J=17;
# NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6), float32: 0.844 ms
# against the fold chain's 2.085 at C=16, 1.838 / 3.264 at 32, 4.116 /
# 4.234 at 48, 5.319 / 5.547 at 64. Every other width runs the fold chain.
NARROW_ROUTE_WIDTHS_FOLD = (16, 32, 48, 64)
# The same for its tiered form (its redesign; the same runs), all
# "high" / the JAX preset's tiers: 0.774-0.775 / 0.723-0.729 ms against
# the fold chain's 2.169 / 1.825 at C=16, 1.507-1.510 / 1.338-1.359
# against 2.453 / 2.252 at C=32, 2.738-2.741 / 2.549-2.554 against 3.354 /
# 2.948 at C=48, 3.458-3.488 / 3.164-3.171 against 4.152 / 3.797 at C=64:
# every width (its first design: C = 16, 32 alone).
NARROW_ROUTE_WIDTHS_FOLD_TIERED = (16, 32, 48, 64)
# The chain's GEMM classes: below "highest" they launch gemm_tc.
GEMM_OPS = ("local_sem", "local_cat", "attn_proj", "attn_cat", "gab_cat")
# The tier codes gab_narrow's tiered form takes, in its C order: the GEMM
# classes (TC_TIERS codes) and the attention's score and apply dots
# (ATTN_TIERS codes).
NARROW_TIER_CLASSES = ("local_sem", "attn_proj", "local_cat", "attn_cat",
                       "gab_cat", "attn_score", "attn_apply")
# Weights the kernel copies into shared memory 16 bytes at a time.
_NARROW_ALIGNED = ("w_proj", "lcat_w", "acat_w", "gcat_w")


def narrow_shape_ok(c: int, k: int, inter: int, g_ch: int, j: int,
                    d: int, form: str = "v1") -> bool:
    """gab_narrow's shape rule, the same as its C entry point's: C one of
    ``NARROW_WIDTHS``, at most 4 heads with K*I = K*G = C, J <= 32 joints
    and D <= 8 neighbour slots; in the fold form, C one of
    ``NARROW_FOLD_WIDTHS``, I = 1 and K = 2 or 4 with K*G = C (an even K:
    the folded projection's rows, 5C + 2K floats, and its g columns must
    start on 16 bytes for the kernel's copies; every GAB of the models has
    K = 4)."""
    if form == "fold":
        heads = c in NARROW_FOLD_WIDTHS and k in (2, 4) and inter == 1
    else:
        heads = c in NARROW_WIDTHS and 1 <= k <= 4 and k * inter == c
    return (heads and k * g_ch == c and 1 <= j <= MAX_JOINTS
            and 1 <= d <= MAX_SLOTS)


def narrow_form(tiers: Optional[Dict[str, str]]) -> Optional[str]:
    """Which ``gab_narrow`` computes a GAB at ``tiers``: ``"float32"``
    where every class is ``"highest"`` (or no tiers), ``"tiered"`` where
    every GEMM class is below it (the attention's two at any tier), else
    None: a GEMM class at ``"highest"`` beside one below it has no
    ``gab_narrow`` form."""
    if tiers is None or all(v == "highest" for v in tiers.values()):
        return "float32"
    if all(tiers[op] != "highest" for op in GEMM_OPS):
        return "tiered"
    return None


def gab_route(c: int, k: int, inter: int, g_ch: int, j: int, d: int,
              tiers: Optional[Dict[str, str]] = None,
              form: str = "v1") -> str:
    """The kernels a GAB of this shape and table form (``"v1"`` or
    ``"fold"``) runs on the card: ``"gab_narrow"`` where its shape rule
    holds and its form (:func:`narrow_form`) beat the chain at this width
    (``NARROW_ROUTE_WIDTHS``, or ``NARROW_ROUTE_WIDTHS_TIERED`` for the
    tiered form; ``NARROW_ROUTE_WIDTHS_FOLD[_TIERED]`` for fold tables),
    else ``"chain"``."""
    widths = {("v1", "float32"): NARROW_ROUTE_WIDTHS,
              ("v1", "tiered"): NARROW_ROUTE_WIDTHS_TIERED,
              ("fold", "float32"): NARROW_ROUTE_WIDTHS_FOLD,
              ("fold", "tiered"): NARROW_ROUTE_WIDTHS_FOLD_TIERED}.get(
                  (form, narrow_form(tiers)), ())
    if narrow_shape_ok(c, k, inter, g_ch, j, d, form) and c in widths:
        return "gab_narrow"
    return "chain"


def gab_shape(t) -> Tuple[int, int, int, int, int, int]:
    """(C, K, I, G, J, D) of a ``fused_gab.GabTables``."""
    c = t.w_proj.shape[0]
    k, inter = t.proj_t.shape
    kg = t.w_proj.shape[1] - 4 * c - 2 * k * inter
    return c, k, inter, kg // k, t.c_k.shape[1], t.col.shape[2]


def narrow_table_ptrs(t) -> list:
    """The pointers of a ``fused_gab.GabTables``'s 20 tables in its field
    order, as ``gab_narrow``'s C function takes them."""
    return [v.data_ptr() for v in t if isinstance(v, torch.Tensor)]


def _check_narrow(x, t, out_dtype):
    device = x.device
    _check(device, IO_DTYPES, x=x)
    _check_out_dtype(out_dtype)
    _check(device, **{k: v for k, v in t._asdict().items()
                      if k not in ("col", "form")})
    if t.form not in NARROW_FORMS:
        raise ValueError(f"gab_narrow has no {t.form!r} form")
    c, k, inter, g_ch, j, d = gab_shape(t)
    if x.dim() != 2 or x.shape[1] != c or x.shape[0] % j:
        raise ValueError(f"x must be (rows, {c}) holding whole frames of {j} "
                         f"joints, got {tuple(x.shape)}")
    kg = t.w_proj.shape[1] - 4 * c - 2 * k * inter
    if kg != k * g_ch or not narrow_shape_ok(c, k, inter, g_ch, j, d,
                                             t.form):
        rule = (f"gab_narrow's fold form takes C in {NARROW_FOLD_WIDTHS}, "
                f"K = 2 or 4 heads with I = 1 and K*G = C"
                if t.form == "fold" else
                f"gab_narrow takes C in {NARROW_WIDTHS}, K <= 4 heads with "
                f"K*I = K*G = C")
        raise ValueError(f"{rule}, J <= 32 and D <= 8; got C={c}, K={k}, "
                         f"K*I={k * inter}, K*G={kg}, J={j}, D={d}")
    if any(getattr(t, name).data_ptr() % 16 for name in _NARROW_ALIGNED):
        raise ValueError("gab_narrow's weight tables must be 16-byte aligned")
    if (t.col.device != device or t.col.dtype != torch.int32
            or not t.col.is_contiguous()):
        raise ValueError("col must be a contiguous int32 table on x's device")
    return device, c, j, k, inter, g_ch, d


def _check_narrow_tiers(tiers: Optional[Dict[str, str]]) -> str:
    if tiers is not None:
        for op in NARROW_TIER_CLASSES:
            check_tier(tiers[op])
    form = narrow_form(tiers)
    if form is None:
        raise ValueError(f"gab_narrow has no form for a GEMM class at "
                         f"'highest' beside one below it: {tiers}")
    return form


def gab_narrow_plain(x: torch.Tensor, t,
                     out_dtype: Optional[torch.dtype] = None,
                     tiers: Optional[Dict[str, str]] = None
                     ) -> torch.Tensor:
    """Plain PyTorch version of :func:`gab_narrow`: the chain of the three
    kernels' plain versions at ``tiers``."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    _check_narrow(x, t, out_dtype)
    _check_narrow_tiers(tiers)
    return gab_chain(x, t, gemm_epilogue_plain, sem_graph_plain,
                     joint_attention_plain, tiers, out_dtype=out_dtype)


def gab_narrow(x: torch.Tensor, t,
               out_dtype: Optional[torch.dtype] = None,
               tiers: Optional[Dict[str, str]] = None) -> torch.Tensor:
    """The eval GAB in one launch at the narrow widths: (rows, C) ->
    (rows, 2C), rows whole frames; ``t`` is a ``fused_gab.GabTables`` whose
    shape meets :func:`narrow_shape_ok` (else ``ValueError``). ``x`` is
    float32 or bf16, the output ``out_dtype`` (default: x's). ``tiers``
    ({op_class: tier} of ``fused_gab.KERNEL_OPS``; None: all
    ``"highest"``) picks the form (:func:`narrow_form`): the float32
    kernel, or the tiered one, whose products run as bf16 ``mma.sync``
    passes at each class's tier and whose attention rounds its operands
    as ``joint_attention`` does (``TIER_LAUNCHES["gab_narrow"]`` counts
    its launches by their tiers); the launch first splits the weights into
    the stream's scratch buffer (:func:`narrow_scratch`, made at the first
    tiered launch on a stream, then reused). Fold tables (``t.form ==
    "fold"``) run
    either kernel's fold form: the scores are two C-long dots of x a row
    and head against the folded columns, at ``attn_score``'s tier
    (``VARIANT_LAUNCHES["gab_narrow"]`` counts launches by form)."""
    check_no_grad("gab_narrow", x, t)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    device, c, j, k, inter, g_ch, d = _check_narrow(x, t, out_dtype)
    form = _check_narrow_tiers(tiers)
    if form == "tiered" and c not in NARROW_TIERED_WIDTHS:
        raise ValueError(f"gab_narrow's tiered form takes C in "
                         f"{NARROW_TIERED_WIDTHS}, got C={c}")
    if not use_kernel(device):
        return gab_narrow_plain(x, t, out_dtype, tiers)
    out = torch.empty((x.shape[0], 2 * c), dtype=out_dtype, device=device)
    fold = t.form == "fold"
    args = [x.data_ptr(), out.data_ptr(), x.shape[0] // j, j, c, d, k,
            inter, g_ch, *narrow_table_ptrs(t), _stream(),
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            int(fold)]
    io = io_label([x], out_dtype)
    if form == "float32":
        _launch("gab_narrow", *args, io=io, variant=t.form)
        return out
    tiers = {op: "default" if v == "kdefault" else v
             for op, v in tiers.items()}
    codes = narrow_tier_codes(tiers)
    label = "/".join(tiers[op] for op in NARROW_TIER_CLASSES)
    scratch = narrow_scratch(device, args[-4])
    _launch("gab_narrow", *args, *codes, scratch.data_ptr(),
            scratch.numel(), symbol="gab_narrow_tiered",
            library="gab_narrow_tiered", variant=t.form,
            tier=f"fold {label}" if fold else label, io=io)
    return out


def narrow_tier_codes(tiers: Dict[str, str]) -> List[int]:
    """The tiered ``gab_narrow``'s tier codes of ``NARROW_TIER_CLASSES``:
    ``TC_TIERS`` for the GEMM classes (``"kdefault"`` as ``"default"``),
    ``ATTN_TIERS`` for the attention's."""
    tiers = {op: "default" if v == "kdefault" else v
             for op, v in tiers.items()}
    return ([TC_TIERS.index(tiers[op]) for op in NARROW_TIER_CLASSES[:5]]
            + [ATTN_TIERS.index(tiers[op]) for op in NARROW_TIER_CLASSES[5:]])


# The tiered gab_narrow's scratch buffer: its launch splits the weights
# into it (gab_narrow.cu, split_weights), after NARROW_SCRATCH_CTL words of
# a grid barrier's counters, which start at 0 and which the launch leaves
# at 0. One zeroed buffer of NARROW_SCRATCH_WORDS int32 words a (device,
# stream), made at its first launch: launches on one stream run in turn.
NARROW_SCRATCH_CTL = 16
NARROW_SCRATCH_WORDS = 1 << 17
_NARROW_SCRATCH: Dict[Tuple[torch.device, int], torch.Tensor] = {}
# The tiered form's slab rows at each width (gab_narrow.cu TieredCfg).
NARROW_TIERED_BK = {16: 16, 32: 32, 48: 48, 64: 32}


def narrow_scratch(device: torch.device, stream: int) -> torch.Tensor:
    """The scratch buffer of tiered ``gab_narrow`` launches on ``stream``
    of ``device``."""
    key = (device, stream)
    if key not in _NARROW_SCRATCH:
        _NARROW_SCRATCH[key] = torch.zeros(NARROW_SCRATCH_WORDS,
                                           dtype=torch.int32, device=device)
    return _NARROW_SCRATCH[key]


def narrow_slabs(t) -> List[Tuple[str, torch.Tensor]]:
    """The products of a tile's slab stream in the tiered ``gab_narrow``,
    in order: (name, W as (K, N) float32), P1 .. P7 (the fold form without
    P4, its P5 the g columns past the 2K folded score columns)."""
    c, k = t.w_proj.shape[0], t.proj_t.shape[0]
    g0 = 4 * c + 2 * k if t.form == "fold" else 6 * c
    slabs = [("P1", t.w_proj[:, :2 * c]), ("P2", t.w_proj[:, 2 * c:4 * c]),
             ("P3", t.lcat_w)]
    if t.form != "fold":
        slabs.append(("P4", t.w_proj[:, 4 * c:6 * c]))
    return slabs + [("P5", t.w_proj[:, g0:g0 + c]), ("P6", t.acat_w),
                    ("P7", t.gcat_w)]


def _bf16_bits(a: torch.Tensor) -> torch.Tensor:
    return a.view(torch.int16).to(torch.int64) & 0xFFFF


def narrow_word(n, kp, bk: int):
    """The offset of word (column n, k pair kp) in a half slab of the
    tiered ``gab_narrow`` (``Tc::word``): BK / 2 words a column, its
    16-byte chunk kp // 4 XOR'd with bits 1-2 of n (4 chunks a column) or
    bit 2 (2 or 6), so that an ldmatrix's 8 columns hit distinct banks."""
    kpw = bk // 2
    sw = (n >> 1) & 3 if kpw % 16 == 0 else (n >> 2) & 1
    return n * kpw + (((kp >> 2) ^ sw) << 2) + (kp & 3)


def narrow_split_plain(t) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the tiered ``gab_narrow``'s split: the words its
    launch writes into the scratch buffer, as (word offsets past the
    ``NARROW_SCRATCH_CTL`` counter words, int32 words). Each product's W (K,
    N) is cut into slabs of ``BK = NARROW_TIERED_BK[C]`` rows in stream
    order (:func:`narrow_slabs`), each slab ``2C * BK`` words: word (n, kp)
    of its hi half, at ``narrow_word(n, kp, BK)``, holds bf16(W[2kp, n]) in
    its low 16 bits and bf16(W[2kp + 1, n]) in its high ones (rounded to
    nearest even, the slab's rows), and its lo half, ``C * BK`` words on,
    the same of W - hi (``precision.split_bf16``)."""
    c = t.w_proj.shape[0]
    bk = NARROW_TIERED_BK[c]
    half = c * bk
    offsets, words, base = [], [], 0
    for _, w in narrow_slabs(t):
        hi, lo = split_bf16(w.float())
        kk, n = w.shape
        for k0 in range(0, kk, bk):
            kp = torch.arange(bk // 2, device=w.device)[:, None]
            col = torch.arange(n, device=w.device)[None, :]
            at = (base + narrow_word(col, kp, bk)).reshape(-1)
            for h, part in ((0, hi), (half, lo)):
                bits = _bf16_bits(part[k0:k0 + bk])
                offsets.append(at + h)
                words.append((bits[0::2] | bits[1::2] << 16).reshape(-1))
            base += 2 * half
    words = torch.cat(words)
    return torch.cat(offsets), torch.where(
        words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
