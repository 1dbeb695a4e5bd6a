"""Build, binding and launch wrappers of the port's CUDA kernels.

Four kernels, each a CUDA C++ source under ``gastx_torch/csrc/`` with a
plain C interface:

  * ``gemm_epilogue`` — pipelined f32 GEMM over up to three pieces with a
    tap row map and a BN (scale/shift) / ReLU / residual epilogue, in two
    instantiations (:func:`gemm_variant`);
  * ``sem_graph`` — the local branch's semantic graph aggregation, and
  * ``joint_attention`` — per-frame multi-head attention over the joints,
    each in two instantiations (:func:`graph_variant`);
  * ``gab_narrow`` — the whole eval GAB at the narrow widths
    (``NARROW_WIDTHS``, C = 16 .. 96 in steps of 16) in one launch, every
    intermediate in shared memory.

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
first use, all ``nvcc`` processes started together, and loaded with
``ctypes``. Kernels launch on PyTorch's current stream and allocate
nothing: the wrappers allocate outputs with ``torch.empty``.

Every wrapper checks device, dtype, shape and contiguity. On a CUDA tensor
it launches its kernel (and raises if the launch fails); on a CPU tensor
it runs the plain PyTorch version beside it, which is also what the card
runs to hold the kernel to. ``LAUNCHES`` counts kernel launches by
kernel, ``VARIANT_LAUNCHES`` those of the kernels with two instantiations
by kernel and instantiation; ``ENTRY_LAUNCHES`` counts the kernel launches
made inside each entry point (:func:`entry_point`). All are counted in
``_launch`` alone, after the launch succeeded.
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

KERNEL_SOURCES = ("gemm_epilogue", "sem_graph", "joint_attention",
                  "gab_narrow")
CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "gastx_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
VARIANT_KERNELS = ("gemm_epilogue", "sem_graph", "joint_attention")
# The graph kernels' shape rule (their C entry points check it too): J <= 32
# joints and, for sem_graph, D <= 8 neighbour slots a joint.
MAX_JOINTS = 32
MAX_SLOTS = 8

# Kernel launches by kernel, by kernel and instantiation, and by the entry
# points open at the launch.
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_SOURCES}
VARIANT_LAUNCHES: Dict[str, Dict[str, int]] = {
    name: {v: 0 for v in VARIANTS} for name in VARIANT_KERNELS}
ENTRY_LAUNCHES: Dict[str, int] = {name: 0 for name in ENTRY_POINTS}
_OPEN_ENTRIES: List[str] = []

_LIBS: Dict[str, ctypes.CDLL] = {}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "gemm_epilogue": [_P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _I, _I,
                      _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _I, _P, _P,
                      _I],
    "sem_graph": [_P, _I, _P, _LL, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I],
    "joint_attention": [_P, _P, _P, _I, _P, _P, _P, _P, _LL, _I, _I, _I,
                        _I, _P, _I],
    # x, out, frames, J, C, D, K, I, G, the 20 tables of a GabTables in
    # its field order, stream
    "gab_narrow": [_P, _P, _LL, _I, _I, _I, _I, _I, _I] + [_P] * 21,
}


def reset_launches() -> None:
    for counts in (LAUNCHES, ENTRY_LAUNCHES, *VARIANT_LAUNCHES.values()):
        for name in counts:
            counts[name] = 0


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


def _library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_kernels() -> Dict[str, str]:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all started together, and load them all. Returns the compiler
    output (``ptxas -v``: registers, shared memory, spills) of each kernel
    built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in KERNEL_SOURCES:
            lib = _library_path(name)
            if lib.exists():
                continue
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, lib)
        logs = {}
        for name, (proc, tmp, lib) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{out}")
            os.replace(tmp, lib)
            logs[name] = out
        for name in KERNEL_SOURCES:
            _lib(name)
        return logs
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        path = _library_path(name)
        if not path.exists():
            build_kernels()
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def _launch(name: str, *args) -> None:
    lib = _lib(name)
    code = getattr(lib, name)(*args)
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.error_string(code).decode()} ({code})")
    LAUNCHES[name] += 1
    if name in VARIANT_LAUNCHES:
        VARIANT_LAUNCHES[name]["vec16" if args[-1] else "general"] += 1
    for entry in _OPEN_ENTRIES:
        ENTRY_LAUNCHES[entry] += 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(device: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def as_table(t: torch.Tensor) -> torch.Tensor:
    """A host-folded weight table as the wrappers take it: detached,
    float32, contiguous."""
    return t.detach().to(torch.float32).contiguous()


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
        _check(device, **{f"a{i}": a, f"w{i}": w})
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
        _check(device, res=res)
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
                        res_off: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`gemm_epilogue` (same arguments)."""
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
        term = torch.matmul(a[rows], w)
        acc = term if acc is None else acc + term
    if scale is not None:
        acc = acc * scale + shift
    if relu:
        acc = torch.relu(acc)
    if res is not None:
        acc = acc + res[_row_map(m, s_out, res_s_in, res_off, device)]
    return acc


def gemm_epilogue(pieces: Sequence[Piece], m: int, *,
                  s_out: Optional[int] = None, a_s_in: Optional[int] = None,
                  scale=None, shift=None, relu: bool = False, res=None,
                  res_s_in: Optional[int] = None,
                  res_off: int = 0) -> torch.Tensor:
    """out (m, N) = epi(sum_p A_p[in_row(r, p)] @ W_p).

    ``pieces``: up to three (a (rows, K_p), w (K_p, N), a_off). Rows are
    grouped in sequences of ``s_out`` output rows (default: one sequence
    of ``m``); output row r = s*s_out + q reads row s*a_s_in + q + a_off of
    ``a``. The epilogue applies ``scale``/``shift`` (a bias is scale 1),
    ReLU, then adds ``res`` row s*res_s_in + q + res_off.
    """
    s_out = m if s_out is None else s_out
    a_s_in = s_out if a_s_in is None else a_s_in
    res_s_in = s_out if res_s_in is None else res_s_in
    device, n = _check_gemm(pieces, m, s_out, a_s_in, scale, shift, res,
                            res_s_in, res_off)
    if not use_kernel(device):
        return gemm_epilogue_plain(
            pieces, m, s_out=s_out, a_s_in=a_s_in, scale=scale, shift=shift,
            relu=relu, res=res, res_s_in=res_s_in, res_off=res_off)
    out = torch.empty((m, n), dtype=torch.float32, device=device)
    flat = []
    for i in range(3):
        if i < len(pieces):
            a, w, off = pieces[i]
            flat += [a.data_ptr(), w.data_ptr(), a.shape[1], off]
        else:
            flat += [None, None, 0, 0]
    _launch("gemm_epilogue", *flat, len(pieces), m, n, s_out, a_s_in,
            res_s_in, _ptr(scale), _ptr(shift), int(relu),
            _ptr(res), res_off, out.data_ptr(), _stream(),
            int(gemm_variant(pieces, n, res) == "vec16"))
    return out


def gemm_variant(pieces: Sequence[Piece], n: int,
                 res: Optional[torch.Tensor]) -> str:
    """The instantiation of ``gemm_epilogue`` for these operands:
    ``"vec16"`` (16-byte loads, copies and epilogue) when every K_p and N are
    multiples of 4 and every a_p, w_p and ``res`` starts 16-byte aligned
    (then so does every row, with its offset a_off * K_p, and the fresh
    output), else ``"general"``."""
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


def joint_attention_plain(theta, phi, g, proj_t, proj_p, c_k):
    """Plain PyTorch version of :func:`joint_attention`."""
    _, k, inter, j, g_ch = _check_attn(theta, phi, g, proj_t, proj_p, c_k)
    check_f32_matmul(theta)
    frames = theta.shape[0] // j
    sa = (theta.reshape(frames, j, k, inter) * proj_t).sum(-1)  # (F, J, K)
    sb = (phi.reshape(frames, j, k, inter) * proj_p).sum(-1)
    sa, sb = sa.transpose(1, 2), sb.transpose(1, 2)             # (F, K, J)
    f = F.leaky_relu(sa[..., :, None] + sb[..., None, :], 0.2)
    attn = torch.softmax(f, dim=-1) + c_k                       # (F,K,J,J)
    gk = g.reshape(frames, j, k, g_ch).transpose(1, 2)          # (F,K,J,G)
    out = torch.matmul(attn, gk).transpose(1, 2)                # (F,J,K,G)
    return out.reshape(frames * j, k * g_ch)


def joint_attention(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor,
                    proj_t, proj_p, c_k) -> torch.Tensor:
    """Per-frame multi-head attention over the joints.

    ``theta``/``phi`` (rows, K*I) and ``g`` (rows, K*G): column views of
    one projection output (same row stride). ``proj_t``/``proj_p`` (K, I)
    rank-1 score vectors, ``c_k`` (K, J, J) additive attention biases.
    Returns the head-major (rows, K*G) head outputs.
    """
    device, k, inter, j, g_ch = _check_attn(theta, phi, g, proj_t, proj_p,
                                            c_k)
    if not use_kernel(device):
        return joint_attention_plain(theta, phi, g, proj_t, proj_p, c_k)
    rows = theta.shape[0]
    out = torch.empty((rows, k * g_ch), dtype=torch.float32, device=device)
    _launch("joint_attention", theta.data_ptr(), phi.data_ptr(),
            g.data_ptr(), theta.stride(0), proj_t.data_ptr(),
            proj_p.data_ptr(), c_k.data_ptr(), out.data_ptr(), rows // j, j,
            inter, g_ch, k, _stream(),
            int(graph_variant((theta, phi, g), (inter, g_ch)) == "vec16"))
    return out


# --------------------------------------------------------------------------
# The chains: the GAB and its two branches through the kernels above
# --------------------------------------------------------------------------

def local_chain(x: torch.Tensor, t, gemm, sem, p=None) -> torch.Tensor:
    """Steps 1-3 of the GAB chain, the eval local branch: (rows, C) ->
    (rows, C). ``p`` is a projection output whose first 4C columns are
    [W0_sym | W1_sym | W0_con | W1_con] (the GAB chain's); without it,
    step 1 projects x onto ``t.w_sem``. ``t`` is a ``fused_gab.
    LocalTables`` or ``GabTables``; ``gemm``/``sem`` the kernels or their
    plain versions."""
    rows, c = x.shape
    if p is None:
        p = gemm([(x, t.w_sem, 0)], rows)
    ab = sem(p, c, t.w_self, t.w_nbr, t.col, t.sem_scale, t.sem_shift)
    return gemm([(ab, t.lcat_w, 0)], rows, scale=t.lcat_scale,
                shift=t.lcat_shift, relu=True)


def global_chain(x: torch.Tensor, t, gemm, attn, p=None) -> torch.Tensor:
    """Steps 1, 4 and 5 of the GAB chain, the eval multi-head global
    branch with its cat, BN and ReLU: (rows, C) -> (rows, C). ``p`` is a
    (rows, 2KI + KG) view [theta | phi | g] of a projection output (the
    GAB chain's); without it, step 1 projects x onto ``t.w_attn`` plus
    its biases. ``t`` is a ``global_attn.GlobalTables`` or ``fused_gab.
    GabTables``."""
    rows = x.shape[0]
    ki = t.proj_t.numel()
    if p is None:
        p = gemm([(x, t.w_attn, 0)], rows, scale=t.attn_scale,
                 shift=t.attn_shift)
    heads = attn(p[:, :ki], p[:, ki:2 * ki], p[:, 2 * ki:], t.proj_t,
                 t.proj_p, t.c_k)
    return gemm([(heads, t.acat_w, 0)], rows, scale=t.acat_scale,
                shift=t.acat_shift, relu=True)


def gab_chain(x: torch.Tensor, t, gemm, sem, attn) -> torch.Tensor:
    """The eval GAB on (rows, C) activations through the given GEMM, graph
    and attention functions (the kernels, or their plain versions); ``t``
    is a ``fused_gab.GabTables``. One projection feeds both branches."""
    rows, c = x.shape
    p = gemm([(x, t.w_proj, 0)], rows, scale=t.proj_scale,
             shift=t.proj_shift)
    local = local_chain(x, t, gemm, sem, p)
    globl = global_chain(x, t, gemm, attn, p[:, 4 * c:])
    return gemm([(x, t.gcat_w[0:c], 0), (local, t.gcat_w[c:2 * c], 0),
                 (globl, t.gcat_w[2 * c:3 * c], 0)], rows,
                scale=t.gcat_scale, shift=t.gcat_shift, relu=True)


def check_blocks(x: torch.Tensor, c: int, j: int, max_channels: int,
                 name: str) -> None:
    """An entry point's (B, T, J, C) float32 contiguous activations."""
    if (x.dim() != 4 or x.shape[-1] != c or x.shape[-2] != j
            or x.dtype != torch.float32 or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous float32 (B, T, {j}, {c}) "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if c > max_channels:
        raise ValueError(f"{name} supports C <= {max_channels}, got {c}")


# --------------------------------------------------------------------------
# gab_narrow
# --------------------------------------------------------------------------


# Widths below this count as narrow (the TPU's fused_gab_pbatch class).
NARROW_MAX_CHANNELS = 127
# The widths gab_narrow.cu is instantiated for.
NARROW_WIDTHS = (16, 32, 48, 64, 80, 96)
# The widths at which gab_narrow beat the three-kernel chain on the card
# (scripts/torch_gab_narrow_phases.py --widths; PERF.md section 6): 0.83
# against 2.13 ms at C=16, 1.94 / 3.20 at 32, 4.47 / 4.49 at 48, 5.91 /
# 5.94 at 64 (a tie since the graph kernels' redesign), but 13.62 / 9.17
# at 80 and 14.26 / 11.05 at 96 (its tile holds 3 frames there). Every
# other width runs the chain.
NARROW_ROUTE_WIDTHS = (16, 32, 48, 64)
# Weights the kernel copies into shared memory 16 bytes at a time.
_NARROW_ALIGNED = ("w_proj", "lcat_w", "acat_w", "gcat_w")


def narrow_shape_ok(c: int, k: int, inter: int, g_ch: int, j: int,
                    d: int) -> bool:
    """gab_narrow's shape rule, the same as its C entry point's: C one of
    ``NARROW_WIDTHS``, at most 4 heads with K*I = K*G = C, J <= 32 joints
    and D <= 8 neighbour slots."""
    return (c in NARROW_WIDTHS and 1 <= k <= 4 and k * inter == c
            and k * g_ch == c and 1 <= j <= MAX_JOINTS
            and 1 <= d <= MAX_SLOTS)


def gab_route(c: int, k: int, inter: int, g_ch: int, j: int,
              d: int) -> str:
    """The kernels a GAB of this shape runs on the card: ``"gab_narrow"``
    where its shape rule holds and it beat the chain, else ``"chain"``."""
    if narrow_shape_ok(c, k, inter, g_ch, j, d) and c in NARROW_ROUTE_WIDTHS:
        return "gab_narrow"
    return "chain"


def gab_shape(t) -> Tuple[int, int, int, int, int, int]:
    """(C, K, I, G, J, D) of a ``fused_gab.GabTables``."""
    c = t.w_proj.shape[0]
    k, inter = t.proj_t.shape
    kg = t.w_proj.shape[1] - 4 * c - 2 * k * inter
    return c, k, inter, kg // k, t.c_k.shape[1], t.col.shape[2]


def _check_narrow(x, t):
    device = x.device
    _check(device, x=x, **{k: v for k, v in t._asdict().items()
                           if k != "col"})
    c, k, inter, g_ch, j, d = gab_shape(t)
    if x.dim() != 2 or x.shape[1] != c or x.shape[0] % j:
        raise ValueError(f"x must be (rows, {c}) holding whole frames of {j} "
                         f"joints, got {tuple(x.shape)}")
    kg = t.w_proj.shape[1] - 4 * c - 2 * k * inter
    if kg != k * g_ch or not narrow_shape_ok(c, k, inter, g_ch, j, d):
        raise ValueError(f"gab_narrow takes C in {NARROW_WIDTHS}, K <= 4 "
                         f"heads with K*I = K*G = C, J <= 32 and D <= 8; got "
                         f"C={c}, K={k}, K*I={k * inter}, K*G={kg}, J={j}, "
                         f"D={d}")
    if any(getattr(t, name).data_ptr() % 16 for name in _NARROW_ALIGNED):
        raise ValueError("gab_narrow's weight tables must be 16-byte aligned")
    if (t.col.device != device or t.col.dtype != torch.int32
            or not t.col.is_contiguous()):
        raise ValueError("col must be a contiguous int32 table on x's device")
    return device, c, j, k, inter, g_ch, d


def gab_narrow_plain(x: torch.Tensor, t) -> torch.Tensor:
    """Plain PyTorch version of :func:`gab_narrow`: the chain of the three
    kernels' plain versions."""
    _check_narrow(x, t)
    return gab_chain(x, t, gemm_epilogue_plain, sem_graph_plain,
                     joint_attention_plain)


def gab_narrow(x: torch.Tensor, t) -> torch.Tensor:
    """The eval GAB in one launch at the narrow widths: (rows, C) ->
    (rows, 2C), rows whole frames; ``t`` is a ``fused_gab.GabTables`` whose
    shape meets :func:`narrow_shape_ok` (else ``ValueError``)."""
    device, c, j, k, inter, g_ch, d = _check_narrow(x, t)
    if not use_kernel(device):
        return gab_narrow_plain(x, t)
    out = torch.empty((x.shape[0], 2 * c), dtype=torch.float32,
                      device=device)
    _launch("gab_narrow", x.data_ptr(), out.data_ptr(), x.shape[0] // j,
            j, c, d, k, inter, g_ch, *(v.data_ptr() for v in t), _stream())
    return out
