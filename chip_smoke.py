"""Drive the gastx_torch main path on one GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and the CUDA toolkit (``nvcc``); it imports nothing of JAX or
of the ``gastx`` package. Phases, in order; any failure ends the run with
a non-zero exit and no result line:

  1. build the four CUDA kernels from ``gastx_torch/csrc`` (one ``nvcc``
     per source, all started together) and print the card's name and power
     limit;
  2. hold each kernel and each entry-point wrapper to its plain PyTorch
     version on the card at the main paths' shapes: the 27-frame model at
     B=256 windows, and the narrow levels (C=32, 64) of the 243- and
     81-frame models at B=256 (``gab_narrow``, ``fused_gab``,
     ``fused_level0``, ``fused_level``); then the other routes' entry
     points at B=256: ``fused_local_branch`` and
     ``fused_global_attention`` at the 27-frame model's C=128 and C=512,
     ``head_attention`` on one head at C=256, ``fused_gab_packed`` at the
     243-frame model's C=32 and C=64; then ``gemm_epilogue`` on ragged
     cases (``gemm_ragged_cases``), each checked to launch the
     instantiation ``gemm_variant`` must pick, 16-byte or general; then
     ``sem_graph`` and ``joint_attention`` on theirs (``graph_cases``: 1,
     7 and 4001 frames against their frame tiles at C=128, 256 and 512
     and on the 15/16/19-joint layouts, P at a 4-byte offset and at an
     odd row stride, the 8-channel model's heads, ``head_attention``'s
     one-head views), each checked likewise against ``graph_variant``;
     then the 8-channel model's forward on the ``"auto"``, ``"pallas"`` and
     packed routes against its plain reference, its C=8 GAB on the chain
     (off ``gab_narrow``'s shape rule) and the others where
     ``kernels.gab_route`` sends them; then the kernels at the rows one
     streaming push gives them (``STREAM_GABS``, M = 1): every launch of
     the 27-frame model's GAB chains at 153, 51 and 17 rows (C = 128, 256,
     512) and the 81-frame model's GAB 0 at 459 rows (C = 64, on
     ``gab_narrow`` where ``gab_route`` picks it), each on the
     instantiation ``gemm_variant`` or ``graph_variant`` picks;
  3. run reconstruct requests through ``gastx_torch.cli.reconstruct
     --random-weights --no-render`` on synthetic COCO keypoint files: 50,
     277 and 1000 frames with the 27-frame model, 277 and 1000 frames with
     ``-f 81`` and ``-f 243``; then two requests through
     ``gastx_torch.infer.lift_sequences`` on the 1000-frame sequence: the
     27-frame model on the hybrid route (``gab_impl="pallas_local"``,
     ``attn_impl="pallas_head"``) and the 243-frame model on the packed
     one (``gab_impl="pallas"``, ``packed_channels=64``). The launch
     counters are zeroed just before and read just after, so they show
     the main paths ran every kernel and every entry point but
     ``fused_global_attention``, which no model route reaches (0 main-path
     launches; its phase-2 calls are reported apart, as
     ``direct_launches``), and that the general ``gemm_epilogue`` ran once
     per default-route forward (its level-0 expand conv, K = 2) and
     nowhere else, and that the graph kernels' general instantiations ran
     nowhere. Every forward the requests make (the padded, flip-TTA
     batches) is recorded and then held to the model's plain reference
     forward on the same batch;
  4. time the full-width forwards against the plain reference forward:
     B=1024 windows of 27 and of 81 frames, B=256 windows of 243 frames,
     then the hybrid 27-frame (B=1024) and packed 243-frame (B=256)
     routes; then each kernel and entry point at its forward's shapes
     against its plain version, and ``gab_narrow`` beside the
     three-kernel chain at the three narrow GABs of the shipped models
     (C=32, T=241, B=256; C=64, T=79, B=1024; C=64, T=235, B=256); then
     ``gemm_epilogue`` at each main-path shape (``GEMM_SHAPES``: ms,
     TFLOP/s, bound, the instantiation, and one ``torch.addmm`` over the
     same product as a yardstick); then the graph kernels by shape
     (``GRAPH_SHAPES``, their six launches in a 27f B=1024 and a 243f
     B=256 forward: device ms per launch from torch.profiler, bound, GB/s,
     the instantiation);
  5. trace one forward of each of the 27-frame (B=1024), 243-frame
     (B=256), hybrid and packed cells with torch.profiler: device time by
     kernel and the device's idle share;
  6. the strided forwards of the 27-, 81- and 243-frame models, causal and
     not, and the 27-frame dense forward, each on B=256 windows of rf
     frames: held to ``reference_forward`` of the same variant, timed, and
     their launches (counters zeroed just before, read just after) held to
     what their GABs must launch with no level kernel, as the JAX gates
     have it;
  7. the dilated ``"auto"`` forward on the 15-, 16- and 19-joint layouts
     (27 frames, B=1024) and the 243-frame one on 19 joints (B=256), held
     to ``reference_forward``, through the level kernels;
  8. causal streaming through ``gastx_torch.infer.StreamingLifter`` at 27
     and 81 frames, M = 1 and 256 streams: 200 pushes after 10 warm-up
     pushes, per-push latency (p50, p99; host clock around ``push``),
     stream-pushes a second, launches a push by kernel (zeroed just
     before, read just after), one profiled push (device busy and idle
     share), and 40 streamed frames held to the same windows edge-padded
     and lifted offline by ``reference_forward(variant="strided")``; then
     ``gab_narrow`` beside the chain at one push's 81f GAB 0 (459 rows).

Tolerance: each kernel, wrapper and the forward must agree with its plain
version to max |delta| <= 1e-4 * max(1, max |plain|); both sides compute
in float32 and only the order of summation differs. Timings are CUDA
events around repeated calls after a warm-up. The last lines are the
script's total seconds, the ``{"kernels": [...]}`` summary (the entries
of ``gemm_epilogue``, ``sem_graph`` and ``joint_attention`` also give
their launches by instantiation and, as ``ragged_max_abs_err``, the
largest error of their phase-2 cases), the card's ``name,
power.limit``, and ``{"ok": true, "device": {...}}``. Details, the
per-shape tables among them, also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

TOL = 1e-4
F32_PEAK = 67e12       # H100 SXM float32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12     # H100 SXM device-memory bytes/s
REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
WORK_DIR = os.path.join(REPO, "build", "chip_smoke")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(got, plain) -> float:
    import torch

    torch.cuda.synchronize()
    if got.shape != plain.shape:
        fail(f"shape {tuple(got.shape)} != plain {tuple(plain.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail("non-finite output")
    return float((got - plain).abs().max())


def check(name: str, got, plain) -> float:
    err = max_err(got, plain)
    bound = TOL * max(1.0, float(plain.abs().max()))
    print(f"  {name}: max|d| {err:.3e} (bound {bound:.3e})")
    if not err <= bound:
        fail(f"{name} disagrees with its plain version: {err} > {bound}")
    return err


# --------------------------------------------------------------------------
# Work counts for the bounds: FLOPs (multiply-add = 2) and the bytes that
# must move (each input read once, each output written once), float32.
# --------------------------------------------------------------------------

def gemm_work(m, ks, n, has_bn, has_res):
    k = sum(ks)
    flops = 2 * m * n * k
    elems = m * k + k * n + m * n + 2 * n * has_bn
    if has_res:
        elems += m * n
        flops += m * n
    return flops + 2 * m * n * has_bn, 4 * elems


def sem_work(rows, c, j, d):
    flops = rows * 2 * c * (2 * (1 + d) + 2)
    elems = rows * 4 * c + rows * 2 * c + 2 * j * c * (1 + d) + 4 * c
    return flops, 4 * elems + 4 * 2 * j * d


def attn_work(rows, j, k, inter, g):
    frames = rows // j
    flops = frames * k * (2 * 2 * j * inter + 6 * j * j + 2 * j * j * g)
    elems = rows * (2 * k * inter + k * g) + rows * k * g + 2 * k * inter \
        + k * j * j
    return flops, 4 * elems


def gab_work(rows, c, j, k, inter, g, d):
    parts = [gemm_work(rows, [c], 4 * c + 2 * k * inter + k * g, 1, 0),
             sem_work(rows, c, j, d),
             gemm_work(rows, [2 * c], c, 1, 0),
             attn_work(rows, j, k, inter, g),
             gemm_work(rows, [k * g], c, 1, 0),
             gemm_work(rows, [c, c, c], 2 * c, 1, 0)]
    flops = sum(p[0] for p in parts)
    weights = c * (4 * c + 2 * k * inter + k * g) + 2 * c * c + k * g * c \
        + 6 * c * c
    return flops, 4 * (rows * c + rows * 2 * c + weights)


def local_work(rows, c, j, d):
    """The local branch alone: its 4C-wide projection, sem_graph, cat."""
    parts = [gemm_work(rows, [c], 4 * c, 0, 0), sem_work(rows, c, j, d),
             gemm_work(rows, [2 * c], c, 1, 0)]
    weights = c * 4 * c + 2 * c * c
    return sum(p[0] for p in parts), 4 * (2 * rows * c + weights)


def global_work(rows, c, j, k, inter, g):
    """The global branch alone: theta/phi/g projection, attention, cat."""
    width = 2 * k * inter + k * g
    parts = [gemm_work(rows, [c], width, 1, 0),
             attn_work(rows, j, k, inter, g),
             gemm_work(rows, [k * g], c, 1, 0)]
    weights = c * width + k * g * c
    return sum(p[0] for p in parts), 4 * (2 * rows * c + weights)


def level_work(rows_in, c_in, rows_out, c, conv_k, gab):
    """A level: its conv chain (conv_k MACs per output row and channel,
    conv_k * c weights) feeding a GAB whose work is ``gab``; the level
    reads its own input instead of the GAB's."""
    flops, nbytes = gab
    return (flops + 2 * rows_out * conv_k * c,
            nbytes + 4 * (rows_in * c_in - rows_out * c + conv_k * c))


def bound(flops, nbytes):
    t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# --------------------------------------------------------------------------
# gemm_epilogue by shape. The 15 launches of one 27f forward at B=1024
# windows, one line each, then the chain levels 2-3 of the 243f model at
# B=256: (label, windows, output frames, K of each piece, N, epilogue,
# taps, residual). Epilogue "bias" is scale 1 and a shift, "bn" a scale,
# shift and ReLU; taps (input frames, dilation) is a conv's row map over
# one input; residual (input frames, offset in frames). J = 17.
# --------------------------------------------------------------------------

GEMM_SHAPES = (
    ("27f L0 expand conv", 1024, 25, (2, 2, 2), 128, "bn", (27, 1), None),
    ("27f L0 projection", 1024, 25, (128,), 896, "bias", None, None),
    ("27f L0 local cat", 1024, 25, (256,), 128, "bn", None, None),
    ("27f L0 global cat", 1024, 25, (128,), 128, "bn", None, None),
    ("27f L0 block concat", 1024, 25, (128,) * 3, 256, "bn", None, None),
    ("27f L1 dilated conv", 1024, 19, (256,) * 3, 256, "bn", (25, 3), None),
    ("27f L1 1x1 + residual", 1024, 19, (256,), 256, "bn", None, (25, 3)),
    ("27f L1 projection", 1024, 19, (256,), 1792, "bias", None, None),
    ("27f L1 local cat", 1024, 19, (512,), 256, "bn", None, None),
    ("27f L1 global cat", 1024, 19, (256,), 256, "bn", None, None),
    ("27f L1 block concat", 1024, 19, (256,) * 3, 512, "bn", None, None),
    ("27f L2 projection", 1024, 1, (512,), 3584, "bias", None, None),
    ("27f L2 local cat", 1024, 1, (1024,), 512, "bn", None, None),
    ("27f L2 global cat", 1024, 1, (512,), 512, "bn", None, None),
    ("27f L2 block concat", 1024, 1, (512,) * 3, 1024, "bn", None, None),
    ("243f L2 projection", 256, 217, (128,), 896, "bias", None, None),
    ("243f L2 block concat", 256, 217, (128,) * 3, 256, "bn", None, None),
    ("243f L3 projection", 256, 163, (256,), 1792, "bias", None, None),
    ("243f L3 block concat", 256, 163, (256,) * 3, 512, "bn", None, None),
)


def gemm_case(spec, dev, seed: int, windows=None):
    """Operands of one ``GEMM_SHAPES`` line (at ``windows`` windows if
    given): (pieces, m, keyword arguments of ``gemm_epilogue``)."""
    import torch

    _, b, t_out, ks, n, epi, taps, res = spec
    b = windows or b
    j = 17
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    m = b * t_out * j
    w_scale = 1.0 / math.sqrt(sum(ks))
    if taps:
        t_in, d = taps
        a = rnd(b * t_in * j, ks[0])
        pieces = [(a, rnd(k, n) * w_scale, p * d * j)
                  for p, k in enumerate(ks)]
    else:
        t_in = t_out
        pieces = [(rnd(m, k), rnd(k, n) * w_scale, 0) for k in ks]
    kw = dict(s_out=t_out * j, a_s_in=t_in * j, relu=epi == "bn",
              scale=(rnd(n).abs() + 0.5 if epi == "bn"
                     else torch.ones(n, device=dev)),
              shift=rnd(n), res=None, res_s_in=t_out * j, res_off=0)
    if res:
        t_res, off = res
        kw.update(res=rnd(b * t_res * j, n), res_s_in=t_res * j,
                  res_off=off * j)
    return pieces, m, kw


def gemm_ragged_cases(dev):
    """Phase 2's held cases of ``gemm_epilogue``: (label, pieces, m,
    keyword arguments, the instantiation they must take)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(31)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def plain(m, k, n, **kw):
        return [(rnd(m, k), rnd(k, n), 0)], m, dict(
            scale=rnd(n), shift=rnd(n), **kw)

    def taps(c, n, d, res):
        b, t_in, j = 3, 11, 17
        t_out = t_in - 2 * d
        x = rnd(b * t_in * j, c)
        kw = dict(s_out=t_out * j, a_s_in=t_in * j, scale=rnd(n),
                  shift=rnd(n), relu=True)
        if res:
            kw.update(res=rnd(b * t_in * j, n), res_s_in=t_in * j,
                      res_off=d * j)
        return ([(x, rnd(c, n), k * d * j) for k in range(3)], b * t_out * j,
                kw)

    w_off = torch.empty(128 * 64 + 1, device=dev)[1:].view(128, 64)
    w_off.copy_(rnd(128, 64))
    cases = [
        ("M=1000, not a tile multiple", *plain(1000, 256, 256), "vec16"),
        ("M=100 < one tile", *plain(100, 64, 96, relu=True), "vec16"),
        ("K=2 taps", *taps(2, 128, 1, False), "general"),
        ("K=130, N=70", *plain(517, 130, 70, relu=True), "general"),
        ("3-piece concat", [(rnd(777, 128), rnd(128, 256), 0)
                            for _ in range(3)], 777,
         dict(scale=rnd(256), shift=rnd(256), relu=True), "vec16"),
        ("dilated taps + residual", *taps(128, 128, 3, True), "vec16"),
        ("dilated taps + residual, C=130, N=70", *taps(130, 70, 3, True),
         "general"),
        ("W at a 4-byte offset", [(rnd(300, 128), w_off, 0)], 300, {},
         "general"),
    ]
    for i, want in ((7, "vec16"), (0, "general")):  # 27f L1 proj, L0 conv
        cases.append((f"{GEMM_SHAPES[i][0]} (B=256)",
                      *gemm_case(GEMM_SHAPES[i], dev, 40 + i, windows=256),
                      want))
    return cases


def gemm_library_operands(pieces, m, kw):
    """torch.addmm's operands for the same product: [A_0 | A_1 | A_2]
    through the row map, and the stacked W (the yardstick only)."""
    import torch

    r = torch.arange(m, device=pieces[0][0].device)
    s_out = kw.get("s_out", m)
    base = (r // s_out) * kw.get("a_s_in", s_out) + r % s_out
    if len(pieces) == 1 and pieces[0][2] == 0 and torch.equal(base, r):
        return pieces[0][0], pieces[0][1]
    return (torch.cat([a[base + off] for a, _, off in pieces], 1),
            torch.cat([w for _, w, _ in pieces], 0))


def gemm_table(K, dev) -> list:
    """Phase 4's per-shape table: ``gemm_epilogue`` at each
    ``GEMM_SHAPES`` line, held to its plain version, beside its bound and
    one ``torch.addmm`` over the same product."""
    import torch

    print("phase 4: gemm_epilogue by shape (ms, TFLOP/s of the product)")
    rows = []
    for i, spec in enumerate(GEMM_SHAPES):
        label, _, _, ks, n, _, taps, _ = spec
        pieces, m, kw = gemm_case(spec, dev, seed=100 + i)
        variant = K.gemm_variant(pieces, n, kw["res"])
        err = check(label, K.gemm_epilogue(pieces, m, **kw),
                    K.gemm_epilogue_plain(pieces, m, **kw))
        ms = cuda_ms(lambda: K.gemm_epilogue(pieces, m, **kw))
        a_cat, w_cat = gemm_library_operands(pieces, m, kw)
        library_ms = cuda_ms(lambda: torch.addmm(kw["shift"], a_cat, w_cat))
        del a_cat, w_cat
        # Bytes: each input once (a conv's taps share one input).
        a_elems = (pieces[0][0].numel() if taps
                   else sum(a.numel() for a, _, _ in pieces))
        flops, nbytes = gemm_work(m, ks, n, 1, kw["res"] is not None)
        nbytes += 4 * (a_elems - m * sum(ks))
        bms, by = bound(flops, nbytes)
        tflops = 2 * m * n * sum(ks) / ms / 1e9
        rows.append({"shape": label, "m": m, "ks": list(ks), "n": n,
                     "variant": variant, "ms": ms, "tflops": tflops,
                     "library_ms": library_ms,
                     "library_tflops": 2 * m * n * sum(ks) / library_ms / 1e9,
                     "bound_ms": bms, "bound_by": by, "max_abs_err": err})
        print(f"  {label} [{variant}] M={m} K={'+'.join(map(str, ks))} "
              f"N={n}: {ms:.3f} ms, {tflops:.1f} TFLOP/s; torch.addmm "
              f"{library_ms:.3f} ms; bound {bms:.3f} by {by}")
        del pieces, kw
        torch.cuda.empty_cache()
    # One 27f B=1024 forward's products, summed.
    f27 = [r for r in rows if r["shape"].startswith("27f")]
    print(f"  the {len(f27)} 27f lines: {sum(r['ms'] for r in f27):.3f} ms; "
          f"torch.addmm {sum(r['library_ms'] for r in f27):.3f} ms")
    return rows


# --------------------------------------------------------------------------
# sem_graph and joint_attention by shape: their launches in one 27f B=1024
# and one 243f B=256 forward, (label, receptive field, GAB level, windows,
# frames at the GAB); J = 17.
# --------------------------------------------------------------------------

GRAPH_SHAPES = (("27f L0", 27, 0, 1024, 25), ("27f L1", 27, 1, 1024, 19),
                ("27f L2", 27, 2, 1024, 1), ("243f L2", 243, 2, 256, 217),
                ("243f L3", 243, 3, 256, 163), ("243f L4", 243, 4, 256, 1))


def graph_operands(K, t, rows, dev, seed, offset=0, pad=0):
    """``sem_graph``'s and ``joint_attention``'s arguments for the GAB
    tables ``t`` on one random projection output P of ``rows`` rows, as
    the chain views it: row stride 7C + ``pad``, P starting ``offset``
    floats past an aligned allocation."""
    import torch

    c, k, inter, _, _, _ = K.gab_shape(t)
    width = t.w_proj.shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(rows * (width + pad) + offset, generator=gen,
                       device=dev)
    p = flat[offset:].view(rows, width + pad)[:, :width]
    ki = k * inter
    return ((p, c, t.w_self, t.w_nbr, t.col, t.sem_scale, t.sem_shift),
            (p[:, 4 * c:4 * c + ki], p[:, 4 * c + ki:4 * c + 2 * ki],
             p[:, 4 * c + 2 * ki:], t.proj_t, t.proj_p, t.c_k))


def head_operands(t, frames, dev, seed, head=0):
    """``head_attention``'s arguments for one head of the GAB tables ``t``
    on one random (frames, J, 2KI + KG) projection, as the hybrid route
    views it."""
    import torch

    k, inter = t.proj_t.shape
    j = t.c_k.shape[1]
    g_ch = (t.w_proj.shape[1] - 4 * t.w_proj.shape[0] - 2 * k * inter) // k
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = torch.randn((frames, j, 2 * k * inter + k * g_ch), generator=gen,
                    device=dev)
    h0 = 2 * k * inter + head * g_ch
    return (p[..., head * inter:(head + 1) * inter],
            p[..., (k + head) * inter:(k + head + 1) * inter],
            p[..., h0:h0 + g_ch], t.proj_t[head].reshape(-1, 1),
            t.proj_p[head].reshape(-1, 1), t.c_k[head])


def launched_variant(K, kernel, call):
    """Run ``call``; return (the instantiation of ``kernel`` it launched,
    its result)."""
    counts = K.VARIANT_LAUNCHES[kernel]
    before = dict(counts)
    got = call()
    taken = [v for v in counts if counts[v] != before[v]]
    return (taken[0] if len(taken) == 1 else str(taken)), got


def device_ms(fn, key: str, reps: int = 20) -> float:
    """Device time per launch of the kernels whose name holds ``key``, from
    torch.profiler over ``reps`` calls of ``fn``, so that launch overhead
    does not hide a small shape. Raises if the profiler records no such
    kernel, so that the yardstick cannot change without notice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and key in ev.key:
            total += ev.self_device_time_total
            count += ev.count
    if not count:
        raise RuntimeError(f"the profiler recorded no kernel named *{key}*")
    return total / 1e3 / count


def graph_table(K, models, dev) -> list:
    """Phase 4's "graph kernels by shape": ``sem_graph`` and
    ``joint_attention`` at each ``GRAPH_SHAPES`` launch of ``models``
    (keyed by receptive field), each held to its plain version, with its
    device time per launch, bound, GB/s and the instantiation that
    launched."""
    import torch
    from gastx_torch.ops.cuda.fused_gab import gab_tables

    print("phase 4: graph kernels by shape (device ms per launch)")
    out = []
    for i, (label, rf, level, b, t_gab) in enumerate(GRAPH_SHAPES):
        m = models[rf]
        t = gab_tables(m.layers_graph_conv[level], m.statics)
        c, k, inter, g_ch, j, d = K.gab_shape(t)
        rows = b * t_gab * j
        sem, attn = graph_operands(K, t, rows, dev, seed=200 + i)
        for name, fn, plain, args, work in (
                ("sem_graph", K.sem_graph, K.sem_graph_plain, sem,
                 sem_work(rows, c, j, d)),
                ("joint_attention", K.joint_attention,
                 K.joint_attention_plain, attn,
                 attn_work(rows, j, k, inter, g_ch))):
            variant, got = launched_variant(K, name, lambda: fn(*args))
            err = check(f"{name} {label} [{variant}]", got, plain(*args))
            del got
            ms = device_ms(lambda: fn(*args), f"{name}_kernel")
            bms, by = bound(*work)
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


def graph_cases(K, dev, seed_model):
    """Phase 2's held cases of the graph kernels: (label, kernel, fn, plain
    fn, args, the instantiation it must take). Frame counts ragged against
    both kernels' frame tiles (1, 7, 4001 frames; tiles of 4 frames in
    sem_graph, 1 to 8 in joint_attention) at C=128, 256 and 512 and on the
    15/16/19-joint layouts at C=256; P at a 4-byte offset and at an odd row
    stride; the 8-channel model's GAB (heads of I = 2); ``head_attention``'s
    one-head views at C=256 and C=8. ``seed_model(frames, joints,
    channels)`` builds a model."""
    from gastx_torch.ops.cuda.fused_gab import gab_tables
    from gastx_torch.ops.cuda.head_attn import (head_attention,
                                                head_attention_plain)

    cases = []

    def both(label, t, rows, want_sem, want_attn, **kw):
        sem, attn = graph_operands(K, t, rows, dev, seed=len(cases), **kw)
        cases.append((label, "sem_graph", K.sem_graph, K.sem_graph_plain,
                      sem, want_sem))
        cases.append((label, "joint_attention", K.joint_attention,
                      K.joint_attention_plain, attn, want_attn))

    m17 = seed_model(27, 17, None)
    for j, levels in ((17, (0, 1, 2)), (15, (1,)), (16, (1,)), (19, (1,))):
        m = m17 if j == 17 else seed_model(27, j, None)
        for level in levels:
            t = gab_tables(m.layers_graph_conv[level], m.statics)
            for frames in (1, 7, 4001):
                both(f"J={j}, C={t.w_proj.shape[0]}, {frames} frames", t,
                     frames * j, "vec16", "vec16")
    t1 = gab_tables(m17.layers_graph_conv[1], m17.statics)
    both("C=256, P at a 4-byte offset", t1, 1000 * 17, "general", "general",
         offset=1)
    both("C=256, row stride 7C + 1", t1, 1000 * 17, "general", "general",
         pad=1)
    m8 = seed_model(27, 17, 8)
    t8 = gab_tables(m8.layers_graph_conv[0], m8.statics)
    both("C=8 (I=2), 7 frames", t8, 7 * 17, "vec16", "general")
    for label, t, want in (("C=256", t1, "vec16"), ("C=8", t8, "general")):
        cases.append((f"head_attention one head, {label}, 1000 frames",
                      "joint_attention", head_attention, head_attention_plain,
                      head_operands(t, 1000, dev, seed=len(cases)), want))
    return cases


def profile_forward(model, x, label):
    """Phase 5: :func:`profile_call` on one forward."""
    return profile_call(lambda: model(x),
                        f"phase 5: torch.profiler trace of one {label} "
                        f"forward")


def profile_call(fn, title):
    """Device time of one call of ``fn`` by kernel, from torch.profiler,
    the kernels it ran, and the device's idle share of the call's
    CUDA-event time (both under the profiler's own overhead). Returns None,
    and says "not measured", if the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(title)
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    groups: dict = {}
    for ev in prof.key_averages():
        # Device-side events only: a CPU op's entry repeats the device time
        # of the kernels it launched.
        dev_ms = ev.self_device_time_total / 1e3
        if ev.device_type != DeviceType.CUDA or dev_ms <= 0:
            continue
        name = next((k for k in ("gemm_epilogue", "sem_graph",
                                 "joint_attention", "gab_narrow")
                     if f"{k}_kernel" in ev.key), f"other: {ev.key[:70]}")
        g = groups.setdefault(name, [0.0, 0])
        g[0] += dev_ms
        g[1] += ev.count
    busy = sum(v[0] for v in groups.values())
    if busy == 0:
        print("  no device time recorded: not measured")
        return None
    for name, (ms, n) in sorted(groups.items(),
                                key=lambda kv: -kv[1][0])[:12]:
        print(f"  {ms:9.3f} ms  {n:4d}x  {name}")
    idle = max(0.0, 1.0 - busy / wall_ms)
    launched = sum(v[1] for v in groups.values())
    print(f"  device busy {busy:.3f} of {wall_ms:.3f} ms: idle share "
          f"{idle:.4f}; {launched} device operations")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": idle,
            "device_operations": launched,
            "by_kernel": {k: {"ms": v[0], "count": v[1]}
                          for k, v in groups.items()}}


# Each entry of the kernels line: (name, launch counter, source, the TPU
# kernel it replaces). The four CUDA kernels count their own launches;
# each entry point counts the kernel launches made inside it, and the
# fused_gab entries count every GAB of their width class (C < 128, the
# narrow levels of 81f/243f; 128 <= C <= 256; C = 512, the last level).
KERNELS = (
    ("gemm_epilogue", "gemm_epilogue", "gastx_torch/csrc/gemm_epilogue.cu",
     "gastx/ops/pallas/fused_gab.py:469"),
    ("sem_graph", "sem_graph", "gastx_torch/csrc/sem_graph.cu",
     "gastx/ops/pallas/fused_gab.py:182"),
    ("joint_attention", "joint_attention",
     "gastx_torch/csrc/joint_attention.cu",
     "gastx/ops/pallas/fused_gab.py:248"),
    ("fused_level0", "fused_level0", "gastx_torch/ops/cuda/fused_level.py",
     "gastx/ops/pallas/fused_level.py:194"),
    ("fused_level", "fused_level", "gastx_torch/ops/cuda/fused_level.py",
     "gastx/ops/pallas/fused_level.py:116"),
    ("fused_gab (C=128, T=25)", "fused_gab",
     "gastx_torch/ops/cuda/fused_gab.py",
     "gastx/ops/pallas/fused_gab.py:798"),
    ("fused_gab (C=512, T=1)", "fused_gab_split",
     "gastx_torch/ops/cuda/fused_gab.py",
     "gastx/ops/pallas/fused_gab.py:1175"),
    ("gab_narrow", "gab_narrow", "gastx_torch/csrc/gab_narrow.cu",
     "gastx/ops/pallas/fused_gab.py:959"),
    ("fused_gab (C=32, T=241)", "fused_gab_pbatch",
     "gastx_torch/ops/cuda/fused_gab.py",
     "gastx/ops/pallas/fused_gab.py:959"),
    ("fused_gab (C=64, T=79)", "fused_gab_pbatch",
     "gastx_torch/ops/cuda/fused_gab.py",
     "gastx/ops/pallas/fused_gab.py:959"),
    ("fused_gab_packed (C=32, T=241)", "fused_gab_packed",
     "gastx_torch/ops/cuda/fused_gab.py",
     "gastx/ops/pallas/fused_gab.py:1053"),
    ("fused_gab_packed (C=64, T=235)", "fused_gab_packed",
     "gastx_torch/ops/cuda/fused_gab.py",
     "gastx/ops/pallas/fused_gab.py:1053"),
    ("fused_local_branch (C=128, T=25)", "fused_local_branch",
     "gastx_torch/ops/cuda/fused_gab.py",
     "gastx/ops/pallas/fused_gab.py:1118"),
    ("fused_local_branch (C=512, T=1)", "fused_local_branch",
     "gastx_torch/ops/cuda/fused_gab.py",
     "gastx/ops/pallas/fused_gab.py:1118"),
    ("head_attention (C=256, T=19)", "head_attention",
     "gastx_torch/ops/cuda/head_attn.py",
     "gastx/ops/pallas/head_attn.py:61"),
    ("fused_global_attention (C=128, T=25)", "fused_global_attention",
     "gastx_torch/ops/cuda/global_attn.py",
     "gastx/ops/pallas/global_attn.py:113"),
    ("fused_global_attention (C=512, T=1)", "fused_global_attention",
     "gastx_torch/ops/cuda/global_attn.py",
     "gastx/ops/pallas/global_attn.py:113"),
)
# No model route reaches fused_global_attention, in the JAX package or
# here: its counter stays 0 on the main paths, and so do its kernels-line
# launches; its phase-2 calls go under "direct_launches".
OFF_PATH = ("fused_global_attention",)
# Entries timed at B=256 windows in phase 4 (the others at B=1024).
B256 = ("gab_narrow", "fused_gab (C=32, T=241)",
        "fused_gab_packed (C=32, T=241)", "fused_gab_packed (C=64, T=235)")

# The reconstruct requests of phase 3: (receptive field, frames).
REQUESTS = ((27, 50), (27, 277), (27, 1000), (81, 277), (81, 1000),
            (243, 277), (243, 1000))
# The other routes, by the config fields that pick them.
HYBRID = {"gab_impl": "pallas_local", "attn_impl": "pallas_head"}
PACKED = {"gab_impl": "pallas", "packed_channels": 64}
# The lift_sequences requests of phase 3: (cell, frames).
ROUTE_REQUESTS = (("27f hybrid", 1000), ("243f packed", 1000))
# The cells of phase 4: (cell, receptive field, batch of windows, route).
FORWARDS = (("27f", 27, 1024, {}), ("81f", 81, 1024, {}),
            ("243f", 243, 256, {}), ("27f hybrid", 27, 1024, HYBRID),
            ("243f packed", 243, 256, PACKED))


def launch_counts(K) -> dict:
    return {**K.LAUNCHES, **{f"{k} {v}": n
                             for k, counts in K.VARIANT_LAUNCHES.items()
                             for v, n in counts.items()},
            **K.ENTRY_LAUNCHES}


# Every view the main paths give the graph kernels meets the 16-byte rule:
# their 4-byte instantiations launch only in phase 2's cases.
GRAPH_GENERAL = ("sem_graph general", "joint_attention general")


# --------------------------------------------------------------------------

# The models of phase 2's odd-width forwards: channels=8 (GABs at C = 8,
# 16, 32) on each route that reaches fused_gab. C = 8 is off gab_narrow's
# shape rule, so its level must take the chain.
ODD_WIDTH_ROUTES = (("auto", {"gab_impl": "auto"}),
                    ("pallas", {"gab_impl": "pallas"}),
                    ("packed", {"gab_impl": "pallas", "packed_channels": 16}))


def odd_width_forwards(K, dev) -> dict:
    """Phase 2: the 8-channel model's forward (B=64 windows of 27 frames)
    on each of ODD_WIDTH_ROUTES, held to its plain reference forward, with
    the launches that show which kernels each GAB took."""
    import torch

    from gastx_torch.models import (GastNet, GastNetConfig, init_gastnet,
                                    randomize_eval_statistics)
    from gastx_torch.ops.cuda.fused_gab import gab_tables

    out = {}
    for label, route in ODD_WIDTH_ROUTES:
        gen = torch.Generator().manual_seed(8)
        m = GastNet(GastNetConfig(filter_widths=(3, 3, 3), channels=8,
                                  **route))
        m = randomize_eval_statistics(init_gastnet(m, gen), gen).to(dev)
        m = m.eval()
        routes = [K.gab_route(*K.gab_shape(gab_tables(g, m.statics)))
                  for g in m.layers_graph_conv]
        x = torch.randn((64, 27, 17, 2), generator=torch.Generator(
            device=dev).manual_seed(9), device=dev)
        K.reset_launches()
        y = m(x)
        torch.cuda.synchronize()
        launches = {k: K.LAUNCHES[k] for k in ("gab_narrow", "sem_graph")}
        want = {"gab_narrow": routes.count("gab_narrow"),
                "sem_graph": routes.count("chain")}
        if routes[0] != "chain" or launches != want:
            fail(f"channels=8 {label}: GAB routes {routes}, launches "
                 f"{launches}")
        err = check(f"channels=8 forward, {label} {tuple(x.shape)}", y,
                    m.reference_forward(x))
        out[label] = {"routes": routes, "launches": launches,
                      "max_abs_err": err}
    return out


# --------------------------------------------------------------------------
# The strided, dense, layout and streaming paths (phases 2, 6-8)
# --------------------------------------------------------------------------

# The GABs of one streaming push at M = 1 (a window of rf frames, strided
# at each level): (receptive field, GAB level, frames at the GAB); J = 17.
# 27f: 153, 51 and 17 rows at C = 128, 256, 512; 81f's GAB 0: 459 rows at
# C = 64.
STREAM_GABS = ((27, 0, 9), (27, 1, 3), (27, 2, 1), (81, 0, 27))


def small_row_cases(K, dev, seed_model) -> list:
    """Phase 2: the kernels at the rows one streaming push gives them
    (``STREAM_GABS``), each launch held to its plain version and checked to
    run on the instantiation ``gemm_variant`` or ``graph_variant`` picks:
    every launch of the GAB's chain, or its ``gab_narrow`` launch where
    ``gab_route`` picks that, and the GAB's whole output."""
    import torch
    from gastx_torch.ops.cuda.fused_gab import gab_tables

    def gemm_variant(pieces, m, **kw):
        return K.gemm_variant(pieces, pieces[0][1].shape[1], kw.get("res"))

    def sem_variant(p, c, *_):
        return K.graph_variant((p,), (c,))

    def attn_variant(theta, phi, g, proj_t, *_):
        k, inter = proj_t.shape
        return K.graph_variant((theta, phi, g), (inter, g.shape[1] // k))

    out = []
    for rf, level, frames in STREAM_GABS:
        m = seed_model(rf, 17, None)
        t = gab_tables(m.layers_graph_conv[level], m.statics)
        c, rows = t.w_proj.shape[0], frames * 17
        label = f"{rf}f GAB {level} (C={c}, {rows} rows)"
        x = torch.randn((rows, c), generator=torch.Generator(
            device=dev).manual_seed(300 + rows), device=dev)
        route = K.gab_route(*K.gab_shape(t))
        errs = []

        def held(name, fn, plain, variant_of):
            def run(*args, **kw):
                taken, got = launched_variant(K, name,
                                              lambda: fn(*args, **kw))
                want = variant_of(*args, **kw)
                if taken != want:
                    fail(f"{name} at {label}: took {taken}, not {want}")
                errs.append(check(f"{name} at {label} [{taken}]", got,
                                  plain(*args, **kw)))
                return got
            return run

        if route == "gab_narrow":
            before = K.LAUNCHES["gab_narrow"]
            got = K.gab_narrow(x, t)
            if K.LAUNCHES["gab_narrow"] != before + 1:
                fail(f"gab_narrow did not launch at {label}")
            errs.append(check(f"gab_narrow at {label}", got,
                              K.gab_narrow_plain(x, t)))
        else:
            got = K.gab_chain(
                x, t,
                held("gemm_epilogue", K.gemm_epilogue, K.gemm_epilogue_plain,
                     gemm_variant),
                held("sem_graph", K.sem_graph, K.sem_graph_plain,
                     sem_variant),
                held("joint_attention", K.joint_attention,
                     K.joint_attention_plain, attn_variant))
            errs.append(check(f"the GAB chain at {label}", got,
                              K.gab_chain(x, t, K.gemm_epilogue_plain,
                                          K.sem_graph_plain,
                                          K.joint_attention_plain)))
        out.append({"gab": label, "route": route, "max_abs_err": max(errs)})
    return out


def gab_launches(K, model) -> dict:
    """What one forward's GABs launch when none runs inside a level
    kernel: per GAB one ``gab_narrow``, or the chain's four
    ``gemm_epilogue`` launches, one ``sem_graph`` and one
    ``joint_attention``, as ``gab_route`` sends it."""
    from gastx_torch.ops.cuda.fused_gab import gab_tables

    routes = [K.gab_route(*K.gab_shape(gab_tables(g, model.statics)))
              for g in model.layers_graph_conv]
    chain = routes.count("chain")
    return {"gemm_epilogue": 4 * chain, "sem_graph": chain,
            "joint_attention": chain, "gab_narrow": routes.count("gab_narrow")}


def held_forward(K, label, model, x, variant, reps=10) -> dict:
    """One forward of ``variant`` with the launch counters zeroed just
    before and read just after, held to ``reference_forward`` on the same
    input, then timed (CUDA events) beside the plain reference."""
    import torch

    K.reset_launches()
    y = model(x, variant=variant)
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts(K).items() if v}
    err = check(f"{label} forward {tuple(x.shape)}", y,
                model.reference_forward(x, variant=variant))
    del y
    ms = cuda_ms(lambda: model(x, variant=variant), reps=reps)
    plain_ms = cuda_ms(lambda: model.reference_forward(x, variant=variant),
                       reps=3)
    b = x.shape[0]
    print(f"  {label} B={b}: {b / (ms / 1e3):.1f} windows/s ({ms:.3f} ms "
          f"per forward; plain {plain_ms:.3f} ms); launches {launches}")
    torch.cuda.empty_cache()
    return {"batch": b, "frames": x.shape[1], "variant": variant, "ms": ms,
            "seq_per_s": b / (ms / 1e3), "plain_ms": plain_ms,
            "max_abs_err": err, "launches_per_forward": launches}


# Phase 6: the strided forwards, (receptive field, causal), each on B=256
# windows of rf frames, and the 27f dense forward.
STRIDED_CELLS = ((27, False), (27, True), (81, False), (81, True),
                 (243, False), (243, True))
# Phase 7: the dilated "auto" forward on the other layouts, (receptive
# field, joints, windows).
LAYOUT_CELLS = ((27, 15, 1024), (27, 16, 1024), (27, 19, 1024),
                (243, 19, 256))
# Phase 8: streaming, (receptive field, persons) of causal models (the
# realtime CLI's -f 27 and -f 81), timed over PUSHES pushes after WARMUP
# ones, then HELD_FRAMES pushes held to the windows lifted offline.
STREAM_CELLS = ((27, 1), (27, 256), (81, 1), (81, 256))
WARMUP_PUSHES, PUSHES, HELD_FRAMES = 10, 200, 40


def stream_keypoints(frames: int, persons: int, seed: int):
    """(T, M, 17, 2) normalized keypoints: the synthetic person of
    ``synthetic_coco`` in H36M order, each stream shifted at random."""
    import numpy as np

    from gastx_torch.data import coco_h36m
    from gastx_torch.geometry import normalize_screen_coordinates

    kps, _ = coco_h36m(synthetic_coco(frames, seed)[0])
    seq = normalize_screen_coordinates(kps, w=1000, h=1002)
    rng = np.random.default_rng(seed)
    shift = rng.normal(0.0, 0.05, (1, persons, 1, 2))
    return (seq[:, None] + shift).astype(np.float32)


def streaming_cell(K, model, persons: int, label: str) -> dict:
    """Phase 8 for one cell: per-push latency (host clock around ``push``,
    which ends in the host copy), streams x pushes a second, launches a
    push by kernel (the counters zeroed just before the timed pushes and
    read just after, each push's GABs held to :func:`gab_launches`), one
    profiled push, and HELD_FRAMES streamed outputs against the same
    windows edge-padded and lifted offline by ``reference_forward``."""
    import numpy as np
    import torch

    from gastx_torch.infer import StreamingLifter

    rf = model.cfg.receptive_field()
    kps = stream_keypoints(WARMUP_PUSHES + PUSHES + 1, persons, seed=rf)
    lifter = StreamingLifter(model, num_person=persons)
    for i in range(WARMUP_PUSHES):
        lifter.push(kps[i])
    torch.cuda.synchronize()
    K.reset_launches()
    dts = []
    for i in range(WARMUP_PUSHES, WARMUP_PUSHES + PUSHES):
        t0 = time.perf_counter()
        pose = lifter.push(kps[i])
        dts.append(time.perf_counter() - t0)
    launches = {k: v / PUSHES for k, v in launch_counts(K).items() if v}
    want = {k: v for k, v in gab_launches(K, model).items() if v}
    got = {k: launches.get(k, 0) for k in ("gemm_epilogue", "sem_graph",
                                           "joint_attention", "gab_narrow")}
    if {k: v for k, v in got.items() if v} != want:
        fail(f"{label}: launches a push {launches}, want {want}")
    if pose.shape != (persons, 17, 3) or not np.isfinite(pose).all():
        fail(f"{label}: bad pose {pose.shape}")
    dts_ms = 1e3 * np.asarray(dts)
    p50, p99 = np.percentile(dts_ms, 50), np.percentile(dts_ms, 99)
    rate = persons * PUSHES / dts_ms.sum() * 1e3
    print(f"  {label}: push p50 {p50:.3f} ms, p99 {p99:.3f} ms; "
          f"{rate:.1f} stream-pushes/s; launches a push {launches}")
    prof = profile_call(lambda: lifter.push(kps[-1]),
                        f"phase 8: torch.profiler trace of one {label} push")
    # The streamed outputs against the offline windows, on a fresh stream.
    seq = stream_keypoints(HELD_FRAMES, persons, seed=rf + 1)
    lifter.reset()
    streamed = np.stack([lifter.push(f) for f in seq])
    padded = np.concatenate([np.repeat(seq[:1], rf - 1, axis=0), seq])
    offline = []
    for i in range(HELD_FRAMES):
        w = torch.from_numpy(np.ascontiguousarray(
            padded[i:i + rf].transpose(1, 0, 2, 3))).to(lifter.device)
        offline.append(model.reference_forward(w, variant="strided")[:, 0])
    err = check(f"{label} streamed vs offline ({HELD_FRAMES} frames)",
                torch.from_numpy(streamed).to(lifter.device),
                torch.stack(offline))
    return {"persons": persons, "push_p50_ms": p50, "push_p99_ms": p99,
            "push_mean_ms": float(dts_ms.mean()),
            "stream_pushes_per_s": rate, "launches_per_push": launches,
            "profile": prof, "max_abs_err": err}


def narrow_vs_chain(K, t, rows, dev, reps=200) -> dict:
    """``gab_narrow`` and the three-kernel chain on one GAB of ``rows`` rows:
    CUDA-event ms a call (launches included) and device ms a call (the
    profiler's kernel time), as ``gab_route`` would weigh them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn((rows, t.w_proj.shape[0]), generator=torch.Generator(
        device=dev).manual_seed(rows), device=dev)
    fns = {"gab_narrow": lambda: K.gab_narrow(x, t),
           "chain": lambda: K.gab_chain(x, t, K.gemm_epilogue, K.sem_graph,
                                        K.joint_attention)}
    out = {}
    for name, fn in fns.items():
        ms = cuda_ms(fn, reps=reps, warmup=10)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        dev_ms = sum(ev.self_device_time_total for ev in prof.key_averages()
                     if ev.device_type == DeviceType.CUDA) / 1e3 / 20
        out[name] = {"ms": ms, "device_ms": dev_ms}
    return out


def synthetic_coco(frames: int, seed: int):
    """(1, T, 17, 2) COCO keypoints of a person swaying across a 1000 x 1002
    frame, with detector-like jitter."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = np.array([[0, -160], [-8, -168], [8, -168], [-18, -160],
                     [18, -160], [-45, -110], [45, -110], [-60, -50],
                     [60, -50], [-65, 5], [65, 5], [-28, 10], [28, 10],
                     [-30, 95], [30, 95], [-32, 180], [32, 180]], np.float32)
    t = np.arange(frames, dtype=np.float32)[:, None, None]
    sway = np.stack([40 * np.sin(t / 25.0), 10 * np.cos(t / 13.0)], -1)[..., 0]
    kps = base[None] * (1.0 + 0.05 * np.sin(t / 40.0)) + sway \
        + np.array([500.0, 520.0], np.float32)
    kps += rng.normal(0.0, 2.0, kps.shape)
    return kps[None].astype(np.float32)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    try:
        import gastx_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: gastx_torch not found; run from the root of a "
              "checkout", file=sys.stderr)
        return 2
    import numpy as np

    import dataclasses

    from gastx_torch.cli import reconstruct as rc
    from gastx_torch.data import coco_h36m, save_keypoints_json
    from gastx_torch.geometry import normalize_screen_coordinates
    from gastx_torch.infer import lift_sequences
    from gastx_torch.models import (GastNet, config_for_frames, init_gastnet,
                                    randomize_eval_statistics)
    from torch.nn.modules.module import register_module_forward_hook
    from gastx_torch.ops.cuda import kernels as K
    from gastx_torch.ops.cuda.fused_gab import (
        fused_gab, fused_gab_packed, fused_gab_packed_plain, fused_gab_plain,
        fused_local_branch, fused_local_branch_plain, gab_tables,
        local_tables)
    from gastx_torch.ops.cuda.fused_level import (
        fused_level, fused_level0, fused_level0_plain, fused_level_plain,
        level0_tables, level_tables)
    from gastx_torch.ops.cuda.global_attn import (
        fused_global_attention, fused_global_attention_plain, global_tables)
    from gastx_torch.ops.cuda.head_attn import (head_attention,
                                                head_attention_plain)

    if (torch.get_float32_matmul_precision() != "highest"
            or torch.backends.cuda.matmul.allow_tf32):
        fail("float32 matmuls must run at 'highest' precision, TF32 off")
    dev = torch.device("cuda")
    report = {"device": torch.cuda.get_device_name(0)}
    t_start = time.time()

    # ---- phase 1: build -------------------------------------------------
    t0 = time.time()
    logs = K.build_kernels()
    report["build_s"] = time.time() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    report["card"] = smi
    print(f"phase 1: built {list(logs) or 'nothing (cached)'} in "
          f"{report['build_s']:.1f} s on {smi}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.split(':')[-1].strip()}")

    def build(frames, route):
        gen = torch.Generator().manual_seed(0 if frames == 27 else frames)
        m = GastNet(dataclasses.replace(config_for_frames(frames), **route))
        m = randomize_eval_statistics(init_gastnet(m, gen), gen)
        return m.to(dev).eval()

    seeded = {}

    def seed_model(frames, joints, channels):
        """A model of ``frames`` on ``joints`` joints with random weights
        from a seed: the shipped config, or its structure at ``channels``
        channels (built once)."""
        key = (frames, joints, channels)
        if key not in seeded:
            cfg = config_for_frames(frames, joints)
            if channels:
                cfg = dataclasses.replace(cfg, channels=channels)
            gen = torch.Generator().manual_seed(frames + joints
                                                + (channels or 0))
            m = randomize_eval_statistics(init_gastnet(GastNet(cfg), gen),
                                          gen)
            seeded[key] = m.to(dev).eval()
        return seeded[key]

    def variant_model(frames, joints=17, **fields):
        """The shipped config of ``frames`` on ``joints`` joints with
        ``fields`` replaced (causal, dense), random weights from a seed."""
        cfg = dataclasses.replace(config_for_frames(frames, joints), **fields)
        gen = torch.Generator().manual_seed(frames + joints + 1)
        m = randomize_eval_statistics(init_gastnet(GastNet(cfg), gen), gen)
        return m.to(dev).eval()

    models = {cell: build(rf, route) for cell, rf, _, route in FORWARDS}
    model = models["27f"]
    statics = model.statics
    j = model.cfg.num_joints_in
    gts = [gab_tables(g, statics) for g in model.layers_graph_conv]
    lts = [local_tables(g.local_graph_layer, statics)
           for g in model.layers_graph_conv]
    glts = [global_tables(g.global_graph_layer)
            for g in model.layers_graph_conv]
    l0t = level0_tables(model.init_bn, model.expand_conv, model.expand_bn)
    l1t = level_tables(*model.level_modules(1))
    m81, m243 = models["81f"], models["243f"]
    n81 = gab_tables(m81.layers_graph_conv[0], m81.statics)
    n243 = [gab_tables(m243.layers_graph_conv[i], m243.statics)
            for i in (0, 1)]
    l0_81 = level0_tables(m81.init_bn, m81.expand_conv, m81.expand_bn)
    l0_243 = level0_tables(m243.init_bn, m243.expand_conv, m243.expand_bn)
    l1_243 = level_tables(*m243.level_modules(1))

    def randn(*shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev)

    # Call sites of each kernel at the main path's shapes for a batch of
    # b windows: (kernel fn, plain fn, args builder).
    def shapes(b):
        x0 = randn(b, 27, j, 2, seed=1)
        x1 = randn(b, 25, j, 256, seed=2)
        x2 = randn(b, 1, j, 512, seed=3)
        x128 = randn(b, 25, j, 128, seed=6)
        g1 = gts[1]
        c1 = 256
        ki = g1.proj_t.numel()
        rows1 = b * 19 * j
        a1 = randn(rows1, c1, seed=4)
        p1 = randn(rows1, g1.w_proj.shape[1], seed=5)
        return {
            "gemm_epilogue": (K.gemm_epilogue, K.gemm_epilogue_plain,
                              ([(a1, g1.w_proj, 0)], rows1),
                              dict(scale=g1.proj_scale,
                                   shift=g1.proj_shift)),
            "sem_graph": (K.sem_graph, K.sem_graph_plain,
                          (p1, c1, g1.w_self, g1.w_nbr, g1.col,
                           g1.sem_scale, g1.sem_shift), {}),
            "joint_attention": (K.joint_attention, K.joint_attention_plain,
                                (p1[:, 4 * c1:4 * c1 + ki],
                                 p1[:, 4 * c1 + ki:4 * c1 + 2 * ki],
                                 p1[:, 4 * c1 + 2 * ki:], g1.proj_t,
                                 g1.proj_p, g1.c_k), {}),
            "fused_level0": (fused_level0, fused_level0_plain,
                             (x0, l0t, gts[0]), {}),
            "fused_level": (fused_level, fused_level_plain,
                            (x1, l1t, gts[1]),
                            dict(fw=3, dilation=3, res_off=3)),
            "fused_gab (C=128, T=25)": (fused_gab, fused_gab_plain,
                                        (x128, gts[0]), {}),
            "fused_gab (C=512, T=1)": (fused_gab, fused_gab_plain,
                                       (x2, gts[2]), {}),
        }

    # The narrow levels: the 243-frame model's levels 0-1 (C=32, 64) on
    # b243 windows, the 81-frame model's level 0 (C=64) on b81.
    def narrow_shapes(b243, b81):
        x32 = randn(b243, 241, j, 32, seed=11)
        x64 = randn(b81, 79, j, 64, seed=12)
        x235 = randn(b243, 235, j, 64, seed=16)
        return {
            "gab_narrow": (K.gab_narrow, K.gab_narrow_plain,
                           (x32.reshape(-1, 32), n243[0]), {}),
            "gab_narrow (C=64, T=79)": (K.gab_narrow, K.gab_narrow_plain,
                                        (x64.reshape(-1, 64), n81), {}),
            "gab_narrow (C=64, T=235)": (K.gab_narrow, K.gab_narrow_plain,
                                         (x235.reshape(-1, 64), n243[1]),
                                         {}),
            "fused_gab (C=32, T=241)": (fused_gab, fused_gab_plain,
                                        (x32, n243[0]), {}),
            "fused_gab (C=64, T=79)": (fused_gab, fused_gab_plain,
                                       (x64, n81), {}),
            "fused_level0 (C=32, T=243)": (
                fused_level0, fused_level0_plain,
                (randn(b243, 243, j, 2, seed=13), l0_243, n243[0]), {}),
            "fused_level0 (C=64, T=81)": (
                fused_level0, fused_level0_plain,
                (randn(b81, 81, j, 2, seed=14), l0_81, n81), {}),
            "fused_level (C=64, T=241)": (
                fused_level, fused_level_plain,
                (randn(b243, 241, j, 64, seed=15), l1_243, n243[1]),
                dict(fw=3, dilation=3, res_off=3)),
        }

    # The other routes' entry points: the 27-frame model's local and global
    # branches at C=128 (level 0) and C=512 (level 2) on b27 windows, one
    # head of its level 1 (C=256), and the packed GABs of the 243-frame
    # model's levels 0-1 (C=32, 64) on b243.
    def route_shapes(b27, b243):
        x128 = randn(b27, 25, j, 128, seed=21)
        x512 = randn(b27, 1, j, 512, seed=22)
        g1 = glts[1]
        k1, i1 = g1.proj_t.shape
        ki = k1 * i1
        p1 = randn(b27 * 19, j, g1.w_attn.shape[1], seed=23)
        g_ch = (p1.shape[-1] - 2 * ki) // k1
        head = (p1[..., :i1], p1[..., ki:ki + i1],
                p1[..., 2 * ki:2 * ki + g_ch],
                g1.proj_t[0].reshape(-1, 1), g1.proj_p[0].reshape(-1, 1),
                g1.c_k[0])
        return {
            "fused_gab_packed (C=32, T=241)": (
                fused_gab_packed, fused_gab_packed_plain,
                (randn(b243, 241, j * 32, seed=24), n243[0], j), {}),
            "fused_gab_packed (C=64, T=235)": (
                fused_gab_packed, fused_gab_packed_plain,
                (randn(b243, 235, j * 64, seed=25), n243[1], j), {}),
            "fused_local_branch (C=128, T=25)": (
                fused_local_branch, fused_local_branch_plain,
                (x128, lts[0]), {}),
            "fused_local_branch (C=512, T=1)": (
                fused_local_branch, fused_local_branch_plain,
                (x512, lts[2]), {}),
            "head_attention (C=256, T=19)": (
                head_attention, head_attention_plain, head, {}),
            "fused_global_attention (C=128, T=25)": (
                fused_global_attention, fused_global_attention_plain,
                (x128, glts[0]), {}),
            "fused_global_attention (C=512, T=1)": (
                fused_global_attention, fused_global_attention_plain,
                (x512, glts[2]), {}),
        }

    # ---- phase 2: each kernel against its plain version, B=256 ----------
    print("phase 2: kernels against their plain versions (B=256)")
    errs = {}
    K.reset_launches()
    for name, (fn, plain, args, kw) in {
            **shapes(256), **narrow_shapes(256, 256),
            **route_shapes(256, 256)}.items():
        errs[name] = check(name, fn(*args, **kw), plain(*args, **kw))
    phase2_launches = launch_counts(K)
    # gemm_epilogue's ragged cases, each on the instantiation it must take.
    gemm_errs = []
    for label, pieces, m, kw, want in gemm_ragged_cases(dev):
        taken, got = launched_variant(
            K, "gemm_epilogue", lambda: K.gemm_epilogue(pieces, m, **kw))
        if taken != want:
            fail(f"gemm_epilogue {label}: took {taken}, not {want}")
        gemm_errs.append(check(f"gemm_epilogue {label} ({want})", got,
                               K.gemm_epilogue_plain(pieces, m, **kw)))
        del got
    # The graph kernels' ragged, layout and unaligned cases, likewise.
    graph_errs = {"sem_graph": [], "joint_attention": []}
    for label, kernel, fn, plain, args, want in graph_cases(K, dev,
                                                           seed_model):
        taken, got = launched_variant(K, kernel, lambda: fn(*args))
        if taken != want:
            fail(f"{kernel} {label}: took {taken}, not {want}")
        graph_errs[kernel].append(check(f"{kernel} {label} ({want})", got,
                                        plain(*args)))
        del got
    torch.cuda.empty_cache()
    report["odd_width_forwards"] = odd_width_forwards(K, dev)
    torch.cuda.empty_cache()
    print("phase 2: the kernels at one streaming push's rows (M = 1)")
    report["small_rows"] = small_row_cases(K, dev, seed_model)
    torch.cuda.empty_cache()

    # ---- phase 3: reconstruct requests (the main paths) ----------------
    print("phase 3: reconstruct requests")
    os.makedirs(WORK_DIR, exist_ok=True)
    requests = []
    forwards = []  # (model, input batch, kernel-route output) of each call

    def record(module, inputs, output):
        if isinstance(module, GastNet):
            forwards.append((module, inputs[0], output))

    hook = register_module_forward_hook(record)
    K.reset_launches()
    for i, (rf, frames) in enumerate(REQUESTS):
        kps = synthetic_coco(frames, seed=i)
        path = os.path.join(WORK_DIR, f"request{i}.json")
        save_keypoints_json(path, kps, np.ones(kps.shape[:3], np.float32))
        argv = ["-k", path, "-f", str(rf), "--random-weights", "--no-render",
                "-vo", os.path.join(WORK_DIR, f"request{i}.mp4")]
        t0 = time.time()
        out = rc.reconstruct(rc.parse_args(argv))
        torch.cuda.synchronize()
        dt = time.time() - t0
        if out.shape != (frames, j, 3) or not np.isfinite(out).all():
            fail(f"request {i}: bad output {out.shape}")
        requests.append({"model": rf, "frames": frames, "s": dt})
        print(f"  request {i}: -f {rf}, {frames} frames -> {out.shape}, "
              f"{dt:.3f} s")
    # The other routes have no CLI flag (nor has the JAX CLI): lift the
    # 1000-frame sequence, converted and normalized as the CLI does it.
    for cell, frames in ROUTE_REQUESTS:
        i = len(requests)
        kps, _ = coco_h36m(synthetic_coco(frames, seed=i)[0])
        seq = normalize_screen_coordinates(kps, w=rc.WIDTH, h=rc.HEIGHT)
        t0 = time.time()
        out = lift_sequences(models[cell], [seq.astype(np.float32)])[0]
        torch.cuda.synchronize()
        dt = time.time() - t0
        if out.shape != (frames, j, 3) or not np.isfinite(out).all():
            fail(f"request {i}: bad output {out.shape}")
        requests.append({"model": cell, "frames": frames, "s": dt})
        print(f"  request {i}: {cell} ({models[cell].cfg.gab_impl}, "
              f"{models[cell].cfg.attn_impl}, packed_channels "
              f"{models[cell].cfg.packed_channels}), {frames} frames -> "
              f"{out.shape}, {dt:.3f} s")
    main_launches = launch_counts(K)
    hook.remove()
    print(f"  launches: {main_launches}")
    for name, count in main_launches.items():
        if name in GRAPH_GENERAL:
            if count:
                fail(f"{name} launched {count} times on the main path")
        elif count <= 0 and name not in OFF_PATH:
            fail(f"{name} was not launched on the main path")
    if len(forwards) != len(requests):
        fail(f"{len(forwards)} forwards recorded for {len(requests)} "
             f"requests")
    level0_convs = sum(module.cfg.gab_impl == "auto"
                       for module, _, _ in forwards)
    if main_launches["gemm_epilogue general"] != level0_convs:
        fail(f"{main_launches['gemm_epilogue general']} general gemm_epilogue "
             f"launches for {level0_convs} level-0 expand convs")
    for i, (module, xb, yb) in enumerate(forwards):
        requests[i]["batch"] = list(xb.shape)
        requests[i]["max_abs_err"] = check(
            f"request {i} forward {tuple(xb.shape)}", yb,
            module.reference_forward(xb))
    del forwards
    report["requests"] = requests
    report["main_path_launches"] = main_launches

    # ---- phase 4: the forwards and each kernel's time -------------------
    print("phase 4: full-width forwards")
    report["forwards"] = {}
    xs = {}
    for cell, rf, b, _ in FORWARDS:
        m = models[cell]
        x = xs[cell] = randn(b, rf, j, 2, seed=7)
        K.reset_launches()
        y = m(x)
        torch.cuda.synchronize()
        per_forward = {k: v for k, v in launch_counts(K).items() if v}
        general = K.VARIANT_LAUNCHES["gemm_epilogue"]["general"]
        if general != (m.cfg.gab_impl == "auto"):
            fail(f"{cell}: {general} general gemm_epilogue launches in one "
                 f"forward")
        if any(per_forward.get(name) for name in GRAPH_GENERAL):
            fail(f"{cell}: a 4-byte graph kernel launched: {per_forward}")
        y_plain = m.reference_forward(x)
        fwd_err = check(f"{cell} forward (B={b})", y, y_plain)
        del y, y_plain
        fwd_ms = cuda_ms(lambda: m(x))
        plain_fwd_ms = cuda_ms(lambda: m.reference_forward(x), reps=3)
        report["forwards"][cell] = {
            "batch": b, "ms": fwd_ms, "seq_per_s": b / (fwd_ms / 1e3),
            "plain_ms": plain_fwd_ms, "max_abs_err": fwd_err,
            "launches_per_forward": per_forward}
        print(f"  {cell} B={b}: {b / (fwd_ms / 1e3):.1f} seq/s ({fwd_ms:.2f} "
              f"ms per forward; plain {plain_fwd_ms:.2f} ms); launches per "
              f"forward {per_forward}")
        torch.cuda.empty_cache()

    b = 1024
    g1 = gts[1]
    k, inter = g1.proj_t.shape
    g_ch = (g1.w_proj.shape[1] - 4 * 256 - 2 * k * inter) // k
    d = g1.col.shape[2]
    rows = {"l0": b * 25 * j, "l1": b * 19 * j, "l2": b * j}
    work = {
        "gemm_epilogue": gemm_work(rows["l1"], [256], g1.w_proj.shape[1],
                                   1, 0),
        "sem_graph": sem_work(rows["l1"], 256, j, d),
        "joint_attention": attn_work(rows["l1"], j, k, inter, g_ch),
    }
    gab = {c: gab_work(rows[lv], c, j, 4, c // 4, c // 4, d)
           for lv, c in (("l0", 128), ("l1", 256), ("l2", 512))}
    work["fused_level0"] = level_work(b * 27 * j, 2, rows["l0"], 128, 3 * 2,
                                      gab[128])
    work["fused_level"] = level_work(b * 25 * j, 256, rows["l1"], 256,
                                     4 * 256, gab[256])
    work["fused_gab (C=128, T=25)"] = gab[128]
    work["fused_gab (C=512, T=1)"] = gab[512]
    work["gab_narrow"] = gab_work(256 * 241 * j, 32, j, 4, 8, 8, d)
    work["fused_gab (C=32, T=241)"] = work["gab_narrow"]
    work["fused_gab (C=64, T=79)"] = gab_work(b * 79 * j, 64, j, 4, 16, 16,
                                              d)
    work["fused_gab_packed (C=32, T=241)"] = work["gab_narrow"]
    work["fused_gab_packed (C=64, T=235)"] = gab_work(256 * 235 * j, 64, j,
                                                      4, 16, 16, d)
    work["fused_local_branch (C=128, T=25)"] = local_work(rows["l0"], 128, j,
                                                          d)
    work["fused_local_branch (C=512, T=1)"] = local_work(rows["l2"], 512, j,
                                                         d)
    work["head_attention (C=256, T=19)"] = attn_work(rows["l1"], j, 1, inter,
                                                     g_ch)
    work["fused_global_attention (C=128, T=25)"] = global_work(
        rows["l0"], 128, j, 4, 32, 32)
    work["fused_global_attention (C=512, T=1)"] = global_work(
        rows["l2"], 512, j, 4, 128, 128)

    kernels = []
    calls = {**shapes(b), **narrow_shapes(256, b), **route_shapes(b, 256)}
    for name, counter, source, replaces in KERNELS:
        fn, plain, args, kw = calls[name]
        nb = 256 if name in B256 else b
        err = check(f"{name} (B={nb})", fn(*args, **kw), plain(*args, **kw))
        ms = cuda_ms(lambda: fn(*args, **kw))
        plain_ms = cuda_ms(lambda: plain(*args, **kw), reps=3)
        library_ms = None
        if name == "gemm_epilogue":  # a bias (scale 1): one addmm
            (a, w, _), = args[0]
            library_ms = cuda_ms(lambda: torch.addmm(kw["shift"], a, w))
        bms, by = bound(*work[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_launches[counter],
            "max_abs_err": max(err, errs[name]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms})
        if counter in OFF_PATH:
            kernels[-1]["direct_launches"] = phase2_launches[counter]
        if name in K.VARIANT_LAUNCHES:  # max_abs_err: the main shape alone
            kernels[-1]["launches_by_variant"] = {
                v: main_launches[f"{name} {v}"] for v in K.VARIANTS}
            kernels[-1]["ragged_max_abs_err"] = max(
                gemm_errs if name == "gemm_epilogue" else graph_errs[name])
        print(f"  {name}: {ms:.3f} ms (plain {plain_ms:.3f}, bound "
              f"{bms:.3f} by {by}"
              + (f", torch.addmm {library_ms:.3f}" if library_ms else "")
              + ")")
        torch.cuda.empty_cache()

    # gab_narrow beside the three-kernel chain, at the three narrow GABs
    # of the shipped models (kernels.gab_route follows such numbers).
    report["gab_narrow_vs_chain"] = {}
    for key, label in (("gab_narrow", "C=32, T=241, B=256"),
                       ("gab_narrow (C=64, T=79)", "C=64, T=79, B=1024"),
                       ("gab_narrow (C=64, T=235)", "C=64, T=235, B=256")):
        x2, t = calls[key][2]
        c = x2.shape[1]
        ms = cuda_ms(lambda: K.gab_narrow(x2, t))
        chain_ms = cuda_ms(lambda: K.gab_chain(
            x2, t, K.gemm_epilogue, K.sem_graph, K.joint_attention))
        bms, by = bound(*gab_work(x2.shape[0], c, j, 4, c // 4, c // 4, d))
        report["gab_narrow_vs_chain"][label] = {
            "ms": ms, "chain_ms": chain_ms, "bound_ms": bms, "bound_by": by}
        print(f"  gab_narrow ({label}): {ms:.3f} ms; the chain "
              f"{chain_ms:.3f} ms; bound {bms:.3f} by {by}")
    del calls
    torch.cuda.empty_cache()
    report["gemm_shapes"] = gemm_table(K, dev)
    report["graph_shapes"] = graph_table(
        K, {27: model, 243: models["243f"]}, dev)
    report["profile"] = profile_forward(model, xs["27f"], "27f B=1024")
    report["profile_243f"] = profile_forward(models["243f"], xs["243f"],
                                             "243f B=256")
    for cell in ("27f hybrid", "243f packed"):
        report[f"profile_{cell.replace(' ', '_')}"] = profile_forward(
            models[cell], xs[cell], f"{cell} B={xs[cell].shape[0]}")

    # ---- phase 6: the strided and dense forwards -----------------------
    def gab_path(label, m, cell):
        """The launches of a forward that no level kernel runs: each GAB's
        kernels as gab_route sends it, the 16-byte instantiations only."""
        got = cell["launches_per_forward"]
        want = {k: v for k, v in gab_launches(K, m).items() if v}
        if ({k: got[k] for k in K.KERNEL_SOURCES if k in got} != want
                or got.get("fused_level0") or got.get("fused_level")
                or any(got.get(f"{k} general") for k in K.VARIANT_KERNELS)):
            fail(f"{label}: launches {got}, want {want} and no level kernel")

    print("phase 6: strided (windows of rf frames) and dense forwards, "
          "B=256")
    report["strided_forwards"] = {}
    for rf, causal in STRIDED_CELLS:
        label = f"{rf}f strided{' causal' if causal else ''}"
        m = variant_model(rf, causal=causal)
        cell = held_forward(K, label, m, randn(256, rf, j, 2, seed=60 + rf),
                            "strided")
        gab_path(label, m, cell)
        report["strided_forwards"][label] = cell
        del m
    m = variant_model(27, dense=True)
    cell = held_forward(K, "27f dense", m, randn(256, 27, j, 2, seed=61),
                        "dilated")
    gab_path("27f dense", m, cell)
    report["dense_forward"] = cell
    del m

    # ---- phase 7: the dilated forward on the other layouts -------------
    print("phase 7: the dilated forward on the 15/16/19-joint layouts")
    report["layout_forwards"] = {}
    for rf, joints, b in LAYOUT_CELLS:
        label = f"{rf}f J={joints}"
        m = variant_model(rf, joints)
        cell = held_forward(K, label, m,
                            randn(b, rf, joints, 2, seed=70 + joints),
                            "dilated", reps=5)
        got, want = cell["launches_per_forward"], gab_launches(K, m)
        if (not got.get("fused_level0") or not got.get("fused_level")
                or any(got.get(k, 0) != want[k]
                       for k in ("sem_graph", "joint_attention",
                                 "gab_narrow"))):
            fail(f"{label}: launches {got}; GABs want {want}")
        report["layout_forwards"][label] = cell
        del m

    # ---- phase 8: causal streaming --------------------------------------
    print("phase 8: causal streaming through StreamingLifter")
    report["streaming"] = {}
    stream_models = {}
    for rf, persons in STREAM_CELLS:
        if rf not in stream_models:
            stream_models[rf] = variant_model(rf, causal=True)
        label = f"{rf}f M={persons}"
        report["streaming"][label] = streaming_cell(
            K, stream_models[rf], persons, label)
        torch.cuda.empty_cache()
    m81 = stream_models[81]
    t81 = gab_tables(m81.layers_graph_conv[0], m81.statics)
    route = K.gab_route(*K.gab_shape(t81))
    vs = narrow_vs_chain(K, t81, 27 * j, dev)
    report["stream_gab0_81f"] = {"route": route, **vs}
    print(f"  81f GAB 0 at one push's 459 rows (C=64), routed to {route}: "
          f"gab_narrow {vs['gab_narrow']['ms']:.4f} ms a call "
          f"({vs['gab_narrow']['device_ms']:.4f} on the device); the chain "
          f"{vs['chain']['ms']:.4f} ({vs['chain']['device_ms']:.4f})")
    del stream_models, m81

    report["kernels"] = kernels
    report["total_s"] = time.time() - t_start
    print(f"chip_smoke: total {report['total_s']:.1f} s (build "
          f"{report['build_s']:.1f} s)")

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    if not all(math.isfinite(kk["ms"]) for kk in kernels):
        fail("a kernel time is not finite")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
