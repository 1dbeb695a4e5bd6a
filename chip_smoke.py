"""Drive the gastx_torch main path on one GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and the CUDA toolkit (``nvcc``); it imports nothing of JAX or
of the ``gastx`` package. Phases, in order; any failure ends the run with
a non-zero exit and no result line:

  1. build the seven CUDA kernels from ``gastx_torch/csrc`` (one ``nvcc``
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
     instantiation ``gemm_variant`` must pick, 16-byte or general, or
     ``gemm_smallk`` (the K = 2 taps); then ``gemm_smallk`` at
     ``"highest"`` and every tier on its cases (``smallk_cases``: the
     three expand convs at small B, one push's rows, ragged M, N = 32 /
     36 / 64 / 128 / 1028, one to three pieces at row offsets, a
     residual, no scale, ReLU off), each checked to launch it at its tier
     and nothing else, held to ``gemm_epilogue_plain`` and, at
     ``"highest"``, bitwise to the general ``gemm_epilogue``; then
     ``gemm_wgrad`` at every call of one tiered strided train step of the
     27f model at B=1024 and the 243f one at B=256, all ``high`` and the
     JAX preset (``wgrad_cases``: each distinct shape and tier held to
     ``gemm_wgrad_plain`` as it is made and bitwise to a second launch,
     every instantiation reached), and five 27f calls timed for the
     kernels line, the three instantiations at their main-path shapes
     (``wgrad_rows``; every call's time: ``scripts/torch_train_tiers.py``);
     then
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
     instantiation ``gemm_variant`` or ``graph_variant`` picks; then the
     bf16-I/O forms (``bf16_cases``): ``gemm_epilogue`` on the 27f
     products with bf16 A pieces (the block concat's [x | local |
     global] with x bf16 and a bf16 output, the projection, the conv
     taps), a bf16 residual, the 243f N = 64 and 81f N = 128 block
     concats, taps with a bf16 residual, and a ragged bf16 product on its
     general instantiation; ``gemm_tc`` at every tier on each of them
     (its ``vec16_bf16`` instantiation) and on three ragged bf16
     products (``BF16_TC_RAGGED``: its general one; one of them three
     pieces, a bf16 one beside two float32 ones, with a bf16 residual and
     output); ``gab_narrow`` at C = 32 and
     64, bf16 in and out and
     float32 in, bf16 out; ``fused_gab`` and ``fused_level`` on bf16
     activations; each checked to launch its kernel with its I/O dtypes
     (``DTYPE_LAUNCHES``) and held to its plain version (a bf16 output
     within one bf16 step, ``check_bf16``);
  3. run reconstruct requests through ``gastx_torch.cli.reconstruct
     --random-weights --no-render`` on synthetic COCO keypoint files: 50,
     277 and 1000 frames with the 27-frame model, 277 and 1000 frames with
     ``-f 81`` and ``-f 243``; then two requests through
     ``gastx_torch.infer.lift_sequences`` on the 1000-frame sequence: the
     27-frame model on the hybrid route (``gab_impl="pallas_local"``,
     ``attn_impl="pallas_head"``) and the 243-frame model on the packed
     one (``gab_impl="pallas"``, ``packed_channels=64``); then trained
     weights: the 27-frame model of ``build_gastnet``'s seed
     ``WEIGHT_SEED`` saved as a port ``.pt`` and read through ``-w``, held
     to ``--random-weights --seed WEIGHT_SEED`` on the same file; then one
     request each for ``-kf mpii``, ``-kf openpose`` and ``-kf wholebody``
     (``-n 19``) on seeded files of those layouts (``synthetic_layout``).
     Every request passes ``-vi`` a missing video, so the normalization
     falls back to 1000x1002 as the JAX CLI's does; none renders (the
     card's machine has neither matplotlib nor cv2). The requests' seconds
     are printed beside the card's name and power limit. The launch
     counters are zeroed just before and read just after, so they show
     the main paths ran every kernel and every entry point but
     ``fused_global_attention``, which no model route reaches (0 main-path
     launches; its phase-2 calls are reported apart, as
     ``direct_launches``), that ``gemm_smallk`` ran once per
     default-route forward (its level-0 expand conv, K = 2) at
     ``"highest"``, and that the general instantiations of
     ``gemm_epilogue``, ``gemm_tc`` and the graph kernels ran nowhere.
     Every forward the requests make (the padded, flip-TTA batches) is
     recorded and then held to the model's plain reference forward on the
     same batch;
  4. time the full-width forwards against the plain reference forward:
     B=1024 windows of 27 and of 81 frames, B=256 windows of 243 frames,
     then the hybrid 27-frame (B=1024) and packed 243-frame (B=256)
     routes; then each kernel and entry point at its forward's shapes
     against its plain version, and ``gab_narrow`` beside the
     three-kernel chain at the three narrow GABs of the shipped models
     (C=32, T=241, B=256; C=64, T=79, B=1024; C=64, T=235, B=256). The
     per-shape tables of ``gemm_epilogue`` and of the graph kernels are
     one-off measurements: ``scripts/torch_gemm_shapes.py`` and
     ``scripts/torch_graph_kernels.py``;
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
     ``gab_narrow`` beside the chain at one push's 81f GAB 0 (459 rows);
  9. training and evaluation (``TRAIN_CELLS`` and the notes beside them):
     (a) strided amsgrad train steps at full width (27f at B=128 and
     B=1024, 243f at B=256; dropout 0.05): ms a step, windows a second,
     the split between forward with loss, backward and optimizer, peak
     memory, one profiled step, and the launch counters held at 0;
     (b) one 27f step at B=16 on the card against the same step on the
     CPU, in float64 and float32; (c) the convergence gate of
     ``tests/test_golden.py`` on the card (held-out MPJPE under 30 mm, its
     eval forward on the kernels, held to ``reference_forward``); (d)
     ``python -m gastx_torch.cli.trainval`` on a synthetic H36M-format
     dataset under ``build/chip_smoke/trainval``: two epochs with
     evaluation and checkpoints, a resume from epoch 1 held to the straight
     run's epoch 2, and ``--evaluate``, all at trainval's default
     ``--matmul-precision high``, then ``--evaluate`` at ``mixed`` and
     ``default``, then ``--evaluate`` and ``--resume`` on the JAX
     package's ``.ckpt`` (``JAX_CKPT``, read by
     ``gastx_torch.io.load_jax_checkpoint``; the resumed Adam's state at
     its first step held to the ``.ckpt``'s step and moments), every eval
     forward held to the same route and tiers through the plain versions
     (``plain_route_forward``) as it runs and the launch counters read
     over the seven runs; since the train steps run at trainval's tier
     too, the resume must match the straight run bit for bit, and
     ``gemm_wgrad`` must have launched; (c) also runs at the JAX preset
     (its eval forward held by ``tiered_check``); (e) the train steps at
     the tiers (``tiered_train_phase``): the cells of (a) at all ``high``
     and the preset, each timed as (a) beside the float32 step, its
     launches a step (only ``TRAIN_TIER_KERNELS``, no entry point),
     ``SITE_PRODUCTS`` (no site at ``"highest"``) and ``SITE_GRADS``
     (every class's gradients) counted over one step with the counters
     zeroed just before; then 27f B=128 and 243f B=256 tiered steps held
     to the same steps through the plain versions
     (``tiered_step_against_plain``: loss, every gradient, every parameter
     after amsgrad, BN statistics; two runs bitwise equal);
 10. the precision tiers (``gastx_torch.ops.precision``): (a) the
     tensor-core ``gemm_tc`` at every tier (``TC_PASSES``) on the 27f
     level-1 projection (B=1024, timed beside the float32
     ``gemm_epilogue``, its bound at 989 TFLOP/s a pass or 3.35 TB/s, and,
     for the one-pass tier, ``torch.addmm(shift, a16, w16,
     out_dtype=torch.float32)``, one cuBLAS call of the same function, and
     a bf16 ``torch.matmul``, bf16 out), the level-1 1x1 with its
     residual, the block concat, the level-0 expand conv (K = 2 a tap:
     ``gemm_smallk``), the edge cases of its ``wgmma`` instantiation
     (``tc_edge_cases``) and ``gemm_epilogue``'s ragged cases, each held
     to ``gemm_epilogue_plain`` at the same tier and checked to launch the
     kernel and instantiation ``kernels.gemm_route`` names, then
     ``joint_attention`` at C=256 and 128 at the cert's tier pairs (B=1024,
     timed) and at every pair (B=4), held by ``attn_tier_check``; (b) the
     cert: 27f, 81f and 243f at seeds 0-23 of the port's init, max
     |tiered - float32| of the card's forward in mm for (i) all "high"
     (over 0.1 mm fails the run) and (ii) the JAX inference preset (a
     finding), worst seed printed; (c) those six tiered forwards at B=64
     held to ``plain_route_forward``, then the preset on the 27f routes
     whose GABs are plain sites (``gab_impl="xla"``, the hybrid) and two
     strided pushes of a causal 27f model (``tiered_check``), the launch
     counters zeroed just before and read just after (the tiered path:
     every tier's instantiation it must launch, ``gemm_smallk`` once a
     forward for its expand conv and the general ``gemm_tc`` once for its
     shrink (N = 3), the ``wgmma`` one for every other product, no float32
     ``gemm_epilogue``, the tiered ``gab_narrow`` wherever ``gab_route``
     sends a GAB, the 243f preset's folded GAB 0 as one fold launch and
     no fold chain, and every plain site's class at a tier, none float32:
     ``K.SITE_PRODUCTS``); (d) windows/s, device busy and idle share and
     launches of the float32, (i) and (ii) forwards at 27f/81f/243f
     (B=1024/1024/256), and ``gab_narrow`` (float32 and tiered) beside the
     chain at the preset's tiers at the three narrow GABs; (e)
     ``gemm_smallk`` at the expand conv of each shipped model
     (``EXPAND_SHAPES``: 27f at B=1024 and 256, 81f at 1024, 243f at 256)
     at ``"highest"`` and every tier (``expand_table``: device time, bound,
     a float32 ``torch.addmm`` and a bf16 ``torch.matmul``); (f)
     ``gab_narrow``'s tiered form at C = 16, 32, 48 and 64, every tier and
     the preset's, in both libraries, against its plain version
     (``narrow_tier_check``), then timed at the 243f GAB 0 by tier beside
     the tiered chain and its bound (``narrow_bound``); its fold form
     (``gab_tables(..., "fold")``) likewise at ``NARROW_FOLD_WIDTHS``,
     float32 too, timed beside the fold chain;
 11. the in-the-wild pipeline (``gastx_torch.cli.gen_skes`` and
     ``gastx_torch.cli.realtime`` through their frame functions,
     ``skeletons_from_frames`` and ``run_frames``) at full width with
     random weights from seeds: YOLOv3 at 416 from a darknet file written
     here (its heads calibrated on the clip: ``write_pipeline_weights``),
     HRNet-W48 at 384x288 from the port module's saved state dict, the 27f
     lifter; on a clip of 256 synthetic 1280x720 frames (``clip_frames``:
     one moving figure, two in the second half). First the card's YOLO
     output and HRNet heatmaps on the first 4 frames against the port's
     CPU path (the same bound), with the same boxes and tracks; then
     ``gen_skes`` at ``-np 1`` and ``2``, ``--det-batch 1`` and ``16``
     (seconds a request, 2D frames a second), every lift forward held to
     ``reference_forward``, one profiled request (device ms by stage:
     letterbox, YOLO, crops, HRNet, lift; idle share); then ``realtime``
     (causal 27f, M = 1) with ``--no-pipeline`` and pipelined over 210
     frames delivered at 30 frames a second (per-frame latency p50/p99 over
     the last 200, frames a second; the two loops' poses equal). The
     launch counters are zeroed before each and read after: every kernel
     of a 27f forward ran under gen_skes, and every kernel of a 27f push
     under realtime;
 12. data parallelism (``gastx_torch.parallel``), each rank a process
     started by the spawn method and joined with a timeout: (a)
     ``gastx_torch.entry.dryrun_multichip(1)`` on NCCL, and the DDP
     strided train step on one NCCL rank against the step without DDP at
     27f B=128 and 1024 (the loss and every gradient), and at the tiers
     (all ``high``, the preset; B=128) bit for bit (the loss, every
     gradient, every parameter after amsgrad, the BN statistics); (b) two
     ranks
     sharing the card over gloo (``dp_pair_rank``): two DP steps at 27f on
     a global B=1024 against one process's steps on the same batch,
     float64 held whole (loss, every gradient, every parameter after
     amsgrad, the BN statistics) and float32 on its first step (loss,
     gradients, BN statistics), a ragged step whose rank 1 holds only
     filler rows (loss and BN statistics), ms a step of both (two ranks
     sharing one card: not a scaling figure) and the gradients'
     all-reduce alone under a ``trace()`` range; (c) ``lift_sequences(
     mesh=)`` with flip TTA on phase 3's 27f sequences against the
     one-process lift, rank 0's launches (zeroed just before, read just
     after: every counter of phase 4's 27f forward) and profile (the
     three CUDA kernels); (d) ``python -m torch.distributed.run
     --nproc_per_node 2 -m gastx_torch.cli.trainval`` on phase 9 (d)'s
     data, one epoch with ``--profile-dir`` (a trace naming
     ``train_step``, rank 0's checkpoint alone, and a one-process
     ``--evaluate`` of it giving the MPJPE rank 0 logged); (e)
     ``gastx_torch.examples.train_synthetic`` (exit 0: its 3x gate); (f)
     ``gastx_torch.entry.entry()`` against the plain route,
     ``profiling.benchmark`` of it and ``flops_estimate`` of the plain
     route; (g) the ablation modules on the card against the CPU;
 13. the JAX package's last config surface at full width
     (``config_phase``): explicit ``"pallas_level"`` (27f) and
     ``"pallas_pbatch"`` (243f), a ``gab_impl_levels`` mix (81f),
     ``storage_dtype="bfloat16"`` at 27f, 81f and 243f, the 81f mixed
     levels, ``gab_io_dtype`` at 27f, ``"pallas_level"`` on bf16 (243f),
     every GAB folded in float32 (243f, ``gab_kernel_form="fold"``: the
     fold ``gab_narrow`` at GAB 0), the 243f preset with its fold at GAB 0
     (the tiered fold ``gab_narrow``), and that preset on bf16
     storage (the JAX package's shipped 243f route on a TPU: every bf16
     GEMM on ``vec16_bf16``, none on ``general``); each with
     the launch counters zeroed just before and read just after (the
     entry points, kernels, instantiations and I/O dtypes it must show)
     and held to ``plain_route_forward`` (float32: the bound below; tiered:
     ``tiered_check``; bf16 storage: ``storage_check``); then windows/s of
     the storage cells beside float32, of the 243f preset without and
     with fold, and of the JAX package's two shipped bf16 routes (the
     243f preset with fold, the 81f preset) beside float32 storage, each
     pair in turns (``pair_turns``, with the host's time to issue a
     forward; the shipped routes also one profiled forward a side,
     ``breakdown``); then the bf16-I/O forms timed at main-path shapes for
     the kernels line (``bf16_kernels``).

Tolerance: each kernel, wrapper and the forward must agree with its plain
version to max |delta| <= 1e-4 * max(1, max |plain|); both sides compute
in float32 and only the order of summation differs (at a tier, both round
the same operands to bf16 and sum exact products in float32;
``attn_tier_check`` says what it adds for the attention's softmax
weights, which each side computes before it rounds them). Timings are CUDA
events around repeated calls after a warm-up. The last lines are the
script's total seconds, the ``{"kernels": [...]}`` summary (every entry
also gives, as ``pipeline_launches``, its launches under phase 11, and
as ``dp_launches`` rank 0's in phase 12 (c); the
entries of ``gemm_epilogue``, ``sem_graph`` and ``joint_attention`` their
launches by instantiation and, as ``ragged_max_abs_err``, the largest
error of their phase-2 cases; ``gab_narrow``'s its launches by form, v1
or fold, and the fold form's two entries, tiered and float32, their
launches over phase 10 (c) and phase 13's ``"243f fold"`` cell), the
card's ``name,
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


def card_state(label: str) -> str:
    """The card's SM clock (and its maximum), power draw, temperature and
    active clock-throttle reasons from nvidia-smi, printed beside
    ``label``: timings taken while the card throttles are not comparable
    with others."""
    fields = ("clocks.sm,clocks.max.sm,power.draw,temperature.gpu,"
              "clocks_throttle_reasons.active")
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"  card ({label}): {out} (sm clock, max, power, temperature, "
          f"throttle reasons)")
    return out


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """ms a call of ``fn``: CUDA events around ``reps`` calls after
    ``warmup``."""
    return issue_ms(fn, reps, warmup)[0]


def issue_ms(fn, reps: int = 5, warmup: int = 2) -> tuple:
    """``cuda_ms`` of ``fn``, and the host's ms to issue one call (its
    clock from the first call to the last one's return, before the sync):
    the two agree where the host, not the device, sets the pace."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host


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
        ("K=2 taps", *taps(2, 128, 1, False), "smallk"),
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
    for i, want in ((7, "vec16"), (0, "smallk")):  # 27f L1 proj, L0 conv
        cases.append((f"{GEMM_SHAPES[i][0]} (B=256)",
                      *gemm_case(GEMM_SHAPES[i], dev, 40 + i, windows=256),
                      want))
    return cases


# The level-0 expand conv of each shipped model at the main path's windows
# (gemm_smallk's main product): (GEMM_SHAPES line or one of its form,
# windows).
EXPAND_SHAPES = (
    (0, 1024), (0, 256),
    (("81f L0 expand conv", 1024, 79, (2, 2, 2), 64, "bn", (81, 1), None),
     1024),
    (("243f L0 expand conv", 256, 241, (2, 2, 2), 32, "bn", (243, 1), None),
     256))


def smallk_cases(dev):
    """Phase 2's held cases of ``gemm_smallk``: (label, pieces, m, keyword
    arguments). The three expand convs at small B (each tap's first row 8
    bytes past the last: off a 16-byte boundary), one push's rows, ragged
    M, N = 32 / 36 / 64 / 128 and a second column chunk (N = 1028), one to
    three pieces at row offsets, a residual at its own offset, no scale,
    ReLU off, A at a 4-byte offset."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(33)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def expand(frames, b, n):
        spec = (f"{frames}f L0 expand conv", b, frames - 2, (2, 2, 2), n,
                "bn", (frames, 1), None)
        return gemm_case(spec, dev, 34 + frames)

    a_off = torch.empty(2000 * 2 + 1, device=dev)[1:].view(2000, 2)
    a_off.copy_(rnd(2000, 2))
    return [
        ("27f expand conv (B=8)", *expand(27, 8, 128)),
        ("81f expand conv (B=4)", *expand(81, 4, 64)),
        ("243f expand conv (B=2)", *expand(243, 2, 32)),
        ("one 27f push's expand conv (153 rows)", *expand(11, 1, 128)),
        ("one 81f push's expand conv (459 rows)", *expand(29, 1, 64)),
        ("M=1001, K=5, N=36, residual at 100, no scale",
         [(rnd(1001, 5), rnd(5, 36), 0)], 1001,
         dict(res=rnd(1101, 36), res_off=100)),
        ("3 pieces K=4/4/8 at a_off 0/17/34, N=64, residual, ReLU off",
         [(rnd(740, k), rnd(k, 64), 17 * p)
          for p, k in enumerate((4, 4, 8))], 700,
         dict(scale=rnd(64), shift=rnd(64), res=rnd(751, 64), res_off=51)),
        ("M=4001, K=3, N=32, no scale, ReLU",
         [(rnd(4001, 3), rnd(3, 32), 0)], 4001, dict(relu=True)),
        ("A at a 4-byte offset, N=128", [(a_off, rnd(2, 128), 0)], 2000, {}),
        ("K=6, N=1028: two column chunks", [(rnd(300, 6), rnd(6, 1028), 0)],
         300, dict(scale=rnd(1028), shift=rnd(1028), relu=True)),
    ]


def general_gemm_epilogue(K, pieces, m, kw):
    """``gemm_epilogue``'s general (4-byte) instantiation on these
    operands through its C function, as the float32 path launched it on
    the level-0 expand conv before ``gemm_smallk``: the bitwise
    reference of ``gemm_smallk`` at ``"highest"``."""
    import torch

    n = pieces[0][1].shape[1]
    out = torch.empty((m, n), device=pieces[0][0].device)
    s_out = kw.get("s_out") or m
    lib = K._lib("gemm_epilogue")
    code = lib.gemm_epilogue(
        *K._flat_pieces(pieces), len(pieces), m, n, s_out,
        kw.get("a_s_in") or s_out, kw.get("res_s_in") or s_out,
        K._ptr(kw.get("scale")), K._ptr(kw.get("shift")),
        int(kw.get("relu", False)), K._ptr(kw.get("res")),
        kw.get("res_off", 0), out.data_ptr(), K._stream(), 0, 0)
    if code:
        fail(f"the general gemm_epilogue: {lib.error_string(code)}")
    return out


def run_smallk_cases(K, dev) -> list:
    """Phase 2: ``gemm_smallk`` on ``smallk_cases`` at ``"highest"`` and
    every tier through the ``gemm_epilogue`` wrapper, each launch checked
    to be ``gemm_smallk``'s at its tier (no other GEMM) and held to
    ``gemm_epilogue_plain`` at the same tier; at ``"highest"`` also
    bitwise to the general ``gemm_epilogue``. Returns the errors."""
    import torch

    errs = []
    for label, pieces, m, kw in smallk_cases(dev):
        for tier in K.ATTN_TIERS + ("kdefault",):
            kt = dict(kw, tier=tier)
            K.reset_launches()
            route, taken, got = launched_route(K, pieces, m, kt)
            if route != ("gemm_smallk", "smallk") or taken != "smallk":
                fail(f"gemm_smallk {tier} {label}: routed to {route}, "
                     f"took {taken}")
            label_t = "default" if tier == "kdefault" else tier
            if (K.TIER_LAUNCHES["gemm_smallk"] != {
                    t: int(t == label_t) for t in K.ATTN_TIERS}
                    or K.LAUNCHES["gemm_epilogue"] or K.LAUNCHES["gemm_tc"]):
                fail(f"gemm_smallk {tier} {label}: launches "
                     f"{launch_counts(K)}")
            errs.append(check(f"gemm_smallk {tier} {label}", got,
                              K.gemm_epilogue_plain(pieces, m, **kt)))
            if tier == "highest":
                want = general_gemm_epilogue(K, pieces, m, kw)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"gemm_smallk {label}: not bitwise the general "
                         f"gemm_epilogue ({float((got - want).abs().max())})")
            del got
    return errs


def smallk_key(K, tier: str) -> str:
    """The kernel name (a substring) that computes the expand conv at
    ``tier`` in this tree: ``gemm_smallk``, or in a tree without it (a
    parent's) the general ``gemm_epilogue`` at ``"highest"`` and the
    general ``gemm_tc`` below it."""
    if "gemm_smallk" in K.LAUNCHES:
        return "gemm_smallk_kernel"
    return "gemm_epilogue_kernel" if tier == "highest" else "gemm_tc_kernel"


def expand_table(K, dev, plain=True) -> list:
    """The expand conv of each shipped model (``EXPAND_SHAPES``) at
    ``"highest"`` and every tier (``K.ATTN_TIERS``; ``"kdefault"`` runs
    ``"default"``'s instantiation) through the ``gemm_epilogue`` wrapper: the kernel's device
    time (``device_ms`` over the kernel ``smallk_key`` names), the call's
    CUDA-event time (``cuda_ms``: the wrapper's host work and, in a tree
    without ``gemm_smallk``, its W split included), the bound (operations
    by ``gemm_work``, "high" two FMAs an element; bytes by ``gemm_bytes``:
    the taps' one input once, W, BN and the float32 output), its share; once a shape, a float32 ``torch.addmm`` on the
    gathered (M, 6) A (W scaled by the BN scale: one call computing all but
    the ReLU), a bf16 ``torch.matmul`` and, with ``plain``, the plain
    version's time at ``"highest"``. Each output is held to the plain
    version at its tier (``check``)."""
    import torch

    rows = []
    for spec, windows in EXPAND_SHAPES:
        spec = GEMM_SHAPES[spec] if isinstance(spec, int) else spec
        label, _, _, ks, n, _, _, _ = spec
        pieces, m, kw = gemm_case(spec, dev, 500 + n, windows=windows)
        shape = f"{label} (B={windows})"
        a_cat, w_cat = gemm_library_operands(pieces, m, kw)
        w_cat = w_cat * kw["scale"]
        library_ms = cuda_ms(lambda: torch.addmm(kw["shift"], a_cat, w_cat),
                             reps=20)
        del a_cat, w_cat
        matmul_ms = bf16_matmul_ms(pieces, m, kw)
        plain_ms = (cuda_ms(lambda: K.gemm_epilogue_plain(pieces, m, **kw),
                            reps=3) if plain else None)
        flops = gemm_work(m, ks, n, 1, 0)[0]
        nbytes = gemm_bytes(pieces, m, n, kw, torch.float32)
        for tier in K.ATTN_TIERS:
            kt = dict(kw, tier=tier)
            err = check(f"expand conv {tier} {shape}",
                        K.gemm_epilogue(pieces, m, **kt),
                        K.gemm_epilogue_plain(pieces, m, **kt))
            ms = device_ms(lambda: K.gemm_epilogue(pieces, m, **kt),
                           smallk_key(K, tier))
            call_ms = cuda_ms(lambda: K.gemm_epilogue(pieces, m, **kt),
                              reps=20)
            bms, by = bound(flops * (2 if tier == "high" else 1), nbytes)
            rows.append({"shape": shape, "tier": tier, "m": m, "n": n,
                         "ms": ms, "call_ms": call_ms, "bound_ms": bms,
                         "bound_by": by, "share_of_bound": bms / ms,
                         "plain_ms": plain_ms if tier == "highest" else None,
                         "max_abs_err": err, "library_ms": library_ms,
                         "matmul_bf16_ms": matmul_ms})
            print(f"  expand conv {tier:8s} {shape}: {ms:.4f} ms on the "
                  f"device ({bms / ms:.1%} of its bound {bms:.4f} by {by}); "
                  f"the call {call_ms:.4f}; float32 torch.addmm "
                  f"{library_ms:.4f}; bf16 torch.matmul {matmul_ms:.4f}"
                  + (f"; plain {plain_ms:.4f}"
                     if plain_ms and tier == "highest" else ""))
        del pieces, kw
        torch.cuda.empty_cache()
    return rows


def tc_edge_cases(dev):
    """Phase 10 (a)'s cases of ``gemm_tc``'s persistent ``wgmma``
    instantiation beyond ``gemm_ragged_cases``: one push's rows, the
    narrow chain's widths, K and N tails inside a tile, more tiles than
    SMs, three pieces at row offsets with a residual at its own: (label,
    pieces, m, keyword arguments, the instantiation ``tc_variant`` must
    pick)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(37)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def one(m, k, n, **kw):
        return [(rnd(m, k), rnd(k, n) / math.sqrt(k), 0)], m, dict(
            scale=rnd(n).abs() + 0.5, shift=rnd(n), **kw)

    m3 = 300
    three = [(rnd(m3 + 40, 128), rnd(128, 256) / math.sqrt(384), 17 * p)
             for p in range(3)]
    return [
        ("M=17, K=512, N=1536 (a push's 27f level-2 rows)",
         *one(17, 512, 1536), "vec16"),
        ("M=153, K=48, N=144 (C=48)", *one(153, 48, 144, relu=True),
         "vec16"),
        ("M=459, K=64, N=192 (C=64)", *one(459, 64, 192, relu=True),
         "vec16"),
        ("K=132, N=72: K and N tails", *one(1000, 132, 72), "vec16"),
        ("M=17,000, N=512: more tiles than SMs",
         *one(17000, 256, 512, relu=True), "vec16"),
        ("3 pieces at a_off 0/17/34, residual at res_off 51", three, m3,
         dict(scale=rnd(256).abs() + 0.5, shift=rnd(256), relu=True,
              res=rnd(m3 + 51, 256), res_off=51), "vec16"),
    ]


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


def launched_route(K, pieces, m, kw):
    """One ``gemm_epilogue`` call: ((kernel, instantiation) as
    ``K.gemm_route`` names them for its operands and tier, the
    instantiation of that kernel it launched, its result). A tree without
    ``gemm_route`` (a parent's) routes by tier alone."""
    import torch

    n, res = pieces[0][1].shape[1], kw.get("res")
    out_dtype, tier = (kw.get("out_dtype", torch.float32),
                       kw.get("tier", "highest"))
    if hasattr(K, "gemm_route"):
        route = K.gemm_route(pieces, n, res, out_dtype, tier)
    elif tier == "highest":
        route = "gemm_epilogue", K.gemm_variant(pieces, n, res)
    else:
        route = "gemm_tc", K.tc_variant(pieces, n, res, out_dtype)
    taken, got = launched_variant(
        K, route[0], lambda: K.gemm_epilogue(pieces, m, **kw))
    return route, taken, got


# Profiler windows device_ms opens before it gives up: a trace on the
# card's machine has come back once without the device activity of a
# kernel the same call had traced a moment before.
PROFILE_TRIES = 3


def device_ms(fn, key: str, reps: int = 20) -> float:
    """Device time per launch of the kernels whose name holds ``key``, from
    torch.profiler over ``reps`` calls of ``fn``, so that launch overhead
    does not hide a small shape. A trace that records no such kernel is
    taken again (``PROFILE_TRIES`` in all, each retry printed); raises if
    none does, so that the yardstick cannot change without notice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
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
        if count:
            return total / 1e3 / count
        print(f"  the profiler recorded no kernel named *{key}* (trace "
              f"{attempt + 1} of {PROFILE_TRIES})")
    raise RuntimeError(f"the profiler recorded no kernel named *{key}* in "
                       f"{PROFILE_TRIES} traces")


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
                                 "joint_attention", "gab_narrow",
                                 "gab_narrow_tiered", "gemm_tc",
                                 "gemm_smallk", "gemm_wgrad")
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
# Phase 3's trained-weights requests: the 27f model of build_gastnet's
# seed WEIGHT_SEED saved as a port .pt and read through -w, against
# --random-weights --seed WEIGHT_SEED; then one request a keypoint format
# the coco requests leave out, (-kf, the model's joints), on files of
# FORMAT_FRAMES frames.
WEIGHT_SEED = 5
FORMAT_REQUESTS = (("mpii", 17), ("openpose", 17), ("wholebody", 19))
FORMAT_FRAMES = 277
# Phase 9 (d)'s JAX .ckpt: the committed fixture of
# tests/test_torch_interchange.py (a gastx.train.save_checkpoint train
# state of -arc 3,3 -ch 8, amsgrad count 7, epoch 1) and its trainval
# flags (later flags win over TRAINVAL_ARGS').
JAX_CKPT = os.path.join(REPO, "tests", "data",
                        "jax_train_state_arc33_ch8.ckpt")
JAX_CKPT_ARGS = ("-arc", "3,3", "-ch", "8")
# The cells of phase 4: (cell, receptive field, batch of windows, route).
FORWARDS = (("27f", 27, 1024, {}), ("81f", 81, 1024, {}),
            ("243f", 243, 256, {}), ("27f hybrid", 27, 1024, HYBRID),
            ("243f packed", 243, 256, PACKED))


def launch_counts(K) -> dict:
    return {**K.LAUNCHES, **{f"{k} {v}": n
                             for k, counts in K.VARIANT_LAUNCHES.items()
                             for v, n in counts.items()},
            **{f"{k} {t}": n for k, counts in K.TIER_LAUNCHES.items()
               for t, n in counts.items()},
            **K.ENTRY_LAUNCHES}


def narrow_tier_launches(launches: dict, fold: bool) -> int:
    """The tiered ``gab_narrow`` launches in ``launch_counts`` of one form:
    its tier keys ("gab_narrow <tiers>", "gab_narrow fold <tiers>")."""
    return sum(v for k, v in launches.items()
               if k.startswith("gab_narrow ") and "/" in k
               and k.startswith("gab_narrow fold ") == fold)


def tiered_launch(name: str) -> bool:
    """A counter of the tiered instantiations (``gemm_tc``'s,
    ``gemm_smallk``'s below ``"highest"``, ``joint_attention``'s by tier
    pair, and ``gemm_wgrad``, the tiered train step's), which the float32
    paths never launch."""
    return (name.startswith("gemm_tc") or "/" in name
            or name.startswith("gemm_wgrad")
            or (name.startswith("gemm_smallk ")
                and name.split()[1] in TC_PASSES))


# Every view the main paths give the graph kernels meets the 16-byte rule:
# their 4-byte instantiations launch only in phase 2's cases.
GRAPH_GENERAL = ("sem_graph general", "joint_attention general")
# gab_narrow's fold form: the float32 default folds no GAB (the JAX preset
# folds the 243f GAB 0; phases 10 and 13 launch it).
FOLD_LAUNCH = "gab_narrow fold"
# The 4-byte GEMMs the main paths never launch: the one product they took
# (the level-0 expand conv, K = 2 a tap) runs on gemm_smallk.
GEMM_GENERAL = ("gemm_epilogue general", "gemm_tc general")


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


# --------------------------------------------------------------------------
# Phase 9: training and evaluation
# --------------------------------------------------------------------------

# The train-step cells: (label, receptive field, batch of rf-frame windows):
# trainval's -b default at 27f, the JAX bench's train batch at 27f, and the
# 243f model at B=256. Random weights from a seed, dropout 0.05, strided.
TRAIN_CELLS = (("27f B=128", 27, 128), ("27f B=1024", 27, 1024),
               ("243f B=256", 243, 256))
TRAIN_DROPOUT, TRAIN_LR = 0.05, 1e-3
TRAIN_WARMUP, TRAIN_STEPS = 3, 20
# The card's step against the CPU's: the 27f model at B=16, dropout 0.
STEP_CHECK_BATCH = 16
# trainval on the synthetic H36M-format dataset: subjects, two actions of
# FRAMES frames each, four cameras (20,000 train frames after flips: its
# steps run at trainval's default tier, each 1.3-1.8 times a float32 step,
# phase 9 (e), so the set is half what a float32 run took in the time).
TRAINVAL_SUBJECTS = ("S1", "S5", "S6", "S7", "S8", "S9", "S11")
TRAINVAL_ACTIONS = ("Walking 1", "Eating 1")
TRAINVAL_FRAMES = 250
TRAINVAL_ARGS = ("-arc", "3,3,3", "-ch", "128", "-b", "128", "--downsample",
                 "1", "--checkpoint-frequency", "1")
# Where a ReLU's input lies within rounding of zero, float32 steps on two
# devices take different branches (a handful of elements of ~5M at 27f
# B=16), and each such element moves every gradient upstream of it by up
# to ~1-5% of its tensor's largest value. So the float32 step is held on
# its loss and BN statistics (forward quantities), and the whole step
# (loss, every gradient, every parameter after the amsgrad step, the BN
# statistics) is held in float64, where no branch flips.
STEP_CHECK_DTYPES = ("float64", "float32")


def train_batch(frames: int, batch: int, seed: int, dev):
    """Random (B, rf, 17, 2) keypoints, (B, 1, 17, 3) targets and unit
    weights on ``dev``."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x2 = torch.randn((batch, frames, 17, 2), generator=g)
    x3 = 0.3 * torch.randn((batch, 1, 17, 3), generator=g)
    return x2.to(dev), x3.to(dev), torch.ones(batch, device=dev)


def train_cell(K, label, frames, batch, dev, tiers=None) -> dict:
    """Phase 9 (a): TRAIN_STEPS strided train steps after TRAIN_WARMUP
    (CUDA events): ms a step, windows a second, the split of a step
    between the forward with its loss, the backward and the optimizer;
    peak memory; one profiled step; the launch counters stay 0. Phase 9
    (e), with ``tiers`` (``TRAIN_TIER_NAMES``): the same at those tiers
    over TIER_TRAIN_STEPS,
    where a step launches ``TRAIN_TIER_KERNELS`` alone (its launches,
    ``SITE_PRODUCTS`` and ``SITE_GRADS`` counted over one step: no site
    at "highest", every class with its gradients)."""
    import torch

    from gastx_torch.models import build_gastnet
    from gastx_torch.train import make_optimizer, set_lr, train_step
    from gastx_torch.train.loop import root_relative, weighted_loss

    model = build_gastnet(train_tier_cfg(frames, tiers), seed=frames,
                          device=dev)
    opt = make_optimizer(model.parameters())
    gen = torch.Generator(device=dev).manual_seed(frames + batch)
    x2, x3, w = train_batch(frames, batch, frames + batch, dev)

    def step():
        return train_step(model, opt, x2, x3, w, TRAIN_LR, gen, "strided")

    def split_step(ev):
        """train_step's three parts, each closed by a CUDA event."""
        model.train()
        loss = weighted_loss(model(x2, "strided", generator=gen),
                             root_relative(x3), w)
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        ev[2].record()
        set_lr(opt, TRAIN_LR)
        opt.step()
        ev[3].record()
        return loss.detach()

    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses = [step() for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    steps = TRAIN_STEPS if tiers is None else TIER_TRAIN_STEPS
    losses += [step() for _ in range(steps)]
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    parts = [0.0, 0.0, 0.0]
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        losses.append(split_step(ev))
        torch.cuda.synchronize()
        for i in range(3):
            parts[i] += ev[i].elapsed_time(ev[i + 1]) / steps
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in launch_counts(K).items() if v}
    K.reset_launches()
    losses.append(step())
    torch.cuda.synchronize()
    per_step = {k: v for k, v in launch_counts(K).items() if v}
    sites = {op: dict(v) for op, v in K.SITE_PRODUCTS.items()}
    grads = {op: dict(v) for op, v in K.SITE_GRADS.items()}
    prof = profile_call(step, f"phase 9: torch.profiler trace of one "
                              f"{label} train step")
    loss = torch.stack(losses).cpu()
    if not bool(torch.isfinite(loss).all()):
        fail(f"{label}: a train loss is not finite")
    if tiers is None and (launches or per_step):
        fail(f"{label}: the train steps launched hand-written kernels: "
             f"{launches}")
    if tiers is not None:
        kernels = {k for k in K.LAUNCHES if per_step.get(k)}
        if kernels != set(TRAIN_TIER_KERNELS) \
                or any(per_step.get(e) for e in K.ENTRY_POINTS):
            fail(f"{label}: a tiered step launched {per_step}")
        if any(v.get("highest") for v in sites.values()) \
                or set(grads) != set(sites) or len(sites) != 12:
            fail(f"{label}: a tiered step's sites {sites}, their "
                 f"gradients {grads}")
        # the weight gradients on every instantiation: wgmma (the sites at
        # C = 32-512), smallk (the expand taps), general (the shrink)
        if not all(per_step.get(f"gemm_wgrad {v}") for v in
                   K.WGRAD_VARIANTS):
            fail(f"{label}: a tiered step left a gemm_wgrad instantiation "
                 f"out: {per_step}")
    split = dict(zip(("forward_loss_ms", "backward_ms", "optimizer_ms"),
                     parts))
    print(f"  {label}: {ms:.3f} ms a step, {batch / (ms / 1e3):.1f} "
          f"windows/s; forward+loss {parts[0]:.3f}, backward "
          f"{parts[1]:.3f}, optimizer {parts[2]:.3f} ms (a split step "
          f"{sum(parts):.3f}); peak {peak / 2**30:.3f} GiB; loss "
          f"{float(loss[0]):.4f} -> {float(loss[-1]):.4f}; launches a step "
          f"{per_step or 0}")
    if tiers is not None:
        print(f"    site products a step {sites}; their gradients {grads}")
    del model, opt
    torch.cuda.empty_cache()
    return {"batch": batch, "frames": frames, "tiers": tiers, "ms": ms,
            "windows_per_s": batch / (ms / 1e3), **split,
            "peak_bytes": peak, "profile": prof,
            "launches": launches, "launches_per_step": per_step,
            "site_products": sites,
            "site_grads": grads,
            "loss_first": float(loss[0]), "loss_last": float(loss[-1])}


def step_against_cpu(dev) -> dict:
    """Phase 9 (b): one train step of the 27f model (dropout 0) at
    B=STEP_CHECK_BATCH on the card and on the CPU from the same weights and
    batch, in each of STEP_CHECK_DTYPES: the largest difference of the
    loss, the gradients, the parameters after the step and the BN running
    statistics, each over its bound TOL * max(1, max|cpu|) per tensor."""
    import copy
    import dataclasses

    import torch

    from gastx_torch.models import (build_gastnet, config_for_frames,
                                    randomize_eval_statistics)
    from gastx_torch.train import make_optimizer, train_step

    cfg = dataclasses.replace(config_for_frames(27), dropout=0.0)
    base = build_gastnet(cfg, seed=27, device="cpu")
    randomize_eval_statistics(base, torch.Generator().manual_seed(28))
    x2, x3, w = train_batch(27, STEP_CHECK_BATCH, 29, "cpu")

    def one_step(dtype, device):
        m = copy.deepcopy(base).to(dtype=dtype, device=device)
        opt = make_optimizer(m.parameters())
        loss = train_step(m, opt, x2.to(device, dtype), x3.to(device, dtype),
                          w.to(device, dtype), TRAIN_LR, None, "strided")
        grads = {n: p.grad for n, p in m.named_parameters()}
        return {"loss": {"loss": loss.reshape(1)}, "grads": grads,
                "params": dict(m.named_parameters()),
                "bn_stats": {n: b for n, b in m.named_buffers()
                             if "running" in n}}

    def worst(got, want):
        """Per category: the largest |got - want| over its bound, and the
        tensor it is in."""
        out = {}
        for cat in want:
            ratios = []
            for n, t in want[cat].items():
                t = t.detach().double().cpu()
                d = (got[cat][n].detach().double().cpu() - t).abs().max()
                ratios.append((float(d) / (TOL * max(1.0, float(
                    t.abs().max()))), float(d), n))
            r = max(ratios)
            out[cat] = {"err_over_bound": r[0], "max_abs_err": r[1],
                        "tensor": r[2]}
        return out

    steps = {(dt, dev_): one_step(getattr(torch, dt), dev_)
             for dt in STEP_CHECK_DTYPES for dev_ in ("cpu", dev)}
    report = {}
    for dt in STEP_CHECK_DTYPES:
        card = worst(steps[(dt, dev)], steps[(dt, "cpu")])
        report[dt] = card
        gated = (card if dt == "float64" else
                 {k: card[k] for k in ("loss", "bn_stats")})
        print(f"  {dt} step, card against CPU: " + "; ".join(
            f"{k} {v['max_abs_err']:.3e} ({v['err_over_bound']:.3f} of "
            f"its bound{', held' if k in gated else ''})"
            for k, v in card.items()))
        for k, v in gated.items():
            if not v["err_over_bound"] <= 1.0:
                fail(f"{dt} train step, {k}: the card's {v['tensor']} is "
                     f"{v['max_abs_err']} off the CPU's")
    # How far float32 itself is from float64, on each device.
    for d in ("cpu", dev):
        ref = worst(steps[("float32", d)], steps[("float64", d)])
        report[f"float32 against float64 on {d}"] = ref
        print(f"  float32 against float64 on {d}: " + "; ".join(
            f"{k} {v['max_abs_err']:.3e} ({v['err_over_bound']:.3f} of the "
            f"bound)" for k, v in ref.items()))
    return report


def convergence_on_card(K, dev, tiers=None) -> dict:
    """Phase 9 (c): the convergence gate of tests/test_golden.py on the
    card from the port's seeded init; the held-out MPJPE is a strided eval
    forward on the kernels, held to reference_forward. With ``tiers``
    (``"preset"``) the model trains and evaluates at the JAX preset's
    tiers, its eval forward held to its plain route (``tiered_check``)."""
    import dataclasses

    import numpy as np
    import torch

    from gastx_torch.models.config import TPU_MIXED_PRECISION_OVERRIDES
    from gastx_torch.data import synthetic
    from gastx_torch.eval.metrics import mpjpe
    from gastx_torch.models import GastNetConfig, build_gastnet
    from gastx_torch.train import make_optimizer, train_step
    from gastx_torch.train.loop import root_relative

    cfg = GastNetConfig(filter_widths=(3, 3), channels=32, dropout=0.0)
    if tiers is not None:
        cfg = dataclasses.replace(
            cfg, matmul_precision="high",
            precision_overrides=TPU_MIXED_PRECISION_OVERRIDES)
    model = build_gastnet(cfg, seed=synthetic.CONVERGENCE_SEED, device=dev)
    rf = cfg.receptive_field()
    rng = np.random.default_rng(7)
    ex2d, ex3d = (torch.from_numpy(a).to(dev)
                  for a in synthetic.wellposed_batch(rng, 256, rf))

    def held_out_mm(label):
        model.eval()
        pred = model(ex2d, "strided")
        name = f"{label} held-out forward {tuple(ex2d.shape)}"
        if tiers is None:
            check(name, pred, model.reference_forward(ex2d, "strided"))
        else:
            tiered_check(f"{name} at the {tiers}", model, ex2d, pred,
                         "strided")
        return float(mpjpe(pred, root_relative(ex3d))) * 1000.0

    K.reset_launches()
    before = held_out_mm("untrained")
    n, batch = synthetic.CONVERGENCE_STEPS, synthetic.CONVERGENCE_BATCH
    x2d, x3d = (torch.from_numpy(a).to(dev) for a in
                synthetic.wellposed_batch(rng, n * batch, rf))
    opt = make_optimizer(model.parameters())
    w = torch.ones(batch, device=dev)
    t0 = time.time()
    for i in range(n):
        sl = slice(i * batch, (i + 1) * batch)
        train_step(model, opt, x2d[sl], x3d[sl], w,
                   synthetic.convergence_lr(i), None, "strided")
    torch.cuda.synchronize()
    train_s = time.time() - t0
    after = held_out_mm("trained")
    launches = {k: v for k, v in launch_counts(K).items() if v}
    print(f"  convergence{'' if tiers is None else ' at the ' + tiers}: "
          f"held-out MPJPE {before:.1f} -> {after:.2f} mm after {n} steps "
          f"of B={batch} ({train_s:.2f} s); launches {launches}")
    if tiers is not None and not launches.get("gemm_wgrad"):
        fail(f"the convergence run at the {tiers} launched no gemm_wgrad")
    if not before > 400.0:
        fail(f"untrained held-out error suspiciously low: {before} mm")
    if not after < synthetic.CONVERGENCE_GATE_MM:
        fail(f"convergence gate failed on the card: {before} -> {after} mm")
    return {"before_mm": before, "after_mm": after, "steps": n,
            "batch": batch, "train_s": train_s, "tiers": tiers,
            "launches": launches}


def write_trainval_data(data_dir: str, seed: int = 0) -> None:
    """A synthetic H36M-format dataset: 32-joint world poses and four
    cameras of 17-joint pixel detections per subject and action."""
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(data_dir, exist_ok=True)
    positions_3d, positions_2d = {}, {}
    for s in TRAINVAL_SUBJECTS:
        positions_3d[s], positions_2d[s] = {}, {}
        for a in TRAINVAL_ACTIONS:
            walk = np.cumsum(0.01 * rng.standard_normal(
                (TRAINVAL_FRAMES, 1, 3)), axis=0)
            positions_3d[s][a] = (walk + 0.3 * rng.standard_normal(
                (TRAINVAL_FRAMES, 32, 3))).astype(np.float32)
            positions_2d[s][a] = [
                (rng.random((TRAINVAL_FRAMES, 17, 2)) * 1000).astype(
                    np.float32) for _ in range(4)]
    np.savez_compressed(os.path.join(data_dir, "data_3d_h36m.npz"),
                        positions_3d=positions_3d)
    metadata = {"layout_name": "h36m", "num_joints": 17,
                "keypoints_symmetry": [[4, 5, 6, 11, 12, 13],
                                       [1, 2, 3, 14, 15, 16]]}
    np.savez_compressed(
        os.path.join(data_dir, "data_2d_h36m_cpn_ft_h36m_dbb.npz"),
        positions_2d=positions_2d, metadata=metadata)


def run_trainval(argv) -> str:
    """``python -m gastx_torch.cli.trainval argv`` in this process (so the
    forward hook and the launch counters see it); returns its stdout."""
    import contextlib
    import io
    import runpy

    out = io.StringIO()
    saved = sys.argv
    sys.argv = ["gastx_torch.cli.trainval", *argv]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_module("gastx_torch.cli.trainval", run_name="__main__",
                             alter_sys=True)
    finally:
        sys.argv = saved
    return out.getvalue()


def trainval_on_card(K, dev) -> dict:
    """Phase 9 (d): trainval end to end: two epochs with evaluation and a
    checkpoint each, a resume from epoch 1 to epoch 2 in a second
    directory (its epoch-2 checkpoint held to the straight one), then
    --evaluate, at trainval's --matmul-precision default ("high": the
    train steps too run at it, on gemm_tc, gemm_smallk and gemm_wgrad;
    the resumed run bit for bit the straight one), and
    --evaluate again at "mixed" and at "default"; then --evaluate and
    --resume (to epoch 2) on the JAX package's .ckpt (``JAX_CKPT``), the
    resumed Adam's state at its first step held to the .ckpt's step and
    moments, each placed on its parameter by name. Every eval forward is
    held to the same route and tiers through the plain versions
    (``plain_route_forward``) on the same batch at the time it runs; the
    launch counters are zeroed before and read after."""
    import json
    import shutil

    import torch
    from torch.nn.modules.module import register_module_forward_hook
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    from gastx_torch.io import load_jax_checkpoint
    from gastx_torch.models import GastNet, GastNetConfig
    from gastx_torch.train import load_checkpoint

    root = os.path.join(WORK_DIR, "trainval")
    shutil.rmtree(root, ignore_errors=True)
    data_dir = os.path.join(root, "data")
    write_trainval_data(data_dir)
    straight, resumed = (os.path.join(root, d) for d in ("straight",
                                                         "resumed"))
    common = [*TRAINVAL_ARGS, "--data-dir", data_dir]
    held, tier_errs = [], {}

    def hold(module, inputs, output):
        if isinstance(module, GastNet) and not module.training:
            cfg = module.cfg
            label = (f"{cfg.matmul_precision}, "
                     f"{len(cfg.precision_overrides)} overrides")
            err, tier_err, scale = tiered_check(
                f"trainval eval forward {tuple(inputs[0].shape)} at "
                f"{label}", module, inputs[0], output)
            held.append(err)
            tier_errs[label] = max(tier_errs.get(label, (0.0, 0.0)),
                                   (tier_err, scale))

    hook = register_module_forward_hook(hold)
    K.reset_launches()
    t0 = time.time()
    try:
        out = run_trainval([*common, "-e", "2", "--checkpoint", straight,
                            "--log-file", os.path.join(root, "log.jsonl")])
        os.makedirs(resumed)
        shutil.copy(os.path.join(straight, "epoch_1.pt"), resumed)
        out_r = run_trainval([*common, "-e", "2", "--checkpoint", resumed,
                              "-r", "epoch_1.pt"])
        out_e = run_trainval([*common, "--checkpoint", straight,
                              "--evaluate", "epoch_2.pt"])
        out_tiers = [run_trainval([*common, "--checkpoint", straight,
                                   "--evaluate", "epoch_2.pt",
                                   "--matmul-precision", tier])
                     for tier in ("mixed", "default")]
        jax_dir = os.path.join(root, "jax_ckpt")
        t_jax = time.time()
        out_je = run_trainval([*common, *JAX_CKPT_ARGS, "--checkpoint",
                               jax_dir, "--evaluate", JAX_CKPT])
        first_step = []

        def capture(optimizer, args, kwargs):
            if not first_step:
                first_step.append([
                    {k: v.detach().cpu().clone() for k, v in
                     optimizer.state[p].items()}
                    for p in optimizer.param_groups[0]["params"]])

        step_hook = register_optimizer_step_pre_hook(capture)
        try:
            out_jr = run_trainval([*common, *JAX_CKPT_ARGS, "--checkpoint",
                                   jax_dir, "-e", "2", "-r", JAX_CKPT])
        finally:
            step_hook.remove()
        jax_s = time.time() - t_jax
    finally:
        hook.remove()
    total_s = time.time() - t0
    launches = {k: v for k, v in launch_counts(K).items() if v}
    for text in (out, out_r, out_e, *out_tiers, out_je, out_jr):
        if "Protocol #2" not in text or f"running on {dev}" not in text:
            fail(f"trainval printed no Protocol #2 evaluation on {dev}:\n"
                 + text[-2000:])
    for tier, text in zip(("high", "mixed", "default"), (out_e, *out_tiers)):
        for line in text.splitlines():
            if "action-wise average" in line:
                print(f"  --evaluate --matmul-precision {tier}: "
                      f"{line.strip()}")
    with open(os.path.join(root, "log.jsonl")) as f:
        epochs = [json.loads(line) for line in f]
    for e in epochs:
        print(f"  epoch {e['step']}: {e['train_s']:.2f} s training "
              f"({e['train_frames'] / e['train_s']:.1f} train frames/s), "
              f"{e['epoch_minutes'] * 60:.2f} s with its evaluation; "
              f"valid MPJPE {e['valid_mpjpe_mm']:.1f} mm")
    a = load_checkpoint(os.path.join(straight, "epoch_2.pt"))
    b = load_checkpoint(os.path.join(resumed, "epoch_2.pt"))
    if a["epoch"] != b["epoch"] or a["lr"] != b["lr"]:
        fail("the resumed checkpoint's epoch or lr differs")
    tensors = dict(a["model"])
    for i, st in a["optimizer"]["state"].items():
        tensors.update({f"optimizer {i} {k}": v for k, v in st.items()})
    other = dict(b["model"])
    for i, st in b["optimizer"]["state"].items():
        other.update({f"optimizer {i} {k}": v for k, v in st.items()})
    worst = (0.0, 0.0, "")
    for n, t in tensors.items():
        t, u = t.double(), other[n].double()
        d = float((t - u).abs().max())
        bound_ = TOL * max(1.0, float(t.abs().max()))
        worst = max(worst, (d / bound_, d, n))
    print(f"  resume against straight: largest difference {worst[1]:.3e} "
          f"({worst[2]}), {worst[0]:.3f} of its bound, bitwise "
          f"{worst[1] == 0.0}; tiers' own largest "
          f"distance from the float32 forward, by tier (mm, and the "
          f"largest float32 output in mm): "
          f"{ {k: (round(e * 1000, 4), round(m * 1000, 1))
               for k, (e, m) in tier_errs.items()} }; "
          f"{len(held)} eval "
          f"forwards held; launches {launches}; {total_s:.1f} s")
    if not worst[1] == 0.0:
        fail(f"resumed {worst[2]} differs from the straight run by "
             f"{worst[1]}")
    for name in ("fused_level0", "fused_level", "fused_gab",
                 "fused_gab_split", "gemm_tc", "sem_graph",
                 "joint_attention", "gemm_tc high", "gemm_tc high_rhs",
                 "gemm_tc default", "joint_attention high/high",
                 "joint_attention default/default", "gemm_wgrad",
                 "gemm_wgrad high", "gemm_wgrad wgmma",
                 "gemm_wgrad smallk"):
        if not launches.get(name):
            fail(f"trainval's train steps and eval passes did not launch "
                 f"{name}")
    if launches.get("gemm_epilogue"):
        fail("trainval's tiered eval passes launched the float32 "
             "gemm_epilogue")
    if not held:
        fail("no trainval eval forward was recorded")

    # The JAX .ckpt: --resume trains epoch 2 only, at the .ckpt's lr, and
    # its Adam starts from the .ckpt's step and moments.
    jax_cfg = GastNetConfig(filter_widths=(3, 3), channels=8)
    want = load_jax_checkpoint(JAX_CKPT, jax_cfg)
    if "[2] time" not in out_jr or "[1] time" in out_jr \
            or f"lr {want['lr']:f}" not in out_jr:
        fail("trainval --resume on the JAX .ckpt did not train epoch 2 "
             "alone at its lr:\n" + out_jr[-2000:])
    names = [n for n, _ in GastNet(jax_cfg).named_parameters()]
    moments = want["optimizer"]
    if not first_step or len(first_step[0]) != len(names):
        fail("trainval --resume on the JAX .ckpt took no optimizer step")
    for n, state in zip(names, first_step[0]):
        if float(state["step"]) != float(moments["step"]) or any(
                not torch.equal(state[k], moments[k][n])
                for k in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")):
            fail(f"the resumed Adam's state of {n} is not the .ckpt's")
    for line in out_je.splitlines():
        if "action-wise average" in line:
            print(f"  --evaluate on the JAX .ckpt: {line.strip()}")
    print(f"  --resume on the JAX .ckpt: Adam's first step from the "
          f".ckpt's step {float(moments['step']):g} and moments on all "
          f"{len(names)} parameters; the .ckpt's two runs {jax_s:.1f} s")
    torch.cuda.empty_cache()
    return {"epochs": epochs, "resume_max_abs_diff": worst[1],
            "resume_bitwise": worst[1] == 0.0,
            "resume_worst_tensor": worst[2], "eval_forwards_held": len(held),
            "eval_max_abs_err": max(held), "launches": launches,
            "tier_max_abs_err_vs_float32": tier_errs,
            "jax_ckpt_s": jax_s, "total_s": total_s}


# --------------------------------------------------------------------------
# Training at the tiers: gemm_wgrad at the train steps' shapes (phase 2)
# and the tiered train steps (phase 9 (e))
# --------------------------------------------------------------------------

# The tier configurations of a tiered train step: all "high", and the JAX
# package's preset (its XLA sites at "high" and "default").
TRAIN_TIER_NAMES = ("high", "preset")
# phase 2: the strided steps whose every gemm_wgrad call is held to its
# plain version: (receptive field, batch of windows).
WGRAD_STEPS = ((27, 1024), (243, 256))
# What a tiered train step may launch: the sites' GEMMs and the weight
# gradients, no fused or graph kernel (the JAX package's train gates).
TRAIN_TIER_KERNELS = ("gemm_tc", "gemm_smallk", "gemm_wgrad")
# phase 9 (e): the tiered steps held against the same step through the
# plain versions: (receptive field, batch of windows).
TIER_STEP_CHECKS = ((27, 128), (243, 256))
# ... the kernel step about as near the float32 step as the plain one, by
# kind of tensor: its 2-norm distance at most this many times the plain
# step's (plus the float32 bound). Each is a draw of the tier's rounding:
# two float32 orders that round an operand's bf16 halves apart move a
# product by up to 2^-16 of it at "high" (2^-8 at "default") where float32
# moves it by 2^-24, and the step's depth (BN on batch statistics)
# amplifies that unevenly, so one tensor of the two draws may lie far
# apart (243f B=256 preset: init_bn.weight's gradient 1.337e-02 apart of
# its largest value 3.496e-02, where the plain step lay 5.593e-04 from
# float32); the norm over a kind's millions of elements does not. A wrong tier, row, tap or piece moves the kernel step's
# distance by orders of magnitude.
TIER_STEP_NORM = 2.0
# phase 9 (e): steps timed a tiered cell (after TRAIN_WARMUP), and again
# split into forward, backward and optimizer.
TIER_TRAIN_STEPS = 10


def train_tier_cfg(frames: int, name: str, dropout: float = TRAIN_DROPOUT):
    """The shipped ``frames`` model at the tier configuration ``name``
    (``TRAIN_TIER_NAMES``; None: float32), at ``dropout``."""
    import dataclasses

    from gastx_torch.models import config_for_frames
    from gastx_torch.models.config import TPU_MIXED_PRECISION_OVERRIDES

    if name is None:
        cfg = config_for_frames(frames)
    else:
        cfg = config_for_frames(
            frames, matmul_precision="high",
            precision_overrides=(TPU_MIXED_PRECISION_OVERRIDES
                                 if name == "preset" else ()))
    return dataclasses.replace(cfg, dropout=dropout)


def wgrad_bytes(m: int, ks, n: int) -> int:
    """The bytes a weight gradient must move: A's rows read once, G read
    once, dW written once (float32)."""
    return 4 * (m * (sum(ks) + n) + sum(ks) * n)


def wgrad_step_calls(K, frames: int, batch: int, name: str, dev,
                     on_call) -> None:
    """One tiered strided train step of the seeded ``frames`` model at
    B=``batch`` and tiers ``name``; ``on_call(site, pieces, g, m, kw,
    out)`` sees every gemm_wgrad call as it is made."""
    import torch

    from gastx_torch.models import build_gastnet
    from gastx_torch.ops.cuda import site_grad as S
    from gastx_torch.train import make_optimizer, train_step

    model = build_gastnet(train_tier_cfg(frames, name), seed=frames,
                          device=dev)
    opt = make_optimizer(model.parameters())
    x2, x3, w = train_batch(frames, batch, frames + batch, dev)
    wgrad = S._wgrad

    def record(site, pieces, g, m, **kw):
        out = wgrad(site, pieces, g, m, **kw)
        on_call(site, pieces, g, m, kw, out)
        return out

    S._wgrad = record
    try:
        train_step(model, opt, x2, x3, w, TRAIN_LR,
                   torch.Generator(device=dev).manual_seed(frames),
                   "strided")
    finally:
        S._wgrad = wgrad
    torch.cuda.synchronize()


# phase 2: the 27f B=1024 calls timed for the kernels line, as (op, tier,
# the pieces' K, N): each instantiation of gemm_wgrad at its main-path
# shapes (wgrad_route: wgmma at the GAB-0 block concat, the local cat and
# the C=512 block concat; smallk at the expand conv's K = 2 taps; general
# at the shrink's N = 3).
WGRAD_TIMED = (("gab_cat", "high", (128, 128, 128), 256),
               ("local_cat", "default", (128, 128), 128),
               ("gab_cat", "high", (512, 512, 512), 1024),
               ("expand", "high", (2, 2, 2), 128),
               ("shrink", "high", (1024,), 3))


def wgrad_cases(K, dev) -> dict:
    """Phase 2: every gemm_wgrad call of the tiered strided steps
    ``WGRAD_STEPS`` at all ``high`` and at the preset, each distinct shape
    and tier held to its plain version on the same operands and to a
    second launch bit for bit; the 27f calls of ``WGRAD_TIMED`` kept for
    the kernels line."""
    import torch

    held, routes, errs, main = {}, {}, {}, {}
    for frames, batch in WGRAD_STEPS:
        for name in TRAIN_TIER_NAMES:
            def hold(site, pieces, g, m, kw, out, frames=frames,
                     batch=batch):
                ks = tuple(a.shape[1] for a, _ in pieces)
                key = (f"{frames}f B={batch} {site.op} {site.tier} K={ks} "
                       f"N={g.shape[1]} M={m} offsets="
                       f"{tuple(off for _, off in pieces)} "
                       f"s_out={kw.get('s_out')}")
                if key in held:
                    return
                variant = K.wgrad_route(pieces, g, kw.get("s_out"),
                                        kw.get("a_s_in"))
                plain = K.gemm_wgrad_plain(pieces, g, m, tier=site.tier,
                                           **kw)
                err = max_err(out, plain)
                bound_ = TOL * max(1.0, float(plain.abs().max()))
                if not err <= bound_:
                    fail(f"gemm_wgrad {key} ({variant}) disagrees with its "
                         f"plain version: {err} > {bound_}")
                again = K.gemm_wgrad(pieces, g, m, tier=site.tier, **kw)
                if not torch.equal(out, again):
                    fail(f"gemm_wgrad {key} ({variant}): two launches "
                         f"differ")
                held[key], routes[key] = err, variant
                errs[variant] = max(err, errs.get(variant, 0.0))
                spec = (site.op, site.tier, ks, g.shape[1])
                if frames == 27 and spec in WGRAD_TIMED:
                    main[spec] = (variant, site.op, pieces, g, m, kw)

            wgrad_step_calls(K, frames, batch, name, dev, hold)
            torch.cuda.empty_cache()
    worst = max(held.values())
    by_variant = {v: sum(r == v for r in routes.values())
                  for v in K.WGRAD_VARIANTS}
    print(f"  gemm_wgrad: {len(held)} distinct calls of the tiered steps "
          f"(27f B=1024, 243f B=256; all high and the preset) held to their "
          f"plain versions and bitwise to a second launch: largest max|d| "
          f"{worst:.3e}; by instantiation {by_variant}")
    if not all(by_variant.values()):
        fail(f"gemm_wgrad: the tiered steps left an instantiation out: "
             f"{by_variant}")
    return {"cases": held, "routes": routes, "max_abs_err": worst,
            "max_abs_err_by_variant": errs, "calls_by_variant": by_variant,
            "main": main}


def wgrad_rows(K, main: dict) -> list:
    """The kernels line's gemm_wgrad rows: each call of ``WGRAD_TIMED``
    timed beside its plain version and its bound (bytes 4 M (K + N) and
    the output; operations 2 M K N a pass at the bf16 peak); at one pass
    two yardsticks: a bf16 ``torch.matmul`` of A^T and G gathered and cast
    beforehand (``library_ms``: it reads half the bytes the function
    must), and the two casts from the float32 operands with that call,
    timed together (``library_f32_ms``: the same inputs as the kernel)."""
    import torch

    rows = []
    # The recorded activations require a gradient: the wrappers take them
    # under no_grad, as the backward hands them over.
    with torch.no_grad():
        for spec in WGRAD_TIMED:
            if spec not in main:
                fail(f"gemm_wgrad: the 27f B=1024 step made no {spec} call")
            rows.append(wgrad_row(K, spec[1], *main[spec]))
    main.clear()
    torch.cuda.empty_cache()
    return rows


def wgrad_row(K, tier, variant, op, pieces, g, m, kw) -> dict:
    """One row of ``wgrad_rows``."""
    import torch

    ks = [a.shape[1] for a, _ in pieces]
    n = g.shape[1]
    ms = cuda_ms(lambda: K.gemm_wgrad(pieces, g, m, tier=tier, **kw))
    plain_ms = cuda_ms(lambda: K.gemm_wgrad_plain(pieces, g, m, tier=tier,
                                                   **kw), reps=3)
    library_ms = library_f32_ms = None
    if tier == "default":
        s_out = kw.get("s_out") or m
        a_s_in = kw.get("a_s_in") or s_out
        r = torch.arange(m, device=g.device)
        rows = [(r // s_out) * a_s_in + r % s_out + off for _, off in pieces]
        at = torch.cat([a[i] for (a, _), i in zip(pieces, rows)],
                       dim=1).t().to(torch.bfloat16)
        gb = g.to(torch.bfloat16)
        library_ms = cuda_ms(lambda: torch.matmul(at, gb))
        a32 = torch.cat([a[i] for (a, _), i in zip(pieces, rows)], dim=1)
        library_f32_ms = cuda_ms(lambda: torch.matmul(
            a32.t().to(torch.bfloat16), g.to(torch.bfloat16)))
        del at, gb, a32
    bms, by = tc_bound(2 * m * sum(ks) * n, wgrad_bytes(m, ks, n),
                       TC_PASSES[tier])
    shape = f"27f B=1024 {op}, M={m}, K={'+'.join(map(str, ks))}, N={n}"
    print(f"  gemm_wgrad ({variant}, {tier}, {shape}): {ms:.4f} ms (plain "
          f"{plain_ms:.3f}, bound {bms:.4f} by {by}"
          + (f", bf16 torch.matmul {library_ms:.4f}, with the casts "
             f"{library_f32_ms:.4f}" if library_ms else "") + ")")
    return {"variant": variant, "tier": tier, "shape": shape, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "library_f32_ms": library_f32_ms}


def step_state_of(loss, model) -> dict:
    """A step's loss, gradients, parameters and BN statistics by name (on
    the card)."""
    out = {"loss": loss.detach().reshape(1)}
    for n, p in model.named_parameters():
        out[f"grad {n}"] = p.grad.detach().clone()
        out[f"param {n}"] = p.detach().clone()
    out.update({f"bn {n}": b.detach().clone()
                for n, b in model.named_buffers() if "running" in n})
    return out


def tiered_step_against_plain(K, frames: int, batch: int, name: str,
                              dev) -> dict:
    """Phase 9 (e): one tiered strided step (dropout 0.05) of the seeded
    ``frames`` model at B=``batch`` on the kernels, against the same step
    through the plain versions on the card (``train_step(plain=True)``)
    and the float32 step: for each kind of tensor (the loss, the
    gradients, the parameters after amsgrad, the BN statistics) the kernel
    step's distance from the float32 step, in the 2-norm over all its
    elements, at most ``TIER_STEP_NORM`` times the plain step's plus the
    float32 bound of the kind's norm; and a second run on the kernels bit
    for bit the first."""
    import copy

    import torch

    from gastx_torch.models import build_gastnet
    from gastx_torch.train import make_optimizer, train_step

    base = build_gastnet(train_tier_cfg(frames, name), seed=frames + 1,
                         device=dev)
    x2, x3, w = train_batch(frames, batch, frames + batch + 1, dev)

    def run(cfg, plain):
        m = copy.deepcopy(base)
        m.cfg = cfg
        opt = make_optimizer(m.parameters())
        loss = train_step(m, opt, x2, x3, w, TRAIN_LR,
                          torch.Generator(device=dev).manual_seed(5),
                          "strided", plain=plain)
        torch.cuda.synchronize()
        return step_state_of(loss, m)

    f32 = run(train_tier_cfg(frames, None), False)
    plain = run(base.cfg, True)
    got = run(base.cfg, False)
    again = run(base.cfg, False)
    sums = {}
    for n, f in f32.items():
        f = f.double()
        acc = sums.setdefault(n.split()[0], [0.0, 0.0, 0.0, (0.0, "")])
        acc[0] += float(((got[n].double() - f) ** 2).sum())
        acc[1] += float(((plain[n].double() - f) ** 2).sum())
        acc[2] += float((f ** 2).sum())
        acc[3] = max(acc[3], (max_err(got[n], plain[n]), n))
    bitwise = all(torch.equal(got[n], again[n]) for n in got)
    label = f"{frames}f B={batch} {name}"
    kinds = {}
    for kind, (dk, dp, scale, direct) in sums.items():
        dk, dp, scale = dk ** 0.5, dp ** 0.5, scale ** 0.5
        bound_ = TIER_STEP_NORM * dp + TOL * max(1.0, scale)
        kinds[kind] = {"kernel_distance": dk, "plain_distance": dp,
                       "bound": bound_, "float32_norm": scale,
                       "largest_kernel_plain_difference": direct[0],
                       "in_tensor": direct[1]}
        print(f"  {label} {kind}: the kernel step {dk:.4e} from float32, the "
              f"plain step {dp:.4e} (2-norms; bound {bound_:.4e}, float32 "
              f"norm {scale:.4e}); kernel against plain at most "
              f"{direct[0]:.3e} ({direct[1]})")
        if not dk <= bound_:
            fail(f"{label}: the tiered step's {kind} lie {dk} from the "
                 f"float32 step, its plain version's {dp}")
    print(f"  {label}: two runs bitwise equal: {bitwise}")
    if not bitwise:
        fail(f"{label}: two runs of the tiered step differ")
    return {"by_kind": kinds, "bitwise_repeat": bitwise,
            "loss": float(got["loss"]), "plain_loss": float(plain["loss"]),
            "float32_loss": float(f32["loss"])}


def tiered_train_phase(K, dev, f32_cells: dict) -> dict:
    """Phase 9 (e): the tiered train steps of ``TRAIN_CELLS`` at all
    ``high`` and the preset, each timed as phase 9 (a) times the float32
    ones (``train_cell``), beside them; then ``TIER_STEP_CHECKS`` against
    the plain-version steps."""
    out = {}
    for label, frames, b in TRAIN_CELLS:
        for name in TRAIN_TIER_NAMES:
            cell = train_cell(K, f"{label} {name}", frames, b, dev,
                              tiers=name)
            cell["against_float32_ms"] = cell["ms"] / f32_cells[label]["ms"]
            out[f"{label} {name}"] = cell
            print(f"    {cell['ms'] / f32_cells[label]['ms']:.3f}x the "
                  f"float32 step ({f32_cells[label]['ms']:.3f} ms)")
    out["against_plain"] = {
        f"{frames}f B={batch} {name}": tiered_step_against_plain(
            K, frames, batch, name, dev)
        for frames, batch in TIER_STEP_CHECKS for name in TRAIN_TIER_NAMES}
    return out


# --------------------------------------------------------------------------
# Phase 10: the precision tiers (gastx_torch.ops.precision) on the card
# --------------------------------------------------------------------------

BF16_PEAK = 989e12     # H100 SXM dense bf16 tensor-core FLOP/s
# gemm_tc's tiers and bf16 passes ("kdefault" is the "default" one).
TC_PASSES = {"default": 1, "high_lhs": 2, "high_rhs": 2, "high": 3}
# phase 10 (a): gemm_epilogue's shapes held at every tier: a GEMM_SHAPES
# line (index) at a number of windows, and the tier row's main shape.
TIER_GEMM_CASES = ((7, 1024), (6, 256), (10, 256), (0, 1024))
# The score/apply tier pairs the cert's two configurations give
# joint_attention: all "high", and the preset's.
ATTN_PAIRS = (("high", "high"), ("default", "default"))
# Every pair at one small shape: the runtime tier codes of the two
# instantiations (the apply tier "high" is the other one).
ATTN_ALL = ("highest", "default", "high_lhs", "high_rhs", "high")
# phase 10 (b): the cert, 24 seeds of the port's init at each model,
# B=64 windows of rf frames, dropout 0, eval; the budget is the JAX
# package's 0.1 mm (gastx/models/config.py:350-353), outputs in metres.
CERT_SEEDS = range(24)
CERT_BUDGET_MM = 0.1
# phase 10 (d): (receptive field, batch of windows) of the throughput.
TIER_FORWARDS = ((27, 1024), (81, 1024), (243, 256))


def tier_configs(frames: int) -> dict:
    """The cert's configurations of the shipped ``frames`` model (h36m17,
    dilated, non-causal, dropout 0): float32, (i) all "high", (ii) the JAX
    package's inference preset."""
    from gastx_torch.models import config_for_frames
    from gastx_torch.models.config import TPU_MIXED_PRECISION_OVERRIDES

    return {
        "highest": config_for_frames(frames, dropout=0.0),
        "high": config_for_frames(frames, dropout=0.0,
                                  matmul_precision="high"),
        "preset": config_for_frames(
            frames, dropout=0.0, matmul_precision="high",
            precision_overrides=TPU_MIXED_PRECISION_OVERRIDES)}


def with_config(model, cfg):
    """``model`` with ``cfg`` (the same architecture, other tiers)."""
    model.cfg = cfg
    return model


def attn_tier_check(name, got, plain, plain_f32, noise, g, c_k,
                    apply_tier):
    """Hold a tiered ``joint_attention`` to its plain version.

    Both round the same score operands (inputs), but the apply's lhs is the
    softmax each computes in its own float32 order, so a weight lying
    within rounding of a bf16 boundary may round to the neighbouring value
    on one side: one bf16 ulp, at most 2^-7 |w| (2^-14 where the lhs keeps
    16 bits). So each output element may differ by the float32 bound plus
    2^-7 max|g| sum_m |w_qm| <= 2^-7 max|g| (1 + max_q sum_m |C_k[q, m]|).
    Such flips are rare, so the kernel must also lie nearer its plain
    version than the float32 output, by half in root-mean-square (a kernel
    that skipped the rounding would sit at the float32 output), wherever
    the tier moves the plain output by more than twice ``noise``, the
    float32 kernel's own root-mean-square distance from its plain
    version (below it no test tells a tier from float32)."""
    err = max_err(got, plain)
    flip = {"highest": 0.0, "high_lhs": 2.0 ** -14,
            "high": 2.0 ** -14}.get(apply_tier, 2.0 ** -7)
    ck_sum = float(c_k.abs().sum(-1).max())
    bound_ = (TOL * max(1.0, float(plain.abs().max()))
              + flip * float(g.abs().max()) * (1.0 + ck_sum))
    rms = float((got - plain).pow(2).mean().sqrt())
    rms_f32 = float((got - plain_f32).pow(2).mean().sqrt())
    rms_tier = float((plain - plain_f32).pow(2).mean().sqrt())
    print(f"  {name}: max|d| {err:.3e} (bound {bound_:.3e}); rms {rms:.3e}"
          f", from the float32 output {rms_f32:.3e} (the tier moves the "
          f"plain output by {rms_tier:.3e}, float32 noise {noise:.3e})")
    if not err <= bound_:
        fail(f"{name} disagrees with its plain version: {err} > {bound_}")
    if rms_tier > 2 * noise and not rms <= 0.5 * rms_f32:
        fail(f"{name}: rms {rms} from its plain version is not half its "
             f"{rms_f32} from the float32 output")
    return err


def tc_work(m, ks, n, has_bn, has_res, tier):
    """gemm_tc's bound: the product's operations at the bf16 rate a pass,
    the bytes of A (float32), W's bf16 halves, the output and epilogue."""
    flops, nbytes = gemm_work(m, ks, n, has_bn, has_res)
    k = sum(ks)
    halves = 2 if tier in ("high", "high_rhs") else 1
    nbytes += (2 * halves - 4) * k * n
    return flops, nbytes, TC_PASSES[tier]


def tc_passes(tier: str, a_bf16: bool) -> int:
    """gemm_tc's bf16 passes over one A piece at ``tier`` that the bound
    counts: A's lo half where the tier splits A and A is float32 (a bf16
    A's lo half is zero; the general body skips that pass, while the wgmma
    kernel multiplies the zeros, work the bound leaves out), W's lo half
    where the tier splits W."""
    return (1 + (tier in ("high", "high_lhs") and not a_bf16)
            + (tier in ("high", "high_rhs")))


def tc_bound(flops, nbytes, passes):
    t_ops, t_bytes = flops * passes / BF16_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def tc_a_route(kw) -> str:
    """How gemm_tc's wgmma instantiation brings A into shared memory for
    these keyword arguments (gemm_tc.cu decides the same): by TMA where a
    tile's rows are contiguous in A (s_out == a_s_in, the 1x1 products),
    else by cp.async row gathers through the row map (the conv taps)."""
    s_out = kw.get("s_out")
    return "tma" if s_out is None or s_out == kw.get("a_s_in", s_out) \
        else "gather"


def tier_kernels(K, dev, gts, glts) -> dict:
    """Phase 10 (a): ``gemm_epilogue`` at every tier on ``gemm_tc`` and
    ``joint_attention`` at the cert's tier pairs, held to their plain
    versions (the same operands rounded), timed beside their bound and one
    PyTorch call where one computes the same function; the ragged
    ``general`` cases at every tier; each GEMM on the kernel and
    instantiation ``gemm_route`` names (``launched_route``)."""
    import torch

    print("phase 10 (a): the tiered kernels against their plain versions")
    card_state("phase 10 (a)")
    rows, errs = [], {}
    for tier in TC_PASSES:
        for idx, windows in TIER_GEMM_CASES:
            spec = GEMM_SHAPES[idx]
            label, _, _, ks, n, epi, taps, res = spec
            pieces, m, kw = gemm_case(spec, dev, 300 + idx, windows=windows)
            kw["tier"] = tier
            (kernel, variant), taken, got = launched_route(K, pieces, m, kw)
            if taken != variant:
                fail(f"{kernel} {label}: took {taken}, not {variant}")
            err = check(f"{kernel} {tier} {label} (B={windows}, {variant})",
                        got, K.gemm_epilogue_plain(pieces, m, **kw))
            del got
            errs[tier] = max(errs.get(tier, 0.0), err)
            if idx != TIER_GEMM_CASES[0][0]:
                continue
            ms = cuda_ms(lambda: K.gemm_epilogue(pieces, m, **kw))
            plain_ms = cuda_ms(lambda: K.gemm_epilogue_plain(pieces, m,
                                                             **kw), reps=3)
            f32_ms = cuda_ms(lambda: K.gemm_epilogue(
                pieces, m, **{**kw, "tier": "highest"}))
            library_ms = matmul_ms = None
            if tier == "default":
                # One cuBLAS call of the same function at this tier (bf16
                # operands, float32 output, the bias: scale is 1 here),
                # and a bf16 torch.matmul (bf16 out: half the output
                # bytes). Yardsticks only.
                a16 = pieces[0][0].to(torch.bfloat16)
                w16 = pieces[0][1].to(torch.bfloat16)
                matmul_ms = cuda_ms(lambda: torch.matmul(a16, w16))
                try:
                    library_ms = cuda_ms(lambda: torch.addmm(
                        kw["shift"], a16, w16, out_dtype=torch.float32))
                except (RuntimeError, TypeError, NotImplementedError) as e:
                    print(f"  torch.addmm(..., out_dtype=torch.float32) "
                          f"refused: {str(e).splitlines()[0][:160]}")
                del a16, w16
            bms, by = tc_bound(*tc_work(m, ks, n, 1, kw["res"] is not None,
                                        tier))
            rows.append({"tier": tier, "shape": f"{label} (B={windows})",
                         "m": m, "ks": list(ks), "n": n, "ms": ms,
                         "plain_ms": plain_ms, "float32_ms": f32_ms,
                         "library_ms": library_ms,
                         "matmul_bf16_ms": matmul_ms, "bound_ms": bms,
                         "bound_by": by, "max_abs_err": err,
                         "a_route": tc_a_route(kw),
                         "tflops": 2 * m * n * sum(ks) / ms / 1e9})
            print(f"  gemm_tc {tier} {label} (B={windows}): {ms:.3f} ms "
                  f"({rows[-1]['tflops']:.1f} TFLOP/s; float32 "
                  f"gemm_epilogue {f32_ms:.3f}; plain {plain_ms:.3f}; bound "
                  f"{bms:.3f} by {by}"
                  + (f"; bf16 torch.matmul {matmul_ms:.3f}; float32-out "
                     f"torch.addmm {library_ms}" if matmul_ms else "")
                  + ")")
            del pieces, kw
            torch.cuda.empty_cache()
        for label, pieces, m, kw, _ in (tc_edge_cases(dev)
                                        + gemm_ragged_cases(dev)):
            kw = {**kw, "tier": tier}
            (kernel, want), taken, got = launched_route(K, pieces, m, kw)
            if taken != want:
                fail(f"{kernel} {label}: took {taken}, not {want}")
            errs[tier] = max(errs[tier], check(
                f"{kernel} {tier} {label} ({want})", got,
                K.gemm_epilogue_plain(pieces, m, **kw)))
            del got

    attn_rows = []
    g1 = gts[1]
    for c, t, frames in ((256, g1, 19), (128, gts[0], 25)):
        for b, pairs in ((1024, ATTN_PAIRS), (4, [
                (s_, a_) for s_ in ATTN_ALL for a_ in ATTN_ALL])):
            rows_ = b * frames * 17
            _, args = graph_operands(K, t, rows_, dev, seed=400 + c)
            g = args[2]
            plain_f32 = K.joint_attention_plain(*args)
            noise = float((K.joint_attention(*args) - plain_f32).pow(2)
                          .mean().sqrt())
            for st, at in pairs:
                kw = dict(score_tier=st, apply_tier=at)
                got = K.joint_attention(*args, **kw)
                plain = (plain_f32 if st == at == "highest"
                         else K.joint_attention_plain(*args, **kw))
                err = attn_tier_check(
                    f"joint_attention {st}/{at} C={c} (B={b})", got, plain,
                    plain_f32, noise, g, t.c_k, at)
                del got, plain
                key = f"{st}/{at}"
                errs[key] = max(errs.get(key, 0.0), err)
                if b != 1024:
                    continue
                ms = device_ms(lambda: K.joint_attention(*args, **kw),
                               "joint_attention")
                f32_ms = device_ms(lambda: K.joint_attention(*args),
                                   "joint_attention")
                plain_ms = cuda_ms(lambda: K.joint_attention_plain(
                    *args, **kw), reps=3)
                k_, inter = t.proj_t.shape
                flops, nbytes = attn_work(rows_, 17, k_, inter,
                                          g.shape[1] // k_)
                bms, by = bound(flops * (2 if at == "high" else 1), nbytes)
                attn_rows.append({
                    "pair": key, "c": c, "rows": rows_, "ms": ms,
                    "float32_ms": f32_ms, "plain_ms": plain_ms,
                    "library_ms": None, "bound_ms": bms, "bound_by": by,
                    "max_abs_err": err})
                print(f"  joint_attention {key} C={c} (B={b}): {ms:.3f} ms "
                      f"a launch on the device (float32 {f32_ms:.3f}; plain "
                      f"{plain_ms:.3f}; bound {bms:.3f} by {by})")
            del args, g, plain_f32
            torch.cuda.empty_cache()
    return {"gemm_tc": rows, "joint_attention": attn_rows, "errs": errs,
            "direct_launches": {k: dict(v) for k, v in
                                K.TIER_LAUNCHES.items()}}


def tier_bound(plain, f32) -> tuple:
    """(bound, the tier's own distance) of a tiered computation against
    its plain version ``plain``, ``f32`` the float32 one.

    Two computations at one tier whose float32 sums run in other orders
    round a few operands to neighbouring bf16 values; past the first such
    operand they differ as two draws of the tier's rounding do. So the
    bound is the float32 one or, where larger, twice the tier's own
    distance from the float32 result, which a broken kernel (a wrong row,
    tap or head) far exceeds. At "highest" it is the float32 bound."""
    tier_err = max_err(plain, f32)
    return max(TOL * max(1.0, float(plain.abs().max())), 2 * tier_err), \
        tier_err


def tiered_check(name, model, x, got, variant="dilated"):
    """Hold a tiered eval forward ``got`` of ``model`` on ``x`` to the same
    route and tiers through the plain versions, by :func:`tier_bound`;
    returns (its max |d|, the plain route's own max distance from the
    float32 ``reference_forward``, the float32 output's largest
    magnitude)."""
    plain = model.plain_route_forward(x, variant)
    f32 = model.reference_forward(x, variant)
    bound_, tier_err = tier_bound(plain, f32)
    err = max_err(got, plain)
    print(f"  {name}: max|d| {err:.3e} (bound {bound_:.3e}; the tier's own "
          f"distance from float32 {tier_err:.3e})")
    if not err <= bound_:
        fail(f"{name} disagrees with its plain version: {err} > {bound_}")
    return err, tier_err, float(f32.abs().max())


def tier_cert(dev) -> dict:
    """Phase 10 (b): the 24-seed cert. For each model and seed, the port's
    init (``build_gastnet``, seed), the input ``np.random.default_rng(seed)
    .standard_normal((64, rf, 17, 2))`` (as the JAX package's
    ``scripts/perf_lab13.py``), and the max |tiered - float32| of the
    card's eval forward in mm (x1000): (i) all "high", which fails the run
    above the budget, (ii) the JAX preset, a finding against it."""
    import numpy as np
    import torch

    from gastx_torch.models import build_gastnet

    print(f"phase 10 (b): the cert, worst of {len(CERT_SEEDS)} seeds, "
          f"max |tiered - float32| in mm (budget {CERT_BUDGET_MM} mm)")
    out = {}
    for frames in (27, 81, 243):
        cfgs = tier_configs(frames)
        worst = {"high": (0.0, -1), "preset": (0.0, -1)}
        per_seed = {"high": [], "preset": []}
        for seed in CERT_SEEDS:
            model = build_gastnet(cfgs["highest"], seed=seed, device=dev)
            x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
                (64, frames, 17, 2)).astype(np.float32)).to(dev)
            exact = model(x)
            for name in worst:
                y = with_config(model, cfgs[name])(x)
                if not bool(torch.isfinite(y).all()):
                    fail(f"cert {frames}f {name} seed {seed}: non-finite")
                d = float((y - exact).abs().max()) * 1000.0
                per_seed[name].append(d)
                worst[name] = max(worst[name], (d, seed))
            with_config(model, cfgs["highest"])
            del model, x, exact
        out[f"{frames}f"] = {name: {"worst_mm": w, "seed": s,
                                    "per_seed_mm": per_seed[name]}
                             for name, (w, s) in worst.items()}
        for name, (w, s) in worst.items():
            print(f"  {frames}f {name}: worst {w:.4f} mm (seed {s}); median "
                  f"{float(np.median(per_seed[name])):.4f} mm")
        torch.cuda.empty_cache()
    for frames in (27, 81, 243):
        w = out[f"{frames}f"]["high"]["worst_mm"]
        if not w <= CERT_BUDGET_MM:
            fail(f"cert (i) at {frames}f: {w} mm over {CERT_BUDGET_MM} mm")
    return out


# phase 10 (c) beyond the six dilated forwards, on the 27f preset: the
# routes whose GABs run plain sites, (label, config fields), B=64 windows;
# then a causal model's strided pushes (StreamingLifter) of PUSH_STREAMS
# streams.
TIER_ROUTE_CELLS = (("27f xla", {"gab_impl": "xla"}), ("27f hybrid", HYBRID))
PUSH_STREAMS = 64


def expected_narrow(K, model) -> int:
    """``gab_narrow`` launches of one dilated kernel-route forward of
    ``model``: its GABs that ``fused_gab.gab_route`` sends there at their
    tiers and forms."""
    from gastx_torch.ops.cuda.fused_gab import (KERNEL_OPS, gab_route,
                                                gab_tables)

    cfg = model.cfg
    return sum(gab_route(gab_tables(g, model.statics, cfg.gab_form_for(i)),
                         {op: cfg.tier_for(op, f"gab{i}")
                          for op in KERNEL_OPS}) == "gab_narrow"
               for i, g in enumerate(model.layers_graph_conv))


def tier_paths(K, dev) -> dict:
    """Phase 10 (c): the tiered forwards, (i) and (ii) at 27f, 81f and
    243f on B=64 windows, each held to the same route and tiers through
    the plain versions (``plain_route_forward``) within the float32 bound
    (the bf16 operands are rounded alike; only the float32 sums' order, and
    the rare operand that rounds to the neighbouring bf16 value after it,
    differ); then the preset on the 27f routes whose GABs are plain sites
    (``TIER_ROUTE_CELLS``) and two strided pushes of a causal 27f model,
    held by ``tiered_check``. The launch counters are zeroed just before
    these forwards and read just after: the tiered path's launches, and
    the plain sites' products (``K.SITE_PRODUCTS``), none of which may
    compute float32."""
    import dataclasses

    import numpy as np
    import torch

    from gastx_torch.infer import StreamingLifter
    from gastx_torch.models import build_gastnet, config_for_frames
    from gastx_torch.models.config import TPU_MIXED_PRECISION_OVERRIDES

    print("phase 10 (c): the tiered forwards against their plain route "
          "(B=64)")
    models, xs, held = {}, {}, {}
    for frames in (27, 81, 243):
        models[frames] = build_gastnet(tier_configs(frames)["highest"],
                                       seed=frames, device=dev)
        xs[frames] = torch.from_numpy(np.random.default_rng(frames)
                                      .standard_normal((64, frames, 17, 2))
                                      .astype(np.float32)).to(dev)
    preset = tier_configs(27)["preset"]
    routes = {label: build_gastnet(dataclasses.replace(preset, **fields),
                                   seed=27, device=dev)
              for label, fields in TIER_ROUTE_CELLS}
    pusher = build_gastnet(config_for_frames(
        27, causal=True, dropout=0.0, matmul_precision="high",
        precision_overrides=TPU_MIXED_PRECISION_OVERRIDES), seed=28,
        device=dev)
    kps = torch.from_numpy(np.random.default_rng(28).standard_normal(
        (2, PUSH_STREAMS, 17, 2)).astype(np.float32)).to(dev)
    lifter = StreamingLifter(pusher, num_person=PUSH_STREAMS)
    outs, want_narrow = {}, 0
    K.reset_launches()
    for frames in (27, 81, 243):
        for name in ("high", "preset"):
            m = with_config(models[frames], tier_configs(frames)[name])
            outs[(frames, name)] = m(xs[frames])
            want_narrow += expected_narrow(K, m)
    route_outs = {label: m(xs[27]) for label, m in routes.items()}
    pushes = [lifter.push_async(k) for k in kps]
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts(K).items() if v}
    sites = {op: dict(v) for op, v in K.SITE_PRODUCTS.items()}
    forwards = len(outs) + len(route_outs) + len(pushes)
    for (frames, name), y in outs.items():
        m = with_config(models[frames], tier_configs(frames)[name])
        held[f"{frames}f {name}"] = check(
            f"{frames}f {name} forward (B=64) against its plain route", y,
            m.plain_route_forward(xs[frames]))
    for label, y in route_outs.items():
        held[f"{label} preset"] = tiered_check(
            f"{label} preset forward (B=64)", routes[label], xs[27], y)[0]
    rf = pusher.cfg.receptive_field()
    window = torch.cat([kps[0][:, None].expand(-1, rf - 1, -1, -1),
                        kps[1][:, None]], dim=1)
    held["27f causal push preset"] = tiered_check(
        f"27f causal preset push ({PUSH_STREAMS} streams)", pusher, window,
        pushes[1][:, None], variant="strided")[0]
    print(f"  launches over the {forwards} forwards: {launches}")
    print(f"  plain sites' products by class and tier: {sites}")
    for key in ("gemm_tc", "gemm_tc high", "gemm_tc high_rhs",
                "gemm_tc default", "gemm_tc vec16", "gemm_smallk",
                "joint_attention high/high",
                "joint_attention default/default", "gab_narrow",
                "gab_narrow fold", "sem_graph", "fused_local_branch",
                "head_attention"):
        if not launches.get(key):
            fail(f"the tiered path did not launch {key}")
    if launches.get("gemm_epilogue"):
        fail("a tiered forward launched the float32 gemm_epilogue")
    # The 243f preset's GAB 0, folded, is one tiered gab_narrow launch: the
    # fold chain's score-free joint_attention ("highest/...") never runs.
    if (narrow_tier_launches(launches, fold=True) != 1
            or any(k.startswith("joint_attention highest/")
                   for k in launches)):
        fail(f"the 243f preset's GAB 0 did not run as one fold gab_narrow "
             f"launch: {launches}")
    # The expand conv (K = 2 a tap) takes gemm_smallk and the shrink (N = 3)
    # the general gemm_tc, once a forward each; no other product is ragged.
    if (launches.get("gemm_smallk") != forwards
            or launches.get("gemm_tc general") != forwards):
        fail(f"the tiered path launched gemm_smallk "
             f"{launches.get('gemm_smallk')} times and the general gemm_tc "
             f"{launches.get('gemm_tc general')} times, not once a forward")
    narrow = sum(v for k, v in K.TIER_LAUNCHES["gab_narrow"].items())
    if narrow != want_narrow or narrow != launches.get("gab_narrow"):
        fail(f"gab_narrow launched {launches.get('gab_narrow')} times, "
             f"{narrow} tiered, where gab_route picks it {want_narrow} "
             f"times")
    from gastx_torch.models.config import OP_CLASSES

    for op in OP_CLASSES:
        if sites.get(op, {}).get("highest") or not sites.get(op):
            fail(f"the plain site {op} computed {sites.get(op)} on the "
                 f"tiered path (none may be float32; every class runs)")
    del models, xs, outs, routes, route_outs, pusher, lifter
    torch.cuda.empty_cache()
    return {"max_abs_err": held, "launches": launches,
            "site_products": sites, "gab_narrow_expected": want_narrow}


def tier_throughput(K, dev) -> dict:
    """Phase 10 (d): windows/s of the full-width forwards (27f/81f/243f at
    B=1024/1024/256) at float32, (i) and (ii) in one call, each with its
    device busy time and idle share (one profiled forward) and launches by
    instantiation; then gab_narrow, float32 and at the preset's tiers,
    beside the chain at the preset's tiers at the three narrow GABs
    (``gab_route``'s rule)."""
    import torch

    from gastx_torch.models import build_gastnet
    from gastx_torch.ops.cuda.fused_gab import KERNEL_OPS, gab_tables

    print("phase 10 (d): throughput of the tiered forwards (each timed in "
          "two turns, float32, high, preset, preset, high, float32)")
    out = {}
    for frames, b in TIER_FORWARDS:
        cfgs = tier_configs(frames)
        model = build_gastnet(cfgs["highest"], seed=frames, device=dev)
        gen = torch.Generator(device=dev).manual_seed(frames)
        x = torch.randn((b, frames, 17, 2), generator=gen, device=dev)
        state = card_state(f"{frames}f B={b}")
        times = {}
        for name in ("highest", "high", "preset", "preset", "high",
                     "highest"):
            m = with_config(model, cfgs[name])
            if name not in times:
                K.reset_launches()
                m(x)
                torch.cuda.synchronize()
                per_forward = {k: v for k, v in launch_counts(K).items()
                               if v}
                prof = profile_call(lambda: m(x), f"  {frames}f B={b} "
                                    f"{name}: one profiled forward")
                out[f"{frames}f {name}"] = {
                    "batch": b, "device_busy_ms": prof
                    and prof["device_busy_ms"],
                    "idle_share": prof and prof["idle_share"],
                    "launches_per_forward": per_forward, "card": state}
            times.setdefault(name, []).append(cuda_ms(lambda: m(x)))
        for name, ms_ in times.items():
            ms = sum(ms_) / len(ms_)
            out[f"{frames}f {name}"].update(ms=ms, turns_ms=ms_,
                                            seq_per_s=b / (ms / 1e3))
            print(f"  {frames}f B={b} {name}: {b / (ms / 1e3):.1f} seq/s "
                  f"({ms:.2f} ms a forward; turns {ms_[0]:.2f}, "
                  f"{ms_[1]:.2f}); launches "
                  f"{out[f'{frames}f {name}']['launches_per_forward']}")
        del model, x
        torch.cuda.empty_cache()
    nar = {}
    for frames, level, b, t_gab in ((243, 0, 256, 241), (81, 0, 1024, 79),
                                    (243, 1, 256, 235)):
        cfg = tier_configs(frames)["preset"]
        model = build_gastnet(cfg, seed=frames, device=dev)
        t = gab_tables(model.layers_graph_conv[level], model.statics)
        tiers = {op: cfg.tier_for(op, f"gab{level}") for op in KERNEL_OPS}
        c = t.w_proj.shape[0]
        gen = torch.Generator(device=dev).manual_seed(level)
        x2 = torch.randn((b * t_gab * 17, c), generator=gen, device=dev)
        ms = cuda_ms(lambda: K.gab_narrow(x2, t))
        tiered_ms = cuda_ms(lambda: K.gab_narrow(x2, t, tiers=tiers))
        chain_ms = cuda_ms(lambda: K.gab_chain(
            x2, t, K.gemm_epilogue, K.sem_graph, K.joint_attention, tiers))
        f32_chain_ms = cuda_ms(lambda: K.gab_chain(
            x2, t, K.gemm_epilogue, K.sem_graph, K.joint_attention))
        label = f"{frames}f GAB {level} C={c} T={t_gab} B={b}"
        nar[label] = {"gab_narrow_ms": ms, "tiered_gab_narrow_ms": tiered_ms,
                      "tiered_chain_ms": chain_ms,
                      "float32_chain_ms": f32_chain_ms,
                      "route": K.gab_route(*K.gab_shape(t), tiers)}
        print(f"  {label}: gab_narrow at the preset's tiers {tiered_ms:.3f} "
              f"ms (float32 {ms:.3f}); the chain at the preset's tiers "
              f"{chain_ms:.3f} ms (float32 {f32_chain_ms:.3f}); routed to "
              f"{nar[label]['route']}")
        del model, t, x2
        torch.cuda.empty_cache()
    out["narrow_vs_tiered_chain"] = nar
    return out


# phase 10 (f): gab_narrow's tiered form, held at each width it routes
# or may route (level 0 of a 2-level model of that many channels, random
# BN statistics) at every tier and at the JAX preset's kernel tiers, on
# NARROW_TIER_FRAMES frames, in both libraries (float32 x and output; bf16
# x and output); then timed at the 243f model's GAB 0 (C=32, T=241, B=256)
# at each tier beside the tiered chain and its bound. The fold form
# likewise, on the fold tables of the same GABs (``NARROW_FOLD_WIDTHS``),
# its float32 kernel too, and timed beside the fold chain.
NARROW_TIER_WIDTHS = (16, 32, 48, 64)
NARROW_TIER_FRAMES = 1000
NARROW_TIERS = ("default", "kdefault", "high_lhs", "high_rhs", "high",
                "preset")


def narrow_tier_dict(tier: str) -> dict:
    """The kernel tiers of a ``NARROW_TIERS`` entry: every class at the
    tier, or the JAX preset's at the 243f model's GAB 1."""
    from gastx_torch.ops.cuda.fused_gab import KERNEL_OPS

    if tier == "preset":
        cfg = tier_configs(243)["preset"]
        return {op: cfg.tier_for(op, "gab1") for op in KERNEL_OPS}
    return dict.fromkeys(KERNEL_OPS, tier)


def narrow_tier_check(K, name, x, t, tiers, noise, out_dtype) -> float:
    """One tiered ``gab_narrow`` launch to ``out_dtype`` held to its plain
    version at the same tiers by ``tier_bound`` (plus one bf16 step of a
    bf16 output), checked to launch the tiered form once and to leave the
    split words of ``narrow_split_plain`` in its scratch buffer, and, on a
    float32 output, in root-mean-square half as far from its plain version
    as from the float32 one wherever the tier moves the plain output by
    more than twice ``noise`` (the float32 kernel's own distance from its
    plain version): a kernel that skipped a tier would sit at the float32
    output (a bf16 output's own rounding hides that)."""
    import torch

    before = sum(K.TIER_LAUNCHES["gab_narrow"].values())
    form = K.VARIANT_LAUNCHES["gab_narrow"][t.form]
    got = K.gab_narrow(x, t, out_dtype, tiers).float()
    if (sum(K.TIER_LAUNCHES["gab_narrow"].values()) != before + 1
            or K.VARIANT_LAUNCHES["gab_narrow"][t.form] != form + 1):
        fail(f"{name}: the tiered gab_narrow did not launch its {t.form} "
             f"form")
    # The launch's split words in its scratch buffer, bit for bit, and the
    # grid barrier's counters back at 0.
    buf = K.narrow_scratch(x.device, torch.cuda.current_stream().cuda_stream)
    off, words = K.narrow_split_plain(t)
    if not (torch.equal(buf[K.NARROW_SCRATCH_CTL + off], words)
            and int(buf[:K.NARROW_SCRATCH_CTL].abs().sum()) == 0):
        fail(f"{name}: the scratch buffer does not hold the split words of "
             f"kernels.narrow_split_plain")
    plain = K.gab_narrow_plain(x, t, out_dtype, tiers).float()
    f32 = K.gab_narrow_plain(x, t, torch.float32)
    bound_, tier_err = tier_bound(plain, f32)
    if out_dtype == torch.bfloat16:
        bound_ += 2.0 ** -8 * float(plain.abs().max())
        noise = float("inf")
    err = max_err(got, plain)
    rms = float((got - plain).pow(2).mean().sqrt())
    rms_f32 = float((got - f32).pow(2).mean().sqrt())
    rms_tier = float((plain - f32).pow(2).mean().sqrt())
    print(f"  {name}: max|d| {err:.3e} (bound {bound_:.3e}; tier "
          f"{tier_err:.3e}); rms {rms:.3e}, from float32 {rms_f32:.3e}")
    if not err <= bound_:
        fail(f"{name} disagrees with its plain version: {err} > {bound_}")
    if rms_tier > 2 * noise and not rms <= 0.5 * rms_f32:
        fail(f"{name}: rms {rms} from its plain version is not half its "
             f"{rms_f32} from the float32 output")
    return err


def narrow_bound(rows, c, j, k, inter, g, d, tiers, fold=False) -> tuple:
    """The tiered gab_narrow's bound: the block's bytes (``gab_work``),
    against its products' operations at the bf16 rate a pass (each class
    at its tier's passes: ``tc_passes``) and the attention's at the
    float32 one. In the fold form (``inter`` 1) the score columns sa | sb
    count at ``attn_score``'s passes (at "highest", float32 operations),
    the g columns at ``attn_proj``'s."""
    flops, nbytes = gab_work(rows, c, j, k, inter, g, d)
    passes = {op: tc_passes("default" if v == "kdefault" else v, False)
              for op, v in tiers.items()}
    width = 4 * c + 2 * k * inter + k * g
    mm = {"local_sem": 2 * rows * c * 4 * c,
          "attn_proj": 2 * rows * c * (width - 4 * c),
          "local_cat": 2 * rows * 2 * c * c, "attn_cat": 2 * rows * k * g * c,
          "gab_cat": 2 * rows * 3 * c * 2 * c}
    if fold:
        mm["attn_proj"] = 2 * rows * c * k * g
        if tiers["attn_score"] != "highest":
            mm["attn_score"] = 2 * rows * c * 2 * k
    t_ops = (sum(n * passes[op] for op, n in mm.items()) / BF16_PEAK
             + (flops - sum(mm.values())) / F32_PEAK)
    t_bytes = nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def tier_narrow(K, dev) -> dict:
    """Phase 10 (f): the tiered ``gab_narrow`` against its plain version
    (``narrow_tier_check``) at ``NARROW_TIER_WIDTHS`` x ``NARROW_TIERS`` in
    both libraries, then its time at the 243f GAB 0 by tier, beside the
    tiered chain, the float32 kernel and the bound (``narrow_bound``); the
    fold form the same way at ``K.NARROW_FOLD_WIDTHS`` (and its float32
    kernel, by ``check_out``), timed beside the fold chain."""
    import torch

    from gastx_torch.models import (GastNet, GastNetConfig, init_gastnet,
                                    randomize_eval_statistics)
    from gastx_torch.ops.cuda.fused_gab import gab_tables

    print("phase 10 (f): gab_narrow's tiered form and its fold form "
          "against their plain versions, then timed")
    card_state("phase 10 (f)")
    errs, fold_errs = {}, {}
    for c in NARROW_TIER_WIDTHS:
        gen = torch.Generator().manual_seed(c)
        m = GastNet(GastNetConfig(filter_widths=(3, 3), channels=c))
        m = randomize_eval_statistics(init_gastnet(m, gen), gen).to(dev)
        x = torch.randn((NARROW_TIER_FRAMES * 17, c), generator=torch
                        .Generator(device=dev).manual_seed(c), device=dev)
        for form in ("v1", "fold") if c in K.NARROW_FOLD_WIDTHS else ("v1",):
            t = gab_tables(m.eval().layers_graph_conv[0], m.statics, form)
            for io, xi, outs in (
                    ("float32", x, (torch.float32,)),
                    ("bf16", x.to(torch.bfloat16),
                     (torch.float32, torch.bfloat16))):
                noise = float((K.gab_narrow(xi, t, torch.float32)
                               - K.gab_narrow_plain(xi, t, torch.float32))
                              .pow(2).mean().sqrt())
                for out in outs if form == "fold" else ():
                    key = f"C={c} {io} -> {str(out)[6:]} float32"
                    before = K.VARIANT_LAUNCHES["gab_narrow"]["fold"]
                    fold_errs[key] = check_out(
                        f"gab_narrow fold {key}", K.gab_narrow(xi, t, out),
                        K.gab_narrow_plain(xi, t, out))
                    if K.VARIANT_LAUNCHES["gab_narrow"]["fold"] != before + 1:
                        fail(f"gab_narrow fold {key}: no fold launch")
                for tier in NARROW_TIERS:
                    for out in outs:
                        key = f"C={c} {io} -> {str(out)[6:]} {tier}"
                        (fold_errs if form == "fold" else errs)[key] = \
                            narrow_tier_check(
                                K, f"gab_narrow {form} {key}", xi, t,
                                narrow_tier_dict(tier), noise, out)
            del t
        del m, x
    gen = torch.Generator().manual_seed(243)
    m = GastNet(tier_configs(243)["highest"])
    m = randomize_eval_statistics(init_gastnet(m, gen), gen).to(dev).eval()
    t = gab_tables(m.layers_graph_conv[0], m.statics)
    c, k, inter, g_ch, j, d = K.gab_shape(t)
    rows = 256 * 241 * j
    x = torch.randn((rows, c), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    f32_ms = cuda_ms(lambda: K.gab_narrow(x, t))
    timed = {}
    for tier in NARROW_TIERS:
        tiers = narrow_tier_dict(tier)
        ms = cuda_ms(lambda: K.gab_narrow(x, t, tiers=tiers))
        chain_ms = cuda_ms(lambda: K.gab_chain(
            x, t, K.gemm_epilogue, K.sem_graph, K.joint_attention, tiers))
        plain_ms = cuda_ms(lambda: K.gab_narrow_plain(x, t, tiers=tiers),
                           reps=2, warmup=1)
        bms, by = narrow_bound(rows, c, j, k, inter, g_ch, d, tiers)
        timed[tier] = {"ms": ms, "tiered_chain_ms": chain_ms,
                       "plain_ms": plain_ms, "bound_ms": bms,
                       "bound_by": by, "float32_ms": f32_ms}
        print(f"  gab_narrow {tier} C=32 T=241 B=256: {ms:.3f} ms (bound "
              f"{bms:.3f} by {by}; the chain at these tiers {chain_ms:.3f};"
              f" float32 gab_narrow {f32_ms:.3f}; plain {plain_ms:.3f})")
    # The fold form at the same GAB (the 243f preset folds GAB 0), in
    # float32 and at each tier, beside the fold chain and the v1 kernel.
    tf = gab_tables(m.layers_graph_conv[0], m.statics, "fold")
    fold_timed = {}
    for tier in ("float32",) + NARROW_TIERS:
        tiers = None if tier == "float32" else narrow_tier_dict(tier)
        ms = cuda_ms(lambda: K.gab_narrow(x, tf, tiers=tiers))
        chain_ms = cuda_ms(lambda: K.gab_chain(
            x, tf, K.gemm_epilogue, K.sem_graph, K.joint_attention, tiers))
        plain_ms = cuda_ms(lambda: K.gab_narrow_plain(x, tf, tiers=tiers),
                           reps=2, warmup=1)
        bms, by = (bound(*gab_work(rows, c, j, k, 1, g_ch, d))
                   if tiers is None else
                   narrow_bound(rows, c, j, k, 1, g_ch, d, tiers, fold=True))
        v1_ms = f32_ms if tiers is None else timed[tier]["ms"]
        fold_timed[tier] = {"ms": ms, "fold_chain_ms": chain_ms,
                            "plain_ms": plain_ms, "bound_ms": bms,
                            "bound_by": by, "v1_gab_narrow_ms": v1_ms}
        print(f"  gab_narrow fold {tier} C=32 T=241 B=256: {ms:.3f} ms "
              f"(bound {bms:.3f} by {by}; the fold chain {chain_ms:.3f}; v1 "
              f"gab_narrow {v1_ms:.3f}; plain {plain_ms:.3f})")
    del m, t, tf, x
    torch.cuda.empty_cache()
    return {"errs": errs, "timed": timed, "fold_errs": fold_errs,
            "fold_timed": fold_timed}


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


def synthetic_layout(fmt: str, frames: int, seed: int):
    """(1, T, J, 2) keypoints of ``fmt``'s layout, rearranged from
    ``synthetic_coco``'s person: MPII-16; OpenPose-18 (COCO with the neck
    at index 1); COCO-WholeBody-133 with the six foot points beside the
    ankles (hands and face left at zero)."""
    import numpy as np

    coco = synthetic_coco(frames, seed)[0]

    def mid(a, b):
        return 0.5 * (coco[:, a] + coco[:, b])

    if fmt == "openpose":
        out = np.concatenate([coco[:, :1], mid(5, 6)[:, None], coco[:, 1:]],
                             axis=1)
    elif fmt == "mpii":
        up = coco[:, 0] - mid(5, 6)
        out = np.stack([coco[:, 16], coco[:, 14], coco[:, 12], coco[:, 11],
                        coco[:, 13], coco[:, 15], mid(11, 12), mid(5, 6),
                        mid(5, 6) + 0.5 * up, coco[:, 0] + 0.5 * up,
                        coco[:, 10], coco[:, 8], coco[:, 6], coco[:, 5],
                        coco[:, 7], coco[:, 9]], axis=1)
    else:  # wholebody
        out = np.zeros((frames, 133, 2), np.float32)
        out[:, :17] = coco
        feet = np.array([[10, 15], [20, 12], [-5, 5]], np.float32)
        out[:, 17:20] = coco[:, 15:16] + feet
        out[:, 20:23] = coco[:, 16:17] + feet * [-1, 1]
    return out[None].astype(np.float32)


# --------------------------------------------------------------------------
# Phase 11: the in-the-wild pipeline (YOLOv3 -> SORT -> HRNet -> lifting).
# --------------------------------------------------------------------------
# The clip: PIPE_FRAMES synthetic 1280x720 BGR frames, one bright figure
# moving across the first half, two the second (seeded numpy, no file).
PIPE_FRAMES, PIPE_W, PIPE_H = 256, 1280, 720
# gen_skes requests: (-np, --det-batch).
PIPE_RUNS = ((1, 1), (1, 16), (2, 1), (2, 16))
# The profiled request: -np 2 --det-batch 16 over the clip's first frames.
PIPE_PROFILE_FRAMES = 32
# Frames held against the port's CPU path (YOLO output, heatmaps, boxes).
PIPE_CPU_FRAMES = 4
# realtime: the per-frame latency over RT_FRAMES frames after RT_WARMUP,
# the clip delivered at RT_FPS frames a second, as a camera delivers it
# (an unpaced file lets the pipelined loop's reader run ahead, and its
# frames then wait in the stage queues).
RT_WARMUP, RT_FRAMES, RT_FPS = 10, 200, 30.0
# Random weights from seeds: YOLOv3 at 416 (darknet file written here)
# and HRNet-W48 at 384x288 (the port module's state dict).
YOLO_SEED, HRNET_SEED = 31, 32
# write_pipeline_weights: the clip's frames YOLO's figure probe is fitted
# on, the gain of its objectness logit (logits a probe unit), and the
# margin of the person class over the others.
YOLO_PROBE_FRAMES = tuple(range(0, PIPE_FRAMES, 32)) + (PIPE_FRAMES // 2,)
YOLO_PROBE_GAIN, YOLO_PERSON_MARGIN = 8.0, 2.0
PIPE_STAGES = ("gastx_torch.letterbox", "gastx_torch.yolo",
               "gastx_torch.crops", "gastx_torch.hrnet", "gastx_torch.lift")


def figure_boxes(t: int) -> list:
    """The (x1, y1, x2, y2) pixel boxes of ``clip_frames``' figures in
    frame ``t``."""
    boxes = [(100 + 3 * t, 150, 180 + 3 * t, 630)]
    if t >= PIPE_FRAMES // 2:
        x = 1100 - 2 * (t - PIPE_FRAMES // 2)
        boxes.append((x, 180, x + 80, 660))
    return boxes


def clip_frames(n: int = PIPE_FRAMES, seed: int = 0):
    """Yield the clip's first ``n`` (PIPE_H, PIPE_W, 3) uint8 BGR frames: a
    fixed noisy background and bright figures (head, torso, legs) moving
    sideways, at ``figure_boxes``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    background = rng.integers(0, 90, (PIPE_H, PIPE_W, 3), dtype=np.uint8)
    colors = ((230, 220, 210), (60, 200, 240))
    for t in range(n):
        img = background.copy()
        for (x, y, _, _), color in zip(figure_boxes(t), colors):
            img[y:y + 60, x + 20:x + 60] = color                 # head
            img[y + 70:y + 300, x:x + 80] = color                # torso
            img[y + 300:y + 480, x + 5:x + 30] = color           # legs
            img[y + 300:y + 480, x + 50:x + 75] = color
        yield img


def paced(frames, fps: float):
    """Yield ``frames`` no faster than ``fps`` a second."""
    t0 = time.perf_counter()
    for i, frame in enumerate(frames):
        wait = t0 + i / fps - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        yield frame


def yolo_arrays(blocks, seed: int) -> list:
    """Random darknet weights for ``blocks``, per conv layer in file
    order: BN layers (bias, scale, mean, var) near identity, conv weights
    of std 1/sqrt(fan in), so activations stay finite at full depth."""
    import numpy as np

    from gastx_torch.pipeline.yolo.model import _infer_channels

    rng = np.random.default_rng(seed)
    chans = _infer_channels(blocks, int(blocks[0].get("channels", 3)))
    layers = []
    for i, b in enumerate(blocks[1:]):
        if b["type"] != "convolutional":
            continue
        f, k = int(b["filters"]), int(b["size"])
        fan_in = chans[i] * k * k
        entry = {"w": (rng.standard_normal(f * fan_in)
                       / np.sqrt(fan_in)).astype(np.float32)}
        if int(b.get("batch_normalize", 0)):
            entry["bn"] = np.concatenate([
                0.1 * rng.standard_normal(f), 1 + 0.1 * rng.standard_normal(f),
                0.1 * rng.standard_normal(f),
                rng.uniform(0.5, 1.5, f)]).astype(np.float32)
        else:
            entry["bias"] = np.zeros(f, np.float32)
        layers.append(entry)
    return layers


def write_darknet(path: str, layers: list) -> None:
    import numpy as np

    with open(path, "wb") as fh:
        np.zeros(5, np.int32).tofile(fh)
        for e in layers:
            (e["bn"] if "bn" in e else e["bias"]).tofile(fh)
            e["w"].tofile(fh)


def write_pipeline_weights(dev) -> tuple:
    """The YOLOv3 ``.weights`` and the HRNet-W48 ``.pth``, under WORK_DIR.

    YOLO's weights are random but for its heads' last convolution. There
    each head's logits are scaled to unit spread on the clip, and the
    13x13 head is made to find the figures: its objectness is a ridge
    probe of its input features over YOLO_PROBE_FRAMES of the clip (1 on
    the cells whose centre lies on a figure, 0 elsewhere), passing 0.70
    halfway between the probe's largest value off the figures and its
    first quartile on them; its box offsets are 0 and its sizes the
    figures' (80x480 pixels), so that NMS keeps one box a figure. The finer
    heads' objectness stays below 0.70, and every anchor's person class is
    put YOLO_PERSON_MARGIN above the other classes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from gastx_torch.pipeline.hrnet import PoseHighResolutionNet, hrnet_extra
    from gastx_torch.pipeline.yolo import prep_frame, yolov3_blocks
    from gastx_torch.pipeline.yolo.detect import YoloHumanDetector

    blocks = yolov3_blocks()
    layers = yolo_arrays(blocks, YOLO_SEED)
    heads = [e for e in layers if "bias" in e]
    yolo_path = os.path.join(WORK_DIR, "yolov3.weights")
    write_darknet(yolo_path, layers)
    det = YoloHumanDetector(yolo_path, device=dev)
    feats, conv2d = [[], [], []], F.conv2d

    def spy(x, w, *args, **kw):  # the heads' input features
        if w.shape[0] == 255:
            k = sum(map(len, feats)) % 3
            feats[k].append(x[0].double().flatten(1).cpu().numpy())
        return conv2d(x, w, *args, **kw)

    frames = {t: f for t, f in enumerate(clip_frames())
              if t in YOLO_PROBE_FRAMES}
    F.conv2d = spy
    try:
        with torch.no_grad():
            for t in YOLO_PROBE_FRAMES:
                det.model(prep_frame(torch.from_numpy(frames[t]).to(dev),
                                     416))
    finally:
        F.conv2d = conv2d
    del det, frames
    threshold = math.log(0.7 / 0.3)  # the objectness logit of 0.70
    scale = min(416 / PIPE_W, 416 / PIPE_H)
    y0 = (416 - int(PIPE_H * scale)) // 2
    x0 = (416 - int(PIPE_W * scale)) // 2
    anchors = np.array([int(v) for v in blocks[-1]["anchors"].split(",")],
                       np.float64).reshape(9, 2)
    for e, phi, g, mask in zip(heads, feats, (13, 26, 52),
                               ((6, 7, 8), (3, 4, 5), (0, 1, 2))):
        phi = np.concatenate(phi, axis=1)                 # (C, frames * g*g)
        if not np.isfinite(phi).all():
            fail(f"YOLO's {g}x{g} head input is not finite")
        w = e["w"].reshape(255, -1)
        logit = w.astype(np.float64) @ phi
        w /= np.float32(logit.std())                       # unit spread
        logit /= logit.std()
        bias = e["bias"].reshape(3, 85)
        for a in range(3):
            bias[a, 5] = YOLO_PERSON_MARGIN + float(np.max(
                logit[a * 85 + 6:(a + 1) * 85].max(axis=0)
                - logit[a * 85 + 5]))
            bias[a, 4] = -30.0
        if g != 13:
            continue
        centre = (np.arange(g) + 0.5) * (416 / g)
        cy = ((centre[:, None] - y0) / scale).repeat(g, 1).reshape(-1)
        cx = ((centre[None] - x0) / scale).repeat(g, 0).reshape(-1)
        target = np.concatenate([
            np.any([(cx >= x1) & (cx < x2) & (cy >= y1) & (cy < y2)
                    for x1, y1, x2, y2 in figure_boxes(t)], axis=0)
            for t in YOLO_PROBE_FRAMES]).astype(np.float64)
        mean = phi.mean(1, keepdims=True)
        xc = phi - mean
        gram = xc @ xc.T
        ridge = 1e-4 * np.trace(gram) / len(gram)
        beta = np.linalg.solve(gram + ridge * np.eye(len(gram)),
                               xc @ (target - target.mean()))
        fit = beta @ xc + target.mean()
        on, off = fit[target > 0], fit[target == 0]
        level = 0.5 * (np.percentile(on, 25) + off.max())
        print(f"  YOLO probe: {int(target.sum())} figure cells of "
              f"{target.size}, the fit {np.percentile(on, 25):.3f} at the "
              f"figures' first quartile, {off.max():.3f} at most elsewhere; "
              f"0.70 at {level:.3f}")
        for a, (aw, ah) in enumerate(anchors[list(mask)]):
            w[a * 85:a * 85 + 4] = 0.0                     # x, y, w, h
            bias[a, :2] = 0.0
            bias[a, 2] = math.log(80 * scale / aw)
            bias[a, 3] = math.log(480 * scale / ah)
            w[a * 85 + 4] = (YOLO_PROBE_GAIN * beta).astype(np.float32)
            bias[a, 4] = threshold + YOLO_PROBE_GAIN * (
                target.mean() - float(beta @ mean[:, 0]) - level)
    write_darknet(yolo_path, layers)

    torch.manual_seed(HRNET_SEED)
    hrnet = PoseHighResolutionNet(hrnet_extra(48))
    gen = torch.Generator().manual_seed(HRNET_SEED)
    with torch.no_grad():
        for m in hrnet.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    hrnet_path = os.path.join(WORK_DIR, "pose_hrnet_w48_384x288.pth")
    torch.save(hrnet.state_dict(), hrnet_path)
    return yolo_path, hrnet_path


def pipeline_args(np_: int, det_batch: int, dev):
    from gastx_torch.cli import gen_skes

    return gen_skes.parse_args([
        "-v", "clip.mp4", "-np", str(np_), "--det-batch", str(det_batch),
        "--random-lifter-weights", "-f", "27", "--device", str(dev)])


def stage_profile(fn, title: str) -> dict:
    """One torch.profiler trace of ``fn``: device ms under each pipeline
    stage's ``record_function`` range (the kernels launched inside it),
    the device's busy ms and idle share of the call's CUDA-event time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(title)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    stages = {key: {"device_ms": 0.0, "calls": 0} for key in PIPE_STAGES}

    def kernel_us(ev):  # the kernels launched under a host-side event
        return (sum(k.duration for k in ev.kernels
                    if k.name not in stages)  # not the range's GPU mirror
                + sum(kernel_us(c) for c in ev.cpu_children))

    for ev in prof.events():
        if ev.name in stages and ev.device_type == DeviceType.CPU:
            stages[ev.name]["device_ms"] += kernel_us(ev) / 1e3
            stages[ev.name]["calls"] += 1
    busy, ops = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.key not in stages:
            busy += ev.self_device_time_total / 1e3
            ops += ev.count
    if busy == 0:
        print("  no device time recorded: not measured")
        return {"wall_ms": wall_ms, "device_busy_ms": None}
    for key in PIPE_STAGES:
        s = stages[key]
        print(f"  {key}: {s['device_ms']:.3f} ms device ({s['calls']} "
              f"calls)")
    attributed = sum(s["device_ms"] for s in stages.values())
    idle = max(0.0, 1.0 - busy / wall_ms)
    print(f"  device busy {busy:.3f} of {wall_ms:.3f} ms: idle share "
          f"{idle:.4f}; {ops} device operations; {busy - attributed:.3f} "
          f"ms outside the stages")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": idle,
            "device_operations": ops, "stages": stages}


def pipeline_against_cpu(yolo_path, hrnet_path, est, dev) -> dict:
    """The card's YOLO output and HRNet heatmaps on the clip's first
    frames against the port's CPU path on the same frames, and the boxes
    and tracks of both (a fresh tracker each)."""
    import numpy as np
    import torch

    from gastx_torch.pipeline.sort import Sort
    from gastx_torch.pipeline.video_pose2d import Pose2DEstimator
    from gastx_torch.pipeline.yolo import letterbox_image
    from gastx_torch.pipeline.yolo.detect import canvas_input

    cpu = Pose2DEstimator(yolo_path, hrnet_path, device="cpu")
    frames = list(clip_frames(PIPE_CPU_FRAMES))
    out = {"yolo_max_abs_err": 0.0, "heatmap_max_abs_err": 0.0,
           "frames": PIPE_CPU_FRAMES}
    est.tracker, cpu.tracker = Sort(), Sort()
    for i, frame in enumerate(frames):
        with torch.no_grad():
            raws = [e.detector.model(canvas_input(letterbox_image(
                e.detector.to_device(frame)[None], 416)))
                for e in (est, cpu)]
        out["yolo_max_abs_err"] = max(out["yolo_max_abs_err"], check(
            f"frame {i}: YOLO output, card against CPU",
            raws[0].cpu(), raws[1]))
        # A box may move by YOLO's bound (in frame pixels) and one step of
        # the 2-decimal rounding.
        box_tol = (TOL * max(1.0, float(raws[1].abs().max()))
                   / min(416 / PIPE_W, 416 / PIPE_H) + 0.01)
        crops = []
        for e in (est, cpu):
            bboxs, scores = e.detector.detect(frame)
            crops.append((bboxs, e.crops_from_detections(
                e.detector.to_device(frame), bboxs, scores, 2, True)))
        (bg, cg), (bc, cc) = crops
        if (bg is None) != (bc is None) or (cg is None) != (cc is None):
            fail(f"frame {i}: detections or tracks differ (card "
                 f"{bg is not None}/{cg is not None}, CPU {bc is not None}"
                 f"/{cc is not None})")
        if bg is None or cg is None:
            continue
        if bg.shape != bc.shape or np.abs(bg - bc).max() > box_tol:
            fail(f"frame {i}: boxes differ: {bg.shape} vs {bc.shape}, "
                 f"max|d| {np.abs(bg - bc).max() if bg.shape == bc.shape else None}"
                 f" (bound {box_tol})")
        if (cg[0].shape != cc[0].shape or np.abs(
                np.asarray(cg[1]) - np.asarray(cc[1])).max() > box_tol):
            fail(f"frame {i}: the tracks differ")
        out["box_max_abs_err"] = max(out.get("box_max_abs_err", 0.0),
                                     float(np.abs(bg - bc).max()))
        hm = [e.heatmaps(c[0]) for e, c in ((est, cg), (cpu, cc))]
        out["heatmap_max_abs_err"] = max(out["heatmap_max_abs_err"], check(
            f"frame {i}: HRNet heatmaps ({len(bg)} boxes, "
            f"{cg[0].shape[0]} tracked), card against CPU",
            torch.from_numpy(hm[0]), torch.from_numpy(hm[1])))
    est.tracker = Sort()
    return out


def pipeline_phase(K, dev, smi) -> dict:
    """Phase 11: gen_skes and realtime at full width through their frame
    functions; the launch counters zeroed just before each and read just
    after; see the module docstring."""
    import numpy as np
    import torch
    from torch.nn.modules.module import register_module_forward_hook

    from gastx_torch.cli import gen_skes, realtime
    from gastx_torch.models import GastNet
    from gastx_torch.pipeline import video_pose2d as vp
    from gastx_torch.pipeline.sort import Sort

    report = {}
    t0 = time.time()
    yolo_path, hrnet_path = write_pipeline_weights(dev)
    est = vp.Pose2DEstimator(yolo_path, hrnet_path, device=dev)
    report["setup_s"] = time.time() - t0
    print(f"  weights written and loaded in {report['setup_s']:.1f} s")
    report["against_cpu"] = pipeline_against_cpu(yolo_path, hrnet_path,
                                                  est, dev)

    inner = vp.kpts_from_frames
    t2d = []

    def timed_2d(*a, **kw):
        t = time.time()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        t2d.append(time.time() - t)
        return out

    forwards = []

    def record(module, inputs, output):
        if isinstance(module, GastNet):
            forwards.append((module, inputs[0], output))

    vp.kpts_from_frames = timed_2d
    try:
        # Warm-up: cuDNN's choices and the allocator at both batch sizes.
        for np_, db in ((2, 1), (2, 16)):
            est.tracker = Sort()
            gen_skes.skeletons_from_frames(pipeline_args(np_, db, dev),
                                           clip_frames(16), PIPE_W, PIPE_H,
                                           est)
        hook = register_module_forward_hook(record)
        K.reset_launches()
        runs = []
        for np_, db in PIPE_RUNS:
            est.tracker = Sort()
            t = time.time()
            pred, re_kpts = gen_skes.skeletons_from_frames(
                pipeline_args(np_, db, dev), clip_frames(), PIPE_W, PIPE_H,
                est)
            torch.cuda.synchronize()
            dt = time.time() - t
            if (pred.ndim != 4 or pred.shape[0] < 1 or pred.shape[2:]
                    != (17, 3) or not np.isfinite(pred).all()):
                fail(f"gen_skes -np {np_} --det-batch {db}: bad output "
                     f"{pred.shape}")
            runs.append({"num_person": np_, "det_batch": db, "s": dt,
                         "s_2d": t2d[-1], "persons": int(pred.shape[0]),
                         "frames_out": int(pred.shape[1]),
                         "frames_2d_per_s": PIPE_FRAMES / t2d[-1]})
            print(f"  gen_skes -np {np_} --det-batch {db}: {dt:.3f} s a "
                  f"request, 2D {PIPE_FRAMES / t2d[-1]:.1f} frames/s; "
                  f"{pred.shape[0]} person(s) over {pred.shape[1]} frames")
        hook.remove()
        report["gen_skes_launches"] = launches = launch_counts(K)
        report["gen_skes"] = runs
        print(f"  launches over the {len(PIPE_RUNS)} requests: "
              f"{ {k: v for k, v in launches.items() if v} }")
        errs = [check(f"lift forward {tuple(x.shape)} against the plain "
                      f"route", y, m.reference_forward(x))
                for m, x, y in forwards]
        if len(forwards) < len(PIPE_RUNS):
            fail(f"{len(forwards)} lift forwards for {len(PIPE_RUNS)} "
                 f"requests")
        report["lift_max_abs_err"] = max(errs)
        del forwards[:]
        est.tracker = Sort()
        report["profile"] = stage_profile(
            lambda: gen_skes.skeletons_from_frames(
                pipeline_args(2, 16, dev), clip_frames(PIPE_PROFILE_FRAMES),
                PIPE_W, PIPE_H, est),
            f"phase 11: torch.profiler trace of one gen_skes -np 2 "
            f"--det-batch 16 request of {PIPE_PROFILE_FRAMES} frames")
    finally:
        vp.kpts_from_frames = inner

    # (b) realtime: causal 27f, M = 1, both loops over the same frames.
    report["realtime"] = {}
    poses = {}
    K.reset_launches()
    for label, extra in (("--no-pipeline", ["--no-pipeline"]),
                         ("pipelined", [])):
        est.tracker = Sort()
        args = realtime.parse_args(["-v", "clip.mp4", "-f", "27",
                                    "--random-lifter-weights", "--device",
                                    str(dev), *extra])
        t = time.time()
        got, lat = realtime.run_frames(
            args, paced(clip_frames(RT_WARMUP + RT_FRAMES), RT_FPS), PIPE_W,
            PIPE_H, est)
        fps = (RT_WARMUP + RT_FRAMES) / (time.time() - t)
        if len(lat) < RT_WARMUP + RT_FRAMES // 2:
            fail(f"realtime {label}: {len(lat)} frames with a pose")
        ms = 1e3 * lat[RT_WARMUP:]
        report["realtime"][label] = {
            "frames": int(len(ms)), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "mean_ms": float(ms.mean()), "frames_per_s": fps}
        poses[label] = got
        print(f"  realtime {label}: per-frame latency p50 "
              f"{np.percentile(ms, 50):.3f} ms, p99 "
              f"{np.percentile(ms, 99):.3f} ms over {len(ms)} frames "
              f"delivered at {RT_FPS:g} frames/s; {fps:.1f} frames/s")
    report["realtime_launches"] = rt_launches = launch_counts(K)
    if not np.array_equal(poses["--no-pipeline"], poses["pipelined"]):
        fail("realtime: the pipelined loop's poses differ from the "
             "sequential loop's")
    if not np.isfinite(poses["pipelined"]).all():
        fail("realtime: non-finite poses")
    print(f"  the two loops' {poses['pipelined'].shape} poses are equal; "
          f"launches {({k: v for k, v in rt_launches.items() if v})} on "
          f"{smi}")
    est.tracker = Sort()
    return report


# --------------------------------------------------------------------------
# Phase 12: data parallelism (gastx_torch.parallel), the profiling
# utilities, the example, the entry and the ablations
# --------------------------------------------------------------------------

# (a) the DDP step on one NCCL rank against the step without DDP, at
# these batches of 27f windows; (b) two ranks sharing the card over gloo:
# the global batch (DP_PAIR_BATCH // 2 a rank), two steps, then
# DP_TIMED_STEPS timed after their warm-up; the ragged step's real rows
# (fewer than a rank's half: rank 1 holds only filler rows).
DP_BATCHES = (128, 1024)
# (a) the tiered DDP step's batch of windows.
DP_TIER_BATCH = 128
DP_PAIR_BATCH = 1024
DP_RAGGED_ROWS = 300
DP_TIMED_STEPS = 5
DP_ALLREDUCE_REPS = 5
DP_RANK_TIMEOUT = 300
# (d) trainval under torch.distributed.run on phase 9 (d)'s data: one
# epoch (later flags win over TRAINVAL_ARGS'), every 8th frame.
DP_TRAINVAL_ARGS = ("-e", "1", "--downsample", "8")
DP_TRAINVAL_TIMEOUT = 300
# (e) the example at its defaults; its gate is its own (exit 1 under 3x).
EXAMPLE_ARGS = ("--steps", "300", "-arc", "3,3", "-ch", "32")


def dp_batch(batch: int, seed: int, real: int = 0):
    """Numpy (x2d (B, 27, 17, 2), x3d (B, 1, 17, 3), w (B,)): unit weights,
    or ``real`` real rows and zero-weight copies of the last after them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x2 = rng.standard_normal((batch, 27, 17, 2)).astype(np.float32)
    x3 = (0.3 * rng.standard_normal((batch, 1, 17, 3))).astype(np.float32)
    w = np.ones(batch, np.float32)
    if real:
        x2[real:], x3[real:], w[real:] = x2[real - 1], x3[real - 1], 0.0
    return x2, x3, w


def dp_config():
    import dataclasses

    from gastx_torch.models import config_for_frames

    return dataclasses.replace(config_for_frames(27), dropout=TRAIN_DROPOUT)


def step_state(model, loss) -> dict:
    """A copy on the host of a step's loss, gradients, parameters and BN
    statistics."""
    def host(t):
        return t.detach().to("cpu", copy=True)

    return {"loss": {"loss": host(loss).reshape(1)},
            "grads": {n: host(p.grad) for n, p in model.named_parameters()},
            "params": {n: host(p) for n, p in model.named_parameters()},
            "bn_stats": {n: host(b) for n, b in model.named_buffers()
                         if "running" in n}}


def worst_by_kind(got: dict, want: dict) -> dict:
    """Per kind (loss, grads, ...): the largest |got - want| over its bound
    TOL * max(1, max|want|) per tensor, the difference, the tensor."""
    out = {}
    for kind in want:
        ratios = []
        for n, t in want[kind].items():
            t = t.double()
            d = float((got[kind][n].double() - t).abs().max())
            ratios.append((d / (TOL * max(1.0, float(t.abs().max()))), d,
                           n))
        r = max(ratios)
        out[kind] = {"err_over_bound": r[0], "max_abs_err": r[1],
                     "tensor": r[2]}
    return out


def ddp_one_rank(rank: int, n: int, address: str) -> dict:
    """Phase 12 (a), in a spawned rank: on NCCL, one rank, the DDP strided
    step (dropout 0.05) against the same step without DDP at each of
    DP_BATCHES; the loss and every gradient. Then the same at the tiers
    (``TRAIN_TIER_NAMES``, B=DP_TIER_BATCH): the loss, every gradient,
    every parameter after amsgrad and the BN statistics, which must be the
    one-process tiered step's bit for bit."""
    import copy

    import torch

    from gastx_torch.models import build_gastnet
    from gastx_torch.parallel import (init_distributed, make_mesh,
                                      replicate, shard_batch)
    from gastx_torch.train import make_optimizer, train_step

    backend = init_distributed(address, n, rank)
    mesh = make_mesh()
    out = {"backend": backend}
    for b in DP_BATCHES:
        plain = build_gastnet(dp_config(), seed=27, device=mesh.device)
        wrapped = copy.deepcopy(plain)
        ddp = replicate(mesh, wrapped)
        arrays = dp_batch(b, seed=b)
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(b)
        loss = train_step(plain, make_optimizer(plain.parameters()),
                          *(torch.from_numpy(a).to(mesh.device)
                            for a in arrays), TRAIN_LR, gen, "strided")
        gen.manual_seed(b)
        (x2, x3, w), _ = shard_batch(mesh, *arrays)
        dp_loss = train_step(ddp, make_optimizer(ddp.parameters()), x2, x3,
                             w, TRAIN_LR, gen, "strided", mesh=mesh,
                             weight_sum=float(arrays[2].sum()))
        cmp = worst_by_kind(step_state(wrapped, dp_loss),
                            step_state(plain, loss))
        out[f"B={b}"] = {k: cmp[k] for k in ("loss", "grads")}
        del plain, wrapped, ddp
        torch.cuda.empty_cache()
    arrays = dp_batch(DP_TIER_BATCH, seed=DP_TIER_BATCH)
    for name in TRAIN_TIER_NAMES:
        plain = build_gastnet(train_tier_cfg(27, name), seed=27,
                              device=mesh.device)
        wrapped = copy.deepcopy(plain)
        ddp = replicate(mesh, wrapped)
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(DP_TIER_BATCH)
        loss = train_step(plain, make_optimizer(plain.parameters()),
                          *(torch.from_numpy(a).to(mesh.device)
                            for a in arrays), TRAIN_LR, gen, "strided")
        gen.manual_seed(DP_TIER_BATCH)
        (x2, x3, w), _ = shard_batch(mesh, *arrays)
        dp_loss = train_step(ddp, make_optimizer(ddp.parameters()), x2, x3,
                             w, TRAIN_LR, gen, "strided", mesh=mesh,
                             weight_sum=float(arrays[2].sum()))
        got, want = step_state(wrapped, dp_loss), step_state(plain, loss)
        out[f"tiered {name}"] = {
            "bitwise": all(torch.equal(got[k][n], t)
                           for k in want for n, t in want[k].items()),
            **worst_by_kind(got, want)}
        del plain, wrapped, ddp
        torch.cuda.empty_cache()
    return out


def dp_pair_rank(rank: int, n: int, address: str, seqs: list) -> dict:
    """Phase 12 (b) and (c), in each of two spawned ranks sharing the card
    over gloo. (b) Two DP strided steps on DP_PAIR_BATCH windows against
    rank 0's one-process steps on the same batch, in float32 and float64;
    a ragged step; ms a step of each (DP_TIMED_STEPS after the two), and
    the all-reduce of the gradients' bytes alone under a trace() range.
    (c) ``lift_sequences(mesh=)`` with flip TTA on ``seqs``, rank 0's
    under torch.profiler and the launch counters, against rank 0's
    one-process lift. Rank 0 returns the comparisons and numbers."""
    import copy

    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gastx_torch.infer import lift_sequences
    from gastx_torch.models import (GastNet, build_gastnet,
                                    config_for_frames, init_gastnet,
                                    randomize_eval_statistics)
    from gastx_torch.ops.cuda import kernels as K
    from gastx_torch.parallel import (init_distributed, make_mesh,
                                      replicate, shard_batch)
    from gastx_torch.train import make_optimizer, train_step
    from gastx_torch.utils import trace

    backend = init_distributed(address, n, rank)
    mesh = make_mesh()
    dev = mesh.device
    out = {"backend": backend}
    main_rank = rank == 0

    def steps(model, arrays, mesh_, count, seed):
        """``count`` steps; the last step's state (rank 0), the losses."""
        ddp = model if mesh_ is None else replicate(mesh_, model)
        opt = make_optimizer(ddp.parameters())
        if mesh_ is None:
            tensors = [torch.from_numpy(a).to(dev) for a in arrays]
        else:
            tensors, _ = shard_batch(mesh_, *arrays)
        gen = torch.Generator(device=dev)
        states = []
        for i in range(count):
            gen.manual_seed(seed + i)
            loss = train_step(ddp, opt, *tensors, TRAIN_LR, gen, "strided",
                              mesh=mesh_, weight_sum=float(arrays[2].sum()))
            if main_rank:
                states.append(step_state(model, loss))
        return states, (ddp, opt, tensors, gen)

    # (b) the steps, in float32 and float64: DP first, then rank 0 alone
    # while rank 1 waits at the barrier.
    for dtype in (torch.float32, torch.float64):
        arrays = [a.astype(str(dtype).split(".")[1])
                  for a in dp_batch(DP_PAIR_BATCH, seed=31)]
        base = build_gastnet(dp_config(), seed=27, device=dev).to(dtype)
        dp_states, _ = steps(copy.deepcopy(base), arrays, mesh, 2, 40)
        dist.barrier()
        if main_rank:
            one_states, _ = steps(base, arrays, None, 2, 40)
            out[str(dtype)] = [worst_by_kind(a, b)
                               for a, b in zip(dp_states, one_states)]
        dist.barrier()
        del base, dp_states
        torch.cuda.empty_cache()

    # The ragged step: rank 1's rows are all filler.
    arrays = dp_batch(DP_PAIR_BATCH, seed=32, real=DP_RAGGED_ROWS)
    base = build_gastnet(dp_config(), seed=27, device=dev)
    dp_states, _ = steps(copy.deepcopy(base), arrays, mesh, 1, 50)
    dist.barrier()
    if main_rank:
        one_states, _ = steps(base, arrays, None, 1, 50)
        out["ragged"] = worst_by_kind(dp_states[0], one_states[0])
    dist.barrier()

    # ms a step: DP (both ranks on the card), then rank 0 alone.
    def step_ms(mesh_):
        _, (ddp, opt, tensors, gen) = steps(
            build_gastnet(dp_config(), seed=27, device=dev),
            dp_batch(DP_PAIR_BATCH, seed=33), mesh_, 2, 60)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(DP_TIMED_STEPS):
            train_step(ddp, opt, *tensors, TRAIN_LR, gen, "strided",
                       mesh=mesh_, weight_sum=float(DP_PAIR_BATCH))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / DP_TIMED_STEPS, ddp

    dist.barrier()
    out["dp_step_ms"], ddp = step_ms(mesh)
    flat = torch.zeros(sum(p.numel() for p in ddp.parameters()),
                       device=dev)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace("gastx_torch.grad_allreduce"):
        for _ in range(DP_ALLREDUCE_REPS):
            dist.all_reduce(flat)
    torch.cuda.synchronize()
    out["allreduce_ms"] = (time.perf_counter() - t0) * 1e3 / DP_ALLREDUCE_REPS
    out["grad_bytes"] = flat.numel() * 4
    del ddp, flat
    dist.barrier()
    if main_rank:
        out["one_process_step_ms"], _ = step_ms(None)
    dist.barrier()
    torch.cuda.empty_cache()

    # (c) the sharded lift on the 27f eval model of phases 2-4.
    gen = torch.Generator().manual_seed(0)
    model = randomize_eval_statistics(init_gastnet(
        GastNet(config_for_frames(27)), gen), gen).to(dev).eval()
    lift_sequences(model, seqs, tta=True, mesh=mesh)  # warm-up
    torch.cuda.synchronize()
    dist.barrier()
    K.reset_launches()
    t0 = time.perf_counter()
    if main_rank:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lifted = lift_sequences(model, seqs, tta=True, mesh=mesh)
            torch.cuda.synchronize()
    else:
        lifted = lift_sequences(model, seqs, tta=True, mesh=mesh)
    out["lift_s"] = time.perf_counter() - t0
    out["dp_launches"] = {k: v for k, v in launch_counts(K).items() if v}
    if main_rank:
        out["profiled_kernels"] = sorted(
            {ev.key for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA
             and ev.self_device_time_total > 0})
        alone = lift_sequences(model, seqs, tta=True)
        out["lift"] = [
            {"frames": a.shape[0], "max_abs_err": float(abs(a - b).max()),
             "bound": TOL * max(1.0, float(abs(b).max()))}
            for a, b in zip(lifted, alone)]
    dist.barrier()
    return out


def run_group(cmd, timeout: float, **kw):
    """``cmd`` in a session of its own (torch.distributed.run and its
    ranks); the whole group killed if it outlives ``timeout``. Returns the
    CompletedProcess."""
    import signal

    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True, **kw)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{' '.join(cmd[:6])} ... ran over {timeout} s")
    return subprocess.CompletedProcess(cmd, proc.returncode, stdout, stderr)


def dp_trainval(dev) -> dict:
    """Phase 12 (d): ``python -m torch.distributed.run --nproc_per_node 2
    -m gastx_torch.cli.trainval`` on phase 9 (d)'s data, one epoch with
    --profile-dir: the trace names train_step, rank 0 alone wrote the
    checkpoint, and a one-process --evaluate of it without TTA gives the
    valid MPJPE rank 0 logged (the action-wise mean of two actions of
    equal frames is the frame-weighted one)."""
    import re
    import shutil

    import numpy as np

    from gastx_torch.parallel.mesh import free_port

    root = os.path.join(WORK_DIR, "trainval")
    data_dir = os.path.join(root, "data")
    ckpt, prof = (os.path.join(root, d) for d in ("dp", "dp_profile"))
    log = os.path.join(root, "dp_log.jsonl")
    for path in (ckpt, prof, log):
        shutil.rmtree(path, ignore_errors=True)
        if os.path.isfile(path):
            os.remove(path)
    args = [*TRAINVAL_ARGS, *DP_TRAINVAL_ARGS, "--data-dir", data_dir,
            "--checkpoint", ckpt, "--log-file", log, "--profile-dir", prof]
    t0 = time.time()
    run = run_group([sys.executable, "-m", "torch.distributed.run",
                     "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
                     "--master_port", str(free_port()), "-m",
                     "gastx_torch.cli.trainval", *args],
                    DP_TRAINVAL_TIMEOUT, cwd=REPO,
                    env={**os.environ, "PYTHONPATH": REPO})
    wall_s = time.time() - t0
    if run.returncode != 0:
        fail(f"trainval under torch.distributed.run exited "
             f"{run.returncode}:\n{run.stdout[-2000:]}\n{run.stderr[-3000:]}")
    if "process group of 2 rank(s), 2 on this host, on gloo" not in run.stdout:
        fail("trainval's two ranks did not take gloo on the one card:\n"
             + run.stdout[-2000:])
    with open(log) as f:
        epochs = [json.loads(line) for line in f]
    if len(epochs) != 1:
        fail(f"{len(epochs)} epochs logged, not 1 by rank 0 alone")
    written = sorted(os.listdir(ckpt))
    if written != ["epoch_1.pt"]:
        fail(f"the checkpoint directory holds {written}, not rank 0's "
             f"epoch_1.pt alone")
    traces = [os.path.join(prof, f) for f in os.listdir(prof)
              if f.endswith(".pt.trace.json")]
    named = [t for t in traces if '"train_step"' in open(t).read()]
    if not named:
        fail(f"no trace under {prof} names train_step: {traces}")
    text = run_trainval([*TRAINVAL_ARGS, *DP_TRAINVAL_ARGS, "--data-dir",
                         data_dir, "--checkpoint", ckpt, "--evaluate",
                         "epoch_1.pt", "-no-tta"])
    p1 = [float(v) for v in re.findall(
        r"Protocol #1 Error \(MPJPE\): (\S+) mm", text)]
    logged = epochs[0]["valid_mpjpe_mm"]
    err = abs(float(np.mean(p1)) - logged)
    bound = TOL * max(1.0, abs(logged))
    print(f"  (d) trainval on 2 gloo ranks sharing the card: 1 epoch, "
          f"{epochs[0]['train_frames']:.0f} train frames in "
          f"{epochs[0]['train_s']:.2f} s ({wall_s:.1f} s with start-up and "
          f"evaluation); rank 0 logged valid MPJPE {logged:.4f} mm; a "
          f"one-process --evaluate of its checkpoint {np.mean(p1):.4f} mm "
          f"({len(p1)} actions, max|d| {err:.3e}, bound {bound:.3e}); "
          f"{len(traces)} traces, {len(named)} naming train_step")
    if len(p1) != 2 or not err <= bound:
        fail(f"the one-process evaluation of rank 0's checkpoint gives "
             f"{p1}, not the logged {logged} mm")
    return {"epoch": epochs[0], "wall_s": wall_s, "evaluate_mm": p1,
            "max_abs_err": err, "traces": len(traces)}


def example_on_card() -> dict:
    """Phase 12 (e): ``gastx_torch.examples.train_synthetic`` at its
    defaults on the card; it must exit 0 (its own 3x gate)."""
    import contextlib
    import io
    import re

    from gastx_torch.examples.train_synthetic import main as example

    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = example([*EXAMPLE_ARGS, "--device", "cuda"])
    s = time.time() - t0
    text = out.getvalue()
    held = [float(v) for v in re.findall(r"held-out (\S+) mm", text)]
    untrained = float(re.search(r"untrained held-out MPJPE: (\S+) mm",
                                text).group(1))
    print(f"  (e) examples.train_synthetic {' '.join(EXAMPLE_ARGS)}: exit "
          f"{rc} in {s:.1f} s; held-out MPJPE {untrained:.1f} -> "
          f"{held[-1]:.1f} mm")
    if rc != 0:
        fail("the synthetic example failed its gate:\n" + text[-2000:])
    return {"s": s, "untrained_mm": untrained, "held_out_mm": held[-1]}


def entry_on_card(dev) -> dict:
    """Phase 12 (f): ``gastx_torch.entry.entry()``'s forward on the card
    against the plain route, ``profiling.benchmark`` of it (windows/s) and
    ``flops_estimate`` of the plain route."""
    from gastx_torch.entry import entry
    from gastx_torch.utils import benchmark, flops_estimate

    fn, (model, x) = entry()
    err = check("(f) entry() forward (8 windows of 27f)", fn(model, x),
                model.plain_route_forward(x))
    bench = benchmark(fn, model, x, iters=50, warmup=5,
                      items_per_call=x.shape[0])
    flops = flops_estimate(model.plain_route_forward, x)
    print(f"  (f) profiling.benchmark of entry(): {bench['items_per_s']:.1f} "
          f"windows/s, p50 {bench['p50_ms']:.3f} ms, p90 "
          f"{bench['p90_ms']:.3f} ms; flops_estimate of the plain route "
          f"{flops:.4e} FLOP a call")
    if not flops:
        fail("flops_estimate counted nothing on the plain route")
    return {"max_abs_err": err, "benchmark": bench, "plain_flops": flops}


def ablations_on_card(dev) -> dict:
    """Phase 12 (g): the three ablation modules on the card against the
    CPU, in eval and train mode (no dropout: the two devices' generators
    differ), their output and running statistics."""
    import copy

    import torch

    from gastx_torch.models.config import graph_statics
    from gastx_torch.ops import ablations as A

    statics = graph_statics("h36m17")
    gen = torch.Generator().manual_seed(12)
    modules = {"SemGraphConv": A.SemGraphConv(128, 128, statics.sym_idx,
                                              17),
               "LocalGraphSimple": A.LocalGraphSimple(128, statics),
               "SingleGlobalGraph": A.SingleGlobalGraph(128, 64, 128, 17)}
    errs = {}
    for name, cpu_mod in modules.items():
        with torch.no_grad():
            for p in cpu_mod.parameters():
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
        x = torch.randn((64, 25, 17, 128), generator=gen)
        for mode in ("eval", "train"):
            card = copy.deepcopy(cpu_mod).to(dev).train(mode == "train")
            cpu = copy.deepcopy(cpu_mod).train(mode == "train")
            errs[f"{name} {mode}"] = check(
                f"(g) {name} ({mode}) card against CPU",
                card(x.to(dev)).detach().cpu(), cpu(x).detach())
            for (n, b), c in zip(card.named_buffers(), cpu.buffers()):
                if "running" in n and not float((b.cpu() - c).abs().max()) \
                        <= TOL * max(1.0, float(c.abs().max())):
                    fail(f"(g) {name} ({mode}): the card's {n} differs")
    return errs


def dp_phase(K, dev, report) -> dict:
    """Phase 12: (a) ``dryrun_multichip(1)`` and the DDP step on one NCCL
    rank; (b) and (c) two ranks sharing the card over gloo
    (``dp_pair_rank``); (d) trainval under torch.distributed.run; (e) the
    synthetic example; (f) the entry and the profiling utilities; (g) the
    ablations. Every rank is a spawned process joined with a timeout; a
    rank that fails fails the run."""
    import numpy as np
    import torch

    from gastx_torch.cli import reconstruct as rc
    from gastx_torch.data import coco_h36m
    from gastx_torch.entry import dryrun_multichip
    from gastx_torch.geometry import normalize_screen_coordinates
    from gastx_torch.parallel import spawn

    torch.cuda.empty_cache()
    res = {}

    def hold(label, cmp, kinds):
        print(f"  {label}: " + "; ".join(
            f"{k} {v['max_abs_err']:.3e} ({v['err_over_bound']:.3f} of its "
            f"bound{', held' if k in kinds else ''})"
            for k, v in cmp.items()))
        for k in kinds:
            if not cmp[k]["err_over_bound"] <= 1.0:
                fail(f"{label}, {k}: {cmp[k]['tensor']} is "
                     f"{cmp[k]['max_abs_err']} off")

    # (a) one rank on NCCL.
    t0 = time.time()
    losses = dryrun_multichip(1)
    res["dryrun_1"] = {"losses": losses, "s": time.time() - t0}
    print(f"  (a) dryrun_multichip(1): losses {losses} "
          f"({res['dryrun_1']['s']:.1f} s)")
    res["ddp_one_rank"] = one = spawn(ddp_one_rank, 1,
                                      timeout=DP_RANK_TIMEOUT)[0]
    if one["backend"] != "nccl":
        fail(f"one rank on the card took {one['backend']}, not NCCL")
    for b in DP_BATCHES:
        hold(f"(a) DDP step on one NCCL rank against the step without DDP, "
             f"27f B={b}", one[f"B={b}"], ("loss", "grads"))
    for name in TRAIN_TIER_NAMES:
        cmp = one[f"tiered {name}"]
        print(f"  (a) tiered ({name}) DDP step on one NCCL rank against the "
              f"one-process tiered step, 27f B={DP_TIER_BATCH}: bitwise "
              f"{cmp['bitwise']}; " + "; ".join(
                  f"{k} {v['max_abs_err']:.3e}" for k, v in cmp.items()
                  if k != "bitwise"))
        if not cmp["bitwise"]:
            fail(f"the tiered ({name}) DDP step on one rank is not the "
                 f"one-process step bit for bit")

    # (b) and (c): two ranks sharing the card over gloo.
    seqs = []
    for i, (rf, frames) in enumerate(REQUESTS):
        if rf == 27:
            kps, _ = coco_h36m(synthetic_coco(frames, seed=i)[0])
            seqs.append(normalize_screen_coordinates(
                kps, w=rc.WIDTH, h=rc.HEIGHT).astype(np.float32))
    t0 = time.time()
    res["pair"] = pair = spawn(dp_pair_rank, 2, seqs,
                               timeout=DP_RANK_TIMEOUT)[0]
    res["pair"]["s"] = time.time() - t0
    if pair["backend"] != "gloo":
        fail(f"two ranks on one card took {pair['backend']}, not gloo")
    # Adam's first update is about lr * sign(g): a float32 gradient near
    # zero whose sign the ranks' other summation order flips moves its
    # parameter by up to 2 lr, and the second step starts from there. So
    # float32 is held on its first step (the loss, every gradient, the BN
    # statistics) and float64 on both steps whole, every parameter after
    # amsgrad included. The ragged step is held on its loss and BN
    # statistics: where a ReLU's input lies within rounding of zero, the
    # float32 backward can take the other branch (as between the card and
    # the CPU, phase 9 (b)), and its gradients are reported.
    f32 = ("loss", "grads", "bn_stats")
    for dtype, kinds_by_step in (
            ("torch.float64", [("loss", "grads", "params", "bn_stats")] * 2),
            ("torch.float32", [f32, ()])):
        for i, (cmp, kinds) in enumerate(zip(pair[dtype], kinds_by_step)):
            hold(f"(b) {dtype[6:]} DP step {i + 1} of two ranks (B="
                 f"{DP_PAIR_BATCH // 2} each) against one process "
                 f"(B={DP_PAIR_BATCH})", cmp, kinds)
    hold(f"(b) ragged DP step ({DP_RAGGED_ROWS} real rows of "
         f"{DP_PAIR_BATCH}: rank 1's all filler)", pair["ragged"],
         ("loss", "bn_stats"))
    print(f"  (b) 27f B={DP_PAIR_BATCH} strided train step, float32, on "
          f"{report['card']}: two ranks sharing one card over gloo (not a "
          f"scaling figure) {pair['dp_step_ms']:.3f} ms a step; one process "
          f"{pair['one_process_step_ms']:.3f} ms; the all-reduce of the "
          f"gradients' {pair['grad_bytes'] / 1e6:.1f} MB alone (under "
          f"trace('gastx_torch.grad_allreduce')) {pair['allreduce_ms']:.3f} "
          f"ms, {pair['allreduce_ms'] / pair['dp_step_ms']:.4f} of the DP "
          f"step")
    for r in pair["lift"]:
        print(f"  (c) sharded flip-TTA lift, {r['frames']} frames: max|d| "
              f"{r['max_abs_err']:.3e} from the one-process lift (bound "
              f"{r['bound']:.3e})")
        if not r["max_abs_err"] <= r["bound"]:
            fail("the sharded lift disagrees with the one-process lift")
    want = [k for k, v in report["forwards"]["27f"]["launches_per_forward"]
            .items() if v]
    missed = [k for k in want if not pair["dp_launches"].get(k)]
    unseen = [k for k in ("gemm_epilogue", "sem_graph", "joint_attention")
              if not any(f"{k}_kernel" in name
                         for name in pair["profiled_kernels"])]
    print(f"  (c) rank 0's launches in the sharded lift "
          f"({pair['lift_s']:.3f} s): {pair['dp_launches']}")
    if missed or unseen:
        fail(f"the sharded lift did not launch {missed}, or rank 0's "
             f"profile does not show {unseen}")

    res["trainval"] = dp_trainval(dev)
    res["example"] = example_on_card()
    res["entry"] = entry_on_card(dev)
    res["ablations"] = ablations_on_card(dev)
    return res


# --------------------------------------------------------------------------
# bf16 I/O (phase 2) and the JAX package's last config surface (phase 13)
# --------------------------------------------------------------------------

# bf16's spacing relative to a value, at worst (7 stored mantissa bits).
BF16_STEP = 2.0 ** -7


def check_bf16(name: str, got, plain) -> float:
    """Hold a bf16 output to its plain version: both round float32 sums
    that differ only in order, so an element may land on the neighbouring
    bf16 value. Each element within one bf16 step of the plain value
    (2^-7 of it) plus the float32 bound; returns the max |d|."""
    g, p = got.float(), plain.float()
    err = max_err(g, p)
    slack = TOL * max(1.0, float(p.abs().max()))
    over = float(((g - p).abs() - BF16_STEP * p.abs()).max())
    print(f"  {name}: max|d| {err:.3e} (bound: one bf16 step + "
          f"{slack:.3e}; worst excess {over:.3e})")
    if got.dtype != plain.dtype:
        fail(f"{name}: dtype {got.dtype}, plain {plain.dtype}")
    if not over <= slack:
        fail(f"{name} disagrees with its plain version by more than one "
             f"bf16 step: {over} > {slack}")
    return err


def check_out(name: str, got, plain) -> float:
    """``check`` for a float32 output, ``check_bf16`` for a bf16 one."""
    import torch

    if got.dtype == torch.bfloat16:
        return check_bf16(name, got, plain)
    return check(name, got, plain)


def gemm_bytes(pieces, m, n, kw, out_dtype) -> int:
    """The bytes a ``gemm_epilogue`` call must move: each distinct A once
    in its dtype (a conv's taps share one), W, the epilogue vectors, the
    residual and the output in theirs."""
    import torch

    seen, total = set(), 0
    for a, w, _ in pieces:
        if a.data_ptr() not in seen:
            seen.add(a.data_ptr())
            total += a.numel() * a.element_size()
        total += w.numel() * w.element_size()
    if kw.get("scale") is not None:
        total += 8 * n
    if kw.get("res") is not None:
        total += kw["res"].numel() * kw["res"].element_size()
    return total + m * n * torch.empty((), dtype=out_dtype).element_size()


# The bf16 cases of gemm_epilogue and gemm_tc (phase 2): (label, a
# GEMM_SHAPES index or a line of its form, pieces cast to bf16, residual
# bf16, output bf16), at B=256 windows; the block concat's pieces are
# [x (bf16) | local | global] as bf16 storage gives them (N = 2C: 256 at
# 27f level 0, 64 at 243f GAB 0 under the JAX preset's fold, 128 at 81f
# GAB 0), the conv taps and residual a bf16 level's input (the taps with
# a residual: "pallas_level" on bf16). Every one takes gemm_tc's
# vec16_bf16 at every tier.
BF16_GEMM_CASES = (
    ("27f L0 block concat, x bf16 -> bf16", 4, (0,), False, True),
    ("27f L0 projection, x bf16", 1, (0,), False, False),
    ("27f L1 dilated conv, taps bf16", 5, (0, 1, 2), False, False),
    ("27f L1 1x1 + bf16 residual", 6, (), True, False),
    ("243f L0 block concat (N=64), x bf16 -> bf16",
     ("243f L0 block concat", 256, 241, (32,) * 3, 64, "bn", None, None),
     (0,), False, True),
    ("81f L0 block concat (N=128), x bf16 -> bf16",
     ("81f L0 block concat", 1024, 79, (64,) * 3, 128, "bn", None, None),
     (0,), False, True),
    ("27f L1 dilated conv + residual, taps and residual bf16",
     ("27f L1 dilated conv + residual", 1024, 19, (256,) * 3, 256, "bn",
      (25, 3), (25, 3)), (0, 1, 2), True, False),
)
# The ragged bf16 GEMMs that stay on gemm_tc's general instantiation, at
# every tier: (label, M, K of each piece, N, pieces, first piece bf16 (the
# others float32), residual bf16, output bf16). The three-piece one mixes
# a bf16 piece with float32 ones under a bf16 residual, as a ragged block
# concat on bf16 storage does.
BF16_TC_RAGGED = (
    ("K=132 bf16 piece (K % 8 = 4)", 4001, 132, 64, 1, True, False, False),
    ("N=70 bf16 output", 4001, 128, 70, 1, False, False, True),
    ("3 pieces K=130 N=70, bf16 piece, residual and output", 4001, 130, 70,
     3, True, True, True),
)


def bf16_ragged_cases(dev, gen) -> list:
    """``BF16_TC_RAGGED``'s operands, drawn from ``gen``: (``"ragged "`` and
    the label, pieces, M, keyword arguments with the output dtype)."""
    import torch

    bf = torch.bfloat16
    cases = []
    for label, m, k, n, n_p, a_bf, res_bf, out_bf in BF16_TC_RAGGED:
        pieces = []
        for p in range(n_p):
            a = torch.randn((m, k), generator=gen, device=dev)
            pieces.append((a.to(bf) if a_bf and p == 0 else a,
                           torch.randn((k, n), generator=gen, device=dev)
                           / 12.0, 0))
        res = torch.randn((m, n), generator=gen, device=dev)
        cases.append((f"ragged {label}", pieces, m, dict(
            scale=torch.rand(n, generator=gen, device=dev) + 0.5,
            shift=torch.randn(n, generator=gen, device=dev), relu=True,
            res=res.to(bf) if res_bf else None,
            out_dtype=bf if out_bf else torch.float32)))
    return cases


def bf16_gemm_case(K, dev, spec_i, cast, res_bf16, windows, seed):
    import torch

    spec = GEMM_SHAPES[spec_i] if isinstance(spec_i, int) else spec_i
    pieces, m, kw = gemm_case(spec, dev, seed, windows=windows)
    # A conv's taps share one input: cast it once.
    cache = {}
    out = []
    for p, (a, w, off) in enumerate(pieces):
        if p in cast:
            a = cache.setdefault(a.data_ptr(), a.to(torch.bfloat16))
        out.append((a, w, off))
    if res_bf16:
        kw["res"] = kw["res"].to(torch.bfloat16)
    return out, m, kw


def bf16_cases(K, dev, gts, n243, n81, l1t):
    """Phase 2's bf16-I/O cases: (label, kernel whose launch it is or None
    for an entry point, its IO_LABELS entry, its instantiation or None,
    call, plain call). Every output held by ``check_out``."""
    import torch
    from gastx_torch.ops.cuda.fused_gab import fused_gab, fused_gab_plain
    from gastx_torch.ops.cuda.fused_level import (fused_level,
                                                  fused_level_plain)

    bf = torch.bfloat16
    cases = []
    for i, (label, spec_i, cast, res_bf16, out_bf16) in enumerate(
            BF16_GEMM_CASES):
        pieces, m, kw = bf16_gemm_case(K, dev, spec_i, cast, res_bf16, 256,
                                       400 + i)
        kw["out_dtype"] = bf if out_bf16 else torch.float32
        io = K.io_label([a for a, _, _ in pieces] + [kw["res"]],
                        kw["out_dtype"])
        want = K.gemm_variant(pieces, pieces[0][1].shape[1], kw["res"])
        cases.append((f"gemm_epilogue {label}", "gemm_epilogue", io, want,
                      lambda p=pieces, m=m, kw=kw: K.gemm_epilogue(p, m, **kw),
                      lambda p=pieces, m=m, kw=kw: K.gemm_epilogue_plain(
                          p, m, **kw)))
        want = K.tc_variant(pieces, pieces[0][1].shape[1], kw["res"],
                            kw["out_dtype"])
        if want != "vec16_bf16":
            fail(f"gemm_tc {label}: tc_variant picks {want}")
        for tier in K.TC_TIERS:
            kt = dict(kw, tier=tier)
            cases.append((
                f"gemm_tc {tier} {label}", "gemm_tc", io, want,
                lambda p=pieces, m=m, kw=kt: K.gemm_epilogue(p, m, **kw),
                lambda p=pieces, m=m, kw=kt: K.gemm_epilogue_plain(
                    p, m, **kw)))
    # A ragged product (K = 130, N = 70) on the general instantiation.
    gen = torch.Generator(device=dev).manual_seed(410)
    a = torch.randn((4001, 130), generator=gen, device=dev).to(bf)
    w = torch.randn((130, 70), generator=gen, device=dev) / 12.0
    kw = dict(scale=torch.rand(70, generator=gen, device=dev) + 0.5,
              shift=torch.randn(70, generator=gen, device=dev), relu=True,
              out_dtype=bf)
    cases.append(("gemm_epilogue K=130 N=70, bf16 in and out",
                  "gemm_epilogue", "bf16_io", "general",
                  lambda: K.gemm_epilogue([(a, w, 0)], 4001, **kw),
                  lambda: K.gemm_epilogue_plain([(a, w, 0)], 4001, **kw)))
    # The ragged bf16 GEMMs on gemm_tc's general instantiation.
    for label, p_r, m_r, kw_r in bf16_ragged_cases(dev, gen):
        io_r = K.io_label([a for a, _, _ in p_r] + [kw_r["res"]],
                          kw_r["out_dtype"])
        if K.tc_variant(p_r, p_r[0][1].shape[1], kw_r["res"],
                        kw_r["out_dtype"]) != "general":
            fail(f"gemm_tc {label}: tc_variant does not pick general")
        for tier in K.TC_TIERS:
            kt = dict(kw_r, tier=tier)
            cases.append((
                f"gemm_tc {tier} {label}", "gemm_tc", io_r, "general",
                lambda p=p_r, m=m_r, kw=kt: K.gemm_epilogue(p, m, **kw),
                lambda p=p_r, m=m_r, kw=kt: K.gemm_epilogue_plain(
                    p, m, **kw)))
    # gab_narrow at C = 32 and 64 (243f GAB 0 and 1, 81f GAB 0), bf16 x and
    # output, and float32 x to a bf16 output (a bf16 level's GAB).
    for label, t, frames, seed, x_bf16 in (
            ("C=32, T=241", n243[0], 256 * 241, 411, True),
            ("C=64, T=79", n81, 256 * 79, 412, True),
            ("C=64, T=235, float32 in", n243[1], 256 * 235, 413, False)):
        c = t.w_proj.shape[0]
        x = torch.randn((frames * 17, c), generator=torch.Generator(
            device=dev).manual_seed(seed), device=dev)
        x = x.to(bf) if x_bf16 else x
        cases.append((f"gab_narrow {label} -> bf16", "gab_narrow",
                      "bf16_io" if x_bf16 else "bf16_out", None,
                      lambda x=x, t=t: K.gab_narrow(x, t, bf),
                      lambda x=x, t=t: K.gab_narrow_plain(x, t, bf)))
    # The entry points on bf16 activations: the 27f GABs at C=128 and 512
    # and its level 1, B=256.
    g = torch.Generator(device=dev).manual_seed(414)
    x128 = torch.randn((256, 25, 17, 128), generator=g, device=dev).to(bf)
    x512 = torch.randn((256, 1, 17, 512), generator=g, device=dev).to(bf)
    x256 = torch.randn((256, 25, 17, 256), generator=g, device=dev).to(bf)
    cases += [
        ("fused_gab (C=128, T=25) bf16", None, None, None,
         lambda: fused_gab(x128, gts[0]),
         lambda: fused_gab_plain(x128, gts[0])),
        ("fused_gab (C=512, T=1) bf16", None, None, None,
         lambda: fused_gab(x512, gts[2]),
         lambda: fused_gab_plain(x512, gts[2])),
        ("fused_level (C=256, T=25) bf16", None, None, None,
         lambda: fused_level(x256, l1t, gts[1], fw=3, dilation=3,
                             res_off=3),
         lambda: fused_level_plain(x256, l1t, gts[1], fw=3, dilation=3,
                                   res_off=3))]
    return cases


def run_bf16_cases(K, cases) -> dict:
    """Phase 2: each bf16 case held to its plain version, and checked to
    launch its kernel once, with its I/O dtypes and instantiation."""
    errs = {}
    for label, kernel, io, variant, fn, plain in cases:
        if kernel is None:
            errs[label] = check_out(label, fn(), plain())
            continue
        before_io = K.DTYPE_LAUNCHES[kernel][io]
        before = dict(K.VARIANT_LAUNCHES.get(kernel, {}))
        got = fn()
        if K.DTYPE_LAUNCHES[kernel][io] != before_io + 1:
            fail(f"{label}: no {kernel} launch with I/O {io}")
        if variant is not None:
            taken = [v for v, n in K.VARIANT_LAUNCHES[kernel].items()
                     if n != before.get(v)]
            if taken != [variant]:
                fail(f"{label}: took {taken}, not {variant}")
        errs[label] = check_out(f"{label} [{io}]", got, plain())
        del got
    return errs


def dtype_counts(K) -> dict:
    """Every kernel's launches by I/O dtypes, where non-zero."""
    return {f"{k} {io}": n for k, counts in K.DTYPE_LAUNCHES.items()
            for io, n in counts.items() if n}


# Phase 13's cells: (label, receptive field, windows held, fields on
# config_for_frames, what the launch counters must show: (counter, >0 or
# ==0) pairs over launch_counts and dtype_counts).
LEVELS_81 = ("pallas_level", "pallas_pbatch", "pallas_local", "xla")
CONFIG_CELLS = (
    ("27f pallas_level", 27, 128, {"gab_impl": "pallas_level"},
     (("fused_level0", True), ("fused_level", True),
      ("fused_gab_split", True), ("gemm_epilogue bf16_in", False))),
    ("243f pallas_pbatch", 243, 32, {"gab_impl": "pallas_pbatch"},
     (("fused_gab_pbatch", True), ("gab_narrow", True),
      ("fused_level", False))),
    ("81f gab_impl_levels", 81, 64, {"gab_impl_levels": LEVELS_81},
     (("fused_level0", True), ("fused_gab", True),
      ("fused_local_branch", True), ("fused_level", False))),
    ("27f storage bf16", 27, 128, {"storage_dtype": "bfloat16"},
     (("gemm_epilogue bf16_in", True), ("gemm_epilogue bf16_io", True),
      ("fused_level", False), ("fused_level0", False))),
    ("81f storage bf16", 81, 64, {"storage_dtype": "bfloat16",
                                  "storage_dtype_levels": ()},
     (("gab_narrow bf16_io", True), ("gemm_epilogue bf16_io", True),
      ("fused_level", False))),
    ("243f storage bf16", 243, 32, {"storage_dtype": "bfloat16"},
     (("gab_narrow bf16_io", True), ("gemm_epilogue bf16_io", True),
      ("fused_level", False))),
    ("81f mixed storage", 81, 64, {"storage_dtype": "bfloat16"},
     (("gab_narrow bf16_io", True), ("gemm_epilogue float32", True),
      ("gemm_epilogue bf16_io", True))),
    ("27f gab_io_dtype", 27, 128, {"gab_io_dtype": "bfloat16"},
     (("fused_level0", True), ("fused_gab_split", True),
      ("gemm_epilogue bf16_io", True), ("gemm_epilogue bf16_in", True))),
    ("243f pallas_level bf16", 243, 32, {"gab_impl": "pallas_level",
                                         "storage_dtype": "bfloat16"},
     (("fused_level", True), ("gemm_epilogue bf16_in", True),
      ("gab_narrow bf16_out", True))),
    # Every kernel GAB folded, float32: the fold gab_narrow where
    # gab_route sends it (GAB 0, C = 32), the fold chain above.
    ("243f fold", 243, 32, {"gab_kernel_form": "fold"},
     (("fused_level0", True), ("gab_narrow fold", True),
      ("gab_narrow v1", False), ("joint_attention general", True))),
)
# The tiered cells: the 243f preset (its fold at GAB 0), and the JAX
# package's shipped 243f route on a TPU (bf16 storage, the preset, fold):
# every bf16 GEMM of its GABs on gemm_tc's vec16_bf16, none on general.
TIERED_CELLS = (
    ("243f preset fold", 243, 32, {},
     (("fused_level0", True), ("gab_narrow fold", True),
      ("joint_attention general", False),
      ("joint_attention highest/default", False))),
    ("243f preset fold bf16", 243, 32, {"storage_dtype": "bfloat16"},
     (("gemm_tc bf16_io", True), ("gemm_tc vec16_bf16", True),
      ("gemm_tc general", False), ("gab_narrow fold", True),
      ("gab_narrow bf16_io", True),
      ("joint_attention highest/default", False))),
)
# Windows a second: (label, receptive field, batch, on the JAX preset,
# (name, fields) of the pair), each pair timed in turns (a, b, b, a): the
# storage cells at float32 and bf16, the 243f preset without and with
# fold, and the JAX package's two shipped bf16 routes (the 243f preset
# with fold; the 81f preset with level 3 float32) against float32
# storage on the same preset.
BF16 = {"storage_dtype": "bfloat16"}
SHIPPED_CELLS = (
    ("243f preset fold, shipped storage", 243, 256, True, ("float32", {}),
     ("bf16", BF16)),
    ("81f preset, shipped storage", 81, 1024, True, ("float32", {}),
     ("bf16", BF16)))
THROUGHPUT_CELLS = (
    ("27f", 27, 1024, False, ("float32", {}), ("bf16", BF16)),
    ("81f", 81, 1024, False, ("float32", {}),
     ("bf16", {**BF16, "storage_dtype_levels": ()})),
    ("81f mixed", 81, 1024, False, ("float32", {}), ("bf16", BF16)),
    ("243f", 243, 256, False, ("float32", {}), ("bf16", BF16)),
    ("243f preset", 243, 256, True,
     ("without fold", {"gab_kernel_form_levels": ()}), ("fold", {}))
) + SHIPPED_CELLS
# breakdown's kernel classes: (class, substrings of the kernel name), the
# first that matches.
BREAKDOWN_CLASSES = (
    ("gemm_tc wgmma", ("gemm_tc_kernel_ws",)),
    ("gemm_tc general", ("gemm_tc_kernel",)),
    ("gemm_epilogue", ("gemm_epilogue_kernel",)),
    ("gemm_smallk", ("gemm_smallk_kernel",)),
    ("gab_narrow", ("gab_narrow",)),
    ("sem_graph", ("sem_graph",)),
    ("joint_attention", ("joint_attention",)),
    ("copy / cast", ("copy",)),
    ("conv (cuDNN)", ("conv", "cudnn", "xmma", "implicit")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "sm90_")),
    ("elementwise / BN / reduce", ("elementwise", "reduce", "norm")))


def breakdown(fn) -> dict:
    """One profiled call of ``fn``: device ms by ``BREAKDOWN_CLASSES`` (and
    the launches of each), the device's busy and idle share of the call's
    CUDA-event time, the eight largest kernels by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    wall = start.elapsed_time(end)
    classes, kernels = {}, {}
    for ev in prof.key_averages():
        ms = ev.self_device_time_total / 1e3
        if ev.device_type != DeviceType.CUDA or ms <= 0:
            continue
        key = ev.key.lower()
        name = next((c for c, subs in BREAKDOWN_CLASSES
                     if any(sub in key for sub in subs)), "other")
        c = classes.setdefault(name, [0.0, 0])
        c[0] += ms
        c[1] += ev.count
        kernels[ev.key[:90]] = kernels.get(ev.key[:90], 0.0) + ms
    busy = sum(v[0] for v in classes.values())
    return {"wall_ms": wall, "busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall) if wall else None,
            "classes": {k: {"ms": v[0], "launches": v[1]}
                        for k, v in classes.items()},
            "top": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])}


def pair_turns(cell, dev, profile: bool = False) -> dict:
    """One ``THROUGHPUT_CELLS`` pair on one model (random weights from the
    receptive field as seed), its config switched between the two sides:
    per side the ms of 5 forwards in each of the turns (a, b, b, a), their
    mean, windows/s, the host's ms to issue a forward (``issue_ms``) and,
    with ``profile``, one profiled forward (``breakdown``)."""
    import dataclasses

    import numpy as np
    import torch

    from gastx_torch.models import build_gastnet, config_for_frames
    from gastx_torch.models.config import TPU_MIXED_PRECISION_OVERRIDES

    label, rf, b, on_preset, (na, fa), (nb, fb) = cell
    preset = dict(matmul_precision="high",
                  precision_overrides=TPU_MIXED_PRECISION_OVERRIDES)
    base = config_for_frames(rf, dropout=0.0, **(preset if on_preset else {}))
    cfgs = [dataclasses.replace(base, **f) for f in (fa, fb)]
    model = build_gastnet(cfgs[0], seed=rf, device=dev)
    x = torch.from_numpy(np.random.default_rng(rf).standard_normal(
        (b, rf, 17, 2)).astype(np.float32)).to(dev)
    ms, host = {0: [], 1: []}, {0: [], 1: []}
    for i in (0, 1, 1, 0):
        with_config(model, cfgs[i])
        t, h = issue_ms(lambda: model(x))
        ms[i].append(t)
        host[i].append(h)
    out = {}
    for i, name in enumerate((na, nb)):
        mean = float(np.mean(ms[i]))
        out[name] = {"ms": mean, "turns": ms[i], "windows_per_s": b / mean
                     * 1e3, "host_issue_ms": host[i]}
        if profile:
            with_config(model, cfgs[i])
            out[name]["breakdown"] = breakdown(lambda: model(x))
    del model, x
    torch.cuda.empty_cache()
    return out


def storage_check(name, got, plain, f32, rounded, levels) -> float:
    """Hold a bf16-storage forward to the same route through the plain
    versions: both round activations to bf16 at every level boundary, and
    an activation whose float32 value the two sum in other orders may
    round to the neighbouring bf16 value, after which they differ as two
    draws of bf16 storage do. So, as ``tiered_check`` for a tier, the bound
    is the float32 one or, where larger, twice the storage's own distance
    from the float32 forward (through the plain versions), which a broken
    kernel (a wrong row, tap, head or dtype) far exceeds.

    A route that skipped the rounding would sit near the float32 forward,
    inside that bound too; so the forward must also lie at least half the
    plain route's distance from the float32 forward, and ``rounded``, its
    launches with a bf16 output, must be at least ``levels`` (the GAB of
    each bf16 level writes the level's output)."""
    err = max_err(got, plain)
    gap = max_err(plain, f32)
    away = max_err(got, f32)
    bound_ = max(TOL * max(1.0, float(plain.abs().max())), 2 * gap)
    print(f"  {name}: max|d| {err:.3e} (bound {bound_:.3e}; the storage's "
          f"own distance from float32 {gap:.3e}, the forward's {away:.3e}; "
          f"float32 bound {TOL * max(1.0, float(plain.abs().max())):.3e}); "
          f"{rounded} launches with a bf16 output, {levels} bf16 levels")
    if not err <= bound_:
        fail(f"{name} disagrees with its plain route: {err} > {bound_}")
    if not away >= gap / 2:
        fail(f"{name} does not round as bf16 storage does: {away} from the "
             f"float32 forward, the plain route {gap}")
    if rounded < levels:
        fail(f"{name}: {rounded} launches with a bf16 output for {levels} "
             f"bf16 levels")
    return err


def config_phase(K, dev) -> dict:
    """Phase 13: every route the JAX package's last config knobs select,
    at full width (``CONFIG_CELLS``, ``TIERED_CELLS``): each cell's
    forward with the launch counters zeroed just before and read just
    after (what the counters must show is checked), held to
    ``plain_route_forward`` (float32 cells: the float32 bound; tiered:
    ``tiered_check``; bf16 storage: ``storage_check``); then windows/s
    (``THROUGHPUT_CELLS``)."""
    import dataclasses

    import numpy as np
    import torch

    from gastx_torch.models import build_gastnet, config_for_frames
    from gastx_torch.models.config import TPU_MIXED_PRECISION_OVERRIDES

    out = {"cells": {}, "throughput": {}}
    launches_all = {}

    def run(label, rf, b, cfg, want, held):
        model = build_gastnet(cfg, seed=rf, device=dev)
        x = torch.from_numpy(np.random.default_rng(rf).standard_normal(
            (b, rf, 17, 2)).astype(np.float32)).to(dev)
        K.reset_launches()
        y = model(x)
        torch.cuda.synchronize()
        counts = {**{k: v for k, v in launch_counts(K).items() if v},
                  **dtype_counts(K)}
        for key, v in counts.items():
            launches_all[key] = launches_all.get(key, 0) + v
        for key, positive in want:
            if bool(counts.get(key)) != positive:
                fail(f"phase 13 {label}: {key} launched "
                     f"{counts.get(key, 0)} times")
        err = held(label, model, x, y, counts)
        out["cells"][label] = {"batch": b, "max_abs_err": err,
                               "launches": counts}
        print(f"    launches {counts}")
        del model, x, y
        torch.cuda.empty_cache()

    def f32_held(label, model, x, y, counts):
        return check(f"{label} (B={x.shape[0]})", y,
                     model.plain_route_forward(x))

    def bf16_held(label, model, x, y, counts):
        levels = max(1, model.level_dtypes().count(torch.bfloat16))
        rounded = sum(v for k, v in counts.items()
                      if k.endswith((" bf16_out", " bf16_io")))
        plain = model.plain_route_forward(x)
        f32 = with_config(model, dataclasses.replace(
            model.cfg, storage_dtype="float32", storage_dtype_levels=(),
            gab_io_dtype="float32")).plain_route_forward(x)
        return storage_check(f"{label} (B={x.shape[0]})", y, plain, f32,
                             rounded, levels)

    print("phase 13: the config surface (explicit routes, gab_impl_levels, "
          "fold, bf16 storage, gab_io_dtype) against plain_route_forward")
    for label, rf, b, fields, want in CONFIG_CELLS:
        cfg = dataclasses.replace(config_for_frames(rf, dropout=0.0),
                                  **fields)
        bf16 = "bfloat16" in (cfg.storage_dtype, cfg.gab_io_dtype)
        run(label, rf, b, cfg, want, bf16_held if bf16 else f32_held)

    def tiered_held(label, model, x, y, counts):
        if model.cfg.storage_dtype == "bfloat16":
            return bf16_held(label, model, x, y, counts)
        return tiered_check(f"{label} (B={x.shape[0]})", model, x, y)[0]

    preset = dict(matmul_precision="high",
                  precision_overrides=TPU_MIXED_PRECISION_OVERRIDES)
    for label, rf, b, fields, want in TIERED_CELLS:
        cfg = dataclasses.replace(config_for_frames(rf, dropout=0.0,
                                                    **preset), **fields)
        if cfg.gab_kernel_form_levels != ("fold",):
            fail(f"{label}: the preset does not fold GAB 0")
        run(label, rf, b, cfg, want, tiered_held)
    out["launches"] = launches_all

    print("phase 13: windows/s, each pair in turns (a, b, b, a)")
    for cell in THROUGHPUT_CELLS:
        label, _, b, _, (na, _), (nb, _) = cell
        r = out["throughput"][label] = pair_turns(
            cell, dev, profile=cell in SHIPPED_CELLS)
        turns = [round(v, 3) for v in r[na]["turns"] + r[nb]["turns"]]
        issued = [round(v, 3) for v in r[na]["host_issue_ms"]
                  + r[nb]["host_issue_ms"]]
        print(f"  {label} B={b}: {na} {r[na]['windows_per_s']:.1f} "
              f"windows/s, {nb} {r[nb]['windows_per_s']:.1f} (ms turns "
              f"{turns}; host issue ms {issued})")
        for name in (na, nb):
            if "breakdown" in r[name]:
                p = r[name]["breakdown"]
                print(f"    {name}, profiled: device busy {p['busy_ms']:.3f} "
                      f"of {p['wall_ms']:.3f} ms, idle "
                      f"{p['idle_share']:.4f}; " + ", ".join(
                          f"{k} {v['ms']:.3f} ({v['launches']})"
                          for k, v in sorted(p["classes"].items(),
                                             key=lambda kv: -kv[1]["ms"])))
    return out


# The kernels line's bf16-I/O GEMM rows: (BF16_GEMM_CASES index, windows,
# kernel, tiers, whether the row carries phase 13's launches of its
# instantiation) at main-path shapes of bf16 storage: the 27f level-0
# block concat, the 243f GAB-0 one (N = 64; its launches: phase 13's
# vec16_bf16 launches are the 243f cell's), the 81f GAB-0 one (N = 128)
# and the 27f level-0 projection; and the ragged row of gemm_tc's general
# instantiation: the 27f level-0 expand conv (K = 2 a tap) on bf16 taps to
# a bf16 output. scripts/torch_gemm_tc.py --bf16 times the gemm_tc rows.
BF16_KERNEL_ROWS = (
    (0, 1024, "gemm_epilogue", ("highest",), True),
    (0, 1024, "gemm_tc", TC_PASSES, False),
    (4, 256, "gemm_tc", TC_PASSES, True),
    (5, 1024, "gemm_tc", TC_PASSES, False),
    (1, 1024, "gemm_tc", TC_PASSES, False))
BF16_GENERAL_ROW = ("27f L0 expand conv, taps bf16 -> bf16", 0, (0, 1, 2),
                    False, True)


def tc_bf16_bound(pieces, m, n, kw, tier):
    """gemm_tc's bound on bf16 I/O: each piece's product at ``tc_passes``
    (a bf16 piece has no A-lo pass) plus the epilogue, against the bytes
    of ``gemm_bytes`` (bf16 activations at 2 bytes)."""
    import torch

    ks = [a.shape[1] for a, _, _ in pieces]
    flops = gemm_work(m, ks, n, 1, kw.get("res") is not None)[0]
    passed = flops - 2 * m * n * sum(ks) + sum(
        2 * m * a.shape[1] * n * tc_passes(tier, a.dtype == torch.bfloat16)
        for a, _, _ in pieces)
    return tc_bound(passed, gemm_bytes(pieces, m, n, kw, kw["out_dtype"]),
                    1)


def bf16_matmul_ms(pieces, m, kw) -> float:
    """One bf16 ``torch.matmul`` (bf16 out) over the same product, the
    operands gathered and rounded once outside the timing: the
    yardstick."""
    import torch

    a_cat, w_cat = gemm_library_operands(pieces, m, kw)
    a16, w16 = a_cat.to(torch.bfloat16), w_cat.to(torch.bfloat16)
    del a_cat, w_cat
    return cuda_ms(lambda: torch.matmul(a16, w16))


def bf16_kernels(K, dev, n243, phase13, phase2_errs) -> list:
    """The bf16-I/O instantiations' entries of the kernels line: each timed
    at a main-path shape of bf16 storage (``BF16_KERNEL_ROWS``: the 27f
    level-0 block concat with bf16 x and output at B=1024 on
    ``gemm_epilogue`` and on ``gemm_tc``'s vec16_bf16 at every tier, the
    243f GAB-0 block concat (N = 64) at B=256, the 81f one (N = 128) and
    the 27f level-0 projection, bf16 x to float32, at B=1024;
    ``BF16_GENERAL_ROW`` on the general
    instantiation; ``gab_narrow`` on the 243f model's C=32 GAB at B=256,
    bf16 in and out) beside its plain version, its bound (bf16 elements at
    2 bytes; ``gemm_tc``'s operations at ``tc_passes`` a piece) and a bf16
    ``torch.matmul``; launches from phase 13 (all bf16 I/O labels; the
    vec16_bf16 launches on one row, its ``default`` 243f one)."""
    import torch

    bf = torch.bfloat16
    launches = phase13["launches"]

    def io_launches(name):
        return sum(launches.get(f"{name} {io}", 0)
                   for io in K.IO_LABELS if io != "float32")

    def phase2(prefix, ragged=None):
        """Phase 2's cases under ``prefix`` (and, for ``ragged`` True or
        False, only the ragged ones or the others)."""
        return [v for k, v in phase2_errs.items() if k.startswith(prefix)
                and (ragged is None or ("ragged" in k) == ragged)]

    def err_of(prefix, ragged=None):
        return max(phase2(prefix, ragged))

    vec_launches = launches.get("gemm_tc vec16_bf16", 0)
    rows = [(BF16_GEMM_CASES[i], windows, kernel, tiers, "vec16_bf16", path)
            for i, windows, kernel, tiers, path in BF16_KERNEL_ROWS]
    rows.append((BF16_GENERAL_ROW, 1024, "gemm_tc", ("default",),
                 "general", True))
    entries = []
    for (label, spec_i, cast, res_bf16, out_bf16), windows, kernel, tiers, \
            variant, path in rows:
        pieces, m, kw = bf16_gemm_case(K, dev, spec_i, cast, res_bf16,
                                       windows, 420)
        kw["out_dtype"] = bf if out_bf16 else torch.float32
        n = pieces[0][1].shape[1]
        shape = f"{label} (B={windows})"
        matmul_ms = bf16_matmul_ms(pieces, m, kw)
        for tier in tiers:
            kt = dict(kw, tier=tier)
            taken, got = launched_variant(
                K, kernel, lambda: K.gemm_epilogue(pieces, m, **kt))
            if kernel == "gemm_tc" and taken != variant:
                fail(f"gemm_tc {tier} {shape}: took {taken}, not {variant}")
            err = check_out(f"{kernel} {tier} {shape}", got,
                            K.gemm_epilogue_plain(pieces, m, **kt))
            del got
            ms = cuda_ms(lambda: K.gemm_epilogue(pieces, m, **kt))
            plain_ms = cuda_ms(lambda: K.gemm_epilogue_plain(pieces, m,
                                                             **kt), reps=3)
            if kernel == "gemm_epilogue":
                ks = [a.shape[1] for a, _, _ in pieces]
                bms, by = bound(gemm_work(m, ks, n, 1, 0)[0],
                                gemm_bytes(pieces, m, n, kw, kw["out_dtype"]))
                name = f"{kernel} (bf16 I/O, {shape})"
                n_launch, err = io_launches(kernel), err_of("gemm_epilogue")
                library_ms = None
            else:
                bms, by = tc_bf16_bound(pieces, m, n, kw, tier)
                name = f"gemm_tc ({tier}, bf16 I/O, {variant}, {shape})"
                if not (path and tier == "default"):
                    n_launch = 0
                elif variant == "general":
                    n_launch = io_launches("gemm_tc") - vec_launches
                else:
                    n_launch = vec_launches
                err = max(err, err_of(f"gemm_tc {tier} ",
                                      ragged=variant == "general"))
                library_ms = matmul_ms if tier == "default" else None
            entries.append({
                "name": name, "route": "cuda",
                "source": f"gastx_torch/csrc/{kernel}.cu",
                "replaces": "gastx/ops/pallas/fused_gab.py:501",
                "launches": n_launch, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                "library_ms": library_ms, "matmul_bf16_ms": matmul_ms})
            if not n_launch:
                entries[-1]["direct_launches"] = len(phase2(
                    f"gemm_tc {tier} ", ragged=variant == "general"))
            print(f"  {name}: {ms:.3f} ms (plain {plain_ms:.3f}, bound "
                  f"{bms:.3f} by {by}, {bms / ms:.1%} of it; bf16 "
                  f"torch.matmul {matmul_ms:.3f}); launches {n_launch}")
        del pieces, kw
        torch.cuda.empty_cache()
    t = n243[0]
    c, k, inter, g_ch, j, d = K.gab_shape(t)
    rows = 256 * 241 * j
    x = torch.randn((rows, c), generator=torch.Generator(
        device=dev).manual_seed(421), device=dev).to(bf)
    check_bf16("gab_narrow (bf16 I/O, C=32, T=241, B=256)",
               K.gab_narrow(x, t), K.gab_narrow_plain(x, t))
    ms = cuda_ms(lambda: K.gab_narrow(x, t))
    plain_ms = cuda_ms(lambda: K.gab_narrow_plain(x, t), reps=3)
    flops, nbytes = gab_work(rows, c, j, k, inter, g_ch, d)
    bms, by = bound(flops, nbytes - 2 * 3 * rows * c)  # x, out in bf16
    entries.append({
        "name": "gab_narrow (bf16 I/O, C=32, T=241)", "route": "cuda",
        "source": "gastx_torch/csrc/gab_narrow.cu",
        "replaces": "gastx/ops/pallas/fused_gab.py:959",
        "launches": io_launches("gab_narrow"),
        "max_abs_err": err_of("gab_narrow"), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": None})
    print(f"  gab_narrow (bf16 I/O, C=32, T=241, B=256): {ms:.3f} ms (plain "
          f"{plain_ms:.3f}, bound {bms:.3f} by {by})")
    del x
    torch.cuda.empty_cache()
    return entries


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
    from gastx_torch.models import (GastNet, build_gastnet,
                                    config_for_frames, init_gastnet,
                                    randomize_eval_statistics)
    from gastx_torch.train import save_checkpoint
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
    torch.backends.cudnn.allow_tf32 = False  # float32 convolutions
    # bf16 storage's plain products sum in float32 (device.check_f32_matmul)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
        # Each library's (and part's) seconds from the build's start.
        print("  " + " ".join(line for line in log.splitlines()
                              if line.startswith("[")))

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
        (kernel, variant), taken, got = launched_route(K, pieces, m, kw)
        if not taken == variant == want:
            fail(f"{kernel} {label}: took {taken}, not {want}")
        gemm_errs.append(check(f"gemm_epilogue {label} ({want})", got,
                               K.gemm_epilogue_plain(pieces, m, **kw)))
        del got
    print("phase 2: gemm_smallk at every tier")
    smallk_errs = run_smallk_cases(K, dev)
    torch.cuda.empty_cache()
    print("phase 2: gemm_wgrad at every call of the tiered train steps")
    t2 = time.time()
    wgrad = wgrad_cases(K, dev)
    report["wgrad_rows"] = wgrad_rows(K, wgrad.pop("main"))
    report["wgrad_cases"] = wgrad
    wgrad["s"] = time.time() - t2
    print(f"  gemm_wgrad's cases took {wgrad['s']:.1f} s")
    torch.cuda.empty_cache()
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
    print("phase 2: the bf16-I/O forms against their plain versions")
    bf16_errs = run_bf16_cases(K, bf16_cases(K, dev, gts, n243, n81, l1t))
    report["bf16_cases"] = bf16_errs
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

    no_video = os.path.join(WORK_DIR, "no_video.mp4")  # -vi falls back

    def request(model, label, argv, frames, joints=j):
        """One ``reconstruct --no-render`` request; its output."""
        i = len(requests)
        argv = [*argv, "--no-render", "-vi", no_video,
                "-vo", os.path.join(WORK_DIR, f"request{i}.mp4")]
        t0 = time.time()
        out = rc.reconstruct(rc.parse_args(argv))
        torch.cuda.synchronize()
        dt = time.time() - t0
        if out.shape != (frames, joints, 3) or not np.isfinite(out).all():
            fail(f"request {i}: bad output {out.shape}")
        requests.append({"model": model, "frames": frames, "s": dt})
        print(f"  request {i}: {label}, {frames} frames -> {out.shape}, "
              f"{dt:.3f} s")
        return out

    def keypoints_file(name, kps):
        path = os.path.join(WORK_DIR, f"{name}.json")
        save_keypoints_json(path, kps, np.ones(kps.shape[:3], np.float32))
        return path

    hook = register_module_forward_hook(record)
    K.reset_launches()
    for i, (rf, frames) in enumerate(REQUESTS):
        path = keypoints_file(f"request{i}", synthetic_coco(frames, seed=i))
        request(rf, f"-f {rf}", ["-k", path, "-f", str(rf),
                                 "--random-weights"], frames)
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
    # Trained weights through -w: a port .pt of the seeded 27f model
    # against the same seed's --random-weights; then the other formats.
    weights = os.path.join(WORK_DIR, "weights.pt")
    save_checkpoint(weights, epoch=0, lr=0.0, model=build_gastnet(
        config_for_frames(27), seed=WEIGHT_SEED, device=dev))
    coco = keypoints_file("weights", synthetic_coco(FORMAT_FRAMES, seed=20))
    from_pt = request("27f -w .pt", "-w weights.pt", ["-k", coco, "-w",
                                                      weights],
                      FORMAT_FRAMES)
    seeded = request("27f seeded", f"--random-weights --seed {WEIGHT_SEED}",
                     ["-k", coco, "--random-weights", "--seed",
                      str(WEIGHT_SEED)], FORMAT_FRAMES)
    report["weights_request_max_abs_err"] = check(
        "reconstruct -w weights.pt against --random-weights --seed",
        torch.from_numpy(from_pt), torch.from_numpy(seeded))
    for i, (fmt, joints) in enumerate(FORMAT_REQUESTS):
        path = keypoints_file(fmt, synthetic_layout(fmt, FORMAT_FRAMES,
                                                    seed=21 + i))
        request(f"27f -kf {fmt}", f"-kf {fmt} -n {joints}",
                ["-k", path, "-kf", fmt, "-n", str(joints),
                 "--random-weights"], FORMAT_FRAMES, joints)
    main_launches = launch_counts(K)
    hook.remove()
    request_s = [r["s"] for r in requests]
    print(f"  {len(requests)} requests in {sum(request_s):.3f} s "
          f"({', '.join(f'{t:.3f}' for t in request_s)}) on {smi}")
    print(f"  launches: {main_launches}")
    for name, count in main_launches.items():
        if (name in GRAPH_GENERAL + GEMM_GENERAL or tiered_launch(name)
                or name.startswith(FOLD_LAUNCH)):
            if count:
                fail(f"{name} launched {count} times on the main path")
        elif count <= 0 and name not in OFF_PATH:
            fail(f"{name} was not launched on the main path")
    if len(forwards) != len(requests):
        fail(f"{len(forwards)} forwards recorded for {len(requests)} "
             f"requests")
    level0_convs = sum(module.cfg.gab_impl == "auto"
                       for module, _, _ in forwards)
    if main_launches["gemm_smallk highest"] != level0_convs:
        fail(f"{main_launches['gemm_smallk highest']} gemm_smallk launches "
             f"for {level0_convs} level-0 expand convs")
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
    report["card_phase4"] = card_state("phase 4")
    report["forwards"] = {}
    xs = {}
    for cell, rf, b, _ in FORWARDS:
        m = models[cell]
        x = xs[cell] = randn(b, rf, j, 2, seed=7)
        K.reset_launches()
        y = m(x)
        torch.cuda.synchronize()
        per_forward = {k: v for k, v in launch_counts(K).items() if v}
        smallk = K.LAUNCHES["gemm_smallk"]
        if (smallk != (m.cfg.gab_impl == "auto")
                or any(per_forward.get(name) for name in GEMM_GENERAL)):
            fail(f"{cell}: {smallk} gemm_smallk launches (one a level-0 "
                 f"expand conv) and no general GEMM in one forward: "
                 f"{per_forward}")
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
                v: main_launches[f"{name} {v}"]
                for v in K.VARIANT_LAUNCHES[name]}
        if name in ("gemm_epilogue", "sem_graph", "joint_attention"):
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

    # ---- phase 9: training and evaluation --------------------------------
    report["card_phase9"] = card_state("phase 9")
    print("phase 9: training (strided train steps, no kernel) and "
          "trainval's evaluation on the kernels")
    took = report["phase9_s"] = {}
    t9 = time.time()
    report["train_cells"] = {label: train_cell(K, label, frames, b, dev)
                             for label, frames, b in TRAIN_CELLS}
    report["train_step_against_cpu"] = step_against_cpu(dev)
    took["a, b"], t9 = time.time() - t9, time.time()
    report["convergence"] = convergence_on_card(K, dev)
    report["convergence_preset"] = convergence_on_card(K, dev, "preset")
    took["c"], t9 = time.time() - t9, time.time()
    report["trainval"] = trainval_on_card(K, dev)
    took["d"], t9 = time.time() - t9, time.time()
    report["card_phase9e"] = card_state("phase 9 (e)")
    print("phase 9 (e): the train steps at the tiers (all high, the JAX "
          "preset) beside the float32 steps of (a)")
    report["tiered_train"] = tt = tiered_train_phase(
        K, dev, report["train_cells"])
    took["e"] = time.time() - t9
    print(f"  phase 9 took, by part (s): "
          f"{ {k: round(v, 1) for k, v in took.items()} }")
    tiered_cells = [v for k, v in tt.items() if k != "against_plain"]
    for r in report["wgrad_rows"]:
        key = f"gemm_wgrad {r['variant']}"
        kernels.append({
            "name": f"gemm_wgrad ({r['variant']}, {r['tier']}, "
                    f"{r['shape']})",
            "route": "cuda", "source": "gastx_torch/csrc/gemm_wgrad.cu",
            "replaces": "gastx/models/gastnet.py:89",
            "launches": sum(c["launches"].get(key, 0) for c in tiered_cells),
            "launches_per_step": {
                k: c["launches_per_step"].get(key, 0)
                for k, c in tt.items() if k != "against_plain"},
            "max_abs_err": report["wgrad_cases"]["max_abs_err_by_variant"][
                r["variant"]],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_f32_ms": r["library_f32_ms"]})

    # ---- phase 10: the precision tiers -----------------------------------
    print("phase 10: the precision tiers (bf16 passes on the tensor cores, "
          "rounded attention operands)")
    t10 = time.time()
    K.reset_launches()
    report["tier_kernels"] = tk = tier_kernels(K, dev, gts, glts)
    direct = launch_counts(K)
    report["tier_cert"] = tier_cert(dev)
    report["tier_paths"] = tp = tier_paths(K, dev)
    report["tier_throughput"] = tier_throughput(K, dev)
    report["tier_narrow"] = tn = tier_narrow(K, dev)
    high = tn["timed"]["high"]
    kernels.append({
        "name": "gab_narrow (tiered, C=32, T=241)", "route": "cuda",
        "source": "gastx_torch/csrc/gab_narrow.cu",
        "replaces": "gastx/ops/pallas/fused_gab.py:959",
        "launches": narrow_tier_launches(tp["launches"], fold=False),
        "max_abs_err": max(tn["errs"].values()), "ms": high["ms"],
        "plain_ms": high["plain_ms"], "bound_ms": high["bound_ms"],
        "bound_by": high["bound_by"], "library_ms": None,
        "tier": "high", "by_tier": tn["timed"]})
    # The fold form (the 243f preset's GAB 0): its tiered kernel's launches
    # over phase 10 (c), the float32 one's over phase 13's float32 fold
    # cell (set there); timed at the preset's tiers and in float32.
    for name, tier in (("gab_narrow (fold, tiered, C=32, T=241)", "preset"),
                       ("gab_narrow (fold, C=32, T=241)", "float32")):
        r = tn["fold_timed"][tier]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "gastx_torch/csrc/gab_narrow.cu",
            "replaces": "gastx/ops/pallas/fused_gab.py:959",
            "launches": (narrow_tier_launches(tp["launches"], fold=True)
                         if tier == "preset" else 0),
            "max_abs_err": max(v for key, v in tn["fold_errs"].items()
                               if key.endswith(" float32") == (
                                   tier == "float32")),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "tier": tier,
            "fold_chain_ms": r["fold_chain_ms"],
            "v1_gab_narrow_ms": r["v1_gab_narrow_ms"],
            "by_tier": tn["fold_timed"]})
    for r in tk["gemm_tc"]:
        key = f"gemm_tc {r['tier']}"
        kernels.append({
            "name": f"gemm_tc ({r['tier']}, {r['shape']})", "route": "cuda",
            "source": "gastx_torch/csrc/gemm_tc.cu",
            "replaces": "gastx/ops/pallas/precision.py:99",
            "launches": tp["launches"].get(key, 0),
            "max_abs_err": tk["errs"][r["tier"]], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "matmul_bf16_ms": r["matmul_bf16_ms"],
            "float32_ms": r["float32_ms"], "a_route": r["a_route"],
            "launches_by_variant": {
                v: tp["launches"].get(f"gemm_tc {v}", 0)
                for v in K.TC_VARIANTS},
            "train_launches_per_step": {
                k: c["launches_per_step"].get(key, 0)
                for k, c in tt.items() if k != "against_plain"}})
        if not kernels[-1]["launches"]:  # off the tiered path: high_lhs
            kernels[-1]["direct_launches"] = direct[key]
    for r in tk["joint_attention"]:
        key = f"joint_attention {r['pair']}"
        kernels.append({
            "name": f"joint_attention ({r['pair']}, C={r['c']})",
            "route": "cuda", "source": "gastx_torch/csrc/joint_attention.cu",
            "replaces": "gastx/ops/pallas/fused_gab.py:248",
            "instantiation": K.attn_instantiation(*r["pair"].split("/")),
            "launches": tp["launches"].get(key, 0),
            "max_abs_err": tk["errs"][r["pair"]], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "float32_ms": r["float32_ms"]})
    print("phase 10 (e): gemm_smallk at the shipped models' expand convs")
    card_state("phase 10 (e)")
    report["smallk"] = sk = expand_table(K, dev)
    sk27 = [r for r in sk if r["shape"] == sk[0]["shape"]]
    kernels.append({
        "name": f"gemm_smallk (highest, {sk27[0]['shape']})",
        "route": "cuda", "source": "gastx_torch/csrc/gemm_smallk.cu",
        "replaces": "gastx/ops/pallas/fused_level.py:194",
        "launches": main_launches["gemm_smallk"],
        "launches_by_tier": {
            "highest": main_launches["gemm_smallk highest"],
            **{t: tp["launches"].get(f"gemm_smallk {t}", 0)
               for t in K.TC_TIERS}},
        "max_abs_err": sk27[0]["max_abs_err"], "ms": sk27[0]["ms"],
        "ms_by_tier": {r["tier"]: r["ms"] for r in sk27},
        "call_ms": sk27[0]["call_ms"], "plain_ms": sk27[0]["plain_ms"],
        "bound_ms": sk27[0]["bound_ms"], "bound_by": sk27[0]["bound_by"],
        "library_ms": sk27[0]["library_ms"],
        "matmul_bf16_ms": sk27[0]["matmul_bf16_ms"],
        "ragged_max_abs_err": max(smallk_errs)})

    report["phase10_s"] = time.time() - t10
    print(f"  phase 10 took {report['phase10_s']:.1f} s")

    # ---- phase 11: the in-the-wild pipeline ------------------------------
    report["card_phase11"] = card_state("phase 11")
    print("phase 11: the in-the-wild pipeline (YOLOv3 416, SORT, HRNet-W48 "
          "384x288, the 27f lifter) through gen_skes and realtime")
    t11 = time.time()
    report["pipeline"] = pl = pipeline_phase(K, dev, smi)
    # Every kernel the 27f forward launches ran under gen_skes, and every
    # kernel a 27f push launches under realtime.
    for runs, want in (("gen_skes", report["forwards"]["27f"]
                        ["launches_per_forward"]),
                       ("realtime", report["streaming"]["27f M=1"]
                        ["launches_per_push"])):
        missed = [k for k, v in want.items()
                  if v and not pl[f"{runs}_launches"].get(k)]
        if missed:
            fail(f"phase 11 {runs}: {missed} not launched")
    counters = [c for _, c, _, _ in KERNELS] + [
        " ".join(e["name"].replace("(", "").split(",")[0].split())
        for e in kernels[len(KERNELS):]]  # "gemm_tc default", ...
    for entry, counter in zip(kernels, counters):
        entry["pipeline_launches"] = (
            pl["gen_skes_launches"].get(counter, 0)
            + pl["realtime_launches"].get(counter, 0))
    report["pipeline"]["s"] = time.time() - t11
    print(f"  phase 11 took {report['pipeline']['s']:.1f} s")

    # ---- phase 12: data parallelism, the utilities, example, entry -----
    report["card_phase12"] = card_state("phase 12")
    print("phase 12: data parallelism (one NCCL rank; two gloo ranks "
          "sharing the card), trainval under torch.distributed.run, the "
          "synthetic example, the entry and the ablations")
    t12 = time.time()
    report["dp"] = dp = dp_phase(K, dev, report)
    for entry, counter in zip(kernels, counters):
        entry["dp_launches"] = dp["pair"]["dp_launches"].get(counter, 0)
    report["dp"]["s"] = time.time() - t12
    print(f"  phase 12 took {report['dp']['s']:.1f} s")

    # ---- phase 13: the config surface -----------------------------------
    report["card_phase13"] = card_state("phase 13")
    t13 = time.time()
    report["config"] = config_phase(K, dev)
    for entry in kernels:  # the float32 fold kernel: the "243f fold" cell
        if entry["name"] == "gab_narrow (fold, C=32, T=241)":
            entry["launches"] = report["config"]["cells"]["243f fold"][
                "launches"].get("gab_narrow fold", 0)
    kernels += bf16_kernels(K, dev, n243, report["config"], bf16_errs)
    report["config"]["s"] = time.time() - t13
    print(f"  phase 13 took {report['config']['s']:.1f} s")

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
