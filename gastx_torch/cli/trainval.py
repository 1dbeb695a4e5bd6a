"""Train and evaluate GastNet on Human3.6M / HumanEva, on the GPU.

The port of ``gastx.cli.trainval`` (the reference's ``trainval.py``): an
epoch loop of amsgrad train steps with a x``lr_decay`` per-epoch learning
rate, per-epoch validation and train-eval MPJPE, a checkpoint of the best
valid MPJPE under 49.5 mm and periodic ones that resume (epoch, lr,
optimizer, batcher RNG), and the final action-wise Protocol #1/#2
evaluation with flip TTA, by subject with ``--by-subject``, or with
``--render`` the lift of one video (``--viz-*``) exported and rendered::

    python -m gastx_torch.cli.trainval -e 80 -k cpn_ft_h36m_dbb -arc 3,3,3 -b 128
    python -m gastx_torch.cli.trainval -k cpn_ft_h36m_dbb --evaluate epoch_best.pt

It runs on ``cuda`` unless ``--device`` names another device, on one
device, or data-parallel over the ranks of ``python -m
torch.distributed.run --nproc_per_node N -m gastx_torch.cli.trainval``
(the JAX trainval's mesh): NCCL where each rank has a card of its own,
gloo where ranks share a card or run on the CPU
(``gastx_torch.parallel``). Every rank runs the same seeded batcher; each
batch is padded to a multiple of the ranks with zero-weight rows and
each rank steps on its rows through DDP, with the global batch's BN
statistics and dropout masks, so that N ranks compute the one-process
step. Every rank evaluates; only rank 0 prints, logs and writes
checkpoints (the bare module's state, which a one-process run loads).
Training takes the strided variant for ``--stride 1`` (else the dilated
one), through the plain ops with autograd, each site's products and
their gradients at the ``--matmul-precision`` tier on the GPU (the GEMM
kernels and ``gemm_wgrad``; ``gastx_torch.models.gastnet``), as the JAX
trainval trains; every evaluation pass runs ``lift_sequences`` on the
model in eval mode, on the hand-written kernels at the same tier
(:func:`build_config`).
``--profile-dir`` writes a ``torch.profiler`` trace of the first epoch,
each step under a ``train_step`` range.
Batches have one fixed size: a ragged last batch is padded with
zero-weight copies of its last row. Each step draws its dropout masks
from a generator seeded by (epoch, batch index), so a resume needs no
RNG state beyond the batcher's. Checkpoints are the port's own
(``gastx_torch.train.checkpoint``, ``.pt``); ``--evaluate`` and
``--resume`` also take the JAX package's ``.ckpt``
(``gastx_torch.io.load_jax_checkpoint``: weights, and for a resume the
epoch, lr, amsgrad moments and batcher RNG), and ``--evaluate`` an
upstream ``.bin``. ``--render`` lifts on the device and renders on the
host (matplotlib; it raises where matplotlib is missing).
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from gastx_torch.cli.arguments import parse_args
from gastx_torch.data.generators import ChunkedBatcher
from gastx_torch.data.harness import fetch, group_actions_by_name, load_data
from gastx_torch.data.prefetch import prefetch_to_device, stage
from gastx_torch.device import resolve_device
from gastx_torch.eval.protocol import evaluate_sequences, run_evaluation
from gastx_torch.geometry import camera_to_world, image_coordinates
from gastx_torch.infer import lift_sequences
from gastx_torch.io import (adam_state_dict, load_jax_checkpoint,
                            load_torch_checkpoint)
from gastx_torch.models import GastNetConfig, build_gastnet
from gastx_torch.models.config import TPU_MIXED_PRECISION_OVERRIDES
from gastx_torch.parallel import (init_distributed, make_mesh, replicate,
                                  shard_batch)
from gastx_torch.train import (load_checkpoint, make_optimizer,
                               restore_batcher_random_state, save_checkpoint,
                               train_step)
from gastx_torch.utils import (MetricLogger, capture_trace,
                               export_training_curves, trace)

LAYOUTS = {17: "h36m17", 16: "sh16", 15: "humaneva15", 19: "h36m19"}
# The reference's acceptance bar: a best checkpoint is kept only under it.
BEST_BAR_MM = 49.5


def build_config(args, dataset, in_features: int = 2) -> GastNetConfig:
    """``in_features`` follows the 2D data's channel count: 2 for plain
    keypoints, 3 when the detections carry confidence scores.
    ``--matmul-precision`` maps onto (matmul_precision, precision_overrides)
    as the JAX ``build_config`` maps it: ``mixed`` is ``"high"`` with
    ``TPU_MIXED_PRECISION_OVERRIDES``, the others the tier alone. On the
    GPU the train steps' site products and the eval passes' kernels run
    it; on the CPU every product is float32."""
    num_joints = dataset.skeleton().num_joints()
    tier = getattr(args, "matmul_precision", "high")
    if tier == "mixed":
        precision, overrides = "high", TPU_MIXED_PRECISION_OVERRIDES
    else:
        precision, overrides = tier, ()
    return GastNetConfig(
        num_joints_in=num_joints, in_features=in_features,
        num_joints_out=num_joints,
        filter_widths=tuple(int(x) for x in args.architecture.split(",")),
        channels=args.channels, dropout=args.dropout, causal=args.causal,
        layout=LAYOUTS[num_joints], matmul_precision=precision,
        precision_overrides=overrides)


def step_seed(epoch: int, batch_index: int) -> int:
    """The dropout generator's seed of one train step."""
    return (epoch << 32) + batch_index


def main(argv=None):
    """Train and evaluate as the flags say; returns the (bare) model. Under
    ``torch.distributed.run`` (``WORLD_SIZE`` set) it joins the process
    group and leaves it at the end; ranks other than 0 print nothing."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if "WORLD_SIZE" not in os.environ:
        return run(args, device, None)
    init_distributed(device=device)
    try:
        world = dist.get_world_size()
        mesh = make_mesh(None if device.type == "cuda" else [device] * world)
        with contextlib.ExitStack() as stack:
            if mesh.rank:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            return run(args, mesh.device, mesh)
    finally:
        dist.destroy_process_group()


def run(args, device, mesh):
    """:func:`main` on ``device``, over ``mesh``'s ranks (None: one
    process)."""
    print(args)
    main_rank = mesh is None or mesh.rank == 0
    os.makedirs(args.checkpoint, exist_ok=True)

    (keypoints, dataset, keypoints_metadata, kps_left, kps_right,
     joints_left, joints_right) = load_data(args.dataset, args.keypoints,
                                            args.data_dir)

    subjects_train = args.subjects_train.split(",")
    subjects_test = ([args.viz_subject] if args.render
                     else args.subjects_test.split(","))
    action_filter = None if args.actions == "*" else args.actions.split(",")
    if action_filter is not None:
        print("Selected actions:", action_filter)

    _, poses_valid, poses_valid_2d = fetch(
        subjects_test, action_filter, dataset, keypoints, args.downsample)

    cfg = build_config(args, dataset, in_features=poses_valid_2d[0].shape[-1])
    rf = cfg.receptive_field()
    pad = (rf - 1) // 2
    print(f"INFO: Receptive field: {rf} frames")
    if args.causal:
        print("INFO: Using causal convolutions")

    model = build_gastnet(cfg, seed=0, device=device)
    print("INFO: Trainable parameter count:",
          sum(p.numel() for p in model.parameters()))
    print(f"INFO: running on {device}")

    # The strided variant trains stride-1 chunks without waste; the
    # dilated one otherwise.
    train_variant = ("strided" if args.stride == 1
                     and not args.disable_optimizations else "dilated")

    epoch = 0
    lr = args.learning_rate
    batcher_rng = None
    opt_state = None
    jax_ckpt = False
    if args.resume or args.evaluate:
        path = os.path.join(args.checkpoint, args.resume or args.evaluate)
        print("Loading checkpoint", path)
        if path.endswith(".bin"):
            model.load_state_dict(load_torch_checkpoint(path), strict=True)
        else:
            jax_ckpt = path.endswith(".ckpt")
            blob = (load_jax_checkpoint(path, cfg) if jax_ckpt
                    else load_checkpoint(path))
            model.load_state_dict(blob["model"], strict=True)
            if args.resume:
                epoch, lr = blob["epoch"], blob["lr"]
                opt_state = blob["optimizer"]
                batcher_rng = restore_batcher_random_state(blob)

    if not args.evaluate:
        cameras_train, poses_train, poses_train_2d = fetch(
            subjects_train, action_filter, dataset, keypoints,
            args.downsample, subset=args.subset)
        full_batch = args.batch_size // args.stride
        train_batcher = ChunkedBatcher(
            full_batch, cameras_train, poses_train, poses_train_2d,
            args.stride, pad=pad, causal_shift=pad if args.causal else 0,
            shuffle=True, augment=args.data_augmentation, kps_left=kps_left,
            kps_right=kps_right, joints_left=joints_left,
            joints_right=joints_right)
        if batcher_rng is not None:
            train_batcher.set_random_state(batcher_rng)
        print(f"INFO: Training on {train_batcher.num_frames()} frames")

        # The DDP wrapper steps; the bare model evaluates and is saved.
        stepped = model if mesh is None else replicate(mesh, model)
        opt = make_optimizer(model.parameters(), lr)
        if opt_state is not None:
            if jax_ckpt:  # the amsgrad moments by parameter name
                opt_state = adam_state_dict(opt_state, model, opt)
            opt.load_state_dict(opt_state)
        generator = torch.Generator(device=device)
        metric_log = MetricLogger(args.log_file if main_rank
                                  and args.log_file else None)
        losses_train, losses_train_eval, losses_valid = [], [], []
        loss_min = BEST_BAR_MM
        # One fixed batch shape: full_batch rounded up to the ranks, so
        # that shard_batch never adds weight-1 duplicates.
        ranks = 1 if mesh is None else mesh.size
        padded_batch = -(-full_batch // ranks) * ranks

        def prepare(batch):
            """Pad a ragged batch with zero-weight filler rows; stage it
            (this rank's rows under a mesh)."""
            _, batch_3d, batch_2d = batch
            b = batch_2d.shape[0]
            weights = np.zeros(padded_batch, np.float32)
            weights[:b] = 1.0
            if b < padded_batch:
                reps = padded_batch - b
                batch_2d = np.concatenate(
                    [batch_2d, np.repeat(batch_2d[-1:], reps, 0)])
                batch_3d = np.concatenate(
                    [batch_3d, np.repeat(batch_3d[-1:], reps, 0)])
            arrays = (batch_2d.astype(np.float32),
                      batch_3d.astype(np.float32), weights)
            if mesh is not None:
                return (*shard_batch(mesh, *arrays)[0], b)
            return (*(stage(a, device) for a in arrays), b)

        while epoch < args.epochs:
            start_time = time.time()
            loss_sum = torch.zeros((), dtype=torch.float64, device=device)
            n_frames = 0
            profile_dir = (args.profile_dir or None) if epoch == 0 else None
            with capture_trace(profile_dir):
                for bi, (b2, b3, w, b) in enumerate(prefetch_to_device(
                        train_batcher.next_epoch(), prepare)):
                    generator.manual_seed(step_seed(epoch, bi))
                    with trace("train_step"):
                        loss = train_step(stepped, opt, b2, b3, w, lr,
                                          generator, train_variant,
                                          mesh=mesh, weight_sum=float(b))
                    frames = b * args.stride
                    loss_sum += loss * frames
                    n_frames += frames
            losses_train.append(loss_sum.item() / n_frames)
            train_s = time.time() - start_time

            if not args.no_eval:
                e_valid, _ = evaluate_sequences(
                    model, poses_valid_2d, poses_valid, tta=False,
                    compute_p2=False)
                e_train, _ = evaluate_sequences(
                    model, poses_train_2d, poses_train, tta=False,
                    compute_p2=False)
                losses_valid.append(e_valid / 1000)
                losses_train_eval.append(e_train / 1000)

            elapsed = (time.time() - start_time) / 60
            metric_log.log(
                epoch + 1, lr=lr, epoch_minutes=round(elapsed, 3),
                train_s=train_s, train_frames=n_frames,
                train_mpjpe_mm=losses_train[-1] * 1000,
                train_eval_mpjpe_mm=(losses_train_eval[-1] * 1000
                                     if losses_train_eval else None),
                valid_mpjpe_mm=(losses_valid[-1] * 1000
                                if losses_valid else None))
            if args.no_eval:
                print(f"[{epoch + 1}] time {elapsed:.2f} lr {lr:f} "
                      f"3d_train {losses_train[-1] * 1000:f}")
            else:
                print(f"[{epoch + 1}] time {elapsed:.2f} lr {lr:f} "
                      f"3d_train {losses_train[-1] * 1000:f} "
                      f"3d_eval {losses_train_eval[-1] * 1000:f} "
                      f"3d_valid {losses_valid[-1] * 1000:f}")
                if losses_valid[-1] * 1000 < loss_min:
                    chk_path = os.path.join(args.checkpoint, "epoch_best.pt")
                    print("Saving checkpoint to", chk_path)
                    if main_rank:
                        save_checkpoint(
                            chk_path, epoch=epoch, lr=lr, model=model,
                            optimizer=opt,
                            batcher_random_state=train_batcher.random_state())
                    loss_min = losses_valid[-1] * 1000

            lr *= args.lr_decay
            epoch += 1

            if epoch % args.checkpoint_frequency == 0:
                chk_path = os.path.join(args.checkpoint, f"epoch_{epoch}.pt")
                print("Saving checkpoint to", chk_path)
                if main_rank:
                    save_checkpoint(
                        chk_path, epoch=epoch, lr=lr, model=model,
                        optimizer=opt,
                        batcher_random_state=train_batcher.random_state())

            if args.export_training_curves and epoch > 3 and main_rank:
                export_training_curves(
                    os.path.join(args.checkpoint, "loss_3d.png"),
                    losses_train, losses_train_eval, losses_valid)

    if args.render:
        if main_rank:
            render(args, model, keypoints, dataset, keypoints_metadata,
                   (kps_left, kps_right))
        return model

    print("Evaluating...")
    all_actions, by_subject = group_actions_by_name(dataset, subjects_test)
    kw = dict(downsample=args.downsample, tta=args.test_time_augmentation,
              action_filter=action_filter, kps_lr=(kps_left, kps_right))
    if not args.by_subject:
        run_evaluation(model, all_actions, dataset, keypoints, **kw)
    else:
        for subject in by_subject:
            print("Evaluating on subject", subject)
            run_evaluation(model, by_subject[subject], dataset, keypoints,
                           **kw)
            print("")
    return model


def render(args, model, keypoints, dataset, keypoints_metadata, kps_lr):
    """``--render``: lift the ``--viz-*`` video's 2D keypoints on the
    model's device (flip TTA unless ``-no-tta``), save them with
    ``--viz-export``, and with ``--viz-output`` render them beside the
    ground truth in world coordinates (the JAX ``--render`` branch)."""
    print("Rendering...")
    subject, action, camera = (args.viz_subject, args.viz_action,
                               args.viz_camera)
    input_keypoints = keypoints[subject][action][camera].copy()
    ground_truth = None
    if subject in dataset.subjects() and action in dataset[subject]:
        if "positions_3d" in dataset[subject][action]:
            ground_truth = dataset[subject][action]["positions_3d"][
                camera].copy()
    if ground_truth is None:
        print("INFO: this action is unlabeled. Ground truth will not be "
              "rendered.")

    # The detections' full channel count (2, or 3 with confidence).
    prediction = lift_sequences(model, [input_keypoints],
                                tta=args.test_time_augmentation,
                                kps_lr=kps_lr)[0]
    if args.viz_export is not None:
        print("Exporting joint positions to", args.viz_export)
        np.save(args.viz_export, prediction)
    if args.viz_output is None:
        return

    def to_world(x, rot, t):  # on the host
        return camera_to_world(torch.from_numpy(x), rot, t).numpy()

    cam = dataset.cameras()[subject][camera]
    if ground_truth is not None:
        trajectory = ground_truth[:, :1]
        ground_truth[:, 1:] += trajectory
        prediction += trajectory
        prediction = to_world(prediction, cam["orientation"],
                              cam["translation"])
        ground_truth = to_world(ground_truth, cam["orientation"],
                                cam["translation"])
    else:
        rot = next(c[camera]["orientation"]
                   for c in dataset.cameras().values()
                   if "orientation" in c[camera])
        prediction = to_world(prediction, rot, 0.0)
        prediction[:, :, 2] -= np.min(prediction[:, :, 2])

    anim_output = {"Reconstruction": prediction}
    if ground_truth is not None and not args.viz_no_ground_truth:
        anim_output["Ground truth"] = ground_truth
    input_keypoints = image_coordinates(input_keypoints[..., :2],
                                        w=cam["res_w"], h=cam["res_h"])

    from gastx_torch.viz import render_animation
    render_animation(
        input_keypoints, keypoints_metadata, anim_output, dataset.skeleton(),
        dataset.fps(), args.viz_bitrate, cam["azimuth"], args.viz_output,
        limit=args.viz_limit, downsample=args.viz_downsample,
        size=args.viz_size, input_video_path=args.viz_video,
        viewport=(cam["res_w"], cam["res_h"]),
        input_video_skip=args.viz_skip)


if __name__ == "__main__":
    main(sys.argv[1:])
