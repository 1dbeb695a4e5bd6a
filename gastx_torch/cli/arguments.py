"""CLI argument surface of ``gastx_torch.cli.trainval``.

The flags, defaults and invalid-combination checks of
``gastx.cli.arguments`` (the reference's ``common/arguments.py``), so
reference invocations work unchanged, plus ``--device`` (default
``cuda``).
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="gastx_torch train/eval")

    # General arguments
    parser.add_argument("-d", "--dataset", default="h36m", type=str,
                        metavar="NAME", help="target dataset (h36m/humaneva*)")
    parser.add_argument("-k", "--keypoints", default="cpn_ft_h36m_dbb",
                        type=str, metavar="NAME", help="2D detections to use")
    parser.add_argument("-str", "--subjects-train", default="S1,S5,S6,S7,S8",
                        type=str, metavar="LIST",
                        help="training subjects separated by comma")
    parser.add_argument("-ste", "--subjects-test", default="S9,S11", type=str,
                        metavar="LIST", help="test subjects")
    parser.add_argument("-a", "--actions", default="*", type=str,
                        metavar="LIST",
                        help="actions to train/test on, or * for all")
    parser.add_argument("-c", "--checkpoint", default="checkpoint", type=str,
                        metavar="PATH", help="checkpoint directory")
    parser.add_argument("--checkpoint-frequency", default=10, type=int,
                        metavar="N", help="create a checkpoint every N epochs")
    parser.add_argument("-r", "--resume", default="", type=str,
                        metavar="FILENAME", help="checkpoint to resume")
    parser.add_argument("--evaluate", default="", type=str,
                        metavar="FILENAME", help="checkpoint to evaluate")
    parser.add_argument("--render", action="store_true",
                        help="visualize a particular video")
    parser.add_argument("--by-subject", action="store_true",
                        help="break down error by subject (on evaluation)")
    parser.add_argument("--export-training-curves", action="store_true",
                        help="save training curves as .png images")

    # Model arguments
    parser.add_argument("-s", "--stride", default=1, type=int, metavar="N",
                        help="chunk size to use during training")
    parser.add_argument("-arc", "--architecture", default="3,3,3", type=str,
                        metavar="LAYERS", help="filter widths, comma-separated")
    parser.add_argument("--causal", action="store_true",
                        help="use causal convolutions (real-time)")
    parser.add_argument("-ch", "--channels", default=128, type=int,
                        metavar="N", help="conv channels")
    # The JAX package's matmul tier knob (trainval.build_config maps it).
    parser.add_argument("--matmul-precision", default="high", type=str,
                        choices=("high", "mixed", "default"),
                        metavar="TIER",
                        help="matmul precision tier of the whole "
                        "train/eval stack on the GPU (the train steps' "
                        "products and their gradients, and the eval "
                        "passes' kernels): 'high' (3 bf16 passes), "
                        "'mixed' (high with the TPU mixed preset) or "
                        "'default' (1 bf16 pass); every pass on the CPU "
                        "computes float32")

    # Experimental settings
    parser.add_argument("-e", "--epochs", default=60, type=int, metavar="N",
                        help="number of training epochs")
    parser.add_argument("-b", "--batch-size", default=128, type=int,
                        metavar="N", help="batch size in predicted frames")
    parser.add_argument("-drop", "--dropout", default=0.05, type=float,
                        metavar="P", help="dropout probability")
    parser.add_argument("-lr", "--learning-rate", default=0.001, type=float,
                        metavar="LR", help="initial learning rate")
    parser.add_argument("-lrd", "--lr-decay", default=0.95, type=float,
                        metavar="LR", help="learning rate decay per epoch")
    parser.add_argument("-no-da", "--no-data-augmentation",
                        dest="data_augmentation", action="store_false",
                        help="disable train-time flipping")
    parser.add_argument("-no-tta", "--no-test-time-augmentation",
                        dest="test_time_augmentation", action="store_false",
                        help="disable test-time flipping")
    parser.add_argument("--subset", default=1, type=float, metavar="FRACTION",
                        help="reduce dataset size by fraction")
    parser.add_argument("--downsample", default=5, type=int, metavar="FACTOR",
                        help="downsample frame rate by factor")
    parser.add_argument("--no-eval", action="store_true",
                        help="disable epoch evaluation while training")
    parser.add_argument("--disable-optimizations", action="store_true",
                        help="disable the strided single-frame train model")
    parser.add_argument("--data-dir", default="data", type=str,
                        metavar="PATH", help="directory with data npz files")
    parser.add_argument("--log-file", default="", type=str, metavar="PATH",
                        help="JSONL per-epoch metric log (gastx extension)")
    parser.add_argument("--profile-dir", default="", type=str, metavar="PATH",
                        help="profiler trace of the first training epoch")
    parser.add_argument("--device", default=None, type=str, metavar="DEV",
                        help="torch device (default: cuda)")

    # Visualization
    parser.add_argument("--viz-subject", type=str, metavar="STR")
    parser.add_argument("--viz-action", type=str, metavar="STR")
    parser.add_argument("--viz-camera", type=int, default=0, metavar="N")
    parser.add_argument("--viz-video", type=str, metavar="PATH")
    parser.add_argument("--viz-skip", type=int, default=0, metavar="N")
    parser.add_argument("--viz-output", type=str, metavar="PATH")
    parser.add_argument("--viz-export", type=str, metavar="PATH")
    parser.add_argument("--viz-bitrate", type=int, default=3000, metavar="N")
    parser.add_argument("--viz-no-ground-truth", action="store_true")
    parser.add_argument("--viz-limit", type=int, default=-1, metavar="N")
    parser.add_argument("--viz-downsample", type=int, default=1, metavar="N")
    parser.add_argument("--viz-size", type=int, default=5, metavar="N")

    parser.set_defaults(bone_length_term=True, data_augmentation=True,
                        test_time_augmentation=True)

    args = parser.parse_args(argv)

    if args.resume and args.evaluate:
        parser.error("--resume and --evaluate cannot be set at the same time")
    if args.export_training_curves and args.no_eval:
        parser.error("--export-training-curves and --no-eval cannot be set "
                     "at the same time")
    return args
