"""Dataset preparation CLI (offline converters): the port of
``gastx.cli.prepare_data``, with its flags. It runs on the host and
writes its npz files into the working directory.

Subcommand surface covering the four reference data/ scripts::

    python -m gastx_torch.cli.prepare_data h36m --from-archive h36m.zip
    python -m gastx_torch.cli.prepare_data h36m --from-source /path/to/h36m
    python -m gastx_torch.cli.prepare_data 2d_sh --pt sh_pt_mpii.tar.gz
    python -m gastx_torch.cli.prepare_data 2d_generic -i detections/ -o cpn_ft_h36m_dbb
    python -m gastx_torch.cli.prepare_data humaneva -p /path/to/humaneva \
        --convert-3d --convert-2d detections/ -o detectron_pt_coco
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description="gastx_torch dataset preparation")
    sub = parser.add_subparsers(dest="command", required=True)

    p_h36m = sub.add_parser("h36m", help="Human3.6M 3D + GT 2D")
    p_h36m.add_argument("--from-archive", default="", type=str)
    p_h36m.add_argument("--from-source", default="", type=str)

    p_sh = sub.add_parser("2d_sh", help="Stacked-Hourglass 2D detections")
    p_sh.add_argument("--pt", default="", type=str,
                      help="pretrained-MPII archive")
    p_sh.add_argument("--ft", default="", type=str,
                      help="fine-tuned-H36M archive")

    p_gen = sub.add_parser("2d_generic", help="generic npz 2D detections")
    p_gen.add_argument("-i", "--input", required=True, type=str)
    p_gen.add_argument("-o", "--output", required=True, type=str,
                       help="output suffix (e.g. cpn_ft_h36m_dbb)")

    p_he = sub.add_parser("humaneva", help="HumanEva-I converter")
    p_he.add_argument("-p", "--path", default="", type=str)
    p_he.add_argument("--convert-3d", action="store_true")
    p_he.add_argument("--convert-2d", default="", type=str)
    p_he.add_argument("-o", "--output", default="", type=str)

    args = parser.parse_args(argv)

    if args.command == "h36m":
        from gastx_torch.data.prepare import compute_h36m_gt_2d, prepare_h36m_3d
        out = prepare_h36m_3d(args.from_archive or None,
                              args.from_source or None)
        compute_h36m_gt_2d(out)
    elif args.command == "2d_sh":
        from gastx_torch.data.prepare import prepare_2d_sh
        prepare_2d_sh(args.pt or None, args.ft or None)
    elif args.command == "2d_generic":
        from gastx_torch.data.prepare import prepare_2d_generic
        prepare_2d_generic(args.input, args.output)
    elif args.command == "humaneva":
        from gastx_torch.data.prepare_humaneva import (
            prepare_humaneva_2d, prepare_humaneva_3d)
        mapping = None
        if args.convert_3d:
            if not args.path:
                parser.error("--path required for --convert-3d")
            _, mapping = prepare_humaneva_3d(args.path)
        if args.convert_2d:
            if not args.output:
                parser.error("-o/--output suffix required")
            prepare_humaneva_2d(args.convert_2d, args.output, mapping)
    print("Done.")


if __name__ == "__main__":
    main(sys.argv[1:])
