"""Compare the machine code (SASS) of a kernel source in two checkouts.

    python3 scripts/torch_sass_diff.py TREE_A TREE_B [--source gemm_tc]
        [--flags=-DGASTX_BF16_IO [--flags=-DGASTX_TIERED_FORM]]
        [--match hopper]

Compiles ``gastx_torch/csrc/<source>.cu`` of each tree to a cubin with the
port's ``nvcc`` flags (``kernels.NVCC_FLAGS`` of this checkout, without
``-shared``; each ``--flags=`` adds one more, e.g. the bf16-I/O
library's; the ``=`` keeps argparse from reading ``-D`` as an option), dumps
each kernel's SASS with ``cuobjdump -sass`` and compares the kernels whose
name holds ``--match`` (default: every kernel), paired by their name with
the anonymous namespace's tag removed (its trailing hash too, which
differs between a kernel instantiated inside the namespace and one
instantiated from a function outside it). Instruction addresses and
encodings are dropped; every other difference counts. Prints, per kernel,
its instruction count in each tree and the lines that differ (the first 40),
then one JSON object; exit 0 when every compared kernel is identical, 1
otherwise. Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), not a GPU.
"""
from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernels_sass(tree: str, source: str, flags, workdir: str) -> dict:
    """{kernel name without its file tag: [instructions]} of ``source``."""
    sys.path.insert(0, REPO)
    from gastx_torch.ops.cuda import kernels as K

    nvcc = K._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    cubin = os.path.join(workdir, f"{abs(hash(tree))}.cubin")
    base = [f for f in K.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                 "-fPIC", "-Xptxas", "-v")]
    subprocess.run([nvcc, *base, *flags, "-cubin", "-o", cubin,
                    os.path.join(tree, "gastx_torch", "csrc",
                                 f"{source}.cu")], check=True)
    dump = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+",
                         "ANON_", m.group(1))
            funcs[cur] = []
            continue
        if cur and "/*" in line:
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", line)
            ins = " ".join(ins.split())
            if ins:
                funcs[cur].append(ins)
    return funcs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs=2)
    ap.add_argument("--source", default="gemm_tc")
    ap.add_argument("--flags", action="append", default=[])
    ap.add_argument("--match", default="")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        a, b = (kernels_sass(os.path.abspath(t), args.source, args.flags,
                             tmp) for t in args.trees)
    result = {}
    for name in sorted(set(a) | set(b)):
        if args.match not in name:
            continue
        x, y = a.get(name, []), b.get(name, [])
        diff = [ln for ln in difflib.unified_diff(x, y, lineterm="", n=0)
                if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
        result[name] = {"instructions": [len(x), len(y)],
                        "diff_lines": len(diff)}
        print(f"{name}: {len(x)} / {len(y)} instructions, {len(diff)} lines "
              f"differ")
        for ln in diff[:40]:
            print(f"    {ln}")
    same = bool(result) and all(r["diff_lines"] == 0 for r in result.values())
    print(json.dumps({"source": args.source, "flags": args.flags,
                      "identical": same, "kernels": result}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
