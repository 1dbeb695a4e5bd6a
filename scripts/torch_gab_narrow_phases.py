"""Where the time of ``gab_narrow`` goes, phase by phase, on one GPU.

Builds ``gastx_torch/csrc/gab_narrow.cu`` as it is and once more with each
phase cut out (the projection, attention, the semantic graph, the local and
global products, the block concat; and all of them, leaving the loads of x
and the tables), times each build at the level-0 shapes of the 243-frame
model (C=32, T=241, B=256) and the 81-frame model (C=64, T=79, B=1024),
and prints one JSON object: ms per build and shape, the card's name and
power limit. A cut build computes garbage; only its time is read. The
difference between the whole kernel and a cut build is the time that
phase costs, overlap with the other phases included.

    python3 scripts/torch_gab_narrow_phases.py
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "gab_narrow_phases")

# Each cut: (text of the phase in the source, what replaces it).
GEMM1 = ("  block_gemm<RT, 7, false>(", "  if (0) block_gemm<RT, 7, false>(")
ATTN = ("  attention(p, ldp, nf, j, c, nheads, inter, g_ch, pt, pp, ck);\n",
        "")
SEM = ("idx < j * c2; idx += blockDim.x) {", "idx < 0; idx += blockDim.x) {")
LOCAL = ("  block_gemm<RT, CW, true>(\n      Gemm{{p + 4 * c",
         "  if (0) block_gemm<RT, CW, true>(\n      Gemm{{p + 4 * c")
GLOBAL = ("  block_gemm<RT, CW, true>(\n      Gemm{{heads",
          "  if (0) block_gemm<RT, CW, true>(\n      Gemm{{heads")
CONCAT = ("  block_gemm<RT, 2 * CW, true>(",
          "  if (0) block_gemm<RT, 2 * CW, true>(")
CUTS = {
    "whole": [],
    "no projection": [GEMM1],
    "no attention": [ATTN],
    "no sem_graph": [SEM],
    "no local/global products": [LOCAL, GLOBAL],
    "no block concat": [CONCAT],
    "loads only": [GEMM1, ATTN, SEM, LOCAL, GLOBAL, CONCAT],
}


def build(K) -> dict:
    src = open(os.path.join(REPO, "gastx_torch", "csrc",
                            "gab_narrow.cu")).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(CUTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"cut {name!r}: the source no longer holds "
                                 f"{old!r}")
            text = text.replace(old, new)
        cu, lib = os.path.join(OUT, f"v{i}.cu"), os.path.join(OUT, f"v{i}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on cut {name!r}:\n{out}")
        fn = ctypes.CDLL(lib).gab_narrow
        fn.argtypes = K._ARGTYPES["gab_narrow"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from gastx_torch.models import (GastNet, config_for_frames,
                                    init_gastnet, randomize_eval_statistics)
    from gastx_torch.ops.cuda import kernels as K
    from gastx_torch.ops.cuda.fused_gab import gab_tables
    from chip_smoke import cuda_ms

    fns = build(K)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    result = {"card": card, "ms": {}}
    for frames, b, t in ((243, 256, 241), (81, 1024, 79)):
        gen = torch.Generator().manual_seed(frames)
        m = randomize_eval_statistics(
            init_gastnet(GastNet(config_for_frames(frames)), gen), gen)
        m = m.cuda().eval()
        tab = gab_tables(m.layers_graph_conv[0], m.statics)
        c = tab.w_proj.shape[0]
        k, inter = tab.proj_t.shape
        g_ch = (tab.w_proj.shape[1] - 4 * c - 2 * k * inter) // k
        gen = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(b * t * 17, c, generator=gen, device="cuda")
        out = torch.empty(b * t * 17, 2 * c, device="cuda")
        shape = f"C={c}, T={t}, B={b}"
        result["ms"][shape] = {}
        for name, fn in fns.items():
            def call(fn=fn):
                code = fn(x.data_ptr(), out.data_ptr(), b * t, 17, c,
                          tab.col.shape[2], k, inter, g_ch,
                          *(v.data_ptr() for v in tab),
                          torch.cuda.current_stream().cuda_stream)
                if code != 0:
                    raise SystemExit(f"launch failed ({code})")
            result["ms"][shape][name] = cuda_ms(call)
            print(f"{shape} {name}: {result['ms'][shape][name]:.3f} ms",
                  flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
