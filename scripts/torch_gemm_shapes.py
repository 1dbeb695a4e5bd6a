"""Time ``gemm_epilogue`` (float32, the ``"highest"`` tier) at its
main-path products on one GPU, beside each product's bound and one
``torch.addmm`` over the same product.

The per-shape table (``gemm_table``: every ``chip_smoke.GEMM_SHAPES``
line, the 15 launches of a 27f B=1024 forward and four 243f B=256 chain
products, each held to its plain version, with its ms, TFLOP/s, bound,
instantiation and the ``torch.addmm`` yardstick); it was
``chip_smoke.py`` phase 4's until the script moved its one-off
measurements here:

    python3 scripts/torch_gemm_shapes.py

Prints one JSON object (the rows, the card's name and power limit) and
writes it to ``chiprun_out/gemm_shapes.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def gemm_table(K, dev) -> list:
    """The per-shape table: ``gemm_epilogue`` at each
    ``chip_smoke.GEMM_SHAPES`` line, held to its plain version, beside its
    bound and one ``torch.addmm`` over the same product."""
    import torch

    import chip_smoke as cs

    print("gemm_epilogue by shape (ms, TFLOP/s of the product)")
    rows = []
    for i, spec in enumerate(cs.GEMM_SHAPES):
        label, _, _, ks, n, _, taps, _ = spec
        pieces, m, kw = cs.gemm_case(spec, dev, seed=100 + i)
        variant = K.gemm_variant(pieces, n, kw["res"])
        err = cs.check(label, K.gemm_epilogue(pieces, m, **kw),
                       K.gemm_epilogue_plain(pieces, m, **kw))
        ms = cs.cuda_ms(lambda: K.gemm_epilogue(pieces, m, **kw))
        a_cat, w_cat = cs.gemm_library_operands(pieces, m, kw)
        library_ms = cs.cuda_ms(
            lambda: torch.addmm(kw["shift"], a_cat, w_cat))
        del a_cat, w_cat
        # Bytes: each input once (a conv's taps share one input).
        a_elems = (pieces[0][0].numel() if taps
                   else sum(a.numel() for a, _, _ in pieces))
        flops, nbytes = cs.gemm_work(m, ks, n, 1, kw["res"] is not None)
        nbytes += 4 * (a_elems - m * sum(ks))
        bms, by = cs.bound(flops, nbytes)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from gastx_torch.ops.cuda import kernels as K

    K.build_kernels()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    result = {"card": card,
              "rows": gemm_table(K, torch.device("cuda"))}
    path = os.path.join(REPO, "chiprun_out", "gemm_shapes.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
