"""Profiling and benchmarking (the counterpart of ``gastx.utils.profiling``).

Named ranges around train and eval steps, trace capture for TensorBoard
or Perfetto, a steady-state throughput timer and a FLOP count, through
``torch.profiler`` and, on the card, NVTX. Kernel launches return before
the device finishes, so :func:`benchmark` synchronises the device after
every call.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(name: str):
    """Annotate a region so that it shows up named in profiler timelines:
    a ``record_function`` range, and an NVTX range where there is a
    card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def capture_trace(log_dir: Optional[str]):
    """Profile the block (CPU, and the card where there is one) and write
    a Chrome/TensorBoard trace (``*.pt.trace.json``) into ``log_dir`` when
    it ends; a no-op for None. Yields the profiler (or None)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _sync(out) -> None:
    """Wait for the device that computed ``out`` (its first tensor)."""
    leaves = out if isinstance(out, (list, tuple)) else [out]
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            return


def benchmark(fn: Callable, *args, iters: int = 20, warmup: int = 2,
              items_per_call: int = 1) -> Dict[str, float]:
    """Steady-state throughput of ``fn(*args)``: {"mean_ms", "p50_ms",
    "p90_ms", "items_per_s"} on the host clock, the device synchronised
    after every call."""
    for _ in range(warmup):
        _sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    times = np.array(times)
    return {
        "mean_ms": float(times.mean() * 1e3),
        "p50_ms": float(np.percentile(times, 50) * 1e3),
        "p90_ms": float(np.percentile(times, 90) * 1e3),
        "items_per_s": float(items_per_call / times.mean()),
    }


def flops_estimate(fn: Callable, *args) -> Optional[float]:
    """FLOPs of one call of ``fn(*args)`` by
    ``torch.utils.flop_counter.FlopCounterMode`` (None if counting
    fails). It counts the PyTorch operators it sees: the hand-written
    kernels launch through ``ctypes`` and count zero, so a model's count
    is taken on ``GastNet.plain_route_forward``, the same function through
    the plain versions."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args)
        return float(counter.get_total_flops())
    except Exception:  # the JAX counterpart's contract: None on failure
        return None
