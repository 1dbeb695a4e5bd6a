"""Asynchronous host->device input prefetching (parity target:
``gastx.data.prefetch``).

A background thread assembles the next host batch (the vectorized gathers
of ``ChunkedBatcher``) and stages it on the device while the current
step runs: :func:`stage` copies each array through a pinned host buffer
with a non-blocking ``.to(device)``, enqueued on the thread's current
stream ahead of the step that reads it. The contract is the JAX
package's: batches arrive in order, producer and consumer overlap, an
exception in the producer is raised at the consumer, and a consumer that
stops early stops the producer.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch


class _Stop:
    pass


def stage(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """``array`` on ``device``: through a pinned host copy and a
    non-blocking copy on CUDA, as a CPU tensor otherwise."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def prefetch_to_device(iterator: Iterator, transform: Callable,
                       depth: int = 2) -> Iterator:
    """Wrap a host batch iterator; ``transform`` maps a host batch to device
    tensors (padding, then :func:`stage`). Batches are transformed in a
    background thread, ``depth`` deep, in order.

    Exceptions in the producer are re-raised at the consumer. If the
    consumer abandons the generator early (break / exception in the train
    step), GeneratorExit unblocks and stops the producer so neither the
    thread nor its staged device batches leak.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        """put() that gives up when the consumer has gone away."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not _put(transform(item)):
                    return
                if stop.is_set():
                    return
        except BaseException as exc:  # propagate to consumer
            if not _put(exc):
                # Consumer already gone: surface the failure somewhere —
                # it may be a real data bug that raced with the shutdown.
                import warnings
                warnings.warn(
                    f"prefetch producer failed after consumer shutdown: "
                    f"{exc!r}")
            return
        _put(_Stop())

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()

    try:
        while True:
            item = q.get()
            if isinstance(item, _Stop):
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # Drain anything the producer parked so it can observe `stop`.
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        # _put waits are bounded to 0.1s, so the only long block is a
        # transform() in flight: don't stall the consumer for it, but
        # don't claim the leak is closed either.
        thread.join(timeout=5.0)
        if thread.is_alive():
            import warnings
            warnings.warn(
                "prefetch producer still inside transform() after 5s; "
                "the daemon thread will exit after the current batch",
                RuntimeWarning, stacklevel=2)
