"""Training metrics logging (a copy of ``gastx.utils.logging``): a JSONL
logger of one record per epoch, and the training-curve PNG export.

matplotlib is imported only by :func:`export_training_curves`; where it is
not installed, that function raises a ``RuntimeError`` that says so.
"""
from __future__ import annotations

import json
import time
from typing import Dict, Optional


class MetricLogger:
    """Append-only JSONL metric log; one record per call."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._t0 = time.time()

    def log(self, step: int, **metrics) -> Dict:
        record = {"step": step, "wall_s": round(time.time() - self._t0, 3)}
        record.update({k: (float(v) if hasattr(v, "__float__") else v)
                       for k, v in metrics.items()})
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        return record


def export_training_curves(path: str, losses_train, losses_train_eval,
                           losses_valid) -> None:
    """Training-curve PNG export (epochs 4 onwards)."""
    try:
        import matplotlib
    except ImportError as exc:
        raise RuntimeError(
            "--export-training-curves needs matplotlib, which is not "
            "installed here") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    plt.figure()
    epoch_x = np.arange(3, len(losses_train)) + 1
    plt.plot(epoch_x, losses_train[3:], "--", color="C0")
    plt.plot(epoch_x, losses_train_eval[3:], color="C0")
    plt.plot(epoch_x, losses_valid[3:], color="C1")
    plt.legend(["3d train", "3d train (eval)", "3d valid (eval)"])
    plt.ylabel("MPJPE (m)")
    plt.xlabel("Epoch")
    plt.xlim((3, len(losses_train)))
    plt.savefig(path)
    plt.close("all")
