"""Real-time causal lifting of streaming keypoints.

Parity target: ``gastx.infer.streaming``. A window of the last
receptive-field frames per person lives on the model's device; each
:meth:`StreamingLifter.push` shifts it by one frame and runs one strided
forward (``GastNet.forward(window, variant="strided")``: rf frames in, one
frame out), so the history never returns to the host.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gastx_torch.models.gastnet import GastNet


class StreamingLifter:
    """Push normalized 2D keypoints frame by frame, get 3D poses back.

    ``model`` must be causal: a non-causal model needs frames that have not
    arrived yet, and raises ``ValueError`` here (the JAX package asserts).
    The lifter runs on the model's device, whatever that is; axis 0 of the
    window is ``num_person`` independent streams.
    """

    def __init__(self, model: GastNet, num_person: int = 1):
        if not model.cfg.causal:
            raise ValueError("streaming inference requires a causal model")
        self.model = model
        self.num_person = num_person
        self.device = next(model.parameters()).device
        self._window: Optional[torch.Tensor] = None

    def reset(self) -> None:
        """Drop the window: the next push starts a new stream."""
        self._window = None

    def push(self, keypoints) -> np.ndarray:
        """``keypoints``: (M, J, 2) normalized screen coordinates of the
        current frame. Returns (M, J, 3) root-relative 3D poses. The first
        push edge-pads the whole window with its frame."""
        return self.push_async(keypoints).cpu().numpy()

    def push_async(self, keypoints) -> torch.Tensor:
        """:meth:`push` without the copy to the host: returns the (M, J, 3)
        tensor on the model's device, its forward possibly still in flight
        (no synchronisation). The window advances as in :meth:`push`."""
        cfg = self.model.cfg
        kpts = torch.as_tensor(keypoints, dtype=torch.float32,
                               device=self.device)
        if kpts.shape != (self.num_person, cfg.num_joints_in, 2):
            raise ValueError(
                f"expected ({self.num_person}, {cfg.num_joints_in}, 2) "
                f"keypoints, got {tuple(kpts.shape)}")
        frame = kpts[:, None]
        if self._window is None:
            self._window = frame.expand(-1, cfg.receptive_field(), -1, -1)
        self._window = torch.cat([self._window[:, 1:], frame], dim=1)
        return self.model(self._window, variant="strided")[:, 0]
