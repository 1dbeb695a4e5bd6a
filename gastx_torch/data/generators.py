"""Input pipeline (a copy of ``gastx.data.generators``): the chunked
training batcher and the whole-sequence eval batcher.

  * ``ChunkedBatcher``: equal-length output chunks with +-pad
    receptive-field context, edge padding at sequence boundaries,
    horizontal-flip augmentation doubling the chunk list, per-epoch
    shuffling from a private RandomState(1234) (saved and restored for a
    resume), and endless mode.
  * ``UnchunkedBatcher``: one padded whole sequence per step, stacked
    with its mirrored copy for test-time augmentation.

All sequences are concatenated into one flat array and each batch is one
clipped-index gather (edge padding is index clamping). It is numpy
throughout, and from the same seed it yields the JAX package's batches.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class ChunkedBatcher:
    """Batched training data source over per-video 2D/3D pose sequences.

    Arguments mirror common/generators.py:24-28: ``batch_size``, per-video
    ``cameras`` (intrinsic vectors) / ``poses_3d`` / ``poses_2d`` lists,
    ``chunk_length`` output frames per example, receptive-field ``pad``,
    ``causal_shift``, shuffling, flip augmentation with left/right index
    lists, and ``endless`` epochs.
    """

    def __init__(self, batch_size: int, cameras, poses_3d,
                 poses_2d: Sequence[np.ndarray], chunk_length: int,
                 pad: int = 0, causal_shift: int = 0, shuffle: bool = True,
                 random_seed: int = 1234, augment: bool = False,
                 kps_left=None, kps_right=None,
                 joints_left=None, joints_right=None, endless: bool = False):
        assert poses_3d is None or len(poses_3d) == len(poses_2d)
        assert cameras is None or len(cameras) == len(poses_2d)

        # Chunk plan: (seq_idx, start, end, flip) rows for every output chunk
        # of every sequence, centered by the half-remainder offset
        # (generators.py:36-42); augmentation appends a flipped copy per seq.
        rows = []
        for i, seq in enumerate(poses_2d):
            assert poses_3d is None or poses_3d[i].shape[0] == seq.shape[0]
            n_frames = seq.shape[0]
            n_chunks = (n_frames + chunk_length - 1) // chunk_length
            offset = (n_chunks * chunk_length - n_frames) // 2
            bounds = np.arange(n_chunks + 1) * chunk_length - offset
            block = np.stack([
                np.full(n_chunks, i), bounds[:-1], bounds[1:],
                np.zeros(n_chunks, dtype=np.int64)], axis=1)
            rows.append(block)
            if augment:
                flipped = block.copy()
                flipped[:, 3] = 1
                rows.append(flipped)
        self.pairs = (np.concatenate(rows, axis=0) if rows
                      else np.zeros((0, 4), dtype=np.int64))

        # Flat storage + per-sequence offsets for one-gather batch assembly.
        self._lengths = np.array([p.shape[0] for p in poses_2d], dtype=np.int64)
        self._offsets = np.concatenate([[0], np.cumsum(self._lengths)])
        self._flat_2d = (np.concatenate(poses_2d, axis=0) if len(poses_2d)
                         else np.zeros((0, 0, 2), dtype=np.float32))
        self._flat_3d = (np.concatenate(poses_3d, axis=0)
                         if poses_3d is not None else None)
        self._cameras = (np.stack([np.asarray(c) for c in cameras])
                         if cameras is not None else None)

        self.num_batches = (len(self.pairs) + batch_size - 1) // batch_size
        self.batch_size = batch_size
        self.chunk_length = chunk_length
        self.random = np.random.RandomState(random_seed)
        self.shuffle = shuffle
        self.pad = pad
        self.causal_shift = causal_shift
        self.endless = endless
        self.state: Optional[Tuple[int, np.ndarray]] = None

        self.augment = augment
        self.kps_left, self.kps_right = kps_left, kps_right
        self.joints_left, self.joints_right = joints_left, joints_right

    # -- bookkeeping (generators.py:71-91) --

    def num_frames(self) -> int:
        return self.num_batches * self.batch_size

    def random_state(self) -> np.random.RandomState:
        return self.random

    def set_random_state(self, random) -> None:
        self.random = random

    def augment_enabled(self) -> bool:
        return self.augment

    def next_pairs(self) -> Tuple[int, np.ndarray]:
        if self.state is None:
            pairs = (self.random.permutation(self.pairs) if self.shuffle
                     else self.pairs)
            return 0, pairs
        return self.state

    # -- vectorized batch assembly --

    def _gather(self, flat: np.ndarray, seq_idx: np.ndarray,
                starts: np.ndarray, window: int) -> np.ndarray:
        """Gather (B, window, J, C) slices with edge padding via index clamp."""
        local = starts[:, None] + np.arange(window)[None, :]
        local = np.clip(local, 0, (self._lengths[seq_idx] - 1)[:, None])
        return flat[self._offsets[seq_idx][:, None] + local]

    def _assemble(self, chunks: np.ndarray):
        seq_idx, start_3d, end_3d = chunks[:, 0], chunks[:, 1], chunks[:, 2]
        flip = chunks[:, 3].astype(bool)

        window_2d = self.chunk_length + 2 * self.pad
        batch_2d = self._gather(self._flat_2d, seq_idx,
                                start_3d - self.pad - self.causal_shift,
                                window_2d).copy()
        if flip.any():
            batch_2d[flip, :, :, 0] *= -1
            batch_2d[np.ix_(flip, np.arange(window_2d),
                            self.kps_left + self.kps_right)] = \
                batch_2d[np.ix_(flip, np.arange(window_2d),
                                self.kps_right + self.kps_left)]

        batch_3d = None
        if self._flat_3d is not None:
            batch_3d = self._gather(self._flat_3d, seq_idx, start_3d,
                                    self.chunk_length).copy()
            if flip.any():
                batch_3d[flip, :, :, 0] *= -1
                batch_3d[np.ix_(flip, np.arange(self.chunk_length),
                                self.joints_left + self.joints_right)] = \
                    batch_3d[np.ix_(flip, np.arange(self.chunk_length),
                                    self.joints_right + self.joints_left)]

        batch_cam = None
        if self._cameras is not None:
            batch_cam = self._cameras[seq_idx].copy()
            if flip.any():
                # Flip horizontal center + tangential distortion
                # (generators.py:140-143).
                batch_cam[flip, 2] *= -1
                batch_cam[flip, 7] *= -1

        return batch_cam, batch_3d, batch_2d

    def next_epoch(self):
        enabled = True
        while enabled:
            start_idx, pairs = self.next_pairs()
            for b_i in range(start_idx, self.num_batches):
                chunks = pairs[b_i * self.batch_size:
                               (b_i + 1) * self.batch_size]
                if self.endless:
                    self.state = (b_i + 1, pairs)
                yield self._assemble(np.asarray(chunks))
            if self.endless:
                self.state = None
            else:
                enabled = False


class UnchunkedBatcher:
    """Whole-sequence eval data source (batch of 1, or 2 with flip TTA)."""

    def __init__(self, cameras, poses_3d, poses_2d: Sequence[np.ndarray],
                 pad: int = 0, causal_shift: int = 0, augment: bool = False,
                 kps_left=None, kps_right=None,
                 joints_left=None, joints_right=None):
        assert poses_3d is None or len(poses_3d) == len(poses_2d)
        assert cameras is None or len(cameras) == len(poses_2d)

        self.augment = augment
        self.kps_left, self.kps_right = kps_left, kps_right
        self.joints_left, self.joints_right = joints_left, joints_right
        self.pad = pad
        self.causal_shift = causal_shift
        self.cameras = [] if cameras is None else cameras
        self.poses_3d = [] if poses_3d is None else poses_3d
        self.poses_2d = poses_2d

    def num_frames(self) -> int:
        return sum(p.shape[0] for p in self.poses_2d)

    def augment_enabled(self) -> bool:
        return self.augment

    def set_augment(self, augment: bool) -> None:
        self.augment = augment

    def next_epoch(self):
        from itertools import zip_longest

        for seq_cam, seq_3d, seq_2d in zip_longest(self.cameras,
                                                   self.poses_3d,
                                                   self.poses_2d):
            # Edge-pad the 2D input by the (possibly causal-shifted)
            # receptive-field margins via index clamping.
            n = seq_2d.shape[0]
            idx = np.clip(
                np.arange(-(self.pad + self.causal_shift),
                          n + self.pad - self.causal_shift), 0, n - 1)
            batch_2d = seq_2d[idx][None]
            batch_3d = None if seq_3d is None else seq_3d[None]
            batch_cam = None if seq_cam is None else np.asarray(seq_cam)[None]

            if self.augment:
                flipped_2d = batch_2d.copy()
                flipped_2d[..., 0] *= -1
                flipped_2d[:, :, self.kps_left + self.kps_right] = \
                    flipped_2d[:, :, self.kps_right + self.kps_left]
                batch_2d = np.concatenate([batch_2d, flipped_2d], axis=0)

                if batch_3d is not None:
                    flipped_3d = batch_3d.copy()
                    flipped_3d[..., 0] *= -1
                    flipped_3d[:, :, self.joints_left + self.joints_right] = \
                        flipped_3d[:, :, self.joints_right + self.joints_left]
                    batch_3d = np.concatenate([batch_3d, flipped_3d], axis=0)

                if batch_cam is not None:
                    flipped_cam = batch_cam.copy()
                    flipped_cam[:, 2] *= -1
                    flipped_cam[:, 7] *= -1
                    batch_cam = np.concatenate([batch_cam, flipped_cam],
                                               axis=0)

            yield batch_cam, batch_3d, batch_2d
