"""Whole-sequence 2D->3D lifting (parity target: ``gastx.infer.lifting``).

Each sequence is edge-padded by the receptive field (asymmetrically when
causal), sequences are grouped into 64-frame length buckets and the batch
count is rounded up to a power of two, so a bucket runs as one batched
forward with flip test-time augmentation: the mirrored copy negates x and
swaps left/right input joints (``in_perm``), and its output is un-flipped
with the 3D layout's ``perm`` before the two halves are averaged. Valid
convs make the trailing bucket fill's outputs garbage that is trimmed, so
bucketing is exact.

With a data-parallel ``mesh`` (``gastx_torch.parallel``), serving-style
inference as the JAX ``mesh=`` argument gives it: each bucket's batch is
padded to a multiple of the mesh size as well, each rank lifts its
contiguous rows (with their flip TTA) on its device, and the outputs are
gathered so that every rank returns every sequence's result, which is
the one-process result (each row's forward is independent of the
others).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gastx_torch.geometry import camera_to_world
from gastx_torch.models.gastnet import GastNet
from gastx_torch.parallel.mesh import Mesh, batch_sharding
from gastx_torch.skeleton import get_layout

# Camera->world rotation of the in-the-wild demos.
DEMO_ROT = np.array([0.14070565, -0.15007018, -0.7552408, 0.62232804],
                    dtype=np.float32)

_BUCKET = 64


def _bucket_length(t: int) -> int:
    return max(_BUCKET, ((t + _BUCKET - 1) // _BUCKET) * _BUCKET)


def _perm_from_lr(left, right, n: int) -> np.ndarray:
    """Joint permutation swapping the given left<->right columns."""
    left, right = list(left), list(right)
    perm = np.arange(n)
    perm[left + right] = perm[right + left].copy()
    return perm


def eval_forward(model: GastNet, x: torch.Tensor,
                 variant: str = "dilated") -> torch.Tensor:
    """The eval forward whatever the module's mode, as the JAX lifting
    always runs ``train=False``: a model in train mode is set to eval and
    back (as ``eval.protocol.evaluate_sequences`` does), under
    ``torch.no_grad``, so a model left in train mode neither moves its BN
    running statistics nor asks for a dropout generator, and the output
    requires no gradient."""
    with torch.no_grad():
        if not model.training:
            return model(x, variant)
        model.eval()
        try:
            return model(x, variant)
        finally:
            model.train()


def _lift_batch(model: GastNet, x: torch.Tensor, tta: bool,
                kps_perm: Optional[np.ndarray] = None) -> torch.Tensor:
    """x: (M, T_padded, J, C_in) -> (M, T_out, J, 3), flip-TTA averaged.

    ``kps_perm``: left<->right permutation of the 2D input columns; None
    takes the 3D layout's (right whenever the 2D data is in its joint
    order)."""
    layout = get_layout(model.cfg.layout)
    perm = torch.as_tensor(_perm_from_lr(layout.joints_left,
                                         layout.joints_right,
                                         layout.num_joints), device=x.device)
    in_perm = perm if kps_perm is None else torch.as_tensor(
        kps_perm, device=x.device)
    if tta:
        flipped = x.clone()
        flipped[..., 0] *= -1.0
        x = torch.cat([x, flipped[:, :, in_perm]], dim=0)
    y = eval_forward(model, x)
    if tta:
        m = y.shape[0] // 2
        y0, y1 = y[:m], y[m:].clone()
        y1[..., 0] *= -1.0
        y = 0.5 * (y0 + y1[:, :, perm])
    return y


def lift_sequences(model: GastNet, sequences: Sequence[np.ndarray], *,
                   tta: bool = True, kps_lr=None,
                   mesh: Optional[Mesh] = None) -> List[np.ndarray]:
    """Lift normalized 2D sequences [(T_i, J, C_in)] to [(T_i, J, 3)] on
    the model's device.

    ``kps_lr``: optional (left, right) index lists of the 2D detections'
    mirror columns, for a 2D joint order that differs from the 3D
    layout's. ``mesh``: lift each bucket's rows across its ranks (every
    rank calls this with the same sequences; the model is the bare
    module, not its DDP wrapper).
    """
    cfg = model.cfg
    device = next(model.parameters()).device
    pad = (cfg.receptive_field() - 1) // 2
    shift = pad if cfg.causal else 0
    kps_perm = None
    if kps_lr is not None:
        kps_perm = _perm_from_lr(kps_lr[0], kps_lr[1], cfg.num_joints_in)

    jobs = {}
    for i, seq in enumerate(sequences):
        jobs.setdefault(_bucket_length(seq.shape[0] + 2 * pad), []).append(i)

    results: List[Optional[np.ndarray]] = [None] * len(sequences)
    for bucket, idxs in jobs.items():
        batch = []
        for i in idxs:
            seq = np.asarray(sequences[i], dtype=np.float32)
            # Edge padding == a clamped index gather; the trailing bucket
            # fill repeats the final frame and its outputs are trimmed.
            gather = np.clip(np.arange(-(pad + shift), bucket - pad - shift),
                             0, seq.shape[0] - 1)
            batch.append(seq[gather])
        m = len(batch)
        m_pad = 1 << (m - 1).bit_length()
        if mesh is not None:  # ... and to a multiple of the mesh size
            m_pad = -(-m_pad // mesh.size) * mesh.size
        batch.extend([np.zeros_like(batch[0])] * (m_pad - m))
        x = np.stack(batch)
        if mesh is None:
            y = _lift_batch(model, torch.from_numpy(x).to(device), tta,
                            kps_perm)
        else:
            rows = torch.from_numpy(x[batch_sharding(mesh, m_pad)])
            y = _gather_rows(_lift_batch(model, rows.to(device), tta,
                                         kps_perm), mesh)
        y = y.cpu().numpy()
        for row, i in enumerate(idxs):
            results[i] = np.array(y[row, :sequences[i].shape[0]])
    return results


def _gather_rows(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's rows of ``y``, in rank order, on every rank."""
    if mesh.size == 1:
        return y
    parts = [torch.empty_like(y) for _ in range(mesh.size)]
    dist.all_gather(parts, y.contiguous(), group=mesh.group)
    return torch.cat(parts)


def lift_to_world(model: GastNet, sequences: Sequence[np.ndarray], *,
                  tta: bool = True, rot: np.ndarray = DEMO_ROT,
                  mesh: Optional[Mesh] = None) -> List[np.ndarray]:
    """Lift, then rotate the predictions into world coordinates."""
    preds = lift_sequences(model, sequences, tta=tta, mesh=mesh)
    return [camera_to_world(torch.from_numpy(p), torch.from_numpy(rot),
                            0.0).numpy() for p in preds]
