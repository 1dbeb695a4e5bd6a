"""Protocol evaluation: MPJPE (P1) and P-MPJPE (P2) in mm, frame-weighted
and action-wise (parity target: ``gastx.eval.protocol``).

Predictions come from the port's :func:`gastx_torch.infer.lift_sequences`
with the model in eval mode, so on the card every pass runs the
hand-written kernels of the dilated ``"auto"`` route. Each function hands
the model back in the mode it came in. The errors are reduced on the host
in numpy.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gastx_torch.eval.metrics import p_mpjpe
from gastx_torch.infer.lifting import lift_sequences
from gastx_torch.models.gastnet import GastNet


def evaluate_sequences(model: GastNet, poses_2d: Sequence[np.ndarray],
                       poses_3d: Sequence[np.ndarray], *, tta: bool = True,
                       compute_p2: bool = True, kps_lr=None
                       ) -> Tuple[float, float]:
    """(MPJPE, P-MPJPE) in mm over the given sequences (P-MPJPE nan
    without ``compute_p2``). ``kps_lr``: the 2D detections' (left, right)
    mirror columns for the flip TTA (see ``lift_sequences``)."""
    was_training = model.training
    model.eval()
    try:
        preds = lift_sequences(model, poses_2d, tta=tta, kps_lr=kps_lr)
    finally:
        model.train(was_training)

    e1_sum = e2_sum = 0.0
    n = 0
    for pred, target in zip(preds, poses_3d):
        target = np.array(target, dtype=np.float32)
        target[:, 0] = 0.0  # root-relative
        frames = target.shape[0]
        e1_sum += frames * float(np.mean(
            np.linalg.norm(pred - target, axis=-1)))
        if compute_p2:
            e2_sum += frames * p_mpjpe(pred, target)
        n += frames
    e1 = e1_sum / n * 1000.0
    e2 = (e2_sum / n * 1000.0) if compute_p2 else float("nan")
    return e1, e2


def run_evaluation(model: GastNet, all_actions: Dict[str, list], dataset,
                   keypoints: Dict, *, downsample: int = 5, tta: bool = True,
                   action_filter: Optional[Sequence[str]] = None, log=print,
                   kps_lr=None) -> Tuple[float, float]:
    """Action-wise protocol run; logs per-action and average P1/P2 in mm
    and returns the two averages."""
    from gastx_torch.data.harness import fetch_actions

    errors_p1: List[float] = []
    errors_p2: List[float] = []
    for action_key in all_actions.keys():
        if action_filter is not None and not any(
                action_key.startswith(a) for a in action_filter):
            continue
        poses_act, poses_2d_act = fetch_actions(
            all_actions[action_key], dataset, keypoints, downsample)
        e1, e2 = evaluate_sequences(model, poses_2d_act, poses_act, tta=tta,
                                    kps_lr=kps_lr)
        log(f"----{action_key}----")
        log(f"Test time augmentation: {tta}")
        log(f"Protocol #1 Error (MPJPE): {e1} mm")
        log(f"Protocol #2 Error (P-MPJPE): {e2} mm")
        log("----------")
        errors_p1.append(e1)
        errors_p2.append(e2)

    p1 = float(np.mean(errors_p1))
    p2 = float(np.mean(errors_p2))
    log(f"Protocol #1   (MPJPE) action-wise average: {round(p1, 1)} mm")
    log(f"Protocol #2 (P-MPJPE) action-wise average: {round(p2, 1)} mm")
    return p1, p2
