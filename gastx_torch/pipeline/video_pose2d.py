"""Video -> 2D keypoints: detection, tracking, HRNet pose estimation (the
port of ``gastx.pipeline.video_pose2d``).

Parity target: reference ``lib/pose/hrnet/pose_estimation/gen_kpts.py``:
  * ``gen_video_kpts`` (:178-275): per frame YOLO person detection -> SORT
    tracking -> keep the last ``num_person`` tracks (reversed) -> affine crops
    -> HRNet heatmaps -> decoded keypoints; accumulates (T, M, 17, 2) and
    returns (M, T, 17, 2) + scores.
  * ``gen_img_kpts`` (:115-175): single-image API.
  * ``generate_ntu_kpts_json`` (:278-358): skeleton-JSON writer.

Each frame goes to the device once, as uint8; the letterbox, the crops, the
/255 and ImageNet normalization and HRNet run there, and only the
candidate boxes and the heatmaps come back. SORT and the decode run on the
host, in frame order. Decode goes through ``gastx_torch.viz.video_io``
(OpenCV where present, else ffmpeg); no image operation needs OpenCV.

Quirk preserved: the reference normalizes the BGR crop with the RGB-ordered
ImageNet constants and then swaps channels (gen_kpts.py:238 ``inputs[:,
[2, 1, 0]]``).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch


class Pose2DEstimator:
    """Bundles YOLOv3 detection, SORT tracking and HRNet 2D pose, on
    ``device`` (``cuda`` unless given)."""

    def __init__(self, yolo_weights: str, hrnet_weights: str,
                 yolo_cfg: Optional[str] = None, det_dim: int = 416,
                 hrnet_width: int = 48, image_size=(288, 384),
                 confidence: float = 0.70, hrnet_spec=None,
                 flip_test: bool = False, shift_heatmap: bool = False,
                 device=None):
        from gastx_torch.device import resolve_device
        from gastx_torch.pipeline.hrnet import (PoseHighResolutionNet,
                                                hrnet_extra)
        from gastx_torch.pipeline.sort import Sort
        from gastx_torch.pipeline.yolo import YoloHumanDetector

        self.device = resolve_device(device)
        self.detector = YoloHumanDetector(yolo_weights, yolo_cfg,
                                          inp_dim=det_dim,
                                          confidence=confidence,
                                          device=self.device)
        # hrnet_spec: explicit stage spec (EXTRA dict) overriding the
        # shipped w<width> preset — used by tests with reduced backbones.
        self.extra = hrnet_spec if hrnet_spec is not None \
            else hrnet_extra(hrnet_width)
        self.image_size = list(image_size)

        blob = torch.load(hrnet_weights, map_location="cpu",
                          weights_only=False)
        if hasattr(blob, "state_dict"):
            blob = blob.state_dict()
        sd = {k.replace("module.", ""): v for k, v in blob.items()}
        self.hrnet = PoseHighResolutionNet(self.extra)
        self.hrnet.load_state_dict(sd)
        self.hrnet = self.hrnet.to(self.device).eval()
        self.tracker = Sort()
        # TEST.FLIP_TEST / TEST.SHIFT_HEATMAP heatmap flip-TTA (reference
        # lib/pose/hrnet/lib/config/default.py:101-103 + utils/
        # transforms.py:15-30): average the ordinary heatmaps with the
        # un-flipped heatmaps of the mirrored crop. Off by default, like
        # the reference's in-the-wild driver.
        self.flip_test = flip_test
        self.shift_heatmap = shift_heatmap

    @torch.no_grad()
    def heatmaps(self, crops: torch.Tensor) -> np.ndarray:
        """(M, H, W, 3) uint8 BGR crops on the device -> (M, J, H/4, W/4)
        heatmaps on the host: /255 and the ImageNet mean/std, then the
        BGR->RGB swap after normalization (the reference's quirk), HRNet,
        and with flip_test the mirrored crops' heatmaps merged in."""
        from gastx_torch.pipeline.hrnet import normalize_crops

        with torch.profiler.record_function("gastx_torch.hrnet"):
            x = normalize_crops(crops).flip(-1).permute(0, 3, 1, 2)
            out = self.hrnet(x)
            flipped = self.hrnet(x.flip(-1)) if self.flip_test else None
        heatmaps = out.cpu().numpy()
        if flipped is not None:
            from gastx_torch.pipeline.hrnet import (COCO_FLIP_PAIRS,
                                                    flip_tta_merge)

            heatmaps = flip_tta_merge(heatmaps, flipped.cpu().numpy(),
                                      COCO_FLIP_PAIRS,
                                      shift_heatmap=self.shift_heatmap)
        return heatmaps

    def estimate_frame(self, frame, num_person: int = 1,
                       track: bool = True):
        """BGR frame -> (kpts (M, 17, 2), scores (M, 17, 1)) or None."""
        crops = self.detect_crops(frame, num_person, track=track)
        if crops is None:
            return None
        return self.pose_from_crops(*crops)

    def detect_crops(self, frame, num_person: int = 1,
                     track: bool = True):
        """First pipeline half: YOLO detect -> SORT track -> affine crops.

        Returns ``(inputs, centers, scales)`` ready for
        :meth:`pose_from_crops` (``inputs``: uint8 crops on the device), or
        None when no person survives. NOTE: the SORT tracker state updates
        here, so calls must happen in frame order.
        """
        frame = self.detector.to_device(frame)
        bboxs, det_scores = self.detector.detect(frame)
        return self.crops_from_detections(frame, bboxs, det_scores,
                                          num_person, track)

    def crops_from_detections(self, frame, bboxs, det_scores, num_person,
                              track):
        """Host half of the detect stage: SORT update + box selection, then
        the affine crops on the device, from already-computed detections.

        Public split point: the device half (``self.detector.detect``) is
        stateless and order-free, so pipelined hosts
        (gastx_torch/cli/realtime.py pooled detect stage,
        :meth:`estimate_batch`) run it concurrently / batched and feed this
        ordered, tracker-owning half in frame order."""
        from gastx_torch.pipeline.hrnet import preprocess_boxes

        if bboxs is None or not bboxs.any():
            return None

        if track:
            people_track = self.tracker.update(
                np.concatenate([bboxs, det_scores], axis=1))
            if people_track.shape[0] == 1:
                boxes = people_track[-1:, :-1]
            elif people_track.shape[0] >= 2:
                boxes = people_track[-num_person:, :-1][::-1]
            else:
                return None
        else:
            boxes = bboxs[:num_person]

        track_boxes = [[round(float(v), 2) for v in box] for box in boxes]
        # Raw uint8 BGR crops; normalization and the BGR->RGB-after-
        # normalization quirk run in :meth:`heatmaps`.
        with torch.profiler.record_function("gastx_torch.crops"):
            return preprocess_boxes(self.detector.to_device(frame),
                                    track_boxes,
                                    self.image_size, num_person,
                                    normalize=False)

    def estimate_batch(self, frames, num_person: int = 1,
                       valid: Optional[int] = None):
        """Batched offline 2D: a chunk of same-size frames -> per-frame
        results.

        Two device passes for the WHOLE chunk (three with flip-TTA):
        batched YOLO detect over the stacked letterboxes, then batched
        HRNet over every surviving crop. SORT updates run per frame in
        order between the two, exactly as the sequential loop. Same math as
        ``estimate_frame`` per frame — only the batch axis changes.

        ``valid`` (default all): number of leading frames that are real —
        trailing pad frames (a caller repeating the last frame to keep one
        chunk shape) are detected in-batch but never touch the tracker or
        the output.

        Returns a list (``valid`` entries) of ``(preds, maxvals)`` or
        None.
        """
        from gastx_torch.pipeline.hrnet import get_final_preds

        if valid is None:
            valid = len(frames)
        stack = torch.stack([self.detector.to_device(f) for f in frames])
        detections = self.detector.detect_batch(stack)
        crops = [self.crops_from_detections(stack[i], bboxs, det_scores,
                                            num_person, True)
                 for i, (bboxs, det_scores)
                 in enumerate(detections[:valid])]

        sizes = [0 if c is None else c[0].shape[0] for c in crops]
        if sum(sizes) == 0:
            return [None] * valid
        heatmaps = self.heatmaps(torch.cat([c[0] for c in crops
                                            if c is not None]))

        results, off = [], 0
        for c, m in zip(crops, sizes):
            if c is None:
                results.append(None)
                continue
            _, centers, scales = c
            preds, maxvals = get_final_preds(
                heatmaps[off:off + m], np.asarray(centers),
                np.asarray(scales))
            results.append((preds, maxvals))
            off += m
        return results

    def pose_from_crops(self, inputs, centers, scales):
        """Second pipeline half: HRNet heatmaps -> decoded keypoints.

        Stateless; takes :meth:`detect_crops` output (uint8 BGR crops on
        the device) and returns ``(preds (M, 17, 2), maxvals (M, 17, 1))``.
        """
        from gastx_torch.pipeline.hrnet import get_final_preds

        return get_final_preds(self.heatmaps(inputs), np.asarray(centers),
                               np.asarray(scales))


def kpts_from_frames(frames: Iterable, yolo_weights: str, hrnet_weights: str,
                     det_dim: int = 416, num_person: int = 1,
                     yolo_cfg: Optional[str] = None,
                     estimator: Optional[Pose2DEstimator] = None,
                     batch_size: int = 1, device=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The 2D pipeline over an iterable of BGR uint8 frames. Returns
    ((M, T, 17, 2) kpts, (M, T, 17) scores) over the T frames with a
    detection. Pass ``estimator`` to reuse loaded models (or to inject
    reduced ones in tests); else one is built from the weight files.

    ``batch_size > 1`` runs ``Pose2DEstimator.estimate_batch`` on chunks of
    ``batch_size`` frames (the last chunk padded by repeating its last
    frame; the padding frames never reach the tracker): same per-frame math
    and tracker evolution, far fewer device round-trips.
    """
    if estimator is None:
        estimator = Pose2DEstimator(yolo_weights, hrnet_weights, yolo_cfg,
                                    det_dim, device=device)
    kpts_result: List[np.ndarray] = []
    scores_result: List[np.ndarray] = []

    def append_result(result):
        if result is None:
            return
        preds, maxvals = result
        kpts = np.zeros((num_person, 17, 2), dtype=np.float32)
        scores = np.zeros((num_person, 17), dtype=np.float32)
        kpts[:len(preds)] = preds[:num_person]
        scores[:len(maxvals)] = maxvals[:num_person, :, 0]
        kpts_result.append(kpts)
        scores_result.append(scores)

    if batch_size > 1:
        chunk = []
        for frame in frames:
            chunk.append(frame)
            if len(chunk) < batch_size:
                continue
            for result in estimator.estimate_batch(chunk, num_person):
                append_result(result)
            chunk = []
        if chunk:
            real = len(chunk)
            chunk = chunk + [chunk[-1]] * (batch_size - real)
            for result in estimator.estimate_batch(chunk, num_person,
                                                   valid=real):
                append_result(result)
    else:
        for frame in frames:
            append_result(estimator.estimate_frame(frame, num_person))

    keypoints = np.array(kpts_result).reshape(-1, num_person, 17, 2)
    out_scores = np.array(scores_result).reshape(-1, num_person, 17)
    return keypoints.transpose(1, 0, 2, 3), out_scores.transpose(1, 0, 2)


def gen_video_kpts(video: str, yolo_weights: str, hrnet_weights: str,
                   det_dim: int = 416, num_person: int = 1,
                   yolo_cfg: Optional[str] = None,
                   progress: bool = True,
                   estimator: Optional[Pose2DEstimator] = None,
                   batch_size: int = 1, device=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Run the full 2D pipeline over a video, decoded on the host
    (``viz.video_io``): :func:`kpts_from_frames` on its frames."""
    from gastx_torch.viz.video_io import read_video

    frames = read_video(video, bgr=True)
    if progress:
        try:
            from tqdm import tqdm
            frames = tqdm(frames)
        except ImportError:
            pass
    return kpts_from_frames(frames, yolo_weights, hrnet_weights, det_dim,
                            num_person, yolo_cfg, estimator, batch_size,
                            device)


def gen_img_kpts(image, estimator: Pose2DEstimator, num_person: int = 1):
    """Single-image 2D keypoints (gen_kpts.py:115-175 equivalent)."""
    return estimator.estimate_frame(image, num_person, track=False)


def generate_kpts_json(video_path: str, kpts_file: str, yolo_weights: str,
                       hrnet_weights: str, num_person: int = 1,
                       label: str = "unknown", label_index: int = -1,
                       device=None) -> None:
    """Write the skeleton-JSON format (gen_kpts.py:278-358 equivalent)."""
    from gastx_torch.data.keypoints_json import save_keypoints_json

    keypoints, scores = gen_video_kpts(video_path, yolo_weights,
                                       hrnet_weights,
                                       num_person=num_person, device=device)
    save_keypoints_json(kpts_file, keypoints, scores, label, label_index)
