"""Person detection: letterbox preprocess, confidence + NMS filter, box
rescale to the original frame (the port of ``gastx.pipeline.yolo.detect``).

Parity targets: reference ``lib/detector/yolov3/preprocess.py:9-38``
(letterbox to 416x416, BGR->RGB, [0,1] normalize), ``util.py:107-229``
(write_results: confidence mask 0.70, xywh->xyxy, class argmax, person-class
filter, greedy IoU NMS at 0.4), and ``human_detector.py:106-157`` (rescale
from letterbox coords to the original frame + clamping).

The frame goes to the device once, as uint8. The letterbox resize runs
there in torch (:func:`letterbox_image`: what ``cv2.resize(...,
INTER_CUBIC)`` computes, no OpenCV), then YOLO and the confidence / person
filter; the NMS and rescale run on the host over the few boxes that pass.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from gastx_torch.pipeline.sort import iou_matrix

PERSON_CLASS = 0
DEFAULT_CONFIDENCE = 0.70
DEFAULT_NMS = 0.4

# The bicubic kernel's parameter (OpenCV's and the reference's).
CUBIC_A = -0.75


def cubic_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """Source indices (dst, 4), clamped to the edge, and float32 weights
    (dst, 4) of a bicubic resize of one axis from ``src`` to ``dst``
    samples: pixel centres aligned, the fractions in float64 as OpenCV 5
    computes them."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    s = np.floor(f)
    f = f - s
    a = CUBIC_A
    c0 = ((a * (f + 1) - 5 * a) * (f + 1) + 8 * a) * (f + 1) - 4 * a
    c1 = ((a + 2) * f - (a + 3)) * f * f + 1
    c2 = ((a + 2) * (1 - f) - (a + 3)) * (1 - f) * (1 - f) + 1
    c3 = 1 - c0 - c1 - c2
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3)[None],
                  0, src - 1)
    return idx, np.stack([c0, c1, c2, c3], -1).astype(np.float32)


def resize_cubic(img: torch.Tensor, new_w: int, new_h: int) -> torch.Tensor:
    """(..., H, W, 3) uint8 -> (..., new_h, new_w, 3) uint8 bicubic resize
    on the image's device: the horizontal pass, then the vertical one, in
    float32, rounded to nearest. Against ``cv2.resize(..., INTER_CUBIC)``
    of OpenCV 5 it differs by at most one level
    (tests/test_torch_pipeline.py)."""
    h, w = img.shape[-3:-1]
    dev = img.device
    xi, xc = (torch.from_numpy(t).to(dev) for t in cubic_taps(w, new_w))
    yi, yc = (torch.from_numpy(t).to(dev) for t in cubic_taps(h, new_h))
    x = img.to(torch.float32)
    row = x[..., xi, :]                               # (..., H, new_w, 4, 3)
    row = sum(row[..., k, :] * xc[:, k, None] for k in range(4))
    col = row[..., yi, :, :]                          # (..., new_h, 4, new_w, 3)
    out = sum(col[..., k, :, :] * yc[:, k, None, None] for k in range(4))
    return torch.round(out).clamp_(0, 255).to(torch.uint8)


def letterbox_image(img: torch.Tensor, inp_dim: int) -> torch.Tensor:
    """Aspect-preserving resize onto a gray (128) square canvas: (..., H, W,
    3) uint8 -> (..., inp_dim, inp_dim, 3) uint8, on the image's device."""
    h, w = img.shape[-3:-1]
    scale = min(inp_dim / w, inp_dim / h)
    new_w, new_h = int(w * scale), int(h * scale)
    resized = resize_cubic(img, new_w, new_h)
    canvas = torch.full((*img.shape[:-3], inp_dim, inp_dim, 3), 128,
                        dtype=torch.uint8, device=img.device)
    y0 = (inp_dim - new_h) // 2
    x0 = (inp_dim - new_w) // 2
    canvas[..., y0:y0 + new_h, x0:x0 + new_w, :] = resized
    return canvas


def canvas_input(canvas: torch.Tensor) -> torch.Tensor:
    """(B, inp, inp, 3) BGR uint8 letterboxes -> (B, 3, inp, inp) float32
    RGB in [0, 1], YOLO's input."""
    return (canvas.flip(-1).to(torch.float32) / 255.0).permute(0, 3, 1, 2)


def prep_frame(img: torch.Tensor, inp_dim: int) -> torch.Tensor:
    """BGR uint8 frame (H, W, 3) -> (1, 3, inp_dim, inp_dim) float32 RGB in
    [0, 1] (NCHW), on the frame's device."""
    return canvas_input(letterbox_image(img, inp_dim)[None])


def greedy_nms(boxes: np.ndarray, scores: np.ndarray,
               threshold: float) -> np.ndarray:
    """Indices kept by descending-score greedy IoU suppression."""
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        ious = iou_matrix(boxes[i:i + 1], boxes[order[1:]])[0]
        order = order[1:][ious < threshold]
    return np.array(keep, dtype=int)


def filter_person_detections(
    raw: np.ndarray,
    confidence: float = DEFAULT_CONFIDENCE,
    nms_threshold: float = DEFAULT_NMS,
) -> Optional[np.ndarray]:
    """(N, 85) decoded predictions -> (M, 6) [x1 y1 x2 y2 obj cls_score]
    for the person class, NMS-suppressed. None when nothing passes."""
    raw = np.asarray(raw)
    mask = raw[:, 4] > confidence
    if not mask.any():
        return None
    pred = raw[mask]

    boxes = np.empty((pred.shape[0], 4), np.float32)
    boxes[:, 0] = pred[:, 0] - pred[:, 2] / 2
    boxes[:, 1] = pred[:, 1] - pred[:, 3] / 2
    boxes[:, 2] = pred[:, 0] + pred[:, 2] / 2
    boxes[:, 3] = pred[:, 1] + pred[:, 3] / 2

    cls_idx = np.argmax(pred[:, 5:], axis=1)
    cls_score = pred[np.arange(len(pred)), 5 + cls_idx]
    person = cls_idx == PERSON_CLASS
    if not person.any():
        return None
    boxes, obj, cls_score = boxes[person], pred[person, 4], cls_score[person]

    keep = greedy_nms(boxes, obj, nms_threshold)
    return np.concatenate([boxes[keep], obj[keep, None],
                           cls_score[keep, None]], axis=1)


def rescale_boxes(dets: np.ndarray, inp_dim: int, orig_w: int,
                  orig_h: int) -> np.ndarray:
    """Undo the letterbox transform and clamp to the frame."""
    dets = dets.copy()
    scale = min(inp_dim / orig_w, inp_dim / orig_h)
    dets[:, [0, 2]] -= (inp_dim - scale * orig_w) / 2
    dets[:, [1, 3]] -= (inp_dim - scale * orig_h) / 2
    dets[:, :4] /= scale
    dets[:, [0, 2]] = np.clip(dets[:, [0, 2]], 0.0, orig_w)
    dets[:, [1, 3]] = np.clip(dets[:, [1, 3]], 0.0, orig_h)
    return dets


Frame = Union[np.ndarray, torch.Tensor]


class YoloHumanDetector:
    """Loads weights once; ``detect(frame)`` -> (bboxs (M,4), scores (M,1)).

    Runs on ``device`` (``cuda`` unless given). A frame is a BGR uint8
    (H, W, 3) array or tensor; a host frame is copied to the device once.
    """

    def __init__(self, weight_file: str, cfg_file: Optional[str] = None,
                 inp_dim: int = 416, confidence: float = DEFAULT_CONFIDENCE,
                 nms_threshold: float = DEFAULT_NMS, device=None):
        from gastx_torch.device import resolve_device
        from gastx_torch.pipeline.yolo.cfg import (parse_darknet_cfg,
                                                   yolov3_blocks)
        from gastx_torch.pipeline.yolo.model import (Darknet,
                                                     load_darknet_weights)

        if inp_dim % 32 or inp_dim <= 32:
            raise ValueError(f"inp_dim must be a multiple of 32 above 32, "
                             f"got {inp_dim}")
        self.device = resolve_device(device)
        self.inp_dim = inp_dim
        self.confidence = confidence
        self.nms_threshold = nms_threshold
        self.blocks = (parse_darknet_cfg(cfg_file) if cfg_file
                       else yolov3_blocks(inp_dim, inp_dim))
        self.model = Darknet(
            self.blocks, load_darknet_weights(weight_file, self.blocks),
            inp_dim).to(self.device).eval()

    def to_device(self, frame: Frame) -> torch.Tensor:
        """A BGR uint8 frame (or a stack of them) as a tensor on the
        detector's device."""
        if not isinstance(frame, torch.Tensor):
            frame = torch.from_numpy(np.ascontiguousarray(frame))
        return frame.to(self.device)

    def _device_filter(self, raw: torch.Tensor) -> torch.Tensor:
        """(..., N, 85) decoded predictions -> (..., N, 7) f32
        [x1 y1 x2 y2 obj cls_score person_keep]; the on-device half of
        filter_person_detections (same IEEE f32 ops)."""
        obj = raw[..., 4]
        cls = raw[..., 5:]
        cls_idx = torch.argmax(cls, dim=-1)
        cls_score = torch.gather(cls, -1, cls_idx[..., None])[..., 0]
        keep = (obj > self.confidence) & (cls_idx == PERSON_CLASS)
        half_w, half_h = raw[..., 2] * 0.5, raw[..., 3] * 0.5
        boxes = torch.stack([raw[..., 0] - half_w, raw[..., 1] - half_h,
                             raw[..., 0] + half_w, raw[..., 1] + half_h],
                            dim=-1)
        return torch.cat([boxes, obj[..., None], cls_score[..., None],
                          keep[..., None].to(torch.float32)], dim=-1)

    @torch.no_grad()
    def _device_detect(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) BGR uint8 frames on the device -> (B, N, 7)."""
        with torch.profiler.record_function("gastx_torch.letterbox"):
            canvases = letterbox_image(frames, self.inp_dim)
        with torch.profiler.record_function("gastx_torch.yolo"):
            return self._device_filter(self.model(canvas_input(canvases)))

    def _host_filter(self, out: np.ndarray, w: int, h: int):
        """(N, 7) device output -> detect()'s (bboxs, scores) contract."""
        rows = out[out[:, 6] > 0.5]
        if rows.shape[0] == 0:
            return None, None
        keep = greedy_nms(rows[:, :4], rows[:, 4], self.nms_threshold)
        dets = rescale_boxes(rows[keep][:, :6], self.inp_dim, w, h)
        bboxs = np.round(dets[:, :4].astype(np.float64), 2)
        scores = dets[:, 4:5]
        return bboxs, scores

    def detect(self, frame: Frame
               ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """``frame``: BGR uint8 (H, W, 3). Mirrors yolo_human_det's
        (bboxs, scores) contract (human_detector.py:106-157)."""
        h, w = frame.shape[:2]
        out = self._device_detect(self.to_device(frame)[None])[0]
        return self._host_filter(out.cpu().numpy(), w, h)

    def detect_batch(self, frames):
        """Batched detect over a chunk of same-size frames — ONE device
        pass for the whole chunk (offline throughput mode). ``frames``: a
        list of BGR uint8 frames or a (B, H, W, 3) tensor. Returns a list
        of per-frame ``detect()`` results.
        """
        stack = (self.to_device(frames) if isinstance(frames, torch.Tensor)
                 else torch.stack([self.to_device(f) for f in frames]))
        out = self._device_detect(stack).cpu().numpy()
        h, w = stack.shape[1:3]
        return [self._host_filter(out[b], w, h) for b in range(len(out))]
