"""Bounding-box -> model-input affine crops and their inverses (the port of
``gastx.pipeline.hrnet.transforms``).

Parity targets: reference ``lib/pose/hrnet/lib/utils/transforms.py:58-122``
(get_affine_transform / affine_transform / transform_preds / crop) and
``lib/pose/hrnet/lib/utils/utilitys.py:103-170`` (box_to_center_scale with
1.25x padding and pixel_std 200; PreProcess warp + ImageNet normalization).

The 2x3 transforms are solved on the host in numpy (the JAX package calls
``cv2.getAffineTransform``); the crops are warped in torch on the frame's
device by :func:`warp_affine`, which computes what ``cv2.warpAffine(...,
INTER_LINEAR)`` computes for uint8 images: the inverse map in float32,
bilinear weights from its fractions, a zero border, rounding to nearest.
No OpenCV is needed.

Note: the reference's PreProcess passes the *image* height/width as the
"model" dimensions into box_to_center_scale (utilitys.py:152) — so the crop
aspect ratio follows the frame, not the network input. That call-site
behavior is preserved here because lifted outputs must match.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
PIXEL_STD = 200.0


# COCO 17-keypoint left/right pairs (eyes, ears, shoulders, elbows,
# wrists, hips, knees, ankles) — the matched_parts argument of flip_back
# for the shipped COCO-trained HRNet backbones.
COCO_FLIP_PAIRS: Tuple[Tuple[int, int], ...] = (
    (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16))


def flip_back(output_flipped: np.ndarray, matched_parts) -> np.ndarray:
    """Un-flip heatmaps predicted from a horizontally flipped input.

    ``output_flipped``: (N, J, H, W) heatmaps from the flipped image;
    returns them reversed along W with left/right joint channels swapped.
    Parity target: reference ``lib/pose/hrnet/lib/utils/transforms.py:15-30``
    (its per-pair copy loop becomes one joint-permutation gather).
    """
    assert output_flipped.ndim == 4, \
        "output_flipped should be [batch_size, num_joints, height, width]"
    perm = np.arange(output_flipped.shape[1])
    for a, b in matched_parts:
        perm[a], perm[b] = perm[b], perm[a]
    return output_flipped[:, perm, :, ::-1]


def flip_tta_merge(heatmaps: np.ndarray, heatmaps_flipped: np.ndarray,
                   matched_parts, shift_heatmap: bool = False) -> np.ndarray:
    """Average ordinary and flipped-input heatmaps (TEST.FLIP_TEST).

    The standard HRNet heatmap flip-TTA (config keys TEST.FLIP_TEST /
    TEST.SHIFT_HEATMAP, reference ``lib/pose/hrnet/lib/config/
    default.py:101-103``): un-flip the flipped prediction, optionally
    shift it right one heatmap column (compensates the half-pixel
    misalignment of flipping an even-width feature map), and average.
    """
    out_f = flip_back(np.asarray(heatmaps_flipped), matched_parts)
    if shift_heatmap:
        out_f = out_f.copy()
        out_f[:, :, :, 1:] = out_f[:, :, :, :-1]
    return (np.asarray(heatmaps) + out_f) * 0.5


def get_3rd_point(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float32)


def get_dir(src_point, rot_rad: float):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return [src_point[0] * cs - src_point[1] * sn,
            src_point[0] * sn + src_point[1] * cs]


def affine_from_points(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 2x3 float64 affine mapping three ``src`` points onto ``dst``
    (what ``cv2.getAffineTransform`` solves): one 6x6 system in float64."""
    a = np.zeros((6, 6))
    a[0::2, 0:2] = src
    a[0::2, 2] = 1.0
    a[1::2, 3:5] = src
    a[1::2, 5] = 1.0
    return np.linalg.solve(a, np.asarray(dst, np.float64).reshape(6)
                           ).reshape(2, 3)


def get_affine_transform(center, scale, rot, output_size,
                         shift=np.array([0, 0], dtype=np.float32),
                         inv: bool = False) -> np.ndarray:
    """2x3 affine mapping the scaled box onto the model input canvas."""
    scale = np.array(scale) if not isinstance(scale, np.ndarray) else scale
    if scale.ndim == 0:
        scale = np.array([scale, scale])

    scale_tmp = scale * PIXEL_STD
    src_w = scale_tmp[0]
    dst_w, dst_h = output_size[0], output_size[1]

    rot_rad = np.pi * rot / 180
    src_dir = get_dir([0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0, :] = center + scale_tmp * shift
    src[1, :] = center + src_dir + scale_tmp * shift
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5]) + dst_dir
    src[2, :] = get_3rd_point(src[0], src[1])
    dst[2, :] = get_3rd_point(dst[0], dst[1])

    if inv:
        return affine_from_points(dst, src)
    return affine_from_points(src, dst)


def invert_affine(m: np.ndarray) -> np.ndarray:
    """The inverse of a 2x3 affine, in float64 (``cv2.invertAffineTransform``,
    which ``cv2.warpAffine`` applies to its matrix)."""
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[1, 1] * det, m[0, 0] * det
    a12, a21 = -m[0, 1] * det, -m[1, 0] * det
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def affine_transform(pt, t: np.ndarray) -> np.ndarray:
    new_pt = np.array([pt[0], pt[1], 1.0])
    return (t @ new_pt)[:2]


def transform_preds(coords: np.ndarray, center, scale,
                    output_size) -> np.ndarray:
    """Heatmap coords -> original image coords via the inverse affine."""
    target = coords.copy()
    trans = get_affine_transform(center, scale, 0, output_size, inv=True)
    for p in range(coords.shape[0]):
        target[p, 0:2] = affine_transform(coords[p, 0:2], trans)
    return target


def warp_affine(image: torch.Tensor, mats: Sequence[np.ndarray],
                output_size) -> torch.Tensor:
    """Warp one (H, W, 3) uint8 image by each 2x3 ``mats`` (image -> crop,
    as ``cv2.warpAffine`` takes them) to (M, out_h, out_w, 3) uint8 crops
    on the image's device.

    Each output pixel samples the image at the inverse map, computed in
    float32, bilinearly: four neighbours weighted by the fractions, any
    neighbour outside the image 0 (``BORDER_CONSTANT``), rounded to
    nearest. Against ``cv2.warpAffine(..., INTER_LINEAR)`` of OpenCV 5 it
    differs by at most one level (tests/test_torch_pipeline.py).
    """
    out_w, out_h = int(output_size[0]), int(output_size[1])
    h, w = image.shape[:2]
    dev = image.device
    inv = torch.from_numpy(np.stack([invert_affine(np.asarray(m, np.float64))
                                     for m in mats]).astype(np.float32)
                           ).to(dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None]
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None]
    coef = inv[:, :, :, None, None]                      # (M, 2, 3, 1, 1)
    sx = coef[:, 0, 0] * xs + coef[:, 0, 1] * ys + coef[:, 0, 2]
    sy = coef[:, 1, 0] * xs + coef[:, 1, 1] * ys + coef[:, 1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.long(), y0.long()
    flat = image.reshape(h * w, 3)
    out = torch.zeros((len(mats), out_h, out_w, 3), dtype=torch.float32,
                      device=dev)
    for dy, dx, weight in ((0, 0, (1 - fy) * (1 - fx)),
                           (0, 1, (1 - fy) * fx),
                           (1, 0, fy * (1 - fx)),
                           (1, 1, fy * fx)):
        yy, xx = y0 + dy, x0 + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        pix = flat[idx].to(torch.float32) * inside[..., None]
        out += pix * weight[..., None]
    return torch.round(out).clamp_(0, 255).to(torch.uint8)


def crop(img: torch.Tensor, center, scale, output_size,
         rot: float = 0) -> torch.Tensor:
    """One (out_h, out_w, 3) uint8 crop of an (H, W, 3) uint8 image."""
    trans = get_affine_transform(center, scale, rot, output_size)
    return warp_affine(img, [trans], output_size)[0]


def box_to_center_scale(box, model_image_width: int,
                        model_image_height: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """xyxy box -> (center, scale) with 1.25x padding (utilitys.py:103-136)."""
    center = np.zeros(2, dtype=np.float32)
    x1, y1, x2, y2 = box[:4]
    box_width, box_height = x2 - x1, y2 - y1
    center[0] = x1 + box_width * 0.5
    center[1] = y1 + box_height * 0.5

    aspect_ratio = model_image_width * 1.0 / model_image_height
    if box_width > aspect_ratio * box_height:
        box_height = box_width * 1.0 / aspect_ratio
    elif box_width < aspect_ratio * box_height:
        box_width = box_height * aspect_ratio
    scale = np.array([box_width / PIXEL_STD, box_height / PIXEL_STD],
                     dtype=np.float32)
    if center[0] != -1:
        scale = scale * 1.25
    return center, scale


def normalize_crops(crops: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 crops -> float32: /255, then the ImageNet mean/std
    (RGB order, applied to the channels as they come)."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(crops.device)
    std = torch.from_numpy(IMAGENET_STD).to(crops.device)
    return (crops.to(torch.float32) / 255.0 - mean) / std


def preprocess_boxes(image: torch.Tensor, bboxs: Sequence, image_size,
                     num_pos: int = 2, normalize: bool = True
                     ) -> Tuple[torch.Tensor, List, List]:
    """Warp per-box crops of an (H, W, 3) uint8 image to the model input
    on the image's device.

    Returns (inputs (M, H, W, 3), centers, scales): the crops ImageNet-
    normalized in float32 (:func:`normalize_crops`), or with
    ``normalize=False`` the raw uint8 crops, which the estimator normalizes
    inside its HRNet step. Mirrors PreProcess (utilitys.py:140-170)
    including its image-dims-as-model-dims call into box_to_center_scale.
    """
    centers, scales, mats = [], [], []
    for bbox in bboxs[:num_pos]:
        c, s = box_to_center_scale(bbox, image.shape[0], image.shape[1])
        centers.append(c)
        scales.append(s)
        mats.append(get_affine_transform(c, s, 0, image_size))
    crops = warp_affine(image, mats, image_size)
    return (normalize_crops(crops) if normalize else crops), centers, scales
