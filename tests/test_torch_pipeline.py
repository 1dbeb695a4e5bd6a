"""The in-the-wild pipeline's modules in the port (``gastx_torch.pipeline``)
against the JAX package's (``gastx.pipeline``), on the CPU, module by
module, at the JAX tests' tiny sizes (``TINY_CFG`` of tests/test_yolo.py,
``TINY_EXTRA`` of tests/test_hrnet.py).

Tolerances:
  * SORT, the keypoint revision, the darknet reader, the configs and the
    heatmap decode: equal (the same numpy arithmetic, or the same float32
    numbers read from the same file).
  * The YOLO, HRNet and PoseResNet forwards on the same input: max |d| <=
    1e-4 * max(1, max |JAX|) (both float32; convolution sums in another
    order).
  * The image operations, which the JAX package runs in OpenCV and the
    port in torch: at most one uint8 level at any pixel (IMAGE_LEVELS),
    and the letterbox at under 1e-4 of its values, against OpenCV 5.0,
    whose float arithmetic the port follows; the values that differ sit at
    rounding ties.
  * The 2x3 transforms: 1e-9 relative (float64 solves).
"""
import os
import re

import jax
import numpy as np
import pytest
import torch

import gastx.pipeline as jp
import gastx.pipeline.hrnet as jh
import gastx.pipeline.keypoint_revision as jkr
import gastx.pipeline.sort as jsort
import gastx.pipeline.yolo as jy
import gastx_torch.pipeline as tp
import gastx_torch.pipeline.hrnet as th
import gastx_torch.pipeline.keypoint_revision as tkr
import gastx_torch.pipeline.sort as tsort
import gastx_torch.pipeline.yolo as ty
from gastx.pipeline.hrnet.pose_resnet import (import_pose_resnet_params,
                                              pose_resnet_forward)
from gastx_torch.device import check_f32_conv
from test_hrnet import TINY_EXTRA
from test_torch_common import REPO
from test_yolo import TINY_CFG, _write_random_weights

RTOL = 1e-4
# The most one uint8 value of the port's letterbox or crop may differ
# from OpenCV's (see the module docstring).
IMAGE_LEVELS = 1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny convolutions run fastest on one thread, and torch's thread
    pool on a host loaded by other test workers slows them many-fold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_within(got, want, rtol=RTOL):
    """max |got - want| <= rtol * max(1, max |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    bound = rtol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


def random_bn(model, gen):
    """Random eval statistics and affine terms for every BN of a port
    module, so that folding is exercised."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.weight.normal_(1.0, 0.1, generator=gen)
                m.bias.normal_(0, 0.1, generator=gen)
    return model.eval()


def state_dict_numpy(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


# ---------------------------------------------------------------- SORT


def detection_stream(frames, seed):
    """Per frame (N, 5) boxes [x1 y1 x2 y2 score]: three people drifting,
    one dropped now and then, plus a spurious box."""
    rng = np.random.default_rng(seed)
    base = np.array([[10, 20, 60, 140], [200, 30, 260, 160],
                     [120, 100, 170, 220]], np.float64)
    out = []
    for t in range(frames):
        boxes = base + t * np.array([3, 1, 3, 1]) \
            + rng.normal(0, 1.5, base.shape)
        keep = rng.random(3) > 0.15
        boxes = boxes[keep]
        if rng.random() < 0.3:
            x, y = rng.uniform(0, 300, 2)
            boxes = np.concatenate([boxes, [[x, y, x + 40, y + 90]]])
        scores = rng.uniform(0.7, 1.0, (len(boxes), 1))
        out.append(np.concatenate([boxes, scores], axis=1))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_matches_jax(seed, monkeypatch):
    monkeypatch.setattr(jsort.KalmanBoxTracker, "count", 0)
    monkeypatch.setattr(tsort.KalmanBoxTracker, "count", 0)
    j, t = jsort.Sort(), tsort.Sort()
    stream = detection_stream(40, seed)
    for dets in stream:
        np.testing.assert_array_equal(t.update(dets.copy()),
                                      j.update(dets.copy()))
    a, b = stream[3][:, :4], stream[4][:, :4]
    np.testing.assert_array_equal(tp.iou_matrix(a, b), jp.iou_matrix(a, b))


# ---------------------------------------------------- keypoint revision


def coco_tracks(persons, frames, seed, w=640, h=480):
    rng = np.random.default_rng(seed)
    kpts = (rng.random((persons, frames, 17, 2)) * [w / 3, h / 2]
            ).astype(np.float32)
    kpts[:, :] += (np.arange(persons) * w / 2)[:, None, None, None] \
        + np.array([20, 100], np.float32)
    scores = rng.random((persons, frames, 17)).astype(np.float32)
    kpts[0, :3] = 0.0  # frames without a detection
    return kpts, scores


@pytest.mark.parametrize("persons", [1, 2])
def test_keypoint_revision_matches_jax(persons):
    kpts, scores = coco_tracks(persons, 30, persons)
    jk, js, jv = jp.h36m_coco_format(kpts.copy(), scores.copy())
    tk, ts, tv = tp.h36m_coco_format(kpts.copy(), scores.copy())
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(ts, js)
    for a, b in zip(tv, jv):
        np.testing.assert_array_equal(a, b)
    re_j = jp.revise_kpts(jk, js, jv)
    re_t = tp.revise_kpts(tk, ts, tv)
    np.testing.assert_array_equal(re_t, re_j)
    rng = np.random.default_rng(7)
    preds = [rng.normal(0, 0.3, (len(v), 17, 3)).astype(np.float32)
             for v in jv]
    np.testing.assert_array_equal(
        tp.revise_skes([p.copy() for p in preds], re_t, tv),
        jp.revise_skes([p.copy() for p in preds], re_j, jv))
    # The real-time path: one frame's converter and placement.
    frame_k = kpts[:, 10].reshape(persons, 17, 2)
    frame_s = scores[:, 10].reshape(persons, 17, 1)
    ck_j, cs_j = jkr.h36m_coco_kpts(frame_k, frame_s)
    ck_t, cs_t = tkr.h36m_coco_kpts(frame_k, frame_s)
    for a, b in zip(ck_t + cs_t, ck_j + cs_j):
        np.testing.assert_array_equal(a, b)
    pose = [p[0] for p in preds]
    np.testing.assert_array_equal(
        tp.revise_skes_real_time(pose, np.stack(ck_t), 640),
        jp.revise_skes_real_time(pose, np.stack(ck_j), 640))


# ---------------------------------------------------------------- YOLO


@pytest.fixture(scope="module")
def tiny_yolo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("yolo")
    cfg = tmp / "tiny.cfg"
    cfg.write_text(TINY_CFG)
    blocks = jy.parse_darknet_cfg(str(cfg))
    weights = tmp / "tiny.weights"
    _write_random_weights(str(weights), blocks, seed=3, obj_bias=2.0)
    return str(cfg), str(weights), blocks


def test_darknet_cfg_and_reader_match_jax(tiny_yolo):
    cfg, weights, blocks = tiny_yolo
    assert ty.parse_darknet_cfg(cfg) == blocks
    assert ty.yolov3_blocks() == jy.yolov3_blocks()
    assert ty.yolov3_blocks(608, 608) == jy.yolov3_blocks(608, 608)
    got = ty.load_darknet_weights(weights, blocks)
    want = jy.load_darknet_weights(weights, blocks)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        if g:  # HWIO -> (out, in, kh, kw); the same float32 numbers
            np.testing.assert_array_equal(
                g["w"].numpy(), np.transpose(np.asarray(w["w"]),
                                             (3, 2, 0, 1)))
            np.testing.assert_array_equal(g["scale"].numpy(),
                                          np.asarray(w["scale"]))
            np.testing.assert_array_equal(g["shift"].numpy(),
                                          np.asarray(w["shift"]))


def test_yolo_forward_and_filter_match_jax(tiny_yolo):
    """The forward on one canvas (the JAX detector's own single-frame
    step, letterbox excluded), then the device filter and the host NMS
    and rescale on the same output."""
    cfg, weights, blocks = tiny_yolo
    jdet = jy.YoloHumanDetector(weights, cfg, inp_dim=96, confidence=0.5)
    tdet = ty.YoloHumanDetector(weights, cfg, inp_dim=96, confidence=0.5,
                                device="cpu")
    rng = np.random.default_rng(4)
    canvas = rng.integers(0, 256, (96, 96, 3), dtype=np.uint8)
    want_raw = np.asarray(jax.jit(jdet._yolo_fwd)(
        jdet.params, canvas[None, ..., ::-1].astype(np.float32) / 255.0))
    # prep_frame letterboxes first: at the canvas size it is the identity.
    got_raw = tdet.model(ty.prep_frame(torch.from_numpy(canvas), 96))
    assert_within(got_raw.detach().numpy(), want_raw)
    want = np.asarray(jdet._detect_dev(jdet.params, canvas))
    got = tdet._device_detect(torch.from_numpy(canvas)[None])[0].numpy()
    assert_within(got, want)
    np.testing.assert_array_equal(got[:, 6], want[:, 6])  # the keep flags
    bj, sj = jdet._host_filter(want, 160, 120)
    bt, st = tdet._host_filter(want, 160, 120)
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(st, sj)
    raw = want_raw[0]
    np.testing.assert_array_equal(ty.filter_person_detections(raw, 0.5),
                                  jy.filter_person_detections(raw, 0.5))
    dets = jy.filter_person_detections(raw, 0.5)
    np.testing.assert_array_equal(ty.rescale_boxes(dets, 96, 160, 120),
                                  jy.rescale_boxes(dets, 96, 160, 120))


def level_diff(got, want):
    return np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))


@pytest.mark.parametrize("h,w,inp", [(720, 1280, 416), (96, 128, 96),
                                     (100, 37, 128), (96, 96, 96)])
def test_letterbox_matches_opencv(h, w, inp):
    """The device letterbox (bicubic resize in torch) against the JAX
    package's (cv2.resize INTER_CUBIC): at most IMAGE_LEVELS at any pixel,
    the gray border equal, and the identity at the canvas size exact."""
    rng = np.random.default_rng(h + w)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    want = jy.letterbox_image(img, inp)
    got = ty.letterbox_image(torch.from_numpy(img), inp).numpy()
    d = level_diff(got, want)
    assert d.max() <= IMAGE_LEVELS, d.max()
    assert (d > 0).mean() < 1e-4
    if (h, w) == (inp, inp):
        np.testing.assert_array_equal(got, want)
    batch = ty.letterbox_image(torch.from_numpy(np.stack([img, img[::-1]])),
                               inp).numpy()
    np.testing.assert_array_equal(batch[0], got)
    np.testing.assert_array_equal(
        batch[1], ty.letterbox_image(torch.from_numpy(
            np.ascontiguousarray(img[::-1])), inp).numpy())


# ----------------------------------------------------- HRNet transforms


@pytest.mark.parametrize("rot", [0.0, 30.0])
def test_affine_transforms_match_jax(rot):
    """The 2x3 transforms solved in numpy against cv2.getAffineTransform
    (JAX package), both directions, and the decode's inverse map."""
    rng = np.random.default_rng(3)
    for _ in range(4):
        center = rng.random(2).astype(np.float32) * 500
        scale = rng.random(2).astype(np.float32) * 3 + 0.5
        for inv in (False, True):
            want = jh.get_affine_transform(center, scale, rot, [288, 384],
                                           inv=inv)
            got = th.get_affine_transform(center, scale, rot, [288, 384],
                                          inv=inv)
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
        coords = rng.random((17, 2)).astype(np.float32) * [72, 96]
        np.testing.assert_allclose(
            th.transform_preds(coords, center, scale, [72, 96]),
            jh.transform_preds(coords, center, scale, [72, 96]),
            rtol=1e-6)
    for box in ([10, 20, 110, 240], [0, 0, 640, 480], [5, 5, 30, 200]):
        for a, b in zip(th.box_to_center_scale(box, 1080, 1920),
                        jh.box_to_center_scale(box, 1080, 1920)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("h,w,size,boxes", [
    (720, 1280, (288, 384), [[300.4, 100.2, 520.7, 650.3],
                             [-20.0, -30.0, 200.0, 800.0]]),
    (96, 128, (64, 96), [[10.5, 20.25, 60.0, 90.0]]),
    (1080, 1920, (288, 384), [[1500.0, 900.0, 1950.0, 1100.0]]),
])
def test_crops_match_opencv(h, w, size, boxes):
    """The device crops (bilinear warp in torch) against the JAX package's
    (cv2.warpAffine INTER_LINEAR), boxes partly outside the frame among
    them: at most IMAGE_LEVELS at any pixel; then the normalization of the
    same uint8 crops equal to the JAX package's."""
    rng = np.random.default_rng(h)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    want, wc, ws = jh.preprocess_boxes(img, boxes, size, normalize=False)
    got, gc, gs = th.preprocess_boxes(torch.from_numpy(img), boxes, size,
                                      normalize=False)
    assert level_diff(got.numpy(), want).max() <= IMAGE_LEVELS
    np.testing.assert_array_equal(np.asarray(gc), np.asarray(wc))
    np.testing.assert_array_equal(np.asarray(gs), np.asarray(ws))
    norm_want, _, _ = jh.preprocess_boxes(img, boxes, size)
    np.testing.assert_allclose(
        th.normalize_crops(torch.from_numpy(want)).numpy(), norm_want,
        rtol=1e-6, atol=1e-6)
    c, s = gc[0], gs[0]
    assert level_diff(th.crop(torch.from_numpy(img), c, s, size).numpy(),
                      jh.crop(img, c, s, size)).max() <= IMAGE_LEVELS


def test_heatmap_decode_matches_jax_bitwise():
    rng = np.random.default_rng(5)
    hm = rng.random((3, 17, 96, 72)).astype(np.float32)
    hm[1, 4] = 0.0  # an all-zero joint: no prediction
    centers = np.asarray([rng.random(2) * 500 for _ in range(3)])
    scales = np.asarray([rng.random(2) * 2 + 0.5 for _ in range(3)])
    for a, b in zip(th.get_max_preds(hm), jh.get_max_preds(hm)):
        np.testing.assert_array_equal(a, b)
    for post in (True, False):
        for a, b in zip(th.get_final_preds(hm, centers, scales, post),
                        jh.get_final_preds(hm, centers, scales, post)):
            np.testing.assert_array_equal(a, b)
    flipped = rng.random((3, 17, 96, 72)).astype(np.float32)
    for shift in (False, True):
        np.testing.assert_array_equal(
            th.flip_tta_merge(hm, flipped, th.COCO_FLIP_PAIRS, shift),
            jh.flip_tta_merge(hm, flipped, jh.COCO_FLIP_PAIRS, shift))


def test_hrnet_configs_match_jax():
    assert th.hrnet_extra(32) == jh.hrnet_extra(32)
    assert th.default_config() == jh.default_config()
    assert th.experiment_names() == jh.experiment_names()
    for name in th.experiment_names():
        assert th.experiment_config(name) == jh.experiment_config(name)
    assert th.resnet_extra(101) == jh.resnet_extra(101)
    cfg = th.default_config()
    cfg.merge_from_list(["TEST.FLIP_TEST", "True"])
    assert cfg.TEST.FLIP_TEST is True
    with pytest.raises(KeyError):
        cfg.merge_from_list(["TEST.NO_SUCH_KEY", "1"])


# ---------------------------------------------------- 2D pose backbones


def test_hrnet_forward_matches_jax():
    """The port's module at TINY_EXTRA (every structural element: the
    transitions, a multi-module stage, the 4-branch fuse, the single-scale
    last module), its state_dict read by the JAX package's
    import_hrnet_params, on one batch of crops."""
    gen = torch.Generator().manual_seed(0)
    model = random_bn(th.PoseHighResolutionNet(TINY_EXTRA), gen)
    params = jh.import_hrnet_params(state_dict_numpy(model), TINY_EXTRA)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 96, 64, 3)).astype(np.float32)
    want = np.transpose(np.asarray(jax.jit(
        lambda p, v: jh.hrnet_forward(p, v, TINY_EXTRA))(params, x)),
        (0, 3, 1, 2))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert got.shape == (2, 17, 24, 16)
    assert_within(got.numpy(), want)


def test_pose_resnet_forward_matches_jax():
    """PoseResNet-50 (bottlenecks with strided downsamples, the deconv
    stack), its state_dict read by import_pose_resnet_params."""
    gen = torch.Generator().manual_seed(1)
    model = random_bn(th.PoseResNet(50), gen)
    params = import_pose_resnet_params(state_dict_numpy(model), 50)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    # The params hold the block kind and depth: closed over, not traced.
    want = np.transpose(np.asarray(jax.jit(
        lambda v: pose_resnet_forward(params, v))(x)), (0, 3, 1, 2))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert got.shape == (1, 17, 16, 16)
    assert_within(got.numpy(), want)


# ------------------------------------------------- device and imports


def test_conv_sites_refuse_cudnn_tf32(monkeypatch):
    """check_f32_conv refuses a CUDA device while cuDNN's TF32 is on (no
    card needed: the check reads the device and the flag), and lets the
    CPU and a TF32-off card through."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        check_f32_conv(torch.device("cuda"))
    with pytest.raises(RuntimeError, match="allow_tf32"):
        check_f32_conv("cuda:0")
    check_f32_conv("cpu")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    check_f32_conv("cuda")


NEW_MODULES = [
    os.path.join(root, f)
    for part in ("gastx_torch/pipeline", "gastx_torch/cli")
    for root, _, files in os.walk(os.path.join(REPO, part))
    for f in sorted(files) if f.endswith(".py")]


@pytest.mark.parametrize("path", NEW_MODULES,
                         ids=[os.path.relpath(p, REPO) for p in NEW_MODULES])
def test_new_modules_import_no_jax_or_gastx(path):
    src = open(path).read()
    bad = re.findall(r"^\s*(?:from|import) (?:jax|gastx)(?:\.|\s|$)", src,
                     flags=re.M)
    assert not bad, bad
    if "pipeline" in path:  # the device path needs no OpenCV
        assert "import cv2" not in src
