"""The port's in-the-wild pipeline end to end (``gastx_torch.pipeline.
video_pose2d``, ``gastx_torch.cli.gen_skes``, ``gastx_torch.cli.realtime``)
against the JAX package's, on the CPU, with the JAX tests' tiny random
models (``TINY_CFG`` YOLO at 96, ``TINY_EXTRA`` HRNet at 64x96 crops; the
HRNet checkpoint is saved by the port's module and read by both packages)
and a synthetic mp4.

The clip is 96x96, the detector's input size, so the letterbox is the
identity on both sides and both detectors see the same canvas: the
bicubic resize itself differs from OpenCV's by up to one uint8 level
(tests/test_torch_pipeline.py), and one level can move an objectness
that sits at the threshold, after which the two trackers see different
boxes. Tolerances: the boxes equal; keypoints within 1e-3 px and scores
within 1e-4 * max(1, max |JAX|) (heatmaps summed in another order); the
3D outputs of both CLIs (lifter weights from one JAX ``.ckpt``, the 2D
stage stubbed as tests/test_gen_skes.py stubs it) within 1e-4 *
max(1, max |JAX|); the port's pipelined realtime loop equal to its
sequential one.
"""
import sys

import numpy as np
import pytest
import torch

import gastx.cli.gen_skes as j_gen_skes
import gastx.cli.realtime as j_realtime
import gastx.models as jm
import gastx.pipeline.video_pose2d as jvp
import gastx_torch.cli.gen_skes as t_gen_skes
import gastx_torch.cli.realtime as t_realtime
import gastx_torch.pipeline.video_pose2d as tvp
from gastx.train import save_checkpoint as j_save_checkpoint
from gastx_torch.pipeline.hrnet import PoseHighResolutionNet
from test_hrnet import TINY_EXTRA
from test_realtime_cli import FakeEstimator
from test_torch_interchange import seeded_train_state
from test_torch_pipeline import assert_within, random_bn
from test_yolo import TINY_CFG, _write_random_weights

W = H = 96
FRAMES = 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny convolutions run fastest on one thread, and torch's thread
    pool on a host loaded by other test workers slows them many-fold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_models(tmp_path_factory):
    """Reduced YOLO cfg and biased random weights (the JAX e2e test's),
    and a reduced HRNet checkpoint saved by the port's module."""
    from gastx.pipeline.yolo.cfg import parse_darknet_cfg

    tmp = tmp_path_factory.mktemp("models")
    cfg = tmp / "tiny.cfg"
    cfg.write_text(TINY_CFG)
    weights = tmp / "tiny.weights"
    _write_random_weights(str(weights), parse_darknet_cfg(str(cfg)), seed=7,
                          obj_bias=3.0)
    gen = torch.Generator().manual_seed(11)
    hrnet = random_bn(PoseHighResolutionNet(TINY_EXTRA), gen)
    hrnet_path = tmp / "tiny_hrnet.pth"
    torch.save(hrnet.state_dict(), str(hrnet_path))
    return str(cfg), str(weights), str(hrnet_path)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 96x96 mp4 of FRAMES frames: dark noise and two bright figures
    moving apart; and its frames as decoded."""
    import cv2

    path = str(tmp_path_factory.mktemp("clip") / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25,
                             (W, H))
    rng = np.random.default_rng(0)
    for i in range(FRAMES):
        frame = rng.integers(0, 80, (H, W, 3), dtype=np.uint8)
        frame[20:70, 6 + 3 * i:30 + 3 * i] = 220
        frame[30:80, 60 - 2 * i:78 - 2 * i] = 180
        writer.write(frame)
    writer.release()
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(frame)
    cap.release()
    return path, frames


ESTIMATOR_KW = dict(det_dim=96, image_size=(64, 96), confidence=0.5,
                    hrnet_spec=TINY_EXTRA)


def port_estimator(tiny_models):
    cfg, weights, hrnet = tiny_models
    return tvp.Pose2DEstimator(weights, hrnet, yolo_cfg=cfg, device="cpu",
                               **ESTIMATOR_KW)


def estimators(tiny_models):
    cfg, weights, hrnet = tiny_models
    return (jvp.Pose2DEstimator(weights, hrnet, yolo_cfg=cfg, **ESTIMATOR_KW),
            port_estimator(tiny_models))


def record_boxes(est):
    """Record the detections each frame hands the tracker."""
    seen = []
    inner = est.crops_from_detections

    def wrapped(frame, bboxs, det_scores, num_person, track):
        seen.append(None if bboxs is None else (bboxs.copy(),
                                                det_scores.copy()))
        return inner(frame, bboxs, det_scores, num_person, track)

    est.crops_from_detections = wrapped
    return seen


@pytest.mark.parametrize("batch_size", [1, 4])
def test_gen_video_kpts_matches_jax(tiny_models, clip, batch_size):
    """Per-frame and batched (4-frame chunks; the last of the 8 frames'
    chunks full, so the padding path is held by the batch_size=3 case of
    test_estimator_needs_no_opencv): the same boxes into SORT every frame,
    the same tracks, keypoints and scores."""
    path, _ = clip
    j_est, t_est = estimators(tiny_models)
    j_boxes, t_boxes = record_boxes(j_est), record_boxes(t_est)
    jk, js = jvp.gen_video_kpts(path, "", "", num_person=2, progress=False,
                                estimator=j_est, batch_size=batch_size)
    tk, ts = tvp.gen_video_kpts(path, "", "", num_person=2, progress=False,
                                estimator=t_est, batch_size=batch_size)
    assert len(t_boxes) == len(j_boxes) == FRAMES
    for a, b in zip(t_boxes, j_boxes):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a[0], b[0])
            assert_within(a[1], b[1])
    assert tk.shape == jk.shape and tk.shape[1] >= FRAMES - 1
    np.testing.assert_allclose(tk, jk, atol=1e-3)
    assert_within(ts, js)
    one_j = jvp.gen_img_kpts(clip[1][3], j_est, num_person=2)
    one_t = tvp.gen_img_kpts(clip[1][3], t_est, num_person=2)
    np.testing.assert_allclose(one_t[0], one_j[0], atol=1e-3)
    assert_within(one_t[1], one_j[1])


def test_estimator_needs_no_opencv(tiny_models, clip, monkeypatch):
    """The 2D stage with OpenCV unimportable: estimate_frame and
    estimate_batch (3-frame chunks, the last padded) on decoded frames give
    what they give with it."""
    _, frames = clip
    est = port_estimator(tiny_models)
    want = [est.estimate_frame(f, 2) for f in frames]
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    est = port_estimator(tiny_models)
    got = [est.estimate_frame(f, 2) for f in frames]
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    kpts, scores = tvp.kpts_from_frames(
        frames, "", "", num_person=2, estimator=port_estimator(tiny_models),
        batch_size=3)
    kpts1, scores1 = tvp.kpts_from_frames(
        frames, "", "", num_person=2, estimator=port_estimator(tiny_models))
    np.testing.assert_allclose(kpts, kpts1, atol=1e-3)
    assert_within(scores, scores1)


@pytest.fixture(scope="module")
def lifter_ckpts(tmp_path_factory):
    """JAX .ckpt files of the 27f lifter and its causal twin, from seeds."""
    tmp = tmp_path_factory.mktemp("lifter")
    paths = {}
    for causal in (False, True):
        cfg = jm.config_for_frames(27, 17, causal=causal, dropout=0.05)
        paths[causal] = str(tmp / f"lifter_causal{int(causal)}.ckpt")
        j_save_checkpoint(paths[causal], epoch=0, lr=0.0,
                          train_state=seeded_train_state(cfg, 21 + causal))
    return paths


def stub_kpts(num_person, seed=3):
    """Two spatially separated people (tests/test_gen_skes.py's stub)."""
    rng = np.random.default_rng(seed)
    base = (rng.random((num_person, FRAMES + 4, 17, 2))
            * [W / 3, H / 2]).astype(np.float32)
    base[0] += [W * 0.1, H * 0.3]
    if num_person == 2:
        base[1] += [W * 0.55, H * 0.35]
    scores = rng.random((num_person, FRAMES + 4, 17)).astype(
        np.float32) * 0.5 + 0.5
    scores[0, 2, [2, 3]] = 0.1  # a low-confidence knee/ankle to revise
    return base, scores


@pytest.mark.parametrize("num_person", [1, 2])
def test_gen_skes_npz_matches_jax(clip, lifter_ckpts, tmp_path, monkeypatch,
                                  num_person):
    """Both CLIs on the same stubbed 2D keypoints and the same lifter
    weights (-w a JAX .ckpt): the .npz reconstructions agree."""
    path, _ = clip
    kpts, scores = stub_kpts(num_person)

    def j_stub(video, yolo_weights, hrnet_weights, num_person=1,
               yolo_cfg=None, **kw):
        return kpts.copy(), scores.copy()

    def t_stub(frames, yolo_weights, hrnet_weights, num_person=1, **kw):
        assert sum(1 for _ in frames) == FRAMES  # decoded, then stubbed
        return kpts.copy(), scores.copy()

    monkeypatch.setattr(jvp, "gen_video_kpts", j_stub)
    monkeypatch.setattr(tvp, "kpts_from_frames", t_stub)
    argv = ["-v", path, "-np", str(num_person), "-w",
            lifter_ckpts[False], "-f", "27"]
    j_gen_skes.main(argv + ["-o", str(tmp_path / "jax")])
    t_gen_skes.main(argv + ["-o", str(tmp_path / "port"), "--device",
                            "cpu"])
    want = np.load(tmp_path / "jax" / "clip_3d.npz")["reconstruction"]
    got = np.load(tmp_path / "port" / "clip_3d.npz")["reconstruction"]
    assert got.shape == (num_person, FRAMES + 4, 17, 3)
    assert np.isfinite(got).all() and abs(got[..., 2].min()) < 1e-5
    assert_within(got, want)


def realtime_argv(path, ckpt, out, *extra):
    return ["-v", path, "-w", ckpt, "--output", str(out), "-f", "27",
            *extra]


def test_realtime_matches_jax(clip, lifter_ckpts, tmp_path):
    """The realtime CLI on the same stubbed 2D stream (frames 0, 3, 6
    without a detection) and the same causal lifter weights: the streamed,
    placed poses agree, pipelined and sequential."""
    path, _ = clip
    ckpt = lifter_ckpts[True]
    j_out, t_out = tmp_path / "jax.npz", tmp_path / "port.npz"
    j_realtime.run(j_realtime.parse_args(realtime_argv(path, ckpt, j_out)),
                   estimator=FakeEstimator(W, H, drop_every=3))
    want = np.load(j_out)["poses"]
    for extra in (["--no-pipeline"], []):
        t_realtime.run(t_realtime.parse_args(realtime_argv(
            path, ckpt, t_out, "--device", "cpu", *extra)),
            estimator=FakeEstimator(W, H, drop_every=3))
        got = np.load(t_out)["poses"]
        assert got.shape == (FRAMES - 3, 1, 17, 3)
        assert_within(got, want)


def test_realtime_pipelined_equals_sequential(tiny_models, clip,
                                              lifter_ckpts, tmp_path):
    """The real estimator in the pooled pipeline (the device/host detect
    split) gives the sequential loop's poses exactly; --max-frames cuts
    both loops alike."""
    path, _ = clip
    outs = {}
    for mode, extra in (("seq", ["--no-pipeline"]), ("pipe", []),
                        ("pipe1", ["--pool-workers", "1"]),
                        ("seq5", ["--no-pipeline", "--max-frames", "5"]),
                        ("pipe5", ["--max-frames", "5"])):
        est = port_estimator(tiny_models)  # a fresh tracker per run
        args = t_realtime.parse_args(realtime_argv(
            path, lifter_ckpts[True], tmp_path / f"{mode}.npz", "-np", "2",
            "--device", "cpu", *extra))
        outs[mode] = t_realtime.run(args, estimator=est)
    assert outs["seq"].shape[0] >= FRAMES - 1
    assert outs["seq5"].shape[0] <= 5
    np.testing.assert_array_equal(outs["pipe"], outs["seq"])
    np.testing.assert_array_equal(outs["pipe1"], outs["seq"])
    np.testing.assert_array_equal(outs["pipe5"], outs["seq5"])
    np.testing.assert_array_equal(outs["seq5"],
                                  outs["seq"][:len(outs["seq5"])])


@pytest.mark.parametrize("cli", [t_gen_skes, t_realtime])
def test_clis_need_a_gpu_unless_asked(cli, clip, monkeypatch, tmp_path):
    """Without --device the CLIs run on cuda: with none they raise
    through resolve_device instead of carrying on on the CPU."""
    path, _ = clip
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["-v", path, "--random-lifter-weights", "-o" if
                  cli is t_gen_skes else "--output", str(tmp_path / "o")])


def test_generate_kpts_json_matches_jax(clip, tmp_path, monkeypatch):
    """The skeleton-JSON writer on the same stubbed 2D stage: the same
    file as the JAX package's."""
    path, _ = clip
    kpts, scores = stub_kpts(2)

    def stub(video, yolo_weights, hrnet_weights, num_person=1, **kw):
        return kpts.copy(), scores.copy()

    monkeypatch.setattr(jvp, "gen_video_kpts", stub)
    monkeypatch.setattr(tvp, "gen_video_kpts", stub)
    jvp.generate_kpts_json(path, str(tmp_path / "jax.json"), "", "",
                           num_person=2, label="walk", label_index=3)
    tvp.generate_kpts_json(path, str(tmp_path / "port.json"), "", "",
                           num_person=2, label="walk", label_index=3)
    assert ((tmp_path / "port.json").read_text()
            == (tmp_path / "jax.json").read_text())
