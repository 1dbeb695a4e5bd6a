"""The offline user's host modules of the port against the JAX package on
the CPU: the keypoint converters and reconstruct's ``-kf`` dispatch, the
camera projection and quaternion inverse, video IO, 2D drawing and the
animation renderer, reconstruct's rendering and ``-vi``, trainval's
``--render``, and data preparation (``gastx_torch.data.prepare``,
``prepare_humaneva``, ``cli.prepare_data``) on synthetic archives.

Host numpy code is held bitwise; the projection at rtol 1e-5 (JAX
float32, the same formula summed in another order); the lifted poses at
atol 2e-5 / rtol 1e-4.
"""
import os
import tarfile
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gastx.data as jd
import gastx.geometry as jg
import gastx.viz as jv
from gastx.skeleton import H36M_17 as J_H36M_17
from gastx_torch import geometry as tg
from gastx_torch import viz as tv
from gastx_torch.cli import prepare_data, reconstruct, trainval
from gastx_torch.data import save_keypoints_json
from gastx_torch.skeleton import H36M_17
from test_torch_common import ATOL, RTOL
from test_torch_interchange import FIXTURE, _fixture_argv
from test_torch_trainval import synthetic_h36m  # noqa: F401


def _assert_same(a, b, where="root"):
    """Nested dicts / lists / arrays equal, dtypes too."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def _npz(path):
    with np.load(path, allow_pickle=True) as blob:
        return {k: (blob[k].item() if blob[k].dtype == object else blob[k])
                for k in blob.files}


# -- converters and -kf --------------------------------------------------------

# The joints of each format's file, its JAX conversion
# (gastx/cli/reconstruct.py:90-99) and the model's joints.
FORMATS = {
    "coco": (17, lambda k: jd.coco_h36m(k), 17),
    "mpii": (16, lambda k: jd.mpii_h36m(k), 17),
    "openpose": (18, lambda k: jd.coco_h36m(jd.openpose_to_coco(k)), 17),
    "wholebody": (23, lambda k: jd.coco_h36m_toe_format(k), 19),
    "h36m": (17, None, 17),
}


def _layout_keypoints(joints, frames=9, seed=0):
    kps = (np.random.default_rng(seed).random((frames, joints, 2)) * 900
           + 50).astype(np.float32)
    kps[3] = 0.0                          # a frame without a detection
    return kps


@pytest.mark.parametrize("kf", list(FORMATS))
def test_to_h36m_matches_jax(kf):
    """reconstruct's conversion of each -kf, bitwise, valid frames too."""
    joints, convert, model_joints = FORMATS[kf]
    kps = _layout_keypoints(joints)
    got, valid = reconstruct._to_h36m(kps.copy(), kf)
    if convert is None:
        want, want_valid = kps, np.where(kps.reshape(9, -1).sum(1) != 0)[0]
    else:
        want, want_valid = convert(kps.copy())
    assert got.shape == (9, model_joints, 2)
    _assert_same(np.asarray(got), np.asarray(want))
    _assert_same(valid, want_valid)
    assert 3 not in valid


@pytest.mark.parametrize("kf", ["mpii", "openpose", "wholebody"])
def test_reconstruct_reads_each_format(tmp_path, kf):
    """A -kf file of its own joint count (a 133-joint wholebody file) is
    read and converted as the JAX converters convert those keypoints."""
    joints, convert, model_joints = FORMATS[kf]
    raw = reconstruct.FILE_JOINTS[kf]
    kps = _layout_keypoints(raw, seed=1)[None]
    path = str(tmp_path / f"{kf}.json")
    save_keypoints_json(path, kps, np.ones(kps.shape[:3], np.float32))
    args = reconstruct.parse_args(["-k", path, "-kf", kf, "-n",
                                   str(model_joints), "--random-weights",
                                   "--no-render", "--device", "cpu",
                                   "-vo", str(tmp_path / "out.mp4")])
    out = reconstruct.reconstruct(args)
    want, valid = convert(kps[0, :, :joints].copy())
    assert out.shape == (9, model_joints, 3)
    np.testing.assert_array_equal(out[3], 0.0)
    assert np.isfinite(out).all() and (out[valid] != 0).any()
    wrong = str(17 if model_joints == 19 else 19)
    with pytest.raises(SystemExit, match=f"pass -n {model_joints}"):
        reconstruct.reconstruct(reconstruct.parse_args(
            ["-k", path, "-kf", kf, "-n", wrong, "--random-weights",
             "--no-render", "--device", "cpu"]))


# -- geometry ------------------------------------------------------------------

def test_project_to_2d_matches_jax():
    from gastx_torch.data.h36m import h36m_cameras

    rng = np.random.default_rng(2)
    cams = h36m_cameras()["S1"]
    params = np.stack([c["intrinsic"] for c in cams[:2]]).astype(np.float32)
    x = rng.standard_normal((2, 5, 17, 3)).astype(np.float32) * 0.4
    x[..., 2] += 4.0
    got = tg.project_to_2d(torch.from_numpy(x), torch.from_numpy(params))
    want = jg.project_to_2d(x, params)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    flat = tg.project_to_2d(torch.from_numpy(x[:, 0]),
                            torch.from_numpy(params))
    np.testing.assert_allclose(flat.numpy(), got.numpy()[:, 0], rtol=1e-6)
    with pytest.raises(ValueError):
        tg.project_to_2d(torch.from_numpy(x), torch.from_numpy(params[:1]))


def test_qinverse_matches_jax():
    q = np.random.default_rng(3).standard_normal((4, 3, 4)).astype(
        np.float32)
    _assert_same(tg.qinverse(torch.from_numpy(q)).numpy(),
                 np.asarray(jg.qinverse(jnp.asarray(q))))


# -- video IO and drawing ------------------------------------------------------

def _write_mp4(path, frames=10, size=(96, 64), fps=25.0):
    import cv2

    w, h = size
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    rng = np.random.default_rng(4)
    for _ in range(frames):
        writer.write(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
    writer.release()
    return path


def test_video_io_matches_jax(tmp_path):
    path = _write_mp4(str(tmp_path / "v.mp4"))
    assert tv.get_resolution(path) == jv.get_resolution(path) == (96, 64)
    assert tv.get_fps(path) == jv.get_fps(path) == 25.0
    got = list(tv.read_video(path, skip=2, limit=8))
    want = list(jv.read_video(path, skip=2, limit=8))
    assert len(got) == len(want) == 6
    _assert_same(got, want)
    x = np.random.default_rng(5).random((11, 17, 3)).astype(np.float32)
    _assert_same(tv.downsample_tensor(x, 3), jv.downsample_tensor(x, 3))


def test_draw2d_matches_jax():
    rng = np.random.default_rng(6)
    img = rng.integers(0, 255, (240, 900, 3), dtype=np.uint8)
    kpts = rng.random((2, 17, 2)).astype(np.float32) * [900, 240]
    scores = rng.random((2, 17)).astype(np.float32)
    _assert_same(tv.draw_keypoints(img, kpts, scores),
                 jv.draw_keypoints(img, kpts, scores))
    boxes = [(10, 10, 60, 100), (80.0, 20.0, 150.0, 110.0)]
    _assert_same(tv.draw_bboxes(img, boxes), jv.draw_bboxes(img, boxes))
    _assert_same(tv.resize_img(img, 640), jv.resize_img(img, 640))


def _gif_frames(path):
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB")) for f in
                ImageSequence.Iterator(im)]


METADATA = {"keypoints_symmetry": (list(H36M_17.joints_left),
                                   list(H36M_17.joints_right)),
            "layout_name": "Human3.6M", "num_joints": 17}


@pytest.mark.parametrize("multiperson", [False, True])
def test_render_animation_matches_jax(tmp_path, multiperson):
    """The port's gif has the frames of the JAX renderer's on the same
    data."""
    rng = np.random.default_rng(7)
    kpts = (rng.random((2, 5, 17, 2)) * [320, 240]).astype(np.float32)
    poses = rng.standard_normal((2, 5, 17, 3)).astype(np.float32) * 0.3
    poses[..., 2] += 0.8
    kw = dict(fps=5, bitrate=1000, azim=70.0, viewport=(320, 240), size=2)
    frames = []
    for mod, skel in ((tv, H36M_17), (jv, J_H36M_17)):
        out = str(tmp_path / f"{mod.__name__}.gif")
        if multiperson:
            mod.render_animation_multiperson(kpts, METADATA, list(poses),
                                             skel.skeleton(), output=out,
                                             **kw)
        else:
            mod.render_animation(kpts[0], METADATA,
                                 {"Reconstruction": poses[0]},
                                 skel.skeleton(), output=out, **kw)
        frames.append(_gif_frames(out))
    assert len(frames[0]) == 5
    _assert_same(frames[0], frames[1])
    assert tv.color_edge(5) == jv.color_edge(5) == "peru"


def test_rendering_needs_matplotlib(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        tv.render_animation(np.zeros((2, 17, 2)), METADATA,
                            {"Reconstruction": np.zeros((2, 17, 3))},
                            H36M_17.skeleton(), 5, 1000, 70.0,
                            str(tmp_path / "a.gif"), (64, 64))


# -- reconstruct and trainval rendering ------------------------------------------

def test_reconstruct_renders_and_reads_the_video_size(tmp_path):
    """Without --no-render, reconstruct writes the animation (the -vi
    video's frames behind it), and the video's resolution normalizes the
    keypoints; with -vi missing it falls back to 1000x1002."""
    from gastx_torch.data import coco_h36m
    from gastx_torch.geometry import normalize_screen_coordinates
    from gastx_torch.infer import lift_to_world
    from gastx_torch.models import build_gastnet, config_for_frames

    video = _write_mp4(str(tmp_path / "v.mp4"), frames=6, size=(320, 240))
    kps = (np.random.default_rng(8).random((1, 6, 17, 2))
           * [320, 240]).astype(np.float32)
    path = str(tmp_path / "kps.json")
    save_keypoints_json(path, kps, np.ones(kps.shape[:3], np.float32))
    common = ["-k", path, "--random-weights", "--seed", "3", "--device",
              "cpu"]
    out = reconstruct.reconstruct(reconstruct.parse_args(
        [*common, "-vi", video, "-vo", str(tmp_path / "a.gif")]))
    assert len(_gif_frames(str(tmp_path / "a.gif"))) == 6

    model = build_gastnet(config_for_frames(27), seed=3, device="cpu")
    h36m, _ = coco_h36m(kps[0])
    for size, args in (((320, 240), ["-vi", video]),
                       ((reconstruct.WIDTH, reconstruct.HEIGHT),
                        ["-vi", str(tmp_path / "missing.mp4")])):
        seq = normalize_screen_coordinates(h36m, w=size[0], h=size[1])
        want = lift_to_world(model, [seq.astype(np.float32)])[0]
        want[:, :, 2] -= np.min(want[:, :, 2])
        got = reconstruct.reconstruct(reconstruct.parse_args(
            [*common, *args, "--no-render", "-vo", str(tmp_path / "b")]))
        np.testing.assert_array_equal(got, want)
        if size == (320, 240):
            np.testing.assert_array_equal(got, out)


def test_trainval_render_matches_jax(synthetic_h36m, capsys):  # noqa: F811
    """trainval --evaluate X.ckpt --render exports the lift of the viz
    video that the JAX trainval exports, and renders it to a gif."""
    from gastx.cli.trainval import main as j_main

    tmp = synthetic_h36m
    viz = ["--render", "--viz-subject", "S1", "--viz-action", "Walking 1",
           "--viz-camera", "1"]
    gif = str(tmp / "render.gif")
    trainval.main(_fixture_argv(
        tmp, "ckpt", "--evaluate", FIXTURE, *viz, "--viz-export",
        str(tmp / "pred"), "--viz-output", gif, "--viz-limit", "8",
        "--viz-downsample", "2", "--viz-size", "2"))
    j_main(["--downsample", "1", "-arc", "3,3", "-ch", "8", "--checkpoint",
            str(tmp / "jckpt"), "--data-dir", str(tmp / "data"),
            "--evaluate", FIXTURE, *viz, "--viz-export",
            str(tmp / "jpred")])
    out = capsys.readouterr().out
    assert "Rendering..." in out and "Protocol #1" not in out
    got, want = np.load(tmp / "pred.npy"), np.load(tmp / "jpred.npy")
    assert got.shape == (40, 17, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert len(_gif_frames(gif)) == 8


# -- data preparation ----------------------------------------------------------

def _run_both(tmp_path, monkeypatch, fn):
    """``fn(package)`` in a directory of each package's own; returns the
    two directories."""
    import gastx.data.prepare as jp
    import gastx.data.prepare_humaneva as jph
    import gastx_torch.data.prepare as tp
    import gastx_torch.data.prepare_humaneva as tph

    dirs = []
    for name, mods in (("port", (tp, tph)), ("jax", (jp, jph))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        fn(*mods)
        dirs.append(d)
    return dirs


def _same_outputs(dirs):
    files = sorted(f for f in os.listdir(dirs[0]) if f.endswith(".npz"))
    assert files and files == sorted(
        f for f in os.listdir(dirs[1]) if f.endswith(".npz"))
    for f in files:
        _assert_same(_npz(dirs[0] / f), _npz(dirs[1] / f), f)
    return files


def test_prepare_2d_sh_matches_jax(tmp_path, monkeypatch):
    """The Stacked-Hourglass archives of tests/test_prepare.py (a ZIP with
    an h36m/ level and a tar.gz) give the JAX npz files."""
    pytest.importorskip("h5py")
    from test_prepare import _build_tree

    pt_root = tmp_path / "pt"
    _build_tree(str(pt_root / "h36m"), "StackedHourglass")
    pt_zip = str(tmp_path / "h36m.zip")
    with zipfile.ZipFile(pt_zip, "w") as zf:
        for dirpath, _, files in os.walk(pt_root):
            for f in files:
                full = os.path.join(dirpath, f)
                zf.write(full, os.path.relpath(full, pt_root))
    ft_root = tmp_path / "ft"
    _build_tree(str(ft_root), "StackedHourglassFineTuned240")
    ft_tar = str(tmp_path / "h36m_ft.tar.gz")
    with tarfile.open(ft_tar, "w:gz") as tar:
        tar.add(str(ft_root), arcname=".")

    dirs = _run_both(tmp_path, monkeypatch,
                     lambda p, _: p.prepare_2d_sh(pt_zip, ft_tar))
    assert _same_outputs(dirs) == ["data_2d_h36m_sh_ft_h36m.npz",
                                   "data_2d_h36m_sh_pt_mpii.npz"]


def _detectron_npz(path, frames, rng):
    """A Detectron output: per frame [_, boxes (n, 5)] and [_, keypoints
    (n, 6, 17)], the second frame without a detection."""
    boxes = np.empty(frames, dtype=object)
    kps = np.empty(frames, dtype=object)
    for i in range(frames):
        n = 0 if i == 1 else 2
        boxes[i] = [None, rng.random((n, 5)).astype(np.float32)]
        kps[i] = [None, rng.random((n, 6, 17)).astype(np.float32)]
    np.savez(path, boxes=boxes, keypoints=kps)


@pytest.mark.parametrize("suffix", ["test_cpn_coco", "detectron_pt_coco"])
def test_prepare_2d_generic_matches_jax(tmp_path, monkeypatch, suffix):
    """Generic detections (the CPN and the Detectron importers), with the
    corrupted S11 Directions and the _ALL files skipped, give the JAX
    npz."""
    src = tmp_path / "npz"
    src.mkdir()
    rng = np.random.default_rng(9)
    for name in ("S1_Walking_1.0.npz", "S1_Walking_1.2.npz",
                 "S11_Directions.0.npz", "S11_Directions_1.0.npz",
                 "S1_Walking_1_ALL.npz", "S5_TakingPhoto.1.npz"):
        if suffix.startswith("detectron"):
            _detectron_npz(str(src / name), 4, rng)
        else:
            np.savez(str(src / name), keypoints=rng.random(
                (3, 17, 3)).astype(np.float32))
    dirs = _run_both(tmp_path, monkeypatch,
                     lambda p, _: p.prepare_2d_generic(str(src), suffix))
    _same_outputs(dirs)
    poses = _npz(dirs[0] / f"data_2d_h36m_{suffix}.npz")["positions_2d"]
    assert set(poses["S11"]) == {"Directions 1"}
    assert set(poses["S5"]) == {"Photo"}


def _h36m_source(root, rng, frames=6):
    """Original-format .cdf.mat 3D poses (mm): 30 actions a subject."""
    from scipy.io import savemat

    actions = (["Directions", "TakingPhoto 1", "WalkingDog"]
               + [f"Action {i}" for i in range(27)])
    for subject in ("S1", "S5", "S6", "S7", "S8", "S9", "S11"):
        d = os.path.join(root, subject, "MyPoseFeatures", "D3_Positions")
        os.makedirs(d)
        for action in actions:
            pos = rng.uniform(-500, 500, (frames, 32, 3))
            pos[..., 2] = rng.uniform(100, 1800, (frames, 32))
            cell = np.empty((1, 1), dtype=object)
            cell[0, 0] = pos.reshape(frames, 96)
            savemat(os.path.join(d, f"{action}.cdf.mat"), {"data": cell})


def test_prepare_data_h36m_matches_jax(tmp_path, monkeypatch):
    """One run of ``python -m gastx_torch.cli.prepare_data h36m
    --from-source``: the 3D npz as JAX's, bitwise, and the ground-truth 2D
    projected through each camera at rtol 1e-5."""
    import gastx.cli.prepare_data as jpd

    src = str(tmp_path / "src")
    _h36m_source(src, np.random.default_rng(10))
    dirs = []
    for name, main in (("port", prepare_data.main), ("jax", jpd.main)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        main(["h36m", "--from-source", src])
        dirs.append(d)
    _assert_same(*(_npz(d / "data_3d_h36m.npz") for d in dirs))
    got, want = (_npz(d / "data_2d_h36m_gt.npz") for d in dirs)
    _assert_same(got["metadata"], want["metadata"])
    assert set(got["positions_2d"]["S11"]) == set(
        want["positions_2d"]["S11"])
    assert "Directions" not in got["positions_2d"]["S11"]
    for s, actions in want["positions_2d"].items():
        for a, cams in actions.items():
            for c, arr in enumerate(cams):
                g = got["positions_2d"][s][a][c]
                assert g.dtype == arr.dtype and g.shape == (6, 17, 2)
                np.testing.assert_allclose(g, arr, rtol=1e-5, atol=1e-4,
                                           err_msg=f"{s} {a} {c}")


@pytest.mark.parametrize("command", [None, "h36m", "2d_sh", "2d_generic",
                                     "humaneva"])
def test_prepare_data_help_matches_jax(capsys, command):
    """The port's CLI takes the JAX CLI's subcommands and flags."""
    import gastx.cli.prepare_data as jpd

    argv = [command, "--help"] if command else ["--help"]
    texts = []
    for main in (prepare_data.main, jpd.main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 0
        texts.append(capsys.readouterr().out)
    if command is None:
        texts = [t.replace("gastx_torch dataset", "gastx dataset")
                 for t in texts]
    assert texts[0] == texts[1]


def _humaneva_source(root, rng):
    """Processed HumanEva .mat files for Walking 1 of Train/S1 and
    Validate/S1, with a non-finite stretch that splits them into chunks;
    detections of S1 (C1) and of an unlabeled S4 video."""
    from scipy.io import savemat

    for split, frames in (("Train", 613), ("Validate", 585)):
        d = os.path.join(root, "mat", split, "S1")
        os.makedirs(d)
        pos = rng.standard_normal((frames, 15, 3)) * 300
        pos2d = rng.random((3, frames, 15, 2)) * 600
        pos[100:110] = np.nan
        pos2d[:, 100:110] = np.nan
        savemat(os.path.join(d, "Walking_1.mat"),
                {"poses_3d": pos, "poses_2d": pos2d})
    for subject, name, frames in (("S1", "Walking_1_(C1).avi.npz", 1300),
                                  ("S4", "Box_1_(C2).avi.npz", 50)):
        d = os.path.join(root, "det", subject)
        os.makedirs(d, exist_ok=True)
        np.savez(os.path.join(d, name), keypoints=rng.random(
            (frames, 15, 3)).astype(np.float32))


def test_prepare_humaneva_matches_jax(tmp_path, monkeypatch):
    """parse_humaneva_mat's chunks and frame mapping, prepare_humaneva_3d's
    npz files and prepare_humaneva_2d's synced, chunked detections equal
    the JAX package's."""
    root = str(tmp_path / "src")
    _humaneva_source(root, np.random.default_rng(11))
    mappings = []

    def run(_, ph):
        _, mapping = ph.prepare_humaneva_3d(os.path.join(root, "mat"))
        mappings.append(mapping)
        ph.prepare_humaneva_2d(os.path.join(root, "det"), "cpn_humaneva15",
                               mapping)

    dirs = _run_both(tmp_path, monkeypatch, run)
    _assert_same(*mappings)
    assert _same_outputs(dirs) == ["data_2d_humaneva15_cpn_humaneva15.npz",
                                   "data_2d_humaneva15_gt.npz",
                                   "data_3d_humaneva15.npz"]
    poses = _npz(dirs[0] / "data_2d_humaneva15_cpn_humaneva15.npz")[
        "positions_2d"]
    assert {"Train/S1", "Validate/S1", "Unlabeled/Train/S1",
            "Unlabeled/S4"} <= set(poses)


def test_prepare_refuses_malformed_input(tmp_path, monkeypatch, capsys):
    """Missing or malformed input raises (a ValueError, or the CLI's usage
    error), also under python -O."""
    from gastx_torch.data.prepare import prepare_2d_generic, prepare_h36m_3d

    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="no input files"):
        prepare_2d_generic(str(tmp_path), "test_cpn_coco")
    with pytest.raises(ValueError, match="exactly one"):
        prepare_h36m_3d()
    with pytest.raises(ValueError, match="Expected 30 files"):
        prepare_h36m_3d(from_source=str(tmp_path))
    with pytest.raises(SystemExit):
        prepare_data.main(["humaneva", "--convert-3d"])
    assert "--path required" in capsys.readouterr().err
