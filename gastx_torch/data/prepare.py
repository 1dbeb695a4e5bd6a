"""Offline dataset preparation: source archives -> the npz files consumed by
the training harness (the port's copy of ``gastx.data.prepare``; host
numpy, with h5py and scipy imported inside the functions that read those
formats).

Parity targets (reference ``data/`` scripts, SURVEY.md §2.6):
  * :func:`prepare_h36m_3d` — Martinez-preprocessed .h5 archive or original
    .cdf.mat source -> ``data_3d_h36m.npz`` (mm->m, 32 joints)
    (data/prepare_data_h36m.py:42-100).
  * :func:`compute_h36m_gt_2d` — GT 3D projected through each camera's full
    distortion model -> ``data_2d_h36m_gt.npz`` (:106-129).
  * :func:`prepare_2d_sh` — Stacked-Hourglass .h5 detections ->
    ``data_2d_h36m_sh_*.npz`` (data/prepare_data_2d_h36m_sh.py:16-105).
  * :func:`prepare_2d_generic` — detectron/cpn npz detections
    (data/prepare_data_2d_h36m_generic.py:44-81, importers from
    data/data_utils.py:57-95).
  * layout metadata tables (data/data_utils.py:4-47).

CLI: ``python -m gastx_torch.cli.prepare_data {h36m,2d_sh,2d_generic,humaneva} ...``
"""
from __future__ import annotations

import os
from glob import glob
from typing import Dict, List, Optional

import numpy as np

H36M_SUBJECTS = ["S1", "S5", "S6", "S7", "S8", "S9", "S11"]

# --- layout metadata (data/data_utils.py:4-47) ---
MPII_METADATA = {
    "layout_name": "mpii", "num_joints": 16,
    "keypoints_symmetry": [[3, 4, 5, 13, 14, 15], [0, 1, 2, 10, 11, 12]],
}
COCO_METADATA = {
    "layout_name": "coco", "num_joints": 17,
    "keypoints_symmetry": [[1, 3, 5, 7, 9, 11, 13, 15],
                           [2, 4, 6, 8, 10, 12, 14, 16]],
}
H36M_METADATA = {
    "layout_name": "h36m", "num_joints": 17,
    "keypoints_symmetry": [[4, 5, 6, 11, 12, 13], [1, 2, 3, 14, 15, 16]],
}
HUMANEVA15_METADATA = {
    "layout_name": "humaneva15", "num_joints": 15,
    "keypoints_symmetry": [[2, 3, 4, 8, 9, 10], [5, 6, 7, 11, 12, 13]],
}
HUMANEVA20_METADATA = {
    "layout_name": "humaneva20", "num_joints": 20,
    "keypoints_symmetry": [[3, 4, 5, 6, 11, 12, 13, 14],
                           [7, 8, 9, 10, 15, 16, 17, 18]],
}
_ALL_METADATA = (MPII_METADATA, COCO_METADATA, H36M_METADATA,
                 HUMANEVA15_METADATA, HUMANEVA20_METADATA)


def check(condition: bool, message: str) -> None:
    """Refuse malformed input with a ValueError (which, unlike an assert,
    also holds under -O)."""
    if not condition:
        raise ValueError(message)


def suggest_metadata(name: str) -> Dict:
    for metadata in _ALL_METADATA:
        if metadata["layout_name"] in name:
            return metadata
    raise KeyError(f"Cannot infer keypoint layout from name {name!r}")


# --- pose importers (data/data_utils.py:57-95) ---

def import_detectron_poses(path: str) -> np.ndarray:
    data = np.load(path, encoding="latin1", allow_pickle=True)
    kp, bb = data["keypoints"], data["boxes"]
    results: List[np.ndarray] = []
    for i in range(len(bb)):
        if len(bb[i][1]) == 0:
            check(i > 0, "first frame must contain a detection")
            results.append(results[-1])  # reuse last pose on failure
            continue
        best_match = np.argmax(bb[i][1][:, 4])
        results.append(kp[i][1][best_match].T.copy())
    return np.array(results)[:, :, 4:6]  # soft-argmax coords


def import_cpn_poses(path: str) -> np.ndarray:
    data = np.load(path, allow_pickle=True)
    return data["keypoints"][:, :, :2]


def import_sh_poses(path: str) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as hf:
        return np.array(hf["poses"]).astype("float32")


def suggest_pose_importer(name: str):
    if "detectron" in name:
        return import_detectron_poses
    if "cpn" in name:
        return import_cpn_poses
    if "sh" in name:
        return import_sh_poses
    raise KeyError(f"Cannot infer keypoint format from name {name!r}")


# --- Human3.6M 3D ---

def prepare_h36m_3d(from_archive: Optional[str] = None,
                    from_source: Optional[str] = None,
                    output: str = "data_3d_h36m.npz") -> str:
    """Convert H36M source data to the serialized positions_3d npz."""
    check(bool(from_archive) != bool(from_source),
          "specify exactly one of from_archive / from_source")
    if os.path.exists(output):
        print("The dataset already exists at", output)
        return output

    out: Dict[str, Dict[str, np.ndarray]] = {}
    if from_archive:
        import h5py
        import zipfile
        from shutil import rmtree

        print("Extracting Human3.6M dataset from", from_archive)
        with zipfile.ZipFile(from_archive, "r") as archive:
            archive.extractall()
        for subject in H36M_SUBJECTS:
            out[subject] = {}
            file_list = glob(f"h36m/{subject}/MyPoses/3D_positions/*.h5")
            check(len(file_list) == 30,
                  f"Expected 30 files for {subject}, got {len(file_list)}")
            for f in file_list:
                action = os.path.splitext(os.path.basename(f))[0]
                if subject == "S11" and action == "Directions":
                    continue  # corrupted video
                with h5py.File(f, "r") as hf:
                    positions = np.array(hf["3D_positions"]).reshape(
                        32, 3, -1).transpose(2, 0, 1)
                out[subject][action] = (positions / 1000).astype("float32")
        rmtree("h36m")
    else:
        from scipy.io import loadmat

        for subject in H36M_SUBJECTS:
            out[subject] = {}
            file_list = glob(
                f"{from_source}/{subject}/MyPoseFeatures/D3_Positions/"
                "*.cdf.mat")
            check(len(file_list) == 30,
                  f"Expected 30 files for {subject}, got {len(file_list)}")
            for f in file_list:
                action = os.path.splitext(
                    os.path.splitext(os.path.basename(f))[0])[0]
                if subject == "S11" and action == "Directions":
                    continue
                canonical = action.replace("TakingPhoto", "Photo") \
                                  .replace("WalkingDog", "WalkDog")
                positions = loadmat(f)["data"][0, 0].reshape(-1, 32, 3)
                out[subject][canonical] = (positions / 1000).astype("float32")

    np.savez_compressed(os.path.splitext(output)[0], positions_3d=out)
    return output


def compute_h36m_gt_2d(dataset_path: str = "data_3d_h36m.npz",
                       output: str = "data_2d_h36m_gt.npz") -> str:
    """Project GT 3D through each camera's distortion model -> pixel 2D."""
    import torch

    from gastx_torch.data.h36m import Human36mDataset
    from gastx_torch.geometry import (image_coordinates, project_to_2d,
                                      world_to_camera)

    # default joint reduction -> 17-joint GT 2D, matching the reference's
    # Human36mDataset(...) default (data/prepare_data_h36m.py:109)
    dataset = Human36mDataset(dataset_path)
    out: Dict[str, Dict[str, List[np.ndarray]]] = {}
    for subject in dataset.subjects():
        out[subject] = {}
        for action in dataset[subject].keys():
            anim = dataset[subject][action]
            positions_2d = []
            for cam in anim["cameras"]:
                pos_3d = world_to_camera(
                    anim["positions"], R=cam["orientation"],
                    t=cam["translation"])
                pos_2d = project_to_2d(
                    torch.from_numpy(pos_3d[None]),
                    torch.from_numpy(cam["intrinsic"][None])).numpy()[0]
                pos_2d_px = image_coordinates(pos_2d, w=cam["res_w"],
                                              h=cam["res_h"])
                positions_2d.append(pos_2d_px.astype("float32"))
            out[subject][action] = positions_2d

    metadata = {
        "num_joints": dataset.skeleton().num_joints(),
        "keypoints_symmetry": [dataset.skeleton().joints_left(),
                               dataset.skeleton().joints_right()],
    }
    np.savez_compressed(os.path.splitext(output)[0], positions_2d=out,
                        metadata=metadata)
    return output


# --- 2D detections (SH / generic) ---

def prepare_2d_sh(archive_pt: Optional[str] = None,
                  archive_ft: Optional[str] = None,
                  dataset_path: str = "data_3d_h36m.npz") -> List[str]:
    """Stacked-Hourglass .h5 archives -> data_2d_h36m_sh_{pt_mpii,ft_h36m}.npz
    (data/prepare_data_2d_h36m_sh.py:53-105)."""
    import h5py
    import tarfile
    import zipfile
    from shutil import rmtree

    outputs = []
    for archive, suffix in ((archive_pt, "sh_pt_mpii"),
                            (archive_ft, "sh_ft_h36m")):
        if not archive:
            continue
        # The pretrained release is a ZIP with an extra h36m/ directory
        # level ('h36m/<subject>/StackedHourglass/*.h5'); the fine-tuned
        # one a tar.gz of '<subject>/StackedHourglassFineTuned240/*.h5'
        # (prepare_data_2d_h36m_sh.py:67-75,86-96). Handle both container
        # formats and both directory shapes. Clean sh_tmp before AND after
        # (try/finally): a failed previous run must never leave stale
        # subject trees that a later run would silently convert.
        rmtree("sh_tmp", ignore_errors=True)
        try:
            if zipfile.is_zipfile(archive):
                with zipfile.ZipFile(archive) as zf:
                    zf.extractall("sh_tmp")
            else:
                with tarfile.open(archive) as tar:
                    tar.extractall("sh_tmp", filter="data")
            out: Dict[str, Dict[str, List]] = {}
            subject_dirs = sorted(glob("sh_tmp/S*")) or sorted(
                glob("sh_tmp/*/S*"))
            check(bool(subject_dirs),
                  "no S* subject directories found in archive")
            for subject_dir in subject_dirs:
                subject = os.path.basename(subject_dir)
                out[subject] = {}
                files = sorted(glob(subject_dir + "/StackedHourglass*/*.h5"))
                check(bool(files), f"no .h5 files under {subject_dir}")
                for f in files:
                    action_cam = os.path.splitext(os.path.basename(f))[0]
                    action, cam = action_cam.rsplit(".", 1)
                    action = action.replace("_", " ").replace(
                        "TakingPhoto", "Photo").replace("WalkingDog",
                                                        "WalkDog")
                    if subject == "S11" and action == "Directions":
                        continue  # corrupted video (reference :43-45)
                    with h5py.File(f, "r") as hf:
                        poses = np.array(hf["poses"]).astype("float32")
                    out[subject].setdefault(action, [None] * 4)
                    cam_ids = ["54138969", "55011271", "58860488",
                               "60457274"]
                    out[subject][action][cam_ids.index(cam)] = poses
            output = f"data_2d_h36m_{suffix}.npz"
            np.savez_compressed(os.path.splitext(output)[0],
                                positions_2d=out, metadata=MPII_METADATA)
            outputs.append(output)
        finally:
            rmtree("sh_tmp", ignore_errors=True)
    return outputs


def prepare_2d_generic(input_dir: str, output_suffix: str,
                       dataset_path: str = "data_3d_h36m.npz") -> str:
    """Generic per-(subject, action, cam) npz detections ->
    data_2d_h36m_<suffix>.npz (data/prepare_data_2d_h36m_generic.py:44-81).

    Input files are named ``<subject>_<action>.<cam_index>.npz``.
    """
    importer = suggest_pose_importer(output_suffix)
    metadata = suggest_metadata(output_suffix)

    out: Dict[str, Dict[str, List]] = {}
    file_list = glob(input_dir + "/S*_*.npz")
    check(bool(file_list), f"no input files found in {input_dir}")
    for f in file_list:
        path, fname = os.path.split(f)
        if "_ALL" in fname:
            continue  # concatenated-cameras file (reference :55-56)
        subject, rest = fname.split("_", 1)
        action, cam = rest.rsplit(".", 2)[:2]
        action = action.replace("_", " ").replace("TakingPhoto", "Photo") \
            .replace("WalkingDog", "WalkDog")
        if subject == "S11" and action == "Directions":
            # Corrupted video, absent from the 3D npz
            # (reference prepare_data_2d_h36m_generic.py:64-66).
            continue
        keypoints = importer(f)
        out.setdefault(subject, {}).setdefault(action, [None] * 4)
        out[subject][action][int(cam)] = keypoints.astype("float32")

    output = f"data_2d_h36m_{output_suffix}.npz"
    np.savez_compressed(os.path.splitext(output)[0], positions_2d=out,
                        metadata=metadata)
    return output
