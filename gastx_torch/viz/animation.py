"""3D pose animation rendering (matplotlib, host-side): the port's copy
of ``gastx.viz.animation``.

  * ``render_animation`` — single-pose-per-axes renderer used by trainval
    --render and the reconstruct CLI (reference tools/visualization.py:84-227):
    left panel shows the input video frame with the 2D keypoint overlay,
    one 3D panel per entry of ``poses``; trajectory-following axis limits;
    mp4 (ffmpeg, else OpenCV's mp4v encoder, else a gif) / gif (imagemagick
    or pillow) export.
  * ``render_animation_multiperson`` — all persons in ONE 3D axes (the
    reference's two-person "com_reconstruction" mode, tools/vis_h36m.py:58-249)
    with per-bone colors.

Nothing here runs on the GPU. matplotlib and cv2 are imported inside the
functions, so the package imports where they are missing; rendering there
raises a ``RuntimeError`` that says so.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from gastx_torch.viz.video_io import downsample_tensor, read_video

# Joint-group colors for the 17-joint H36M layout
# (tools/visualization.py:11-35 / tools/color_edge.py:12-29).
_JOINT_COLOR_GROUPS = {
    "peru": (5, 15), "indianred": (2, 12), "coral": (6, 16),
    "brown": (3, 13), "tan": (1, 4, 11, 14), "olive": (7, 9),
}


def _pyplot():
    """matplotlib's pyplot on the Agg backend; a RuntimeError where
    matplotlib is not installed (rendering never skips quietly)."""
    try:
        import matplotlib
    except ImportError as exc:
        raise RuntimeError("rendering needs matplotlib, which is not "
                           "installed here") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def color_edge(joint_num: int) -> str:
    for color, joints in _JOINT_COLOR_GROUPS.items():
        if joint_num in joints:
            return color
    return "purple"


def _make_cv2_writer(fps: int):
    """A matplotlib MovieWriter that encodes mp4 through OpenCV's bundled
    mp4v encoder — covers the reference's ffmpeg export surface
    (tools/visualization.py:219-226) on hosts without ffmpeg."""
    import cv2
    import matplotlib.animation

    class _Cv2MovieWriter(matplotlib.animation.AbstractMovieWriter):
        def __init__(self, fps):
            super().__init__(fps=fps, codec="mp4v")
            self._writer = None

        @classmethod
        def isAvailable(cls):
            return True

        def setup(self, fig, outfile, dpi=None):
            super().setup(fig, outfile, dpi=dpi)
            # canvas.draw() renders at the figure's own dpi, so apply the
            # requested one (ffmpeg/pillow writers do this via savefig);
            # restored in finish() so later renders of the same figure
            # keep the caller's dpi.
            self._orig_dpi = fig.dpi
            fig.dpi = self.dpi

        def grab_frame(self, **savefig_kwargs):
            self.fig.canvas.draw()
            buf = np.asarray(self.fig.canvas.buffer_rgba())[..., :3]
            # mp4v wants even frame dimensions
            h, w = (d - d % 2 for d in buf.shape[:2])
            buf = buf[:h, :w]
            if self._writer is None:
                self._writer = cv2.VideoWriter(
                    self.outfile, cv2.VideoWriter_fourcc(*self.codec),
                    self.fps, (w, h))
                if not self._writer.isOpened():
                    raise RuntimeError(
                        f"cv2.VideoWriter could not open {self.outfile}")
            self._writer.write(cv2.cvtColor(buf, cv2.COLOR_RGB2BGR))

        def finish(self):
            if self._writer is not None:
                self._writer.release()
            if getattr(self, "_orig_dpi", None) is not None:
                self.fig.dpi = self._orig_dpi

    return _Cv2MovieWriter(fps=fps)


def _save_animation(anim, output: str, fps: int, bitrate: int) -> None:
    import shutil

    import matplotlib

    if output.endswith(".mp4"):
        if shutil.which("ffmpeg"):
            writer = matplotlib.animation.writers["ffmpeg"](
                fps=fps, metadata={}, bitrate=bitrate)
            anim.save(output, writer=writer)
            return
        try:
            anim.save(output, dpi=80, writer=_make_cv2_writer(fps))
        except (ImportError, RuntimeError) as exc:
            # Only encoder-unavailability (no cv2 / VideoWriter won't
            # open) falls back to GIF; genuine render bugs propagate.
            import os
            if os.path.exists(output):
                os.unlink(output)  # drop the partial mp4
            fallback = output[:-4] + ".gif"
            print(f"WARNING: no mp4 encoder ({exc}); "
                  f"writing {fallback} instead")
            anim.save(fallback, dpi=80, writer="pillow")
    elif output.endswith(".gif"):
        writer = ("imagemagick"
                  if shutil.which("convert") or shutil.which("magick")
                  else "pillow")
        anim.save(output, dpi=80, writer=writer)
    else:
        raise ValueError(f"Unsupported output format: {output}")


def _background_frames(input_video_path: Optional[str], n_frames: int,
                       viewport, skip: int, limit: int, downsample: int):
    if input_video_path is None:
        all_frames = np.zeros((n_frames, viewport[1], viewport[0]),
                              dtype=np.uint8)
    else:
        all_frames = []
        for f in read_video(input_video_path, skip=skip, limit=limit):
            all_frames.append(f)
        all_frames = np.array(all_frames)
        if downsample > 1:
            all_frames = downsample_tensor(all_frames,
                                           downsample).astype(np.uint8)
    return all_frames


def render_animation(keypoints: np.ndarray, keypoints_metadata: Dict,
                     poses: Dict[str, np.ndarray], skeleton, fps: int,
                     bitrate: int, azim: float, output: str, viewport,
                     limit: int = -1, downsample: int = 1, size: int = 6,
                     input_video_path: Optional[str] = None,
                     input_video_skip: int = 0) -> None:
    """Render input-2D + per-pose 3D panels to mp4/gif.

    ``keypoints``: (T, J, 2) pixel coords; ``poses``: {title: (T, J, 3)}
    world-space poses; ``skeleton``: a gastx_torch Skeleton for bone
    topology.
    """
    plt = _pyplot()
    from matplotlib.animation import FuncAnimation

    plt.ioff()
    pose_list = list(poses.items())
    fig = plt.figure(figsize=(size * (1 + len(pose_list)), size))
    ax_in = fig.add_subplot(1, 1 + len(pose_list), 1)
    ax_in.set_axis_off()

    radius = 1.7
    ax_3d, trajectories = [], []
    for index, (_title, data) in enumerate(pose_list):
        ax = fig.add_subplot(1, 1 + len(pose_list), index + 2,
                             projection="3d")
        ax.view_init(elev=15.0, azim=azim)
        ax.set_xlim3d([-radius / 2, radius / 2])
        ax.set_zlim3d([0, radius])
        ax.set_ylim3d([-radius / 2, radius / 2])
        ax.set_xticklabels([])
        ax.set_yticklabels([])
        ax.set_zticklabels([])
        try:
            ax.dist = 7.5
        except AttributeError:
            pass  # removed in newer matplotlib
        ax_3d.append(ax)
        trajectories.append(data[:, 0, [0, 1]])

    poses_data = [data for _, data in pose_list]
    n_frames = len(poses_data[0]) if poses_data else len(keypoints)
    all_frames = _background_frames(input_video_path, n_frames, viewport,
                                    input_video_skip, limit, downsample)

    if downsample > 1:
        keypoints = downsample_tensor(keypoints, downsample)
        poses_data = [downsample_tensor(d, downsample) for d in poses_data]
        trajectories = [downsample_tensor(t, downsample)
                        for t in trajectories]
        fps = max(1, fps // downsample)

    n_render = min(len(keypoints), *(len(d) for d in poses_data)) \
        if poses_data else len(keypoints)
    n_render = min(n_render, len(all_frames)) if len(all_frames) else n_render
    if limit > 0:
        n_render = min(n_render, limit)

    parents = skeleton.parents()
    joints_right = set(skeleton.joints_right())
    joints_right_2d = set(keypoints_metadata["keypoints_symmetry"][1])

    state = {"image": None, "lines": [], "points": None, "lines_3d":
             [[] for _ in poses_data], "init": False}

    def update(i):
        # Follow the trajectory with the 3D view window.
        for n, ax in enumerate(ax_3d):
            ax.set_xlim3d([-radius / 2 + trajectories[n][i, 0],
                           radius / 2 + trajectories[n][i, 0]])
            ax.set_ylim3d([-radius / 2 + trajectories[n][i, 1],
                           radius / 2 + trajectories[n][i, 1]])

        if not state["init"]:
            state["image"] = ax_in.imshow(all_frames[i], aspect="equal")
            for j, parent in enumerate(parents):
                if parent == -1:
                    continue
                col = ("red" if j in joints_right_2d else "black")
                state["lines"].append(ax_in.plot(
                    [keypoints[i, j, 0], keypoints[i, parent, 0]],
                    [keypoints[i, j, 1], keypoints[i, parent, 1]],
                    color=col)[0])
                for n, ax in enumerate(ax_3d):
                    pos = poses_data[n][i]
                    state["lines_3d"][n].append(ax.plot(
                        [pos[j, 0], pos[parent, 0]],
                        [pos[j, 1], pos[parent, 1]],
                        [pos[j, 2], pos[parent, 2]],
                        zdir="z", c=color_edge(j))[0])
            state["points"] = ax_in.scatter(*keypoints[i].T, 10,
                                            color="red", edgecolors="white",
                                            zorder=10)
            state["init"] = True
            return

        state["image"].set_data(all_frames[i])
        k = 0
        for j, parent in enumerate(parents):
            if parent == -1:
                continue
            state["lines"][k].set_data(
                [keypoints[i, j, 0], keypoints[i, parent, 0]],
                [keypoints[i, j, 1], keypoints[i, parent, 1]])
            for n in range(len(poses_data)):
                pos = poses_data[n][i]
                state["lines_3d"][n][k].set_data(
                    np.array([[pos[j, 0], pos[parent, 0]],
                              [pos[j, 1], pos[parent, 1]]]))
                state["lines_3d"][n][k].set_3d_properties(
                    np.array([pos[j, 2], pos[parent, 2]]), zdir="z")
            k += 1
        state["points"].set_offsets(keypoints[i])

    fig.tight_layout()
    anim = FuncAnimation(fig, update, frames=n_render,
                         interval=1000.0 / fps, repeat=False)
    _save_animation(anim, output, fps, bitrate)
    plt.close()


def render_animation_multiperson(
        keypoints: np.ndarray, keypoints_metadata: Dict,
        poses: List[np.ndarray], skeleton, fps: int, bitrate: int,
        azim: float, output: str, viewport, limit: int = -1,
        downsample: int = 1, size: int = 6,
        input_video_path: Optional[str] = None,
        input_video_skip: int = 0) -> None:
    """All persons rendered in a single 3D axes (tools/vis_h36m.py:58-249).

    ``keypoints``: (M, T, J, 2); ``poses``: list of (T, J, 3) per person.
    """
    plt = _pyplot()
    from matplotlib.animation import FuncAnimation

    plt.ioff()
    fig = plt.figure(figsize=(size * 2, size))
    ax_in = fig.add_subplot(1, 2, 1)
    ax_in.set_axis_off()

    radius = 1.7
    ax = fig.add_subplot(1, 2, 2, projection="3d")
    ax.view_init(elev=15.0, azim=azim)
    centers = np.concatenate([p[:, 0, :2] for p in poses], axis=0)
    cx, cy = centers[:, 0].mean(), centers[:, 1].mean()
    span = max(radius, np.abs(centers - [cx, cy]).max() + radius / 2)
    ax.set_xlim3d([cx - span, cx + span])
    ax.set_ylim3d([cy - span, cy + span])
    ax.set_zlim3d([0, 2 * span])
    ax.set_xticklabels([])
    ax.set_yticklabels([])
    ax.set_zticklabels([])

    n_frames = min(p.shape[0] for p in poses)
    all_frames = _background_frames(input_video_path, n_frames, viewport,
                                    input_video_skip, limit, downsample)
    if downsample > 1:
        keypoints = np.stack([downsample_tensor(k, downsample)
                              for k in keypoints])
        poses = [downsample_tensor(p, downsample) for p in poses]
        fps = max(1, fps // downsample)
        n_frames = min(p.shape[0] for p in poses)

    n_render = min(n_frames, len(all_frames)) if len(all_frames) else n_frames
    if limit > 0:
        n_render = min(n_render, limit)

    parents = skeleton.parents()
    state = {"image": None, "lines": [], "lines_3d": [[] for _ in poses],
             "init": False}

    def update(i):
        if not state["init"]:
            state["image"] = ax_in.imshow(all_frames[i], aspect="equal")
            for m, person_kpts in enumerate(keypoints):
                for j, parent in enumerate(parents):
                    if parent == -1:
                        continue
                    state["lines"].append(ax_in.plot(
                        [person_kpts[i, j, 0], person_kpts[i, parent, 0]],
                        [person_kpts[i, j, 1], person_kpts[i, parent, 1]],
                        color="black")[0])
            for m, pose in enumerate(poses):
                for j, parent in enumerate(parents):
                    if parent == -1:
                        continue
                    state["lines_3d"][m].append(ax.plot(
                        [pose[i, j, 0], pose[i, parent, 0]],
                        [pose[i, j, 1], pose[i, parent, 1]],
                        [pose[i, j, 2], pose[i, parent, 2]],
                        zdir="z", c=color_edge(j))[0])
            state["init"] = True
            return
        state["image"].set_data(all_frames[i])
        k = 0
        for m, person_kpts in enumerate(keypoints):
            for j, parent in enumerate(parents):
                if parent == -1:
                    continue
                state["lines"][k].set_data(
                    [person_kpts[i, j, 0], person_kpts[i, parent, 0]],
                    [person_kpts[i, j, 1], person_kpts[i, parent, 1]])
                k += 1
        for m, pose in enumerate(poses):
            for kk, (j, parent) in enumerate(
                    [(j, p) for j, p in enumerate(parents) if p != -1]):
                state["lines_3d"][m][kk].set_data(
                    np.array([[pose[i, j, 0], pose[i, parent, 0]],
                              [pose[i, j, 1], pose[i, parent, 1]]]))
                state["lines_3d"][m][kk].set_3d_properties(
                    np.array([pose[i, j, 2], pose[i, parent, 2]]), zdir="z")

    fig.tight_layout()
    anim = FuncAnimation(fig, update, frames=n_render,
                         interval=1000.0 / fps, repeat=False)
    _save_animation(anim, output, fps, bitrate)
    plt.close()
