"""Host-side video IO: the port's copy of ``gastx.viz.video_io``.

Functional parity with the reference's decode helpers
(tools/visualization.py:38-81): probe resolution/fps, stream RGB frames,
mean-pool temporal downsampling. Primary backend is OpenCV, imported
inside each function; the reference's ffmpeg/ffprobe subprocess pipes are
used as a fallback when cv2 is unavailable.
"""
from __future__ import annotations

import shutil
import subprocess as sp
from typing import Iterator, Tuple

import numpy as np


def _has_cv2() -> bool:
    try:
        import cv2  # noqa
        return True
    except ImportError:
        return False


def get_resolution(filename: str) -> Tuple[int, int]:
    if _has_cv2():
        import cv2

        cap = cv2.VideoCapture(filename)
        try:
            return (int(round(cap.get(cv2.CAP_PROP_FRAME_WIDTH))),
                    int(round(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))))
        finally:
            cap.release()
    cmd = ["ffprobe", "-v", "error", "-select_streams", "v:0",
           "-show_entries", "stream=width,height", "-of", "csv=p=0",
           filename]
    out = sp.check_output(cmd).decode().strip().splitlines()[0]
    w, h = out.split(",")[:2]
    return int(w), int(h)


def get_fps(filename: str) -> float:
    if _has_cv2():
        import cv2

        cap = cv2.VideoCapture(filename)
        try:
            return float(cap.get(cv2.CAP_PROP_FPS))
        finally:
            cap.release()
    cmd = ["ffprobe", "-v", "error", "-select_streams", "v:0",
           "-show_entries", "stream=r_frame_rate", "-of", "csv=p=0",
           filename]
    out = sp.check_output(cmd).decode().strip().splitlines()[0]
    num, den = out.split("/")
    return int(num) / int(den)


def read_video(filename: str, skip: int = 0, limit: int = -1,
               bgr: bool = False) -> Iterator[np.ndarray]:
    """Yield (H, W, 3) uint8 RGB frames (BGR, as OpenCV decodes them, with
    ``bgr``)."""
    if _has_cv2():
        import cv2

        cap = cv2.VideoCapture(filename)
        i = 0
        try:
            while True:
                ret, frame = cap.read()
                if not ret:
                    break
                i += 1
                if limit != -1 and i > limit:
                    break  # pull-based reader: stop decoding immediately
                if i > skip:
                    yield frame if bgr else frame[:, :, ::-1]  # -> RGB
        finally:
            cap.release()
        return

    if not shutil.which("ffmpeg"):
        raise RuntimeError("neither OpenCV nor ffmpeg is available for "
                           "video decoding")
    w, h = get_resolution(filename)
    cmd = ["ffmpeg", "-i", filename, "-f", "image2pipe", "-pix_fmt",
           "bgr24" if bgr else "rgb24", "-vsync", "0", "-vcodec", "rawvideo",
           "-"]
    i = 0
    with sp.Popen(cmd, stdout=sp.PIPE, stderr=sp.DEVNULL,
                  bufsize=-1) as pipe:
        while True:
            data = pipe.stdout.read(w * h * 3)
            if not data or len(data) < w * h * 3:
                break
            i += 1
            if limit != -1 and i > limit:
                continue
            if i > skip:
                yield np.frombuffer(data, dtype=np.uint8).reshape((h, w, 3))


def downsample_tensor(x: np.ndarray, factor: int) -> np.ndarray:
    """Mean-pool along the leading (time) axis."""
    length = x.shape[0] // factor * factor
    return np.mean(x[:length].reshape(-1, factor, *x.shape[1:]), axis=1)
