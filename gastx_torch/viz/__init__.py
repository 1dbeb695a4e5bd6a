"""Rendering and video IO on the host (copies of ``gastx.viz``).

cv2 and matplotlib are imported inside the functions that use them, so
this package imports on a machine that has neither."""
from gastx_torch.viz.animation import (
    color_edge,
    render_animation,
    render_animation_multiperson,
)
from gastx_torch.viz.draw2d import draw_bboxes, draw_keypoints, resize_img
from gastx_torch.viz.video_io import (
    downsample_tensor,
    get_fps,
    get_resolution,
    read_video,
)

__all__ = [
    "draw_bboxes",
    "draw_keypoints",
    "resize_img",
    "color_edge",
    "render_animation",
    "render_animation_multiperson",
    "downsample_tensor",
    "get_fps",
    "get_resolution",
    "read_video",
]
