from gastx_torch.geometry.camera import (camera_to_world,
                                         normalize_screen_coordinates)
from gastx_torch.geometry.quaternion import qrot

__all__ = ["camera_to_world", "normalize_screen_coordinates", "qrot"]
