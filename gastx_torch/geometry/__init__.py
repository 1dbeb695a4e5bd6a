from gastx_torch.geometry.camera import (camera_to_world, image_coordinates,
                                         normalize_screen_coordinates,
                                         world_to_camera)
from gastx_torch.geometry.quaternion import qrot

__all__ = ["camera_to_world", "image_coordinates",
           "normalize_screen_coordinates", "qrot", "world_to_camera"]
