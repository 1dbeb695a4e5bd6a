from gastx_torch.geometry.camera import (camera_to_world, image_coordinates,
                                         normalize_screen_coordinates,
                                         project_to_2d, world_to_camera)
from gastx_torch.geometry.quaternion import qinverse, qrot

__all__ = ["camera_to_world", "image_coordinates",
           "normalize_screen_coordinates", "project_to_2d", "qinverse",
           "qrot", "world_to_camera"]
