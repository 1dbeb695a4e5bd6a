from gastx_torch.skeleton.skeleton import Skeleton
from gastx_torch.skeleton.layouts import (
    JointLayout,
    LAYOUTS,
    KEYPOINT_METADATA,
    H36M_17,
    H36M_19,
    SH_16,
    HUMANEVA_15,
    get_layout,
)
from gastx_torch.skeleton.adjacency import (
    adj_from_edges,
    adj_from_skeleton,
    local_adjacencies,
)

__all__ = [
    "Skeleton",
    "JointLayout",
    "LAYOUTS",
    "KEYPOINT_METADATA",
    "H36M_17",
    "H36M_19",
    "SH_16",
    "HUMANEVA_15",
    "get_layout",
    "adj_from_edges",
    "adj_from_skeleton",
    "local_adjacencies",
]
