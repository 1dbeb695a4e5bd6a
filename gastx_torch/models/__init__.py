from gastx_torch.models.config import (TPU_MIXED_PRECISION_OVERRIDES,
                                       GastNetConfig, config_for_frames,
                                       graph_statics)
from gastx_torch.models.gastnet import GastNet
from gastx_torch.models.init import (build_gastnet, init_gastnet,
                                     randomize_eval_statistics)

__all__ = ["TPU_MIXED_PRECISION_OVERRIDES", "GastNetConfig",
           "config_for_frames", "graph_statics", "GastNet",
           "build_gastnet", "init_gastnet", "randomize_eval_statistics"]
