from gastx_torch.io.jax_checkpoint import (adam_state_dict,
                                           load_jax_checkpoint)
from gastx_torch.io.torch_import import (ablation_params_from_jax,
                                         load_torch_checkpoint,
                                         params_from_jax)

__all__ = ["ablation_params_from_jax", "adam_state_dict",
           "load_jax_checkpoint", "load_torch_checkpoint", "params_from_jax"]
