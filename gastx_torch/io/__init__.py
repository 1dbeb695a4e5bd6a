from gastx_torch.io.torch_import import load_torch_checkpoint, params_from_jax

__all__ = ["load_torch_checkpoint", "params_from_jax"]
