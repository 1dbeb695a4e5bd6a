"""Plain PyTorch ops (the references) and, under ``cuda``, the kernels."""
