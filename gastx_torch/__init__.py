"""gastx_torch — the PyTorch/CUDA port of gastx for NVIDIA Hopper.

A second package beside ``gastx`` (the JAX reference). It imports torch
and numpy only: nothing of JAX and nothing of ``gastx``. The port computes
in float32 throughout. Every entry point runs on ``cuda`` unless the
caller passes ``device="cpu"``; on the CPU each kernel wrapper runs its
plain PyTorch version.
"""
from gastx_torch.device import resolve_device

__all__ = ["resolve_device"]
