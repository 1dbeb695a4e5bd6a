"""Hand-written CUDA kernels for Hopper and their wrappers.

Importing this package builds nothing: a kernel is compiled at its first
launch on a CUDA tensor (or by ``kernels.build_kernels()``).
"""
