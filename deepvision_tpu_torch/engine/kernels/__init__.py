"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each wrapper launches its kernel on CUDA tensors, runs the plain version on
CPU tensors, and counts its launches in ``<wrapper>.launches``.
"""
