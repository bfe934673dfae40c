"""PyTorch/CUDA port of the deepvision_tpu serving engine.

The JAX package ``deepvision_tpu`` stays the reference; this package
imports nothing from it and nothing of JAX.  Its entry points run on a CUDA
device unless the caller passes ``device="cpu"``.
"""
