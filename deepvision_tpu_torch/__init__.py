"""PyTorch/CUDA port of deepvision_tpu: the serving engine, the trainer
and the interview app (``python -m deepvision_tpu_torch.web.server``).

The JAX package ``deepvision_tpu`` stays the reference; this package
imports nothing from it and nothing of JAX.  Its entry points run on a CUDA
device unless the caller passes ``device="cpu"``.
"""
