"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each wrapper launches its kernel on CUDA tensors, runs the plain version on
CPU tensors, and counts its launches in ``<wrapper>.launches``.  The
package exports the read-only paged decode attention, as the JAX kernels
package does.
"""

from deepvision_tpu_torch.engine.kernels.paged_attention import (  # noqa: F401
    paged_attention,
    paged_attention_reference,
)
