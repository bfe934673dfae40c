"""The exact three-term bf16 split of a float32 matrix: CUDA kernel + plain
version.

``split_bf16(t, dim)`` gives ``hi = bf16(t)``, ``mid = bf16(t - hi)`` and
``lo = bf16(t - hi - mid)`` stacked along ``dim`` smallest first (``lo``,
``mid``, ``hi``: the order in which a product adds them up); they add up to
``t`` bit for bit wherever ``|t| >= 2**-110`` (``csrc/bf16_split.cu``
has the rule for smaller and non-finite values).  The float32 matmuls of
``engine/f32_matmul.py`` run on the tensor cores as sums of these terms'
products.  It replaces no TPU kernel (the JAX package leaves its float32
matmuls to XLA).

On a CUDA tensor the wrapper launches ``csrc/bf16_split.cu`` and counts it
in ``split_bf16.launches``; on a CPU tensor it runs
:func:`split_bf16_reference`.
"""

from __future__ import annotations

import torch

from deepvision_tpu_torch.engine.kernels import _build

BF16_MAX = torch.finfo(torch.bfloat16).max


def split_bf16(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The terms of a float32 matrix ``t [R, C]`` stacked along ``dim``:
    ``[3R, C]`` (dim 0) or ``[R, 3C]`` (dim 1), bf16, blocks ``lo``,
    ``mid``, ``hi``.  A transposed contiguous ``t`` (``w.t()``) is read as
    it lies, and the result is its terms' buffer seen the same way."""
    return _split(t, (dim,))[0]


def split_bf16_both(t: torch.Tensor):
    """``(split_bf16(t, 0), split_bf16(t, 1))`` from one pass over ``t``."""
    return _split(t, (0, 1))


split_bf16.launches = 0


def _split(t: torch.Tensor, dims) -> list:
    if (t.dtype != torch.float32 or t.dim() != 2
            or any(d not in (0, 1) for d in dims)):
        raise ValueError(f"split_bf16: a float32 matrix and dim 0 or 1, "
                         f"got {t.dtype} {tuple(t.shape)} dims {dims}")
    if t.device.type == "cpu":
        return [split_bf16_reference(t, d) for d in dims]
    R, C = t.shape
    flip = t.stride() == (1, R) and not t.is_contiguous()
    if flip:
        C, R = R, C
    else:
        t = t.contiguous()
    outs, strides = [], []
    for d in dims:
        if (d == 0) != flip:      # stacked along the rows as t lies
            outs.append(torch.empty(3 * R, C, dtype=torch.bfloat16,
                                    device=t.device))
            strides += [R * C, C]
        else:
            outs.append(torch.empty(R, 3 * C, dtype=torch.bfloat16,
                                    device=t.device))
            strides += [C, 3 * C]
    out2 = outs[1].data_ptr() if len(outs) > 1 else None
    strides += strides[:2] if len(outs) == 1 else []
    rc = _build.library().dv_bf16_split(
        t.data_ptr(), outs[0].data_ptr(), out2, R, C, *strides,
        _build.stream_ptr(t.device))
    _build.check(rc, "split_bf16")
    split_bf16.launches += 1
    return [o.t() for o in outs] if flip else outs


def split_bf16_reference(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Plain version of :func:`split_bf16` (same values, any layout)."""
    finite = t.isfinite()
    hi = t.to(torch.bfloat16)
    hi = torch.where(hi.isinf() & finite,
                     torch.full_like(t, BF16_MAX).copysign(t)
                     .to(torch.bfloat16), hi)
    zero = t == 0
    r = torch.where(zero, t, torch.where(finite, t - hi.float(),
                                         torch.zeros_like(t)))
    mid = r.to(torch.bfloat16)
    lo = torch.where(zero, hi, (r - mid.float()).to(torch.bfloat16))
    return torch.cat([lo, mid, hi], dim=dim)
