"""The compiled zstd decoder that CUDA checkpoint loads use.

``csrc/zstd_decode.cu`` is host C++ (RFC 8878, the same scope as the plain
``engine/zstd.py``) built into the kernel library and bound with ``ctypes``.
It is not a TPU kernel's counterpart: orbax checkpoints keep their OCDBT
nodes and zarr chunks as zstd frames, and a load whose device is CUDA
decodes them here, while a load onto the CPU uses the plain decoder.
Neither falls back to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np

from deepvision_tpu_torch.engine.kernels import _build
from deepvision_tpu_torch.engine.zstd import ZstdError

# DvZstdError of csrc/zstd_decode.cu
_DST_SMALL = -2
_ERRORS = {
    -1: "corrupt or unsupported zstd stream",
    -2: "the output does not fit in the buffer",
    -3: "content checksum mismatch",
    -4: "frames with a dictionary are not supported",
    -5: "truncated frame",
}


def decompress(data, size=None) -> bytearray:
    """Decode every frame of ``data`` (bytes-like) with the compiled
    decoder.  ``size``, when given, is the exact decoded length (a zarr
    chunk's bytes) and the output buffer is allocated once; otherwise the
    buffer starts at four times the input and grows until the frames fit.
    Raises :class:`~deepvision_tpu_torch.engine.zstd.ZstdError` as the
    plain decoder does."""
    lib = _build.library()
    src = np.frombuffer(data, np.uint8)
    cap = size if size is not None else max(4 * len(src), 1 << 16)
    while True:
        out = bytearray(max(cap, 1))
        dst = (ctypes.c_char * len(out)).from_buffer(out)
        rc = lib.dv_zstd_decompress(src.ctypes.data, len(src),
                                    ctypes.addressof(dst), cap)
        del dst
        if rc == _DST_SMALL and size is None:
            cap *= 4
            continue
        if rc < 0:
            raise ZstdError(f"compiled zstd decoder: "
                            f"{_ERRORS.get(rc, f'error {rc}')}")
        if size is not None and rc != size:
            raise ZstdError(f"decoded {rc} bytes, expected {size}")
        del out[rc:]
        return out
