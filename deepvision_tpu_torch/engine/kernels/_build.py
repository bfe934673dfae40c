"""Build the CUDA kernels in ``csrc/`` and bind them with ``ctypes``.

The sources compile on first use with ``nvcc`` for ``sm_90a``: one ``nvcc``
per ``.cu`` file, all started together, then one link into a shared
library with a plain C interface.  The library lands in ``build/`` (listed
in ``.gitignore``) under a name keyed by a hash of the sources and flags,
so an edited source rebuilds and an unchanged one loads at once.  Nothing
here includes PyTorch's headers: that keeps a build to seconds.

Every exported kernel function returns ``cudaGetLastError()`` after its
launch; :func:`check` turns a non-zero code into an exception.  One source,
``zstd_decode.cu``, is host code with no kernel: the zstd decoder that CUDA
checkpoint loads use (``kernels/zstd.py``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, seq_lens, out, lse (or null), B, H, KV, S, HD, dtype, scale,
    # stream
    "dv_flash_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # HD, dtype, out int[5]
    "dv_flash_fwd_info": [_I, _I, _P],
    # q, k, v, dout, lse, delta, seq_lens, dq, B, H, KV, S, HD, dtype,
    # scale, stream
    "dv_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, dout, lse, delta, seq_lens, dk, dv, B, H, KV, S, HD, dtype,
    # scale, stream
    "dv_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _F, _P],
    # dq (1) or dk/dv (0), HD, dtype, out int[5]
    "dv_flash_bwd_info": [_I, _I, _I, _P],
    # q, new_k, new_v, k_pages, v_pages, block_tables, seq_lens, k_scale,
    # v_scale, out, part (or null), B, H, KV, N, P, MP, HD, q_dtype,
    # pool_dtype, nsplit, scale, stream
    "dv_paged_decode_update": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                               _P],
    # HD, pool_dtype, G, out int[5]
    "dv_paged_decode_info": [_I, _I, _I, _P],
    # q, new_k (or null), new_v (or null), k_pages, v_pages, block_tables,
    # seq_lens, k_scale, v_scale, out, part (or null), B, H, KV, N, P, MP,
    # HD, pool_dtype, write, nsplit, scale, stream
    "dv_paged_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # HD, pool_dtype, write, P, G, out int[5]
    "dv_paged_attention_info": [_I, _I, _I, _I, _I, _P],
    # q, k_pages, v_pages, block_tables, chunk_starts, seq_lens, k_scale,
    # v_scale, out, part_acc (or null), part_ml (or null), B, C, H, KV, N,
    # P, MP, HD, q_dtype, pool_dtype, nsplit, scale, stream
    "dv_paged_chunk": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # HD, pool_dtype, out int[5]
    "dv_paged_chunk_info": [_I, _I, _P],
    # host code (csrc/zstd_decode.cu): src, n, dst, cap -> bytes written or
    # a negative error
    "dv_zstd_decompress": [_P, ctypes.c_longlong, _P, ctypes.c_longlong],
}
# return types other than the launches' cudaError_t
_RESTYPES = {"dv_zstd_decompress": ctypes.c_longlong}

_lock = threading.Lock()
_state: dict = {}


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "CUDA kernels are built from source on first use")
    return path


def _compile(so_path: str, log_path: str) -> None:
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="objs_", dir=BUILD_DIR)
    try:
        jobs = []
        for src in sources():
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            jobs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        logs, failed, failed_logs = [], [], []
        for obj, proc in jobs:
            out = proc.communicate()[0].decode(errors="replace")
            logs.append(f"== {os.path.basename(obj)} (rc {proc.returncode})"
                        f"\n{out}")
            if proc.returncode:
                failed.append(obj)
                failed_logs.append(logs[-1])
        tmp_so = os.path.join(work, "lib.so")
        if not failed:
            link = subprocess.run(
                [nvcc, "-shared", *NVCC_FLAGS[:2], "-Xcompiler", "-fPIC",
                 "-o", tmp_so, *[o for o, _ in jobs]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            logs.append(f"== link (rc {link.returncode})\n"
                        + link.stdout.decode(errors="replace"))
            if link.returncode:
                failed.append("link")
                failed_logs.append(logs[-1])
        with open(log_path, "w") as fh:
            fh.write("\n".join(logs))
        if failed:
            # the failed steps' own output (errors come first in it)
            raise RuntimeError(f"nvcc failed for {failed}; log:\n"
                               + "\n".join(failed_logs)[:8000])
        os.replace(tmp_so, so_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The kernel library, built on first call (thread-safe)."""
    with _lock:
        lib = _state.get("lib")
        if lib is not None:
            return lib
        tag = _digest()
        so_path = os.path.join(BUILD_DIR, f"libdv_kernels_{tag}.so")
        log_path = os.path.join(BUILD_DIR, f"build_{tag}.log")
        t0 = time.monotonic()
        if not os.path.isfile(so_path):
            _compile(so_path, log_path)
        lib = ctypes.CDLL(so_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        _state.update(lib=lib, build_s=time.monotonic() - t0,
                      log_path=log_path, so_path=so_path)
        return lib


def build_info() -> dict:
    """``{"build_s", "log_path", "so_path"}`` of the loaded library (after
    :func:`library`)."""
    return {k: _state[k] for k in ("build_s", "log_path", "so_path")}


def kernel_info(fn_name: str, *args) -> dict:
    """How the card runs one kernel, from the library's ``*_info`` export
    ``fn_name(*args, out)``: registers a thread, shared memory (static and
    dynamic) and local (spill) bytes, blocks an SM and threads a block."""
    vals = (ctypes.c_int * 5)()
    rc = getattr(library(), fn_name)(*args, ctypes.cast(vals,
                                                         ctypes.c_void_p))
    check(rc, f"{fn_name}{args}")
    return dict(zip(("registers", "smem_bytes", "local_bytes",
                     "blocks_per_sm", "threads"), vals))


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
