"""Parameters as nested dicts of torch tensors, with the JAX package's names.

The layout is the JAX package's: ``embed [V, D]``, ``final_norm [D]`` and a
``blocks`` dict whose leaves carry a leading layer axis (``wq [L, D, H*HD]``
and so on).  Keeping it means one ``.npz`` checkpoint or orbax directory
serves both packages and a test can hand the same numbers to both.
"""

from __future__ import annotations

import io
import math
import os
from typing import Optional

import numpy as np
import torch

from deepvision_tpu_torch.engine import orbax_format
from deepvision_tpu_torch.engine.config import ModelConfig
from deepvision_tpu_torch.engine.quant import is_quantized_weight


def init_params(cfg: ModelConfig, *, device, seed: int = 0,
                dtype=torch.bfloat16) -> dict:
    """Random parameters with the JAX package's names and shapes.

    Draws come from a ``torch.Generator`` seeded with ``seed`` on the CPU
    (then moved to ``device``), so the same seed gives the same weights on
    every device; they differ from the JAX package's draws for that seed.
    On the ``meta`` device nothing is drawn or allocated: the tree gives
    names, shapes and dtypes only (a restore template).
    """
    gen = torch.Generator().manual_seed(seed)
    D, F, HD = cfg.d_model, cfg.d_ff, cfg.head_dim
    H, KV, L, V = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers, cfg.vocab_size
    meta = torch.device(device).type == "meta"

    def norm(shape, fan_in):
        if meta:
            return torch.empty(shape, device=device, dtype=dtype)
        w = torch.randn(shape, generator=gen, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(device=device, dtype=dtype)

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    params = {
        "embed": norm((V, D), D),
        "final_norm": zeros((D,)),
        "blocks": {
            "ln1": zeros((L, D)),
            "ln2": zeros((L, D)),
            "wq": norm((L, D, H * HD), D),
            "wk": norm((L, D, KV * HD), D),
            "wv": norm((L, D, KV * HD), D),
            "wo": norm((L, H * HD, D), H * HD),
            "w_gate": norm((L, D, F), D),
            "w_up": norm((L, D, F), D),
            "w_down": norm((L, F, D), F),
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = norm((D, V), D)
    return params


def _to_tensor(arr: np.ndarray, device, bf16_bits: bool) -> torch.Tensor:
    """numpy leaf -> tensor.  bf16 arrives either as raw uint16 bits
    (``bf16_bits``) or as an ``ml_dtypes`` bfloat16 array; both are
    reinterpreted bit for bit, never rounded through float."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    if bf16_bits or arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def from_numpy_params(tree: dict, *, device) -> dict:
    """Carry a params tree of numpy arrays (e.g. the JAX package's params
    after ``np.asarray``) into torch tensors on ``device``, keeping names
    and the stacked ``[L, ...]`` block leaves."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = from_numpy_params(leaf, device=device)
        else:
            out[name] = _to_tensor(np.asarray(leaf), device, False)
    return out


def load_npz(path: str, *, device) -> dict:
    """Read a flat ``.npz`` checkpoint (``blocks/wq@bf16`` style keys; bf16
    leaves stored as uint16 bits tagged ``@bf16``)."""
    params: dict = {}
    with np.load(path) as data:
        for name in data.files:
            arr = data[name]
            key, bits = name, name.endswith("@bf16")
            if bits:
                key = name[: -len("@bf16")]
            node = params
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = _to_tensor(arr, device, bits)
    return params


def round_to_bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 -> bfloat16 as the JAX package's orbax restore converts (in
    tensorstore): round to nearest even on the bits; a NaN keeps its sign
    and top payload bits with bit 5 set (0x7FC00000 -> 0x7FE0).  Finite
    values and infinities match ``ml_dtypes`` and JAX's ``astype`` too;
    torch's own cast gives other NaN bits.  Works through the tensor in
    slices, so the int64 scratch stays small."""
    flat = t.detach().contiguous().view(-1).view(torch.int32)
    out = torch.empty(flat.shape, dtype=torch.int16, device=flat.device)
    step = 1 << 24
    for i in range(0, flat.numel(), step):
        u = flat[i:i + step].to(torch.int64) & 0xFFFFFFFF
        r = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
        r = torch.where((u & 0x7FFFFFFF) > 0x7F800000, (u >> 16) | 0x20, r)
        out[i:i + step] = r.to(torch.int32).to(torch.int16)
    return out.view(torch.bfloat16).view(t.shape)


def astype(params: dict, dtype) -> dict:
    """Detached copies of a params tree's leaves in ``dtype``.  An int8
    weight ``{"q8", "scale"}`` (engine/quant.py) keeps its dtypes: cast, it
    would no longer be the weight it stands for."""
    return {name: ({k: t.detach() for k, t in leaf.items()}
                   if is_quantized_weight(leaf)
                   else astype(leaf, dtype) if isinstance(leaf, dict)
                   else leaf.detach().to(dtype))
            for name, leaf in params.items()}


def save_npz(path: str, params: dict) -> None:
    """Write a flat ``.npz`` checkpoint in the JAX package's format:
    ``blocks/wq`` style keys (sorted, as JAX flattens a dict), bf16 leaves
    stored as their raw uint16 bits under a ``@bf16`` tag, other leaves as
    they are.  ``load_npz`` here and in the JAX package read it back bit
    for bit."""
    flat = {}

    def walk(node, prefix):
        for name in sorted(node):
            leaf = node[name]
            key = f"{prefix}{name}"
            if isinstance(leaf, dict):
                walk(leaf, key + "/")
                continue
            t = leaf.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                flat[key + "@bf16"] = t.view(torch.int16).numpy().view(
                    np.uint16)
            else:
                flat[key] = t.numpy()

    walk(params, "")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    with open(path, "wb") as fh:
        fh.write(buf.getvalue())


def save_checkpoint(path: str, params: dict) -> None:
    """Write ``params`` as an orbax checkpoint directory, as the JAX
    package's ``save_checkpoint`` does (``orbax_format.write_checkpoint``:
    the layout without OCDBT, raw chunks); the JAX ``load_checkpoint``
    reads it back bit for bit."""
    orbax_format.write_checkpoint(path, params)


def load_checkpoint(path: str, template: Optional[dict] = None, *,
                    device) -> dict:
    """Restore an orbax checkpoint directory onto ``device``, as the JAX
    package's ``load_checkpoint``: OCDBT or plain, zstd or raw chunks.

    Without ``template`` every leaf keeps its stored dtype.  With one (a
    params tree, e.g. on the ``meta`` device), its tree must be the stored
    one and its shapes the stored shapes, else ``ValueError``; each leaf is
    cast to the template's dtype (float32 -> bfloat16 through
    :func:`round_to_bf16`, bit for bit as the JAX restore converts).  zstd
    is decoded by the compiled decoder on a CUDA load and by the plain one
    on a CPU load.  Leaves are read, cast and copied to the device one at
    a time."""
    reader = orbax_format.CheckpointReader(
        os.path.abspath(path), orbax_format.decoder_for(device))
    wanted = None
    if template is not None:
        wanted = dict(orbax_format.flatten(template))
        if set(wanted) != set(reader.leaves):
            raise ValueError(
                "User-provided restore item and on-disk value metadata tree "
                f"structures do not match: template has "
                f"{sorted(set(wanted) - set(reader.leaves))} not on disk, "
                f"disk has {sorted(set(reader.leaves) - set(wanted))} not "
                f"in the template")
    params: dict = {}
    for keys in sorted(reader.leaves):
        t = reader.read(keys)
        if wanted is not None:
            like = wanted[keys]
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"{'.'.join(keys)}: stored shape "
                                 f"{tuple(t.shape)}, template "
                                 f"{tuple(like.shape)}")
            t = (round_to_bf16(t) if (t.dtype, like.dtype) ==
                 (torch.float32, torch.bfloat16) else t.to(like.dtype))
        node = params
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t.to(device)
    return params


def load_or_init(cfg: ModelConfig, checkpoint_dir: Optional[str],
                 seed: int = 0, *, device) -> dict:
    """Engine boot path, as the JAX package's ``load_or_init``: a flat
    ``.npz`` file is loaded; a directory is restored as an orbax checkpoint
    with ``init_params``' names, shapes and bfloat16 dtype as the template
    (built on the ``meta`` device); any other path, or none, gives random
    weights from ``seed``."""
    if checkpoint_dir and os.path.isfile(checkpoint_dir) and \
            checkpoint_dir.endswith(".npz"):
        return load_npz(checkpoint_dir, device=device)
    if checkpoint_dir and os.path.isdir(checkpoint_dir):
        template = init_params(cfg, device="meta", seed=seed)
        return load_checkpoint(checkpoint_dir, template, device=device)
    return init_params(cfg, device=device, seed=seed)


def count_params(params: dict) -> int:
    return sum(
        count_params(v) if isinstance(v, dict) else v.numel()
        for v in params.values()
    )
