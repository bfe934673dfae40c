"""Orbax checkpoint directories: the layout the JAX package's
``save_checkpoint`` writes, read and written without orbax or tensorstore.

A checkpoint directory holds ``_METADATA`` (JSON: ``tree_metadata`` maps
each leaf's key path to its metadata, ``use_ocdbt`` and ``use_zarr3`` say
where the arrays are), ``_CHECKPOINT_METADATA``, ``_sharding`` (base64 of
each leaf's dotted name -> its sharding, as JSON) and
``array_metadatas/process_0``.  Each leaf is a zarr v2 array named by its
dotted key path (``blocks.wq``): a ``.zarray`` JSON and chunk files named
by their grid indices joined with the dimension separator (``0.0.0``).
With ``use_ocdbt`` the ``.zarray`` and the chunks are keys of an OCDBT
store (``engine/ocdbt.py``); without it they are files under
``<dir>/<name>/``.

:class:`CheckpointReader` reads both layouts: bfloat16, float32, int32 and
int8 arrays in C order, zstd-compressed or raw chunks, arrays of many chunks
(missing chunks take the fill value).  :func:`write_checkpoint` writes the
layout without OCDBT, one raw chunk a leaf, which the JAX package's
``load_checkpoint`` restores.
"""

from __future__ import annotations

import base64
import itertools
import json
import math
import os
import shutil
import time
from typing import Callable, Optional

import numpy as np
import torch

from deepvision_tpu_torch.engine import zstd
from deepvision_tpu_torch.engine.kernels import zstd as compiled_zstd
from deepvision_tpu_torch.engine.ocdbt import OcdbtStore

# zarr v2 dtype strings -> (numpy storage dtype, torch dtype); bfloat16 is
# stored as its uint16 bits and viewed as torch.bfloat16
_DTYPES = {
    "bfloat16": (np.dtype("<u2"), torch.bfloat16),
    "<f4": (np.dtype("<f4"), torch.float32),
    "<i4": (np.dtype("<i4"), torch.int32),
    "|i1": (np.dtype("|i1"), torch.int8),
}
_ZARR_DTYPE = {t: name for name, (_, t) in _DTYPES.items()}
_DICT_KEY = 2  # orbax key_metadata key_type of a dict key
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
_SHARDING = json.dumps({"sharding_type": "SingleDeviceSharding",
                        "device_str": "TFRT_CPU_0"})


def decoder_for(device) -> Callable:
    """The zstd decoder a load onto ``device`` uses: the compiled one
    (``kernels/zstd.py``) for CUDA, the plain one (``engine/zstd.py``) for
    the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return compiled_zstd.decompress
    if kind == "cpu":
        return zstd.decompress
    raise ValueError(f"checkpoint loads go to cuda or cpu, not {device}")


class _DirStore:
    """The layout without OCDBT: each key is a file under the directory."""

    def __init__(self, root: str):
        self.root = root

    def __contains__(self, key: str) -> bool:
        return os.path.isfile(os.path.join(self.root, key))

    def read(self, key: str) -> bytearray:
        path = os.path.join(self.root, key)
        buf = bytearray(os.path.getsize(path))
        with open(path, "rb") as fh:
            if fh.readinto(buf) != len(buf):
                raise OSError(f"{path}: short read")
        return buf


def _fill_value(fill, storage: np.dtype, zdtype: str):
    if fill is None:
        return 0
    if isinstance(fill, str):  # zarr spells the special floats as strings
        fill = {"NaN": math.nan, "Infinity": math.inf,
                "-Infinity": -math.inf}[fill]
    if zdtype == "bfloat16":
        return int(torch.tensor(fill, dtype=torch.float32).to(
            torch.bfloat16).view(torch.int16).item()) & 0xFFFF
    return np.array(fill).astype(storage)


class CheckpointReader:
    """An orbax checkpoint directory, read leaf by leaf.

    ``decompress(data, size)`` decodes zstd (OCDBT nodes and chunks):
    :func:`decoder_for` gives the one a device uses.
    """

    def __init__(self, path: str, decompress: Callable):
        self.path = path
        self._decompress = decompress
        with open(os.path.join(path, "_METADATA")) as fh:
            meta = json.load(fh)
        if meta.get("use_zarr3"):
            raise NotImplementedError(f"{path}: zarr v3 checkpoints are not "
                                      f"supported")
        self._store = (OcdbtStore(path, decompress) if meta.get("use_ocdbt")
                       else _DirStore(path))
        self.leaves = {}  # key path tuple -> dotted param name
        for entry in meta["tree_metadata"].values():
            keys = []
            for k in entry["key_metadata"]:
                if k["key_type"] != _DICT_KEY:
                    raise NotImplementedError(
                        f"{path}: only trees of dicts are supported, got "
                        f"key {k}")
                keys.append(str(k["key"]))
            self.leaves[tuple(keys)] = ".".join(keys)

    def zarray(self, keys: tuple) -> dict:
        raw = self._store.read(self.leaves[keys] + "/.zarray")
        return json.loads(bytes(raw))

    def read(self, keys: tuple) -> torch.Tensor:
        """Leaf ``keys`` as a CPU tensor of its stored dtype."""
        name = self.leaves[keys]
        z = self.zarray(keys)
        if z.get("zarr_format") != 2 or z.get("order", "C") != "C" \
                or z.get("filters"):
            raise NotImplementedError(f"{name}: zarr array {z} is not a "
                                      f"filterless C-order v2 array")
        if z["dtype"] not in _DTYPES:
            raise NotImplementedError(f"{name}: dtype {z['dtype']}")
        comp = z.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise NotImplementedError(f"{name}: compressor {comp}")
        storage, tdtype = _DTYPES[z["dtype"]]
        shape, chunks = tuple(z["shape"]), tuple(z["chunks"])
        sep = z.get("dimension_separator", ".")
        chunk_bytes = math.prod(chunks) * storage.itemsize
        fill = _fill_value(z.get("fill_value"), storage, z["dtype"])
        grid = [-(-s // c) for s, c in zip(shape, chunks)]

        def chunk(idx) -> Optional[np.ndarray]:
            key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
            if key not in self._store:
                return None
            raw = self._store.read(key)
            if comp is not None:
                raw = self._decompress(raw, chunk_bytes)
            elif len(raw) != chunk_bytes:
                raise ValueError(f"{key}: {len(raw)} bytes, expected "
                                 f"{chunk_bytes}")
            if not isinstance(raw, bytearray):
                raw = bytearray(raw)
            return np.frombuffer(raw, storage).reshape(chunks)

        if chunks == shape:  # one chunk: its buffer is the array
            arr = chunk((0,) * len(shape))
            if arr is None:
                arr = np.full(shape, fill, storage)
        else:
            arr = np.empty(shape, storage)
            for idx in itertools.product(*map(range, grid)):
                region = tuple(slice(i * c, min((i + 1) * c, s))
                               for i, c, s in zip(idx, chunks, shape))
                part = chunk(idx)
                if part is None:
                    arr[region] = fill
                else:
                    arr[region] = part[tuple(slice(0, r.stop - r.start)
                                             for r in region)]
        t = torch.from_numpy(arr)
        if tdtype == torch.bfloat16:
            t = t.view(torch.int16).view(torch.bfloat16)
        return t


def flatten(tree: dict, prefix=()) -> list:
    """``(key path, leaf)`` pairs of a nested dict, in sorted key order (the
    order JAX flattens a dict in)."""
    out = []
    for name in sorted(tree):
        leaf = tree[name]
        if isinstance(leaf, dict):
            out += flatten(leaf, prefix + (name,))
        else:
            out.append((prefix + (name,), leaf))
    return out


def _write(path: str, data) -> None:
    with open(path, "wb") as fh:
        fh.write(data)


def write_checkpoint(path: str, params: dict) -> None:
    """Write ``params`` (a nested dict of tensors) as an orbax checkpoint
    without OCDBT: the JAX package's ``load_checkpoint`` restores it, with
    or without a template.  Each leaf is one uncompressed zarr chunk,
    copied to the host leaf by leaf.  An existing directory is replaced,
    as orbax's ``force=True`` does."""
    path = os.path.abspath(path)
    leaves = flatten(params)
    for keys, t in leaves:
        if any("." in k or "/" in k for k in keys):
            raise ValueError(f"{keys}: key names may not hold '.' or '/'")
        if t.dtype not in _ZARR_DTYPE:
            raise TypeError(f"{keys}: dtype {t.dtype} has no zarr dtype "
                            f"here")
    init_ns = time.time_ns()
    tmp = path + ".orbax-checkpoint-tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "array_metadatas"))
    tree_meta, shardings, array_meta = {}, {}, []
    for keys, t in leaves:
        name = ".".join(keys)
        shape = list(t.shape)
        tree_meta[str(keys)] = {
            "key_metadata": [{"key": k, "key_type": _DICT_KEY} for k in keys],
            "value_metadata": {"value_type": "jax.Array",
                               "skip_deserialize": False,
                               "write_shape": shape}}
        shardings[base64.b64encode(name.encode()).decode()] = _SHARDING
        array_meta.append({"array_metadata": {
            "param_name": name, "write_shape": shape, "chunk_shape": shape,
            "ext_metadata": None}})
        leaf_dir = os.path.join(tmp, name)
        os.makedirs(leaf_dir)
        zarray = {"chunks": shape, "compressor": None,
                  "dimension_separator": ".", "dtype": _ZARR_DTYPE[t.dtype],
                  "fill_value": None, "filters": None, "order": "C",
                  "shape": shape, "zarr_format": 2}
        _write(os.path.join(leaf_dir, ".zarray"),
               json.dumps(zarray, separators=(",", ":")).encode())
        host = t.detach().to("cpu").contiguous()
        if host.dtype == torch.bfloat16:
            host = host.view(torch.int16)
        chunk = ".".join("0" for _ in shape) or "0"
        _write(os.path.join(leaf_dir, chunk), host.numpy())
    _write(os.path.join(tmp, "_METADATA"), json.dumps({
        "tree_metadata": tree_meta, "use_ocdbt": False, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True,
        "custom_metadata": None}).encode())
    _write(os.path.join(tmp, "_sharding"),
           json.dumps(shardings, separators=(",", ":")).encode())
    _write(os.path.join(tmp, "array_metadatas", "process_0"),
           json.dumps({"array_metadatas": array_meta}).encode())
    _write(os.path.join(tmp, "_CHECKPOINT_METADATA"), json.dumps({
        "item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": init_ns,
        "commit_timestamp_nsecs": time.time_ns(),
        "custom_metadata": {}}).encode())
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)

