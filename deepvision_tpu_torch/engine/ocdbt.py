"""Read-only OCDBT key-value store: the database orbax keeps a checkpoint in.

OCDBT ("optionally-cooperative distributed B+tree") is tensorstore's
on-disk format, as its published "OCDBT on-disk format" describes it.  A
directory holds ``manifest.ocdbt`` and data files under ``d/``.  The
manifest carries the store's config and its versions (the newest inline,
older ones in a version tree); each version names the root of a B+tree
whose leaves map keys to values, kept inline or as (data file, offset,
length) references.  Manifests, B+tree nodes and version tree nodes start
with a 4-byte magic, an 8-byte little-endian length, a version varint and a
compression varint (1 = zstd), and end with a CRC-32C of all that comes
before it.  Arrays inside a node are stored column by column; keys are
prefix-compressed against the key before them and against the common
prefix of the subtree, which an interior entry states for its child.

An orbax checkpoint written with OCDBT has a root store whose tree points
into the per-process stores (``ocdbt.process_0/d/...``): data file paths
are relative to the directory of the store that names them, and a node read
from a data file resolves its own table against that file's base path.

:class:`OcdbtStore` reads the newest version (its generation and B+tree
height are attributes).  Compressed bodies go through
the ``decompress`` callable it is given (the plain or the compiled zstd
decoder); values are returned as they are stored.
"""

from __future__ import annotations

import os
from typing import Callable

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_TREE_MAGIC = 0x0CDB1234

_KIND_INLINE, _KIND_INDIRECT = 0, 1


class OcdbtError(ValueError):
    """A file of the store is not what the format says."""


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``; ``zlib`` has only CRC-32."""
    c = 0xFFFFFFFF
    table = _CRC32C
    for b in bytes(data):
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """Cursor over a decoded body: varints and bytes."""

    def __init__(self, buf: bytes):
        self.buf, self.pos = buf, 0

    def varint(self) -> int:
        value, shift = 0, 0
        buf = self.buf
        while True:
            if self.pos >= len(buf) or shift > 63:
                raise OcdbtError("truncated or overlong varint")
            b = buf[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise OcdbtError("body ends early")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8s(self, n: int) -> list:
        return list(self.take(n))


def _unwrap(raw: bytes, magic: int, what: str,
            decompress: Callable[[bytes], bytes]) -> bytes:
    """Check a manifest's or node's header and footer; return its body,
    decompressed."""
    if len(raw) < 18:
        raise OcdbtError(f"{what}: {len(raw)} bytes is too short")
    if int.from_bytes(raw[:4], "big") != magic:
        raise OcdbtError(f"{what}: bad magic {raw[:4].hex()}")
    if int.from_bytes(raw[4:12], "little") != len(raw):
        raise OcdbtError(f"{what}: length field disagrees with its size")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    head = _Reader(raw[12:-4])
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    body = raw[12 + head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return decompress(body)
    raise OcdbtError(f"{what}: compression {compression}")


def _data_file_table(r: _Reader, base: str) -> list:
    """Read a data file table.  Returns ``(path, base_path)`` pairs, both
    resolved against ``base``, the base path of the file the table sits
    in."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base_len = r.varints(n)
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError("data file path prefix longer than its "
                             "predecessor")
        path = prev[:prefix[i]] + r.take(suffix[i])
        if base_len[i] > len(path):
            raise OcdbtError("data file base path longer than its path")
        prev = path
        text = path.decode()
        out.append((base + text, base + text[:base_len[i]]))
    return out


def _locations(r: _Reader, n: int, files: list) -> list:
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    for f in ids:
        if f >= len(files):
            raise OcdbtError(f"data file id {f} out of range")
    return [(files[f], o, ln) for f, o, ln in zip(ids, offsets, lengths)]


def _versions(r: _Reader, files: list) -> list:
    """A version tree leaf's entries: ``(generation, root_height,
    root_location)``; an empty tree has location None."""
    n = r.varint()
    gens = r.varints(n)
    heights = r.u8s(n)
    locs = _locations(r, n, files)
    r.varints(3 * n)  # statistics: keys, tree bytes, indirect value bytes
    r.take(8 * n)  # commit times, uint64
    out = []
    for g, h, loc in zip(gens, heights, locs):
        empty = loc[1] == (1 << 64) - 1 and loc[2] == (1 << 64) - 1
        out.append((g, h, None if empty else loc))
    return out


class OcdbtStore:
    """The newest version of the OCDBT store in directory ``root``.

    ``decompress`` decodes zstd-compressed manifests and nodes.  Keys are
    returned as ``str``; :meth:`read` gives a value's bytes.
    """

    def __init__(self, root: str, decompress: Callable[[bytes], bytes]):
        self.root = root
        self._decompress = decompress
        with open(os.path.join(root, "manifest.ocdbt"), "rb") as fh:
            raw = fh.read()
        r = _Reader(_unwrap(raw, MANIFEST_MAGIC, "manifest",
                            self._decompress))
        r.take(16)  # uuid
        if r.varint() != 0:
            raise OcdbtError("numbered manifests are not supported")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.u8s(1)  # version_tree_arity_log2
        if r.varint() == 1:
            r.take(4)  # zstd level, int32
        files = _data_file_table(r, "")
        versions = _versions(r, files)
        n = r.varint()
        gens = r.varints(n)
        locs = _locations(r, n, files)
        r.varints(n)  # generations under each node
        r.take(8 * n)  # commit times, uint64
        heights = r.u8s(n)
        self._version_nodes = list(zip(gens, heights, locs))
        if r.pos != len(r.buf):
            raise OcdbtError("manifest has trailing bytes")
        if not versions:
            raise OcdbtError("manifest holds no version")
        self._inline_generations = [v[0] for v in versions]
        self.generation, self.height, root_loc = max(versions)
        self._values: dict = {}
        if root_loc is not None:
            self._walk(root_loc, self.height, b"")

    # -- reading ------------------------------------------------------

    def _raw(self, loc) -> bytes:
        (path, _), offset, length = loc
        with open(os.path.join(self.root, path), "rb") as fh:
            fh.seek(offset)
            data = fh.read(length)
        if len(data) != length:
            raise OcdbtError(f"{path}: {length} bytes at {offset} not there")
        return data

    def _walk(self, loc, height: int, prefix: bytes) -> None:
        """Read the B+tree node at ``loc`` (keys under ``prefix``) and
        everything below it into ``self._values``."""
        base = loc[0][1]
        r = _Reader(_unwrap(self._raw(loc), BTREE_MAGIC, "b-tree node",
                            self._decompress))
        if r.u8s(1)[0] != height:
            raise OcdbtError("b-tree node height disagrees with its parent")
        files = _data_file_table(r, base)
        n = r.varint()
        key_prefix = [0] + r.varints(n - 1) if n else []
        key_suffix = r.varints(n)
        if height:
            common = r.varints(n)
        keys, prev = [], b""
        for i in range(n):
            key = prev[:key_prefix[i]] + r.take(key_suffix[i])
            keys.append(key)
            prev = key
        if height:
            children = _locations(r, n, files)
            r.varints(3 * n)  # statistics
            for key, c, child in zip(keys, common, children):
                self._walk(child, height - 1, prefix + key[:c])
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        n_indirect = sum(k == _KIND_INDIRECT for k in kinds)
        if any(k not in (_KIND_INLINE, _KIND_INDIRECT) for k in kinds):
            raise OcdbtError("unknown value kind")
        ids, offsets = r.varints(n_indirect), r.varints(n_indirect)
        j = 0
        for key, length, kind in zip(keys, lengths, kinds):
            if kind == _KIND_INDIRECT:
                if ids[j] >= len(files):
                    raise OcdbtError(f"data file id {ids[j]} out of range")
                value = (files[ids[j]], offsets[j], length)
                j += 1
            else:
                value = r.take(length)
            self._values[(prefix + key).decode()] = value
        if r.pos != len(r.buf):
            raise OcdbtError("b-tree leaf has trailing bytes")

    def versions(self) -> list:
        """Generation numbers of every version the store keeps, oldest
        first (the version tree's nodes read)."""
        gens = list(self._inline_generations)
        for _, height, loc in self._version_nodes:
            gens += self._version_node(loc, height)
        return sorted(gens)

    def _version_node(self, loc, height: int) -> list:
        r = _Reader(_unwrap(self._raw(loc), VERSION_TREE_MAGIC,
                            "version tree node", self._decompress))
        r.u8s(1)  # arity log2
        if r.u8s(1)[0] != height:
            raise OcdbtError("version node height disagrees with its parent")
        files = _data_file_table(r, loc[0][1])
        if height == 0:
            return [v[0] for v in _versions(r, files)]
        n = r.varint()
        r.varints(n)  # last generation under each child
        locs = _locations(r, n, files)
        gens = []
        for child in locs:
            gens += self._version_node(child, height - 1)
        return gens

    def keys(self) -> list:
        return sorted(self._values)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def read(self, key: str) -> bytes:
        value = self._values[key]
        if isinstance(value, tuple):  # (data file, offset, length)
            return self._raw(value)
        return bytes(value)
