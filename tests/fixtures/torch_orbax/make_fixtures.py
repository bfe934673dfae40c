"""Make the committed fixtures of the port's orbax and zstd tests.

    JAX_PLATFORMS=cpu python tests/fixtures/torch_orbax/make_fixtures.py

Writes next to this file, from seed ``SEED``:

* ``tiny_ckpt/``: the JAX package's ``save_checkpoint`` (orbax with OCDBT,
  zstd-compressed nodes and chunks) of ``init_params(TINY_TEST, SEED)``
  with each bf16 mantissa cut to its top 2 bits, which brings the
  checkpoint and its twin within the fixtures' 1 MiB;
* ``tiny_ckpt.npz``: its twin: the same params in the JAX ``save_npz``
  layout (``blocks/wq@bf16`` keys, uint16 bits), zip-compressed;
* ``frames.zst``: frames made by the ``zstandard`` package (and one
  skippable frame), concatenated, that together use every frame, block,
  literals and sequence mode :func:`features` names;
* ``frames.json``: each frame's name, offset, length, decoded size and the
  SHA-256 of its decoded bytes.

Orbax names its data files and stamps its metadata afresh on every run, so
a rerun writes other bytes holding the same arrays.  ``features`` is also
what ``tests/test_torch_zstd.py`` holds the committed frames to.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 3

# every mode the committed frames must reach
WANTED = {
    "frame:single_segment", "frame:window", "frame:checksum",
    "frame:no_content_size", "frame:skippable",
    "block:raw", "block:rle", "block:compressed",
    "literals:raw", "literals:rle", "literals:huffman", "literals:treeless",
    "streams:1", "streams:4", "weights:direct", "weights:fse",
    "sequences:none",
    *(f"{t}:{m}" for t in ("ll", "of", "ml")
      for m in ("predefined", "rle", "fse", "repeat")),
}
_MODES = ("predefined", "rle", "fse", "repeat")


def _literals_size(b: bytes, pos: int) -> int:
    """Bytes of the literals section at ``b[pos]``."""
    b0 = b[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:
        if fmt in (0, 2):
            head, size = 1, b0 >> 3
        elif fmt == 1:
            head, size = 2, (b0 >> 4) | (b[pos + 1] << 4)
        else:
            head, size = 3, (b0 >> 4) | (b[pos + 1] << 4) | (b[pos + 2] << 12)
        return head + (size if kind == 0 else 1)
    head = (3, 3, 4, 5)[fmt]
    width = (10, 10, 14, 18)[fmt]
    word = int.from_bytes(b[pos:pos + head], "little")
    return head + ((word >> (4 + width)) & ((1 << width) - 1))


def features(data: bytes) -> set:
    """The frame, block, literals and sequence modes ``data`` (concatenated
    frames) uses, read from its headers."""
    seen, pos = set(), 0
    while pos < len(data):
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if 0x184D2A50 <= magic <= 0x184D2A5F:
            seen.add("frame:skippable")
            pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
            continue
        fhd = data[pos + 4]
        pos += 5
        single = (fhd >> 5) & 1
        seen.add("frame:single_segment" if single else "frame:window")
        pos += 0 if single else 1
        fcs = (1 if single else 0, 2, 4, 8)[fhd >> 6]
        if not fcs:
            seen.add("frame:no_content_size")
        pos += fcs
        while True:
            head = int.from_bytes(data[pos:pos + 3], "little")
            pos += 3
            last, btype, size = head & 1, (head >> 1) & 3, head >> 3
            seen.add(f"block:{('raw', 'rle', 'compressed')[btype]}")
            if btype == 2:
                b0 = data[pos]
                kind = b0 & 3
                seen.add(f"literals:"
                         f"{('raw', 'rle', 'huffman', 'treeless')[kind]}")
                if kind >= 2:
                    seen.add(f"streams:{1 if (b0 >> 2) & 3 == 0 else 4}")
                if kind == 2:
                    h = (3, 3, 4, 5)[(b0 >> 2) & 3]
                    seen.add("weights:direct" if data[pos + h] >= 128
                             else "weights:fse")
                s = pos + _literals_size(data, pos)
                if data[s] == 0:
                    seen.add("sequences:none")
                else:
                    s += 1 if data[s] < 128 else 2 if data[s] < 255 else 3
                    m = data[s]
                    seen.add(f"ll:{_MODES[m >> 6]}")
                    seen.add(f"of:{_MODES[(m >> 4) & 3]}")
                    seen.add(f"ml:{_MODES[(m >> 2) & 3]}")
            pos += 1 if btype == 1 else size
            if last:
                break
        if fhd & 4:
            seen.add("frame:checksum")
            pos += 4
    return seen


def _words(rng, nbytes: int) -> bytes:
    """Text-like bytes: words of a seeded vocabulary drawn with Zipf's
    frequencies, in lines."""
    letters = np.frombuffer(b"etaoinshrdlucmfwypvbgkqjxz", np.uint8)
    p = 1.0 / np.arange(1, 27)
    vocab = [bytes(rng.choice(letters, int(rng.integers(2, 10)),
                              p=p / p.sum())) for _ in range(3000)]
    z = 1.0 / np.arange(1, 3001) ** 1.1
    out = bytearray()
    while len(out) < nbytes:
        out += b" ".join(vocab[i] for i in rng.choice(3000, 2000,
                                                      p=z / z.sum()))
        out += b".\n"
    return bytes(out[:nbytes])


def _inputs() -> dict:
    """Each input from its own generator, seeded ``[SEED, k]``."""
    rng = [np.random.default_rng([SEED, k]) for k in range(8)]
    w = rng[1].standard_normal(24_000).astype(np.float32) * 0.02
    bf16 = (w.view(np.uint32) >> 16).astype(np.uint16).tobytes()
    small = bytes(rng[2].integers(0, 12, 3000, dtype=np.uint8))
    runs = b"".join(bytes([65 + i % 3]) * (5 + i % 7) for i in range(4000))
    # 20-byte words, then "Q" + a word again and again: a block whose
    # literals are all "Q" and whose sequences share one code each
    words = [rng[3].bytes(20) for _ in range(6000)]
    picks = rng[3].integers(0, len(words), 5000)
    q_words = b"".join(words) + b"".join(b"Q" + words[i] for i in picks)
    # one random byte, then 8-10 bytes of a fixed string: block after
    # block of like sequences (the repeat table modes)
    heads = rng[4].integers(0, 256, 30_000, dtype=np.uint8)
    like = b"".join(bytes([int(r)]) + b"abcdefghij"[:8 + i % 3]
                    for i, r in enumerate(heads))
    return {"text": _words(rng[0], 40_000),
            "text_long": _words(rng[5], 160_000), "bf16": bf16,
            "small_alphabet": small, "runs": runs, "zeros": bytes(300_000),
            "random": rng[6].bytes(10_000), "tiny": b"zstd fixture",
            "q_words": q_words, "like": like}


def _frames() -> list:
    import zstandard

    data = _inputs()
    out = []
    for name, lvl, ck in (("text", 19, True), ("text_long", 1, False),
                          ("bf16", 3, True), ("small_alphabet", 3, False),
                          ("runs", 3, False), ("runs", 19, False),
                          ("zeros", 3, False), ("random", 1, False),
                          ("tiny", 3, True), ("q_words", 19, False),
                          ("like", 9, False)):
        c = zstandard.ZstdCompressor(level=lvl, write_checksum=ck)
        out.append((f"{name}_l{lvl}{'_ck' if ck else ''}",
                    c.compress(data[name]), data[name]))
    stream = zstandard.ZstdCompressor(level=3).compressobj()
    out.append(("text_streamed", stream.compress(data["text"])
                + stream.flush(), data["text"]))
    params = zstandard.ZstdCompressionParameters.from_level(
        19, enable_ldm=True, window_log=27)
    out.append(("text_long_ldm", zstandard.ZstdCompressor(
        compression_params=params).compress(data["text"]), data["text"]))
    payload = np.random.default_rng([SEED, 7]).bytes(37)
    out.append(("skippable", (0x184D2A53).to_bytes(4, "little")
                + len(payload).to_bytes(4, "little") + payload, b""))
    return out


def _cut_mantissa(x):
    import jax
    import jax.numpy as jnp

    bits = jax.lax.bitcast_convert_type(x, jnp.uint16) & jnp.uint16(0xFFE0)
    return jax.lax.bitcast_convert_type(bits, jnp.bfloat16)


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from deepvision_tpu.engine.config import TINY_TEST
    from deepvision_tpu.engine.weights import init_params, save_checkpoint

    params = jax.tree.map(_cut_mantissa, init_params(TINY_TEST, seed=SEED))
    ckpt = os.path.join(HERE, "tiny_ckpt")
    if os.path.isdir(ckpt):
        shutil.rmtree(ckpt)
    save_checkpoint(ckpt, params)
    np.savez_compressed(os.path.join(HERE, "tiny_ckpt.npz"), **{
        f"{'/'.join(k.key for k in path)}@bf16":
        np.asarray(leaf).view(np.uint16)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]})

    index, blob = [], bytearray()
    for name, frame, plain in _frames():
        index.append({"name": name, "offset": len(blob), "length": len(frame),
                      "size": len(plain),
                      "sha256": hashlib.sha256(plain).hexdigest()})
        blob += frame
    missing = WANTED - features(bytes(blob))
    if missing:
        print(f"the frames miss {sorted(missing)}", file=sys.stderr)
        return 1
    with open(os.path.join(HERE, "frames.zst"), "wb") as fh:
        fh.write(blob)
    with open(os.path.join(HERE, "frames.json"), "w") as fh:
        json.dump({"seed": SEED, "frames": index}, fh, indent=1)
    print(f"{len(index)} frames, {len(blob)} bytes")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        HERE))))
    sys.exit(main())
