"""The port's zstd decoders against the ``zstandard`` package.

``deepvision_tpu_torch/engine/zstd.py`` (the plain decoder a CPU checkpoint
load uses) must give ``zstandard``'s input back byte for byte over levels 1,
3, 9 and 19 and long-distance mode, on text, zeros, random bytes, bf16
weights and repeated patterns of several 128 KiB blocks, with and without a
checksum; single-segment, windowed, skippable and concatenated frames; and
it must raise on a corrupted checksum or a dictionary.  Every comparison is
exact: a decoder's output is bytes.

The committed frames (``tests/fixtures/torch_orbax/frames.zst``, made by
``make_fixtures.py``) cover every frame, block, literals and sequence mode;
``zstandard`` and both decoders must give each frame's recorded SHA-256.
The compiled decoder (``kernels/csrc/zstd_decode.cu``) is host C++ with no
device code, so g++ builds it here for the same comparisons; on the card
``chip_smoke.py`` phase ``orbax`` builds it with nvcc.
"""

import ctypes
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import zstandard

from deepvision_tpu_torch.engine import zstd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_orbax")
SOURCE = os.path.join(ROOT, "deepvision_tpu_torch", "engine", "kernels",
                      "csrc", "zstd_decode.cu")


def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs():
    rng = np.random.default_rng(0)
    with open(os.path.join(ROOT, "ROADMAP.md"), "rb") as fh:
        text = fh.read()
    w = rng.standard_normal(150_000).astype(np.float32) * 0.02
    return {
        "text": (text * (1 + 300_000 // len(text)))[:300_000],
        "zeros": bytes(300_000),
        "random": rng.bytes(200_000),
        "bf16": (w.view(np.uint32) >> 16).astype(np.uint16).tobytes(),
        "repeated": (b"orbax-checkpoint:" + bytes(range(7))) * 12_000,
    }


INPUTS = _inputs()
# a single-segment frame naming dictionary 7 (1-byte id), holding "abc" in
# one raw block
_NAMES_A_DICTIONARY = bytes.fromhex("28b52ffd" "21" "07" "03" "190000") \
    + b"abc"


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [1, 3, 9, 19])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_decodes_zstandard_frames(name, level, checksum):
    data = INPUTS[name]
    assert len(data) > 128 * 1024  # several blocks
    frame = zstandard.ZstdCompressor(
        level=level, write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == data
    assert zstd.decompress(frame, len(data)) == data


def test_long_distance_mode():
    data = INPUTS["text"] + INPUTS["random"][:50_000] + INPUTS["text"]
    params = zstandard.ZstdCompressionParameters.from_level(
        19, enable_ldm=True, window_log=27)
    frame = zstandard.ZstdCompressor(compression_params=params).compress(
        data)
    assert zstd.decompress(frame) == data


def test_single_segment_windowed_skippable_and_concatenated_frames():
    feats = _maker().features
    small = zstandard.ZstdCompressor(level=3).compress(b"small input " * 9)
    assert "frame:single_segment" in feats(small)
    obj = zstandard.ZstdCompressor(level=3, write_checksum=True).compressobj()
    streamed = obj.compress(INPUTS["text"]) + obj.flush()
    assert {"frame:window", "frame:no_content_size"} <= feats(streamed)
    skip = (0x184D2A5F).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"12345"
    both = small + skip + streamed + skip
    assert "frame:skippable" in feats(both)
    assert zstd.decompress(both) == b"small input " * 9 + INPUTS["text"]
    assert zstd.decompress(skip + small) == b"small input " * 9


def test_corrupt_input_raises():
    frame = bytearray(zstandard.ZstdCompressor(
        level=3, write_checksum=True).compress(INPUTS["text"]))
    frame[-1] ^= 0x40
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))
    good = zstandard.ZstdCompressor(level=3).compress(INPUTS["bf16"])
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(good[:len(good) // 2])
    with pytest.raises(zstd.ZstdError, match="expected"):
        zstd.decompress(good, len(INPUTS["bf16"]) + 1)
    with pytest.raises(zstd.ZstdError, match="magic"):
        zstd.decompress(b"\x00" * 16)
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(_NAMES_A_DICTIONARY)


def test_xxh64_matches_the_checksums_zstandard_writes():
    for data in (b"", b"a", b"0123456789abcdef" * 3, INPUTS["random"]):
        frame = zstandard.ZstdCompressor(write_checksum=True).compress(data)
        assert int.from_bytes(frame[-4:], "little") == \
            zstd.xxh64(data) & 0xFFFFFFFF


def _committed():
    with open(os.path.join(FIXTURES, "frames.json")) as fh:
        index = json.load(fh)["frames"]
    with open(os.path.join(FIXTURES, "frames.zst"), "rb") as fh:
        blob = fh.read()
    return index, blob


def test_committed_frames_cover_every_mode_and_zstandard_reads_them():
    maker = _maker()
    index, blob = _committed()
    assert maker.WANTED <= maker.features(blob)
    for f in index:
        frame = blob[f["offset"]:f["offset"] + f["length"]]
        want = b"".join(zstandard.ZstdDecompressor().read_to_iter(frame))
        assert len(want) == f["size"], f["name"]
        assert hashlib.sha256(want).hexdigest() == f["sha256"], f["name"]
        got = zstd.decompress(frame)
        assert hashlib.sha256(got).hexdigest() == f["sha256"], f["name"]
    assert sum(f["length"] for f in index) == len(blob)
    assert len(zstd.decompress(blob)) == sum(f["size"] for f in index)


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """``zstd_decode.cu`` built as host C++ with g++ (it includes no CUDA
    header), bound as ``_build`` binds it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    so = str(tmp_path_factory.mktemp("zstd") / "libzstd_decode.so")
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-fPIC",
                    "-shared", "-o", so, SOURCE], check=True, timeout=300)
    fn = ctypes.CDLL(so).dv_zstd_decompress
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong]
    fn.restype = ctypes.c_longlong

    def decode(data, cap):
        src = np.frombuffer(data, np.uint8)
        dst = np.zeros(max(cap, 1), np.uint8)
        rc = fn(src.ctypes.data, len(src), dst.ctypes.data, cap)
        return rc if rc < 0 else dst[:rc].tobytes()

    return decode


def test_compiled_decoder_equals_the_plain_one(compiled):
    index, blob = _committed()
    for f in index:
        frame = blob[f["offset"]:f["offset"] + f["length"]]
        assert compiled(frame, f["size"]) == bytes(zstd.decompress(frame)), \
            f["name"]
    total = sum(f["size"] for f in index)
    assert compiled(blob, total) == bytes(zstd.decompress(blob))
    for name, data in INPUTS.items():
        for level in (1, 19):
            frame = zstandard.ZstdCompressor(
                level=level, write_checksum=True).compress(data)
            assert compiled(frame, len(data)) == data, (name, level)
    # its error codes: output too small, checksum, dictionary, truncated
    frame = bytearray(zstandard.ZstdCompressor(
        level=3, write_checksum=True).compress(INPUTS["text"]))
    assert compiled(bytes(frame), len(INPUTS["text"]) - 1) == -2
    frame[-1] ^= 0x40
    assert compiled(bytes(frame), len(INPUTS["text"])) == -3
    assert compiled(_NAMES_A_DICTIONARY, 16) == -4
    assert compiled(bytes(frame[:len(frame) // 2]), len(INPUTS["text"])) in (
        -1, -5)
