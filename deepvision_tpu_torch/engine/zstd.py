"""Zstandard decoder (RFC 8878) in plain Python, with numpy where it helps.

Orbax checkpoints keep their OCDBT nodes and their zarr chunks as zstd
frames, and neither the card's machine nor Python's standard library has a
zstd package.  This module is the plain decoder, used when a checkpoint is
read onto the CPU; ``kernels/zstd.py`` binds the compiled one
(``kernels/csrc/zstd_decode.cu``) that a CUDA load uses.  Both follow the
RFC section by section and give the same bytes.

What is decoded: zstd frames (single-segment or windowed, with or without
the content size and the XXH64 content checksum, which is verified),
skippable frames, and any concatenation of them; raw, RLE and compressed
blocks; raw, RLE, Huffman (tree description direct or FSE-compressed) and
treeless literals in 1 or 4 streams; sequences with predefined, RLE, FSE
and repeat table modes and the three repeat offsets.  A frame that names a
dictionary raises :class:`ZstdError`: checkpoints use none.

Huffman streams, the bulk of a checkpoint's work, are decoded with numpy:
the table index at every bit position of a stream is computed at once, and
the walk from position to position that remains is a list lookup.
"""

from __future__ import annotations

import numpy as np

MAGIC = 0xFD2FB528
SKIPPABLE_MIN, SKIPPABLE_MAX = 0x184D2A50, 0x184D2A5F
MAX_BLOCK = 128 * 1024


class ZstdError(ValueError):
    """The input is not a zstd stream this decoder accepts."""


# --- predefined tables and code baselines (RFC 8878 3.1.1.3.2.1-2) --------

_LL_DEFAULT = (4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
               2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1)
_ML_DEFAULT = (1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1)
_OF_DEFAULT = (1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, -1, -1, -1, -1, -1)

_LL_BASE = tuple(range(16)) + (16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                               256, 512, 1024, 2048, 4096, 8192, 16384,
                               32768, 65536)
_LL_BITS = (0,) * 16 + (1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                        13, 14, 15, 16)
_ML_BASE = tuple(range(3, 35)) + (35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                                  99, 131, 259, 515, 1027, 2051, 4099, 8195,
                                  16387, 32771, 65539)
_ML_BITS = (0,) * 32 + (1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
                        12, 13, 14, 15, 16)

# (max symbol, max accuracy log) of each sequence code table
_LL_LIMITS, _OF_LIMITS, _ML_LIMITS = (35, 9), (31, 8), (52, 9)


# --- bit readers ----------------------------------------------------------

class _ForwardBits:
    """Little-endian bit reader, least significant bit first (FSE table
    descriptions)."""

    def __init__(self, buf, start: int, end: int):
        self.buf, self.start, self.end = buf, start, end
        self.bit = 0

    def peek(self, n: int) -> int:
        i = self.start + (self.bit >> 3)
        if i >= self.end:
            return 0
        word = int.from_bytes(self.buf[i:min(i + 5, self.end)], "little")
        return (word >> (self.bit & 7)) & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.bit += n
        if self.start + ((self.bit + 7) >> 3) > self.end:
            raise ZstdError("FSE table description runs past its block")

    def nbytes(self) -> int:
        return (self.bit + 7) >> 3


class _BackwardBits:
    """Bit reader for zstd's backward streams: the stream is one number,
    little-endian; reading starts under the highest set bit of its last
    byte (the end mark) and takes bits from the top down.  Bits read past
    the start are zeros, and :attr:`pos` goes negative."""

    def __init__(self, buf, start: int, end: int):
        if end <= start or buf[end - 1] == 0:
            raise ZstdError("bitstream lacks its end mark")
        self.buf, self.start = buf, start
        self.pos = (end - start - 1) * 8 + buf[end - 1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        pos = self.pos - n
        self.pos = pos
        if pos >= 0:
            i = self.start + (pos >> 3)
            word = int.from_bytes(self.buf[i:i + 5], "little")
            return (word >> (pos & 7)) & ((1 << n) - 1)
        if pos + n <= 0:
            return 0
        word = int.from_bytes(self.buf[self.start:self.start + 5], "little")
        return (word & ((1 << (pos + n)) - 1)) << -pos


# --- FSE (RFC 8878 4.1) ---------------------------------------------------

def _read_fse_counts(buf, start: int, end: int, max_symbol: int,
                     max_log: int):
    """Read an FSE table description.  Returns ``(probs, log,
    bytes_used)``; a probability of -1 is "less than 1"."""
    bits = _ForwardBits(buf, start, end)
    log = bits.peek(4) + 5
    bits.skip(4)
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} over {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    probs = []
    while remaining > 1:
        if len(probs) > max_symbol:
            raise ZstdError("FSE table description names too many symbols")
        top = (2 * threshold - 1) - remaining
        low = bits.peek(nbits - 1)
        if low < top:
            count = low
            bits.skip(nbits - 1)
        else:
            count = bits.peek(nbits)
            if count >= threshold:
                count -= top
            bits.skip(nbits)
        count -= 1
        remaining -= -count if count < 0 else count
        probs.append(count)
        if count == 0:
            while True:
                flag = bits.peek(2)
                bits.skip(2)
                probs.extend([0] * flag)
                if flag != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(probs) > max_symbol + 1:
        raise ZstdError("FSE table description does not add up")
    return probs, log, bits.nbytes()


def _fse_table(probs, log: int):
    """Decoding table of an FSE distribution: per state, ``(symbol,
    nbits, baseline)`` as three lists."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    for s, p in enumerate(probs):
        if p == -1:
            symbols[high] = s
            high -= 1
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, p in enumerate(probs):
        for _ in range(max(p, 0)):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("FSE distribution does not fill its table")
    nxt = [1 if p == -1 else p for p in probs]
    nbits, base = [0] * size, [0] * size
    for state in range(size):
        s = symbols[state]
        x = nxt[s]
        nxt[s] += 1
        nb = log - (x.bit_length() - 1)
        nbits[state] = nb
        base[state] = (x << nb) - size
    return symbols, nbits, base, log


def _rle_table(symbol: int):
    return [symbol], [0], [0], 0


_LL_PREDEFINED = _fse_table(_LL_DEFAULT, 6)
_ML_PREDEFINED = _fse_table(_ML_DEFAULT, 6)
_OF_PREDEFINED = _fse_table(_OF_DEFAULT, 5)


# --- Huffman literals (RFC 8878 4.2) --------------------------------------

def _huffman_weights(buf, pos: int, end: int):
    """Read a Huffman tree description.  Returns ``(weights,
    next_pos)``, the last (implied) weight included."""
    header = buf[pos]
    pos += 1
    if header >= 128:
        n = header - 127
        nbytes = (n + 1) // 2
        if pos + nbytes > end:
            raise ZstdError("Huffman weights run past the literals")
        weights = []
        for b in buf[pos:pos + nbytes]:
            weights += (b >> 4, b & 15)
        weights = weights[:n]
        pos += nbytes
    else:
        if pos + header > end:
            raise ZstdError("Huffman weights run past the literals")
        probs, log, used = _read_fse_counts(buf, pos, pos + header, 255, 6)
        symbols, nbits, base, _ = _fse_table(probs, log)
        bits = _BackwardBits(buf, pos + used, pos + header)
        s1, s2 = bits.read(log), bits.read(log)
        weights = []
        while True:
            if len(weights) > 254:
                raise ZstdError("too many Huffman weights")
            weights.append(symbols[s1])
            s1 = base[s1] + bits.read(nbits[s1])
            if bits.pos < 0:
                weights.append(symbols[s2])
                break
            weights.append(symbols[s2])
            s2 = base[s2] + bits.read(nbits[s2])
            if bits.pos < 0:
                weights.append(symbols[s1])
                break
        pos += header
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0 or max(weights) > 11:
        raise ZstdError("bad Huffman weights")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise ZstdError("Huffman weights do not complete a power of two")
    weights.append(rest.bit_length())
    if max_bits > 11 or len(weights) > 256:
        raise ZstdError("Huffman tree too deep")
    return weights, pos


def _huffman_table(weights):
    """``(symbol_of_index, nbits_of_index, max_bits)`` as numpy arrays
    indexed by the next ``max_bits`` bits of a stream."""
    max_bits = (sum(1 << (w - 1) for w in weights if w)).bit_length() - 1
    size = 1 << max_bits
    sym = np.zeros(size, np.uint8)
    nb = np.zeros(size, np.int64)
    pos = 0
    for w in range(1, max_bits + 1):
        span = 1 << (w - 1)
        for s, sw in enumerate(weights):
            if sw == w:
                sym[pos:pos + span] = s
                nb[pos:pos + span] = max_bits + 1 - w
                pos += span
    return sym, nb, max_bits


def _huffman_stream(buf, start: int, end: int, count: int, table) -> bytes:
    """Decode ``count`` literals from one backward Huffman stream."""
    sym, nb, max_bits = table
    if end <= start or buf[end - 1] == 0:
        raise ZstdError("Huffman stream lacks its end mark")
    bits = np.unpackbits(np.frombuffer(buf, np.uint8, end - start, start),
                         bitorder="little")
    top = (end - start - 1) * 8 + buf[end - 1].bit_length() - 1
    # ext[j] = bit j - max_bits of the stream (zeros below its start);
    # index[q] = the max_bits bits just under position q, the highest first
    ext = np.concatenate([np.zeros(max_bits, np.uint8), bits[:top]])
    index = np.zeros(top + 1, np.int64)
    for k in range(max_bits):
        index |= ext[k:k + top + 1].astype(np.int64) << k
    sym_at = sym[index].tolist()
    step_at = nb[index].tolist()
    out = bytearray(count)
    q = top
    for i in range(count):
        out[i] = sym_at[q]
        q -= step_at[q]
        if q < 0:
            raise ZstdError("Huffman stream overrun")
    if q != 0:
        raise ZstdError("Huffman stream not consumed exactly")
    return bytes(out)


# --- frame state ----------------------------------------------------------

class _Frame:
    """Tables and offsets that carry from block to block in a frame."""

    def __init__(self):
        self.huffman = None
        self.ll = self.of = self.ml = None
        self.reps = [1, 4, 8]


def _literals(buf, pos: int, end: int, st: _Frame):
    """Decode a block's literals section.  Returns ``(literals, pos)``."""
    b0 = buf[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) | (buf[pos + 1] << 4), pos + 2
        else:
            size = (b0 >> 4) | (buf[pos + 1] << 4) | (buf[pos + 2] << 12)
            pos += 3
        if size > MAX_BLOCK:
            raise ZstdError("literals larger than a block")
        if kind == 0:
            if pos + size > end:
                raise ZstdError("raw literals run past the block")
            return bytes(buf[pos:pos + size]), pos + size
        if pos >= end:
            raise ZstdError("RLE literals run past the block")
        return bytes(buf[pos:pos + 1]) * size, pos + 1
    nhead = (3, 3, 4, 5)[fmt]
    if pos + nhead > end:
        raise ZstdError("literals header runs past the block")
    word = int.from_bytes(buf[pos:pos + nhead], "little")
    width = (10, 10, 14, 18)[fmt]
    size = (word >> 4) & ((1 << width) - 1)
    csize = (word >> (4 + width)) & ((1 << width) - 1)
    streams = 1 if fmt == 0 else 4
    pos += nhead
    stop = pos + csize
    if stop > end or size > MAX_BLOCK:
        raise ZstdError("compressed literals run past the block")
    if kind == 2:
        weights, pos = _huffman_weights(buf, pos, stop)
        st.huffman = _huffman_table(weights)
    elif st.huffman is None:
        raise ZstdError("treeless literals without an earlier table")
    if streams == 1:
        return _huffman_stream(buf, pos, stop, size, st.huffman), stop
    if pos + 6 > stop:
        raise ZstdError("jump table runs past the literals")
    s1 = buf[pos] | buf[pos + 1] << 8
    s2 = buf[pos + 2] | buf[pos + 3] << 8
    s3 = buf[pos + 4] | buf[pos + 5] << 8
    bounds = [pos + 6]
    for s in (s1, s2, s3):
        bounds.append(bounds[-1] + s)
    bounds.append(stop)
    if bounds[3] > stop:
        raise ZstdError("jump table runs past the literals")
    each = (size + 3) // 4
    counts = (each, each, each, size - 3 * each)
    if counts[3] < 0:
        raise ZstdError("too few literals for four streams")
    return b"".join(_huffman_stream(buf, bounds[i], bounds[i + 1],
                                    counts[i], st.huffman)
                    for i in range(4)), stop


def _seq_table(mode: int, buf, pos: int, end: int, limits, predefined,
               previous):
    max_symbol, max_log = limits
    if mode == 0:
        return predefined, pos
    if mode == 1:
        if pos >= end or buf[pos] > max_symbol:
            raise ZstdError("bad RLE sequence code")
        return _rle_table(buf[pos]), pos + 1
    if mode == 2:
        probs, log, used = _read_fse_counts(buf, pos, end, max_symbol,
                                            max_log)
        return _fse_table(probs, log), pos + used
    if previous is None:
        raise ZstdError("repeat table mode without an earlier table")
    return previous, pos


def _block(buf, pos: int, end: int, st: _Frame, out: bytearray,
           frame_start: int) -> None:
    """Decode one compressed block of ``buf[pos:end]`` onto ``out``."""
    lits, pos = _literals(buf, pos, end, st)
    if pos >= end:
        raise ZstdError("block lacks its sequences section")
    b0 = buf[pos]
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + buf[pos + 1], pos + 2
    else:
        nseq, pos = buf[pos + 1] + (buf[pos + 2] << 8) + 0x7F00, pos + 3
    if nseq == 0:
        if pos != end:
            raise ZstdError("bytes after an empty sequences section")
        out += lits
        return
    modes = buf[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved sequence mode bits set")
    st.ll, pos = _seq_table(modes >> 6, buf, pos, end, _LL_LIMITS,
                            _LL_PREDEFINED, st.ll)
    st.of, pos = _seq_table((modes >> 4) & 3, buf, pos, end, _OF_LIMITS,
                            _OF_PREDEFINED, st.of)
    st.ml, pos = _seq_table((modes >> 2) & 3, buf, pos, end, _ML_LIMITS,
                            _ML_PREDEFINED, st.ml)
    ll_sym, ll_nb, ll_base, ll_log = st.ll
    of_sym, of_nb, of_base, of_log = st.of
    ml_sym, ml_nb, ml_base, ml_log = st.ml
    bits = _BackwardBits(buf, pos, end)
    read = bits.read
    ll_state, of_state, ml_state = read(ll_log), read(of_log), read(ml_log)
    reps = st.reps
    lit_pos = 0
    for i in range(nseq):
        of_code = of_sym[of_state]
        ml_code = ml_sym[ml_state]
        ll_code = ll_sym[ll_state]
        if of_code > 31:
            raise ZstdError("offset code out of range")
        offset_value = (1 << of_code) + read(of_code)
        ml = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        if offset_value > 3:
            offset = offset_value - 3
            reps[2], reps[1], reps[0] = reps[1], reps[0], offset
        else:
            idx = offset_value - (1 if ll else 0)
            if idx == 0:
                offset = reps[0]
            else:
                offset = reps[0] - 1 if idx == 3 else reps[idx]
                if idx > 1:
                    reps[2] = reps[1]
                reps[1], reps[0] = reps[0], offset
        if i + 1 < nseq:
            ll_state = ll_base[ll_state] + read(ll_nb[ll_state])
            ml_state = ml_base[ml_state] + read(ml_nb[ml_state])
            of_state = of_base[of_state] + read(of_nb[of_state])
        if lit_pos + ll > len(lits):
            raise ZstdError("sequence takes more literals than decoded")
        out += lits[lit_pos:lit_pos + ll]
        lit_pos += ll
        n = len(out)
        if offset <= 0 or offset > n - frame_start:
            raise ZstdError("match offset before the frame's start")
        if offset >= ml:
            out += out[n - offset:n - offset + ml]
        else:
            piece = out[n - offset:]
            out += (piece * (ml // offset + 1))[:ml]
    if bits.pos != 0:
        raise ZstdError("sequences bitstream not consumed exactly")
    out += lits[lit_pos:]


def _frame(buf, pos: int, out: bytearray) -> int:
    """Decode the frame whose header starts at ``pos`` (after the magic)
    onto ``out``; returns the position after it."""
    n = len(buf)
    if pos >= n:
        raise ZstdError("truncated frame header")
    fhd = buf[pos]
    pos += 1
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    if fhd & 8:
        raise ZstdError("reserved frame header bit set")
    if fhd & 3:
        raise ZstdError("frames with a dictionary are not supported")
    window = None
    if not single:
        wd = buf[pos]
        pos += 1
        base = 1 << (10 + (wd >> 3))
        window = base + (base >> 3) * (wd & 7)
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if pos + fcs_size > n:
        raise ZstdError("truncated frame header")
    content_size = None
    if fcs_size:
        content_size = int.from_bytes(buf[pos:pos + fcs_size], "little")
        if fcs_size == 2:
            content_size += 256
        pos += fcs_size
    block_max = MAX_BLOCK if window is None else min(window, MAX_BLOCK)
    st = _Frame()
    start = len(out)
    while True:
        if pos + 3 > n:
            raise ZstdError("truncated block header")
        head = buf[pos] | buf[pos + 1] << 8 | buf[pos + 2] << 16
        pos += 3
        last, btype, bsize = head & 1, (head >> 1) & 3, head >> 3
        if btype == 1:
            if pos >= n or bsize > block_max:
                raise ZstdError("bad RLE block")
            out += bytes(buf[pos:pos + 1]) * bsize
            pos += 1
        elif btype == 3:
            raise ZstdError("reserved block type")
        else:
            if pos + bsize > n or bsize > block_max:
                raise ZstdError("block runs past the input")
            if btype == 0:
                out += buf[pos:pos + bsize]
            else:
                before = len(out)
                _block(buf, pos, pos + bsize, st, out, start)
                if len(out) - before > block_max:
                    raise ZstdError("block decodes past its maximum")
            pos += bsize
        if last:
            break
    if content_size is not None and len(out) - start != content_size:
        raise ZstdError(f"frame decoded {len(out) - start} bytes, header "
                        f"says {content_size}")
    if fhd & 4:
        if pos + 4 > n:
            raise ZstdError("truncated content checksum")
        want = int.from_bytes(buf[pos:pos + 4], "little")
        if xxh64(memoryview(out)[start:]) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
        pos += 4
    return pos


def decompress(data, size=None) -> bytearray:
    """Decode every frame of ``data`` (bytes-like) and return the bytes
    they hold, skippable frames skipped.  ``size``, when given, is the
    exact decoded length the caller expects (a zarr chunk's bytes)."""
    buf = memoryview(data).cast("B")
    n = len(buf)
    out = bytearray()
    pos = 0
    if n == 0:
        raise ZstdError("empty input")
    while pos < n:
        if pos + 4 > n:
            raise ZstdError("truncated frame magic")
        magic = int.from_bytes(buf[pos:pos + 4], "little")
        if SKIPPABLE_MIN <= magic <= SKIPPABLE_MAX:
            if pos + 8 > n:
                raise ZstdError("truncated skippable frame")
            pos += 8 + int.from_bytes(buf[pos + 4:pos + 8], "little")
            if pos > n:
                raise ZstdError("skippable frame runs past the input")
            continue
        if magic != MAGIC:
            raise ZstdError(f"bad magic {magic:#010x} at byte {pos}")
        try:
            pos = _frame(buf, pos + 4, out)
        except IndexError as e:
            raise ZstdError(f"truncated frame: {e}") from None
    if size is not None and len(out) != size:
        raise ZstdError(f"decoded {len(out)} bytes, expected {size}")
    return out


# --- XXH64 (the content checksum) -----------------------------------------

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    acc = ((acc << 31) | (acc >> 33)) & _M64
    return (acc * _P1) & _M64


def _merge(acc: int, val: int) -> int:
    acc ^= _round(0, val)
    return (acc * _P1 + _P4) & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (bytes-like) with ``seed``."""
    buf = memoryview(data).cast("B")
    n = len(buf)
    pos = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed
        v4 = (seed - _P1) & _M64
        stripes = n // 32
        lanes = np.frombuffer(buf, "<u8", stripes * 4).tolist()
        for i in range(0, 4 * stripes, 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        pos = stripes * 32
        h = (((v1 << 1) | (v1 >> 63)) + ((v2 << 7) | (v2 >> 57))
             + ((v3 << 12) | (v3 >> 52)) + ((v4 << 18) | (v4 >> 46))) & _M64
        for v in (v1, v2, v3, v4):
            h = _merge(h, v)
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while pos + 8 <= n:
        k = _round(0, int.from_bytes(buf[pos:pos + 8], "little"))
        h ^= k
        h = ((((h << 27) | (h >> 37)) & _M64) * _P1 + _P4) & _M64
        pos += 8
    if pos + 4 <= n:
        h ^= (int.from_bytes(buf[pos:pos + 4], "little") * _P1) & _M64
        h = ((((h << 23) | (h >> 41)) & _M64) * _P2 + _P3) & _M64
        pos += 4
    while pos < n:
        h ^= (buf[pos] * _P5) & _M64
        h = ((((h << 11) | (h >> 53)) & _M64) * _P1) & _M64
        pos += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h
