"""Tokenizers for the serving engine, in plain Python.

``ByteTokenizer`` maps UTF-8 bytes to ids 0..255 plus three specials.
``BPETokenizer`` reads a HuggingFace ``tokenizer.json`` of the byte-level
BPE kind the repository ships (``resources/tokenizer/dv_bpe_*.json``) and
gives the same ids as the ``tokenizers`` library does for such a file,
without needing that library or ``regex``:

1. the added tokens (``<pad> <s> </s> <|eot|>``) are split out first;
2. each remaining piece is pre-tokenized with the GPT-2 ByteLevel pattern
   ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``
   (``add_prefix_space: false``), written out as a scanner over
   ``unicodedata.category`` because ``re`` has no ``\\p{..}`` classes;
3. each word's bytes are mapped to the GPT-2 byte alphabet and merged by
   merge rank, with a per-word cache.

The files carry no post-processor, so no BOS is added; ``decode`` skips the
special ids, as the ``tokenizers`` library does by default.
"""

from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple


class ByteTokenizer:
    """Byte-level tokenizer: ids 0..255 are raw bytes, then specials."""

    BOS = 256
    EOS = 257
    PAD = 258

    vocab_size = 259
    special_ids = frozenset({256, 257, 258})

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.BOS] if add_bos else []) + ids

    def encode_batch(self, texts: Sequence[str],
                     add_bos: bool = True) -> List[List[int]]:
        return [self.encode(t, add_bos) for t in texts]

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")

    def id_to_token(self, tid: int) -> Optional[str]:
        """ByteLevel spelling of a byte id; None for the specials."""
        if 0 <= tid < 256:
            return bytes_to_unicode()[tid]
        return None

    @property
    def eos_id(self) -> int:
        return self.EOS


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible map from the 256 bytes to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# ``\s`` as the tokenizers library's regex engine (Oniguruma) reads it:
# \t \n \v \f \r, NEL, and the Unicode separator categories.
_WS_CHARS = frozenset("\t\n\x0b\x0c\r\x85")
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _kind(ch: str) -> str:
    """'s' whitespace, 'L' letter, 'N' number, 'P' anything else."""
    if ch in _WS_CHARS:
        return "s"
    cat = unicodedata.category(ch)
    if cat in ("Zs", "Zl", "Zp"):
        return "s"
    if cat[0] == "L":
        return "L"
    if cat[0] == "N":
        return "N"
    return "P"


def pretokenize(text: str) -> List[str]:
    """Split ``text`` as the GPT-2 ByteLevel regex does (first matching
    alternative at each position, each alternative greedy)."""
    kinds = [_kind(c) for c in text]
    n = len(text)
    out: List[str] = []
    i = 0
    while i < n:
        ch = text[i]
        # 's 't 're 've 'm 'll 'd (case-sensitive)
        if ch == "'":
            hit = next((c for c in _CONTRACTIONS
                        if text.startswith(c, i + 1)), None)
            if hit is not None:
                out.append(text[i:i + 1 + len(hit)])
                i += 1 + len(hit)
                continue
        # ' ?\p{L}+', ' ?\p{N}+', ' ?[^\s\p{L}\p{N}]+'
        j = i + 1 if (ch == " " and i + 1 < n) else i
        k = kinds[j]
        if k != "s":
            end = j + 1
            while end < n and kinds[end] == k:
                end += 1
            out.append(text[i:end])
            i = end
            continue
        # '\s+(?!\S)' then '\s+'
        end = i
        while end < n and kinds[end] == "s":
            end += 1
        if end < n and end - i > 1:
            end -= 1  # leave the last space to prefix the next word
        out.append(text[i:end])
        i = end
    return out


class BPETokenizer:
    """Byte-level BPE over a ``tokenizer.json`` (see the module docstring)."""

    def __init__(self, path: str):
        with open(path, encoding="utf-8") as fh:
            spec = json.load(fh)
        model = spec["model"]
        if model.get("type") != "BPE":
            raise ValueError(f"{path}: model type {model.get('type')!r} "
                             "is not BPE")
        pre = spec.get("pre_tokenizer") or {}
        if pre.get("type") != "ByteLevel" or pre.get("add_prefix_space"):
            raise ValueError(f"{path}: needs a ByteLevel pre-tokenizer "
                             "without add_prefix_space")
        self._vocab: Dict[str, int] = dict(model["vocab"])
        self._ranks: Dict[Tuple[str, str], int] = {}
        for rank, merge in enumerate(model["merges"]):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            self._ranks[(a, b)] = rank
        self._added: Dict[str, int] = {}
        special = set()
        for tok in spec.get("added_tokens") or ():
            self._added[tok["content"]] = tok["id"]
            if tok.get("special"):
                special.add(tok["id"])
        self.special_ids = frozenset(special)
        self._id_to_tok: Dict[int, str] = {v: k for k, v in
                                           self._vocab.items()}
        for content, tid in self._added.items():
            self._id_to_tok[tid] = content
        self.vocab_size = max(self._id_to_tok) + 1
        self._b2u = bytes_to_unicode()
        self._u2b = {v: k for k, v in self._b2u.items()}
        self._cache: Dict[str, List[int]] = {}
        # longest first, so an added token that prefixes another loses
        self._added_sorted = sorted(self._added, key=len, reverse=True)
        self._added_first = {a[0] for a in self._added}
        self._added_ids = frozenset(self._added.values())
        eos = None
        for cand in ("<|eot|>", "</s>", "<eos>", "<|endoftext|>",
                     "<|eot_id|>"):
            tid = self._added.get(cand, self._vocab.get(cand))
            if tid is not None:
                eos = tid
                break
        self._eos = eos if eos is not None else 0

    # -- encode ----------------------------------------------------------
    def _split_added(self, text: str) -> List[Tuple[str, bool]]:
        """``[(piece, is_added_token)]`` in order."""
        if not self._added:
            return [(text, False)]
        out: List[Tuple[str, bool]] = []
        start = i = 0
        while i < len(text):
            hit = None
            if text[i] in self._added_first:
                hit = next((a for a in self._added_sorted
                            if text.startswith(a, i)), None)
            if hit is None:
                i += 1
                continue
            if i > start:
                out.append((text[start:i], False))
            out.append((hit, True))
            i += len(hit)
            start = i
        if start < len(text):
            out.append((text[start:], False))
        return out

    def _bpe(self, word: str) -> List[int]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        syms = [self._b2u[b] for b in word.encode("utf-8")]
        ranks = self._ranks
        while len(syms) > 1:
            best, best_i = None, -1
            for i in range(len(syms) - 1):
                r = ranks.get((syms[i], syms[i + 1]))
                if r is not None and (best is None or r < best):
                    best, best_i = r, i
            if best is None:
                break
            a, b = syms[best_i], syms[best_i + 1]
            merged: List[str] = []
            i = 0
            while i < len(syms):
                if i < len(syms) - 1 and syms[i] == a and syms[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(syms[i])
                    i += 1
            syms = merged
        ids = [self._vocab[s] for s in syms]
        if len(self._cache) < 100_000:
            self._cache[word] = ids
        return ids

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids: List[int] = []
        for piece, added in self._split_added(text):
            if added:
                ids.append(self._added[piece])
                continue
            for word in pretokenize(piece):
                ids.extend(self._bpe(word))
        return ids

    def encode_batch(self, texts: Sequence[str],
                     add_bos: bool = True) -> List[List[int]]:
        """``add_bos`` is ignored, as in :meth:`encode`."""
        return [self.encode(t) for t in texts]

    # -- decode ----------------------------------------------------------
    def decode(self, ids: Sequence[int]) -> str:
        data = bytearray()
        for tid in ids:
            tid = int(tid)
            if tid in self.special_ids:
                continue
            tok = self._id_to_tok.get(tid)
            if tok is None:
                continue
            if tid in self._added_ids:
                data.extend(tok.encode("utf-8"))
                continue
            data.extend(self._u2b[c] for c in tok)
        return data.decode("utf-8", errors="replace")

    def id_to_token(self, tid: int) -> Optional[str]:
        return self._id_to_tok.get(tid)

    @property
    def eos_id(self) -> int:
        return self._eos


def get_tokenizer(spec: Optional[str] = None):
    """``spec``: None/"byte" for the byte tokenizer, else a tokenizer.json path."""
    if not spec or spec == "byte":
        return ByteTokenizer()
    if os.path.isfile(spec):
        return BPETokenizer(spec)
    raise FileNotFoundError(f"tokenizer spec {spec!r} not found")
