"""Grammar-constrained decoding: JSON guaranteed by the sampler's mask.

A JSON grammar is compiled once per tokenizer into a token-level DFA; the
transition table lives on the device and masks logits inside the decode
loop, so every sampled token keeps the output inside the grammar and
``json.loads`` succeeds by construction.  This is a copy of the JAX
package's builder (same states, same numbering, same table), so the two
packages' tables are equal for the same tokenizer.

Design (all static shapes, no host round-trips in the decode loop):

* A byte-level JSON automaton with bounded nesting depth: states are
  (container-stack-config, mode); the bounded stack makes the pushdown a
  DFA.  Transitions are over 19 byte classes, so the char table is tiny.
* Token lifting: each BPE token's raw bytes (via the GPT-2 byte<->unicode
  map used by ByteLevel tokenizers) walk the byte DFA; the result is a
  ``[n_states, vocab] int32`` table: next state or -1 (forbidden).
* Row 0 is the FREE state: everything allowed, self-loop — unconstrained
  requests ride the same decode step with state 0.
* The ACCEPT state (a complete top-level value) allows only EOS, so
  constrained generations terminate cleanly.

The table is built once per (tokenizer, depth) and cached to disk, under
the directory the caller names (the engine uses the user's cache
directory, never the repository).
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional

import numpy as np

from deepvision_tpu_torch.engine.tokenizer import bytes_to_unicode

# ---------------------------------------------------------------------------
# Byte classes
# ---------------------------------------------------------------------------

CLS_LBRACE, CLS_RBRACE, CLS_LBRACK, CLS_RBRACK = 0, 1, 2, 3
CLS_QUOTE, CLS_BACKSLASH, CLS_COLON, CLS_COMMA = 4, 5, 6, 7
CLS_WS, CLS_ZERO, CLS_DIG19, CLS_MINUS, CLS_PLUS = 8, 9, 10, 11, 12
CLS_DOT, CLS_EXP, CLS_LIT, CLS_OTHER, CLS_CTRL = 13, 14, 15, 16, 17
# \t \n \r: legal BETWEEN JSON tokens, ILLEGAL unescaped inside strings
# (json.loads strict mode) — so they get their own class, distinct from
# space (CLS_WS) which is legal in both positions.
CLS_WSCTL = 18
N_CLS = 19

_LIT_CHARS = set(b"trufalsn")  # chars of true/false/null (minus e/E)


def byte_class(b: int) -> int:
    if b == 0x7B:
        return CLS_LBRACE
    if b == 0x7D:
        return CLS_RBRACE
    if b == 0x5B:
        return CLS_LBRACK
    if b == 0x5D:
        return CLS_RBRACK
    if b == 0x22:
        return CLS_QUOTE
    if b == 0x5C:
        return CLS_BACKSLASH
    if b == 0x3A:
        return CLS_COLON
    if b == 0x2C:
        return CLS_COMMA
    if b == 0x20:
        return CLS_WS
    if b in (0x09, 0x0A, 0x0D):
        return CLS_WSCTL
    if b == 0x30:
        return CLS_ZERO
    if 0x31 <= b <= 0x39:
        return CLS_DIG19
    if b == 0x2D:
        return CLS_MINUS
    if b == 0x2B:
        return CLS_PLUS
    if b == 0x2E:
        return CLS_DOT
    if b in (0x45, 0x65):  # E e
        return CLS_EXP
    if b in _LIT_CHARS:
        return CLS_LIT
    if b < 0x20:
        return CLS_CTRL
    return CLS_OTHER


# ---------------------------------------------------------------------------
# Byte-level JSON DFA (bounded depth)
# ---------------------------------------------------------------------------

# modes
M_VAL = 0          # expecting a value
M_OBJ_FIRST = 1    # after '{': key-quote or '}'
M_OBJ_KEYQ = 2     # after ',' in object: key-quote required
M_KEY = 3          # inside key string
M_KEY_ESC = 4
M_COLON = 5        # expecting ':'
M_STR = 6          # inside string value
M_STR_ESC = 7
M_NUM = 8          # inside a number; aux = N_* sub-mode below
M_AFTER = 9        # after a complete value: ',' or matching close
M_LIT = 10         # inside a literal; literal progress tracked separately
M_KEY_HEX = 11     # inside \uXXXX in a key; aux = hex digits remaining
M_STR_HEX = 12     # inside \uXXXX in a string value

# number sub-modes (JSON: -?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?)
N_SIGN, N_ZERO, N_INT, N_FRAC0, N_FRAC, N_EXP0, N_EXP1, N_EXP = range(8)

_LITERALS = (b"true", b"false", b"null")

# every class that is plain content inside a string (everything except
# quote, backslash and control bytes)
_STRING_CONTENT_CLASSES = (
    CLS_LBRACE, CLS_RBRACE, CLS_LBRACK, CLS_RBRACK, CLS_COLON, CLS_COMMA,
    CLS_WS, CLS_ZERO, CLS_DIG19, CLS_MINUS, CLS_PLUS, CLS_DOT, CLS_EXP,
    CLS_LIT, CLS_OTHER,
)

_VALID_ESCAPES = frozenset(b'"\\/bfnrt')  # \u handled via the HEX states


class _DfaBuilder:
    """Explicit-state construction over (stack, mode, lit-progress)."""

    def __init__(self, max_depth: int = 6, root: str = "value"):
        self.max_depth = max_depth
        self.root = root
        self.states: Dict[tuple, int] = {}
        self.trans: List[np.ndarray] = []  # per state: int32[N_CLS]
        # special ids assigned first for stable numbering
        self.FREE = self._state(("FREE",))
        self.ACCEPT = self._state(("ACCEPT",))
        # root="object": the top-level value must be a JSON object — kills
        # degenerate bare-literal outputs (` true`) for API call types
        # whose consumers expect an object.
        self.start = self._state(((), M_VAL, 2 if root == "object" else 0))
        self._build()

    def _state(self, key: tuple) -> int:
        sid = self.states.get(key)
        if sid is None:
            sid = self.states[key] = len(self.trans)
            self.trans.append(np.full(N_CLS, -1, dtype=np.int32))
        return sid

    def _build(self):
        # FREE: everything loops to FREE (row replaced at token level too)
        self.trans[self.FREE][:] = self.FREE
        # ACCEPT: nothing allowed at byte level (EOS handled at token level);
        # allow trailing whitespace.
        self.trans[self.ACCEPT][CLS_WS] = self.ACCEPT

        # breadth-first over reachable (stack, mode, aux) states.  Helpers
        # like _wire_after create states without queueing them, so sweep
        # until every created state has been processed.
        pending = [((), M_VAL, 0)]
        seen = set()
        while True:
            if not pending:
                unseen = [k for k in self.states
                          if k not in seen and k[0] not in ("FREE", "ACCEPT")]
                if not unseen:
                    break
                pending.extend(unseen)
            key = pending.pop()
            if key in seen or key[0] == "FREE" or key[0] == "ACCEPT":
                continue
            seen.add(key)
            stack, mode, aux = key
            row = self.trans[self._state(key)]

            def go(cls, nkey):
                if nkey in (("FREE",), ("ACCEPT",)):
                    row[cls] = self._state(nkey)
                    return
                row[cls] = self._state(nkey)
                if nkey not in seen:
                    pending.append(nkey)

            def after_key(st):
                """State after a complete value with stack ``st``."""
                return ("ACCEPT",) if not st else (st, M_AFTER, 0)

            if mode == M_VAL:
                go(CLS_WS, (stack, M_VAL, aux))
                if aux == 2:  # object-root start: '{' (or ws) only
                    go(CLS_LBRACE, (stack + ("O",), M_OBJ_FIRST, 0))
                    continue
                if len(stack) < self.max_depth:
                    go(CLS_LBRACE, (stack + ("O",), M_OBJ_FIRST, 0))
                    go(CLS_LBRACK, (stack + ("A",), M_VAL, 1))
                go(CLS_QUOTE, (stack, M_STR, 0))
                go(CLS_ZERO, (stack, M_NUM, N_ZERO))
                go(CLS_DIG19, (stack, M_NUM, N_INT))
                go(CLS_MINUS, (stack, M_NUM, N_SIGN))
                # literals: aux encodes (lit_index, pos) packed later;
                # entering a literal requires matching first byte — handled
                # in the byte walker below via per-literal states
                for li, lit in enumerate(_LITERALS):
                    go_lit = (stack, M_LIT, (li, 1))
                    # first byte of the literal is a CLS_LIT byte; byte-level
                    # resolution happens in walk_byte (class alone is too
                    # coarse) — store the entry states for the walker.
                    self._state(go_lit)
                    if go_lit not in seen:
                        pending.append(go_lit)
                if aux == 1:  # directly after '[': allow immediate ']'
                    inner = stack[:-1]
                    go(CLS_RBRACK, after_key(inner))

            elif mode == M_OBJ_FIRST or mode == M_OBJ_KEYQ:
                go(CLS_WS, key)
                go(CLS_QUOTE, (stack, M_KEY, 0))
                if mode == M_OBJ_FIRST:
                    inner = stack[:-1]
                    go(CLS_RBRACE, after_key(inner))

            elif mode == M_KEY:
                nkey = (stack, M_KEY, 0)
                for cls in _STRING_CONTENT_CLASSES:
                    row[cls] = self._state(nkey)
                go(CLS_BACKSLASH, (stack, M_KEY_ESC, 0))
                go(CLS_QUOTE, (stack, M_COLON, 0))

            elif mode == M_KEY_ESC:
                # escapes are byte-exact (" \ / b f n r t u) — resolved in
                # walk_byte; the row stores the continuation under CLS_QUOTE
                nkey = (stack, M_KEY, 0)
                row[CLS_QUOTE] = self._state(nkey)
                if nkey not in seen:
                    pending.append(nkey)
                for n in (4, 3, 2, 1):  # materialize \uXXXX hex states
                    self._state((stack, M_KEY_HEX, n))

            elif mode == M_COLON:
                go(CLS_WS, key)
                go(CLS_COLON, (stack, M_VAL, 0))

            elif mode == M_STR:
                nkey = (stack, M_STR, 0)
                for cls in _STRING_CONTENT_CLASSES:
                    row[cls] = self._state(nkey)
                go(CLS_BACKSLASH, (stack, M_STR_ESC, 0))
                go(CLS_QUOTE, after_key(stack))

            elif mode == M_STR_ESC:
                nkey = (stack, M_STR, 0)
                row[CLS_QUOTE] = self._state(nkey)
                if nkey not in seen:
                    pending.append(nkey)
                for n in (4, 3, 2, 1):  # materialize \uXXXX hex states
                    self._state((stack, M_STR_HEX, n))

            elif mode == M_NUM:
                sub = aux
                complete = sub in (N_ZERO, N_INT, N_FRAC, N_EXP)
                if sub == N_SIGN:
                    go(CLS_ZERO, (stack, M_NUM, N_ZERO))
                    go(CLS_DIG19, (stack, M_NUM, N_INT))
                elif sub == N_ZERO:
                    go(CLS_DOT, (stack, M_NUM, N_FRAC0))
                    go(CLS_EXP, (stack, M_NUM, N_EXP0))
                elif sub == N_INT:
                    go(CLS_ZERO, (stack, M_NUM, N_INT))
                    go(CLS_DIG19, (stack, M_NUM, N_INT))
                    go(CLS_DOT, (stack, M_NUM, N_FRAC0))
                    go(CLS_EXP, (stack, M_NUM, N_EXP0))
                elif sub == N_FRAC0:
                    go(CLS_ZERO, (stack, M_NUM, N_FRAC))
                    go(CLS_DIG19, (stack, M_NUM, N_FRAC))
                elif sub == N_FRAC:
                    go(CLS_ZERO, (stack, M_NUM, N_FRAC))
                    go(CLS_DIG19, (stack, M_NUM, N_FRAC))
                    go(CLS_EXP, (stack, M_NUM, N_EXP0))
                elif sub == N_EXP0:
                    go(CLS_PLUS, (stack, M_NUM, N_EXP1))
                    go(CLS_MINUS, (stack, M_NUM, N_EXP1))
                    go(CLS_ZERO, (stack, M_NUM, N_EXP))
                    go(CLS_DIG19, (stack, M_NUM, N_EXP))
                elif sub == N_EXP1:
                    go(CLS_ZERO, (stack, M_NUM, N_EXP))
                    go(CLS_DIG19, (stack, M_NUM, N_EXP))
                elif sub == N_EXP:
                    go(CLS_ZERO, (stack, M_NUM, N_EXP))
                    go(CLS_DIG19, (stack, M_NUM, N_EXP))
                if complete:
                    # terminators behave as if we were in M_AFTER
                    self._wire_after(row, stack, as_number=True)

            elif mode == M_AFTER:
                go(CLS_WS, key)
                self._wire_after(row, stack, as_number=False)

            elif mode == M_LIT:
                li, pos = aux
                lit = _LITERALS[li]
                if pos < len(lit):
                    # exact byte matching is resolved in walk_byte; the
                    # class row only records that a literal byte advances
                    nkey = ((stack, M_LIT, (li, pos + 1))
                            if pos + 1 < len(lit)
                            else after_key(stack))
                    row[CLS_LIT] = self._state(nkey)
                    if isinstance(nkey, tuple) and nkey[0] != "ACCEPT" and \
                            nkey not in seen:
                        pending.append(nkey)

        # post-pass: \t \n \r follow the same transitions as space in
        # every STRUCTURAL state; inside strings/keys they stay forbidden
        # (json.loads strict mode rejects unescaped control chars there)
        for key, sid in self.states.items():
            if key[0] in ("FREE", "ACCEPT"):
                self.trans[sid][CLS_WSCTL] = self.trans[sid][CLS_WS]
                continue
            if key[1] in (M_STR, M_KEY):
                continue
            self.trans[sid][CLS_WSCTL] = self.trans[sid][CLS_WS]

    def _wire_after(self, row, stack, *, as_number: bool):
        """Fill ',' and close-bracket transitions for a complete value."""
        if not stack:
            if as_number:
                row[CLS_WS] = self.ACCEPT
            return
        top, inner = stack[-1], stack[:-1]
        after_inner = self.ACCEPT if not inner else \
            self._state((inner, M_AFTER, 0))
        if as_number:
            row[CLS_WS] = self._state((stack, M_AFTER, 0))
        if top == "O":
            row[CLS_COMMA] = self._state((stack, M_OBJ_KEYQ, 0))
            row[CLS_RBRACE] = after_inner
        else:
            row[CLS_COMMA] = self._state((stack, M_VAL, 0))
            row[CLS_RBRACK] = after_inner

    def eos_ok_states(self) -> List[int]:
        """States where EOS may terminate: ACCEPT plus complete top-level
        numbers (a bare ``0`` has no closing delimiter to reach ACCEPT)."""
        out = [self.ACCEPT]
        for key, sid in self.states.items():
            if key[0] in ("FREE", "ACCEPT"):
                continue
            stack, mode, aux = key
            if not stack and mode == M_NUM and aux in (
                N_ZERO, N_INT, N_FRAC, N_EXP
            ):
                out.append(sid)
        return out

    # -- byte-exact walking (resolves literal bytes) ----------------------
    def walk_byte(self, sid: int, b: int) -> int:
        rev = getattr(self, "_rev", None)
        if rev is None or len(rev) != len(self.states):
            rev = self._rev = {v: k for k, v in self.states.items()}
        key = rev.get(sid)
        # escape states need byte-exact matching (" \ / b f n r t u)
        if key and key[0] not in ("FREE", "ACCEPT") and \
                key[1] in (M_KEY_ESC, M_STR_ESC):
            if b == 0x75:  # 'u' -> four hex digits
                hex_mode = M_KEY_HEX if key[1] == M_KEY_ESC else M_STR_HEX
                return self.states[(key[0], hex_mode, 4)]
            if b in _VALID_ESCAPES:
                return int(self.trans[sid][CLS_QUOTE])
            return -1
        # \uXXXX hex digits are byte-exact too
        if key and key[0] not in ("FREE", "ACCEPT") and \
                key[1] in (M_KEY_HEX, M_STR_HEX):
            if not (0x30 <= b <= 0x39 or 0x41 <= b <= 0x46
                    or 0x61 <= b <= 0x66):
                return -1
            stack, mode, remaining = key
            if remaining > 1:
                return self.states[(stack, mode, remaining - 1)]
            back = M_KEY if mode == M_KEY_HEX else M_STR
            return self.states[(stack, back, 0)]
        # literal states need byte-exact matching
        if key and key[0] not in ("FREE", "ACCEPT") and key[1] == M_LIT:
            li, pos = key[2]
            lit = _LITERALS[li]
            if pos < len(lit) and b == lit[pos]:
                return self.trans[sid][CLS_LIT]
            return -1
        if key and key[0] not in ("FREE", "ACCEPT") and key[1] == M_VAL \
                and key[2] != 2:
            cls = byte_class(b)
            if cls == CLS_LIT:
                stack = key[0]
                for li, lit in enumerate(_LITERALS):
                    if b == lit[0]:
                        if len(lit) > 1:
                            return self.states[(stack, M_LIT, (li, 1))]
                        return self.ACCEPT if not stack else \
                            self.states[(stack, M_AFTER, 0)]
                return -1
        cls = byte_class(b)
        return int(self.trans[sid][cls])


# ---------------------------------------------------------------------------
# GPT-2 byte <-> unicode map (ByteLevel tokenizers store tokens this way)
# ---------------------------------------------------------------------------

_U2B: Optional[Dict[str, int]] = None


def token_bytes(token_str: str) -> Optional[bytes]:
    """Raw bytes of a ByteLevel BPE token; None for special tokens."""
    global _U2B
    if _U2B is None:
        _U2B = {v: k for k, v in bytes_to_unicode().items()}
    out = []
    for ch in token_str:
        b = _U2B.get(ch)
        if b is None:
            return None  # special token like <pad>
        out.append(b)
    return bytes(out)


# ---------------------------------------------------------------------------
# Token-level table
# ---------------------------------------------------------------------------

class JsonTokenDfa:
    """Token-level JSON DFA for one tokenizer.

    Attributes:
      table: np.int32 [n_states, vocab] — next state or -1.
      dist:  np.int32 [n_states] — minimum number of (non-EOS) tokens from
             each state to an EOS-terminable state.  The decode loop masks
             transitions whose ``dist`` exceeds the remaining token budget,
             so a generation that hits ``max_tokens`` still CLOSES all open
             strings/containers and parses — the reference instead repairs
             truncated JSON after the fact (web/server.py:21685-21943).
      start: initial state for a constrained generation.
      FREE:  state 0 — all tokens allowed, self-loop (unconstrained mode);
             ``dist[FREE] == 0`` so unconstrained requests are never masked.
    """

    def __init__(self, table: np.ndarray, start: int, accept: int,
                 dist: Optional[np.ndarray] = None):
        self.table = table
        self.start = start
        self.accept = accept
        self.FREE = 0
        if dist is None:
            dist = self._min_close_dist(table, accept)
        self.dist = dist

    @staticmethod
    def _min_close_dist(table: np.ndarray, accept: int) -> np.ndarray:
        """Per-state shortest path, in sampled tokens, to ACCEPT.

        EOS rides the table like any other token (``build`` wires it from
        EOS-terminable states into ACCEPT), so "close via EOS" is just
        another path and needs no special-casing — sampling EOS consumes
        one budget unit exactly like a content token.  Reverse Bellman
        relaxation; the diameter is tiny (close ``max_depth`` containers
        plus a string/number tail), so this converges in ~a dozen sweeps.
        """
        n_states = table.shape[0]
        INF = np.int32(1 << 20)
        dist = np.full(n_states, INF, dtype=np.int32)
        dist[0] = 0      # FREE: never force-close unconstrained requests
        dist[accept] = 0
        nxt = np.maximum(table, 0)
        valid = table >= 0
        for _ in range(n_states):
            cand = np.where(valid, dist[nxt], INF)
            best = cand.min(axis=1)
            new = np.minimum(dist, np.minimum(best, INF - 1) + 1)
            if np.array_equal(new, dist):
                break
            dist = new
        return dist.astype(np.int32)

    @classmethod
    def build(cls, tokenizer, *, max_depth: int = 6, root: str = "value",
              cache_dir: Optional[str] = None) -> "JsonTokenDfa":
        vocab = tokenizer.vocab_size
        eos = tokenizer.eos_id
        cache_path = None
        if cache_dir:
            # the signature must cover the token-to-bytes CONTENT, not just
            # the vocab size — a retrained tokenizer with an identical
            # vocab count would otherwise silently reuse a stale table
            content = hashlib.md5()
            for tid in range(vocab):
                content.update(
                    (_id_to_token(tokenizer, tid) or "\x00").encode())
            sig = hashlib.md5(
                f"json-dfa-v5:{vocab}:{eos}:{max_depth}:{root}:"
                f"{content.hexdigest()}".encode()
            ).hexdigest()[:12]
            cache_path = os.path.join(cache_dir, f"json_dfa_{sig}.npz")
            if os.path.isfile(cache_path):
                data = np.load(cache_path)
                return cls(data["table"], int(data["start"]),
                           int(data["accept"]), dist=data["dist"])

        builder = _DfaBuilder(max_depth, root=root)
        n_states = len(builder.trans)

        # byte sequences per token
        tok_bytes: List[Optional[bytes]] = []
        for tid in range(vocab):
            s = _id_to_token(tokenizer, tid)
            tok_bytes.append(token_bytes(s) if s is not None else None)

        # key by state: walk every token's bytes.  Vectorized per token
        # over all states at once.
        sid_index = {v: k for k, v in builder.states.items()}
        table = np.full((n_states, vocab), -1, dtype=np.int32)
        # Precompute byte-exact char tables: [n_states, 256]
        byte_table = np.full((n_states, 256), -1, dtype=np.int32)
        for sid in range(n_states):
            for b in range(256):
                byte_table[sid, b] = builder.walk_byte(sid, b)
        _ = sid_index  # (debug aid)

        special_ids = set(getattr(tokenizer, "special_ids", ()) or ())
        states_vec = np.arange(n_states, dtype=np.int32)
        for tid, bts in enumerate(tok_bytes):
            if bts is None or len(bts) == 0 or tid in special_ids:
                continue  # special tokens forbidden under constraint
            cur = states_vec.copy()
            for b in bts:
                valid = cur >= 0
                nxt = np.where(valid, byte_table[np.maximum(cur, 0), b], -1)
                cur = nxt.astype(np.int32)
            table[:, tid] = cur

        # FREE row: everything allowed, self-loop
        table[builder.FREE, :] = builder.FREE
        # EOS terminates exactly at ACCEPT and at complete top-level
        # numbers (which have no closing delimiter to reach ACCEPT)
        col = table[:, eos]
        col[1:][col[1:] >= 0] = -1
        for sid in builder.eos_ok_states():
            table[sid, eos] = builder.ACCEPT

        dfa = cls(table, builder.start, builder.ACCEPT)
        if cache_path:
            os.makedirs(cache_dir, exist_ok=True)
            np.savez_compressed(cache_path, table=table, start=builder.start,
                                accept=builder.ACCEPT, dist=dfa.dist)
        return dfa

    # -- host-side helpers -------------------------------------------------
    def next_state(self, state: int, token: int) -> int:
        return int(self.table[state, token])

    def walk(self, tokens, state: Optional[int] = None) -> int:
        s = self.start if state is None else state
        for t in tokens:
            if s < 0:
                return s
            s = int(self.table[s, int(t)])
        return s


def _id_to_token(tokenizer, tid: int) -> Optional[str]:
    return tokenizer.id_to_token(tid)
