"""Radix-tree prefix cache: share fully written KV pages across requests.

The interview flow resends a mostly stable prompt head on every call
(role, topic, documents, early history), and a report re-draft reuses the
evidence head.  The cache keeps those heads' KV pages on the device in a
token-content radix tree at page granularity, so a request whose prompt
starts with a cached chain skips straight to the first page it does not
share (a prefix-cache resume through chunked prefill).  A head shared by
several sessions is stored once.

Invariants:

* only FULL pages are ever shared, and never the whole prompt (the last
  token must run again to give logits).  The partial tail page is written
  by the request's own prefill and decode writes only past the prompt, so
  a shared page is never written;
* edges are multiples of ``page_size`` tokens and children are keyed by
  their edge's first full page of tokens, so chains that diverge inside a
  page are siblings and every node's pages match its tokens exactly;
* pages are refcounted in the allocator: the tree holds one reference per
  cached page and every active sequence holds its own.

``prefix_key`` gates participation (``None`` bypasses the cache, for a
deterministic replay); matching is by token content alone.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence, Tuple

from deepvision_tpu_torch.engine.kv_cache import PageAllocator


def _common_prefix_len(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class _Node:
    __slots__ = ("tokens", "pages", "children", "parent", "last_used")

    def __init__(self, tokens: tuple, pages: List[int],
                 parent: Optional["_Node"]):
        self.tokens = tokens          # edge label; a multiple of page_size
        self.pages = pages            # len == len(tokens) // page_size
        # first full page of the child's edge (a tuple) -> _Node
        self.children: dict = {}
        self.parent = parent
        self.last_used = time.monotonic()

    def key(self, page_size: int) -> tuple:
        return self.tokens[:page_size]


class PrefixCache:
    def __init__(self, allocator: PageAllocator, page_size: int,
                 max_pages: Optional[int] = None):
        self.alloc = allocator
        self.page_size = page_size
        # a cold cache must never crowd out live sequences: by default it
        # holds at most half the pool
        self.max_pages = (max_pages if max_pages is not None
                          else max(1, allocator.num_pages // 2))
        self._lock = threading.Lock()
        self._root = _Node((), [], None)
        self._cached_pages = 0
        self._nodes = 0
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0

    # ------------------------------------------------------------------
    # Lookup
    # ------------------------------------------------------------------

    def lookup(self, key: Optional[str],
               prompt_tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Returns ``(n_shared_tokens, shared_pages)`` and takes a reference
        on the returned pages.  ``n_shared_tokens`` is page-aligned and
        strictly less than ``len(prompt_tokens)``."""
        if not key:
            return 0, []
        ps = self.page_size
        # the most that may be shared, page-aligned, leaving >= 1 token
        limit = ((len(prompt_tokens) - 1) // ps) * ps
        if limit <= 0:
            self.misses += 1
            return 0, []
        with self._lock:
            node = self._root
            matched = 0
            shared: List[int] = []
            now = time.monotonic()
            while matched < limit:
                child = node.children.get(
                    tuple(prompt_tokens[matched:matched + ps]))
                if child is None:
                    break
                m = _common_prefix_len(child.tokens,
                                       prompt_tokens[matched:limit])
                full = (m // ps) * ps
                if full > 0:
                    shared.extend(child.pages[: full // ps])
                    child.last_used = now
                if full < len(child.tokens):
                    break
                matched += full
                node = child
            if not shared:
                self.misses += 1
                return 0, []
            self.alloc.share(shared)
            n = len(shared) * ps
            self.hits += 1
            self.tokens_saved += n
            return n, list(shared)

    # ------------------------------------------------------------------
    # Store
    # ------------------------------------------------------------------

    def store(self, key: Optional[str], prompt_tokens: Sequence[int],
              pages: Sequence[int]) -> None:
        """Insert the prompt's full pages into the tree.  The tree takes
        its own reference on pages it adopts; a chain already cached keeps
        its pages, so identical heads are stored once."""
        if not key:
            return
        ps = self.page_size
        n_full = len(prompt_tokens) // ps
        if n_full <= 0:
            return
        tokens = tuple(prompt_tokens[: n_full * ps])
        pages = list(pages[:n_full])
        with self._lock:
            node = self._root
            i = 0
            now = time.monotonic()
            while i < len(tokens):
                child = node.children.get(tuple(tokens[i:i + ps]))
                if child is None:
                    # no edge shares the next page: the remainder becomes
                    # a new leaf
                    new_pages = pages[i // ps:]
                    self.alloc.share(new_pages)
                    leaf = _Node(tokens[i:], new_pages, node)
                    node.children[leaf.key(ps)] = leaf
                    self._cached_pages += len(new_pages)
                    self._nodes += 1
                    break
                m = _common_prefix_len(child.tokens, tokens[i:])
                full = (m // ps) * ps
                child.last_used = now
                if full == len(child.tokens):
                    i += full
                    node = child
                    continue
                # the shared head ends inside this edge: split it at the
                # page boundary `full` (>= ps, since the child was found
                # by its first page)
                upper = _Node(child.tokens[:full],
                              child.pages[: full // ps], node)
                upper.last_used = now
                child.tokens = child.tokens[full:]
                child.pages = child.pages[full // ps:]
                child.parent = upper
                upper.children[child.key(ps)] = child
                node.children[upper.key(ps)] = upper
                self._nodes += 1
                i += full
                node = upper
            self._enforce_cap_locked()

    # ------------------------------------------------------------------
    # Eviction
    # ------------------------------------------------------------------

    def _leaves(self) -> List[_Node]:
        out = []
        stack = [self._root]
        while stack:
            n = stack.pop()
            kids = list(n.children.values())
            if not kids and n is not self._root:
                out.append(n)
            stack.extend(kids)
        return out

    def _drop_leaf_locked(self, leaf: _Node) -> int:
        self.alloc.free(leaf.pages)
        released = len(leaf.pages)
        self._cached_pages -= released
        self._nodes -= 1
        parent = leaf.parent
        if parent is not None:
            parent.children.pop(leaf.key(self.page_size), None)
        return released

    def _evict_lru_locked(self, n_pages: int) -> int:
        released = 0
        while released < n_pages:
            leaves = self._leaves()
            if not leaves:
                break
            leaf = min(leaves, key=lambda n: n.last_used)
            released += self._drop_leaf_locked(leaf)
        return released

    def _enforce_cap_locked(self) -> None:
        if self._cached_pages > self.max_pages:
            self._evict_lru_locked(self._cached_pages - self.max_pages)

    def evict_lru(self, n_pages: int) -> int:
        """Drop least recently used leaf chains until about ``n_pages``
        cache-held pages are released (live requests outrank cold cache
        entries).  Returns the number of pages released."""
        with self._lock:
            return self._evict_lru_locked(n_pages)

    def clear(self) -> None:
        with self._lock:
            stack = [self._root]
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if n is not self._root:
                    self.alloc.free(n.pages)
            self._root = _Node((), [], None)
            self._cached_pages = 0
            self._nodes = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": self._nodes,
                "pages": self._cached_pages,
                "hits": self.hits,
                "misses": self.misses,
                "tokens_saved": self.tokens_saved,
            }
