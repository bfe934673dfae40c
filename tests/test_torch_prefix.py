"""The port's prefix cache, refcounting allocator, chunked runner and
chunked-prefill engine against the JAX package.

The unit tests of ``PrefixCache`` and ``PageAllocator`` follow the JAX
package's ``tests/test_prefix_cache.py``; a randomized oracle test drives
the JAX and the port caches through one op sequence.  The runner and
engine tests hold chunked prefill against batched prefill and against the
JAX engine (Pallas kernels in interpret mode) on dv-tiny-test, on the CPU.
"""

import random

import numpy as np
import pytest
import torch

from deepvision_tpu.engine.config import TINY_TEST
from deepvision_tpu.engine.kv_cache import PageAllocator as JPageAllocator
from deepvision_tpu.engine.prefix_cache import PrefixCache as JPrefixCache
from deepvision_tpu_torch.engine import kv_cache as tkv
from deepvision_tpu_torch.engine import model as tmodel
from deepvision_tpu_torch.engine import weights as tweights
from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine
from deepvision_tpu_torch.engine.kv_cache import PageAllocator
from deepvision_tpu_torch.engine.prefix_cache import PrefixCache
from deepvision_tpu_torch.engine.runner import ModelRunner

torch.set_num_threads(2)

TINY = dict(model="dv-tiny-test", tokenizer="byte", max_slots=2,
            num_pages=96, page_size=16, max_pages_per_seq=16, seed=0)


# -- refcounting allocator ------------------------------------------------------

def test_allocator_refcounts_shared_pages():
    alloc = PageAllocator(8)
    pages = alloc.alloc(3)
    assert alloc.available() == 4
    alloc.share(pages[:2])
    alloc.free(pages)               # the request's references
    assert alloc.available() == 5   # only the unshared page came back
    alloc.free(pages[:2])           # the sharer's references
    assert alloc.available() == 7
    with pytest.raises(MemoryError):
        alloc.alloc(8)
    assert alloc.try_alloc(8) is None
    alloc.free([0])                 # the trash page is never freed
    assert alloc.available() == 7 and alloc.num_pages == 8


# -- PrefixCache (the JAX package's unit tests, on the port) -----------------

def test_prefix_cache_refcounting():
    alloc = PageAllocator(num_pages=32)
    cache = PrefixCache(alloc, page_size=4)
    tokens = list(range(10))  # 2 full pages + partial
    pages = alloc.alloc(3)
    avail_after_alloc = alloc.available()
    cache.store("k", tokens, pages)
    # the cache holds its own references on the 2 full pages: freeing the
    # request's must not return them to the free list
    alloc.free(pages)
    assert alloc.available() == avail_after_alloc + 1
    n, shared = cache.lookup("k", tokens + [99])
    assert n == 8 and len(shared) == 2
    cache.clear()
    alloc.free(shared)
    assert alloc.available() == 31


def test_prefix_lookup_respects_divergence():
    alloc = PageAllocator(num_pages=32)
    cache = PrefixCache(alloc, page_size=4)
    pages = alloc.alloc(3)
    cache.store("k", [1, 2, 3, 4, 5, 6, 7, 8, 9], pages)
    n, shared = cache.lookup("k", [1, 2, 99, 4, 5, 6, 7, 8])
    assert n == 0 and shared == []
    n, shared = cache.lookup("k", [1, 2, 3, 4, 5, 6, 99, 8])
    assert n == 4 and len(shared) == 1
    alloc.free(shared)


def test_prefix_never_shares_whole_prompt():
    alloc = PageAllocator(num_pages=32)
    cache = PrefixCache(alloc, page_size=4)
    tokens = [1, 2, 3, 4, 5, 6, 7, 8]
    cache.store("k", tokens, alloc.alloc(2))
    n, shared = cache.lookup("k", tokens)
    assert n == 4  # not 8: the last token must run again
    alloc.free(shared)


def test_radix_cross_key_sharing():
    alloc = PageAllocator(num_pages=64)
    cache = PrefixCache(alloc, page_size=4)
    head = [7, 7, 7, 7, 8, 8, 8, 8]
    pages_a = alloc.alloc(3)
    cache.store("sess-a", head + [1, 2, 3], pages_a)
    n, shared = cache.lookup("sess-b", head + [9, 9, 9, 9, 5])
    assert n == 8 and shared == pages_a[:2]
    alloc.free(shared)


def test_radix_edge_split_and_dedupe():
    alloc = PageAllocator(num_pages=64)
    cache = PrefixCache(alloc, page_size=2)
    a = [1, 2, 3, 4, 5, 6]
    pa = alloc.alloc(3)
    cache.store("k1", a, pa)
    pages_before = cache.stats()["pages"]
    pb = alloc.alloc(3)
    cache.store("k2", a, pb)             # the same chain: stored once
    assert cache.stats()["pages"] == pages_before
    alloc.free(pb)
    pc = alloc.alloc(3)
    cache.store("k3", [1, 2, 3, 4, 9, 9], pc)   # splits the edge at 4
    n, shared = cache.lookup("k4", [1, 2, 3, 4, 9, 9, 0])
    assert n == 6 and shared[:2] == pa[:2] and shared[2] == pc[2]
    alloc.free(shared)
    alloc.free(pc)
    alloc.free(pa)


def test_radix_page_cap_evicts_lru():
    alloc = PageAllocator(num_pages=64)
    cache = PrefixCache(alloc, page_size=2, max_pages=4)
    p1 = alloc.alloc(3)
    cache.store("k1", [1, 1, 1, 1, 1, 1], p1)
    p2 = alloc.alloc(3)
    cache.store("k2", [2, 2, 2, 2, 2, 2], p2)
    assert cache.stats()["pages"] <= 4
    alloc.free(p1)
    alloc.free(p2)
    cache.clear()
    assert alloc.available() == 63
    assert PrefixCache(PageAllocator(64), 2).max_pages == 32  # half the pool


def test_evict_lru_releases_the_oldest_chain():
    alloc = PageAllocator(num_pages=32)
    cache = PrefixCache(alloc, page_size=2)
    p1, p2 = alloc.alloc(2), alloc.alloc(2)
    cache.store("a", [1, 1, 1, 1], p1)
    cache.store("b", [2, 2, 2, 2], p2)
    alloc.free(p1)
    alloc.free(p2)
    cache.lookup("a", [1, 1, 1, 1, 5])      # "a" is now the newer chain
    alloc.free(p1)                          # drop the lookup's references
    assert cache.evict_lru(1) == 2          # the whole "b" leaf goes
    assert cache.lookup("b", [2, 2, 2, 2, 5]) == (0, [])
    assert cache.stats()["entries"] == 1 and alloc.available() == 29


def test_mid_page_divergence_chains_coexist():
    alloc = PageAllocator(num_pages=128)
    cache = PrefixCache(alloc, page_size=4)
    chains = []
    for i in range(8):
        chain = [1, 100 + i, 2, 3, 4, 5, 6, 7, 8]
        pages = alloc.alloc(2)
        cache.store(f"sess-{i}", chain, pages)
        chains.append((chain, pages))
    assert cache.stats()["entries"] == 8
    for i, (chain, _) in enumerate(chains):
        n, shared = cache.lookup(f"sess-{i}", chain)
        assert n == 8, (i, n)
        alloc.free(shared)
    assert cache.stats()["hits"] == 8
    for _, pages in chains:
        alloc.free(pages)


def test_prefix_key_none_bypasses():
    alloc = PageAllocator(num_pages=16)
    cache = PrefixCache(alloc, page_size=2)
    p = alloc.alloc(2)
    cache.store(None, [1, 2, 3, 4], p)
    assert cache.stats()["pages"] == 0
    assert cache.lookup(None, [1, 2, 3, 4, 5]) == (0, [])
    alloc.free(p)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_cache_oracle_against_jax(seed):
    """Random store / lookup / free / evict / clear sequences, applied to
    the JAX and the port cache (each over its own allocator): every result,
    every stats() and the free-page count must be identical."""
    rnd = random.Random(seed)
    ps, num_pages = 4, 48
    ja, ta = JPageAllocator(num_pages), PageAllocator(num_pages)
    jc = JPrefixCache(ja, ps, max_pages=16)
    tc = PrefixCache(ta, ps, max_pages=16)
    heads = [[rnd.randrange(1, 5) for _ in range(rnd.choice([4, 6, 9]))]
             for _ in range(4)]
    held = []   # pages a "request" still holds, one list per request
    for _ in range(300):
        op = rnd.random()
        tokens = (rnd.choice(heads)
                  + [rnd.randrange(1, 5) for _ in range(rnd.randrange(0, 14))])
        key = rnd.choice(["s1", "s2", None])
        if op < 0.35:
            need = -(-len(tokens) // ps)
            got = (ja.try_alloc(need), ta.try_alloc(need))
            assert got[0] == got[1]
            if got[0] is None:
                assert jc.evict_lru(need) == tc.evict_lru(need)
                continue
            jc.store(key, tokens, got[0])
            tc.store(key, tokens, got[1])
            held.append(got[0])
        elif op < 0.7:
            res = (jc.lookup(key, tokens), tc.lookup(key, tokens))
            assert res[0] == res[1]
            held.append(res[0][1])
        elif op < 0.9 and held:
            pages = held.pop(rnd.randrange(len(held)))
            ja.free(pages)
            ta.free(pages)
        elif op < 0.97:
            n = rnd.randrange(1, 6)
            assert jc.evict_lru(n) == tc.evict_lru(n)
        else:
            jc.clear()
            tc.clear()
        assert jc.stats() == tc.stats()
        assert ja.available() == ta.available()
    for pages in held:
        ja.free(pages)
        ta.free(pages)
    jc.clear()
    tc.clear()
    assert ja.available() == ta.available() == num_pages - 1


# -- chunked runner ---------------------------------------------------------------

CACHE = tkv.CacheConfig(num_pages=64, page_size=16, max_pages_per_seq=8)


@pytest.fixture(scope="module")
def tiny_params():
    """dv-tiny-test params of the JAX package, as JAX and as torch."""
    from deepvision_tpu.engine.weights import init_params

    jp = init_params(TINY_TEST, seed=0)
    tp = tweights.from_numpy_params(
        {k: (np.asarray(v) if not isinstance(v, dict)
             else {kk: np.asarray(vv) for kk, vv in v.items()})
         for k, v in jp.items()}, device="cpu")
    return jp, tp


def _drive(runner, alloc, prompt, n_decode=4):
    """Prefill ``prompt`` then greedy-decode ``n_decode`` tokens in slot 0
    (the loop of the JAX package's test_chunked_prefill.py)."""
    pages = alloc.alloc(6)
    first = runner.prefill(prompt, pages, temperature=0.0)
    seq = list(prompt) + [first]
    bt = np.zeros((2, CACHE.max_pages_per_seq), np.int32)
    bt[0, : len(pages)] = pages
    toks, lens = np.zeros(2, np.int32), np.ones(2, np.int32)
    out = [first]
    for _ in range(n_decode):
        toks[0], lens[0] = seq[-1], len(seq)
        nt = runner.decode(toks, lens, bt, np.zeros(2, np.float32),
                           np.zeros(2, np.int32), np.ones(2, np.float32))[0]
        seq.append(int(nt[0]))
        out.append(int(nt[0]))
    return out


def _torch_run(tp, chunked, prompt):
    runner = ModelRunner(TINY_TEST, CACHE, tp, device="cpu", max_slots=2,
                         chunked_prefill=chunked, prefill_chunk_size=8)
    return _drive(runner, PageAllocator(CACHE.num_pages), prompt)


@pytest.mark.parametrize("n,seed", [(23, 0), (5, 1), (16, 2)])
def test_chunked_runner_equals_batched_and_jax(tiny_params, n, seed):
    """The cases of test_chunked_prefill.py: 2 full chunks of 8 + a partial
    one, a single partial chunk, an exact chunk boundary.  Greedy tokens of
    the chunked runner equal the batched runner's and the JAX chunked
    runner's (interpret mode)."""
    from deepvision_tpu.engine.kv_cache import CacheConfig as JCacheConfig
    from deepvision_tpu.engine.runner import ModelRunner as JModelRunner

    jp, tp = tiny_params
    prompt = np.random.RandomState(seed).randint(
        1, TINY_TEST.vocab_size, size=n).tolist()
    jrunner = JModelRunner(
        TINY_TEST, JCacheConfig(num_pages=64, page_size=16,
                                max_pages_per_seq=8),
        jp, max_slots=2, interpret=True, chunked_prefill=True,
        prefill_chunk_size=8)
    want = _drive(jrunner, JPageAllocator(CACHE.num_pages), prompt)
    got = _torch_run(tp, True, prompt)
    assert got == _torch_run(tp, False, prompt)
    assert got == want


def test_prefill_chunk_step_defers_the_sync(tiny_params):
    """Intermediate chunks return the token as a device tensor (no host
    read); the last chunk returns an int."""
    _, tp = tiny_params
    runner = ModelRunner(TINY_TEST, CACHE, tp, device="cpu",
                         chunked_prefill=True, prefill_chunk_size=8)
    prompt, pages = list(range(1, 20)), [1, 2]
    mid = runner.prefill_chunk_step(prompt, pages, 0, sync=False)
    assert isinstance(mid, torch.Tensor) and mid.shape == (1,)
    assert isinstance(runner.prefill_chunk_step(prompt, pages, 16), int)
    with pytest.raises(ValueError):
        ModelRunner(TINY_TEST, CACHE, tp, device="cpu").prefill(
            prompt, pages, start_from=16)


def test_resume_never_writes_shared_pages(tiny_params):
    """A request resumed at a page boundary over pages another prompt
    wrote (chunked prefill with a partial, padded last chunk, then decode
    steps) leaves those pages unchanged byte for byte, and its logits
    equal a cold chunked prefill's."""
    _, tp = tiny_params
    cfg, P, C = TINY_TEST, 16, 8
    cache = tkv.init_cache(cfg, CACHE, device="cpu")
    rng = np.random.default_rng(11)
    head = rng.integers(1, cfg.vocab_size, size=2 * P).tolist()
    a = head + rng.integers(1, cfg.vocab_size, size=5).tolist()
    b = head + rng.integers(1, cfg.vocab_size, size=11).tolist()

    def chunks(tokens, bt, start):
        n = len(tokens)
        for s in range(start, n, C):
            chunk = np.zeros((1, C), np.int32)
            chunk[0, : len(tokens[s:s + C])] = tokens[s:s + C]
            logits = tmodel.forward_prefill_chunk(
                tp, cache, torch.from_numpy(chunk),
                torch.tensor([s], dtype=torch.int32),
                torch.tensor([n], dtype=torch.int32), bt, cfg=cfg)
        return logits

    bt_a = torch.tensor([[3, 4, 5, 0, 0, 0, 0, 0]], dtype=torch.int32)
    chunks(a, bt_a, 0)
    shared = [3, 4]
    before = [(k[:, shared].clone(), v[:, shared].clone())
              for k, v in zip(cache["k"], cache["v"])]
    bt_b = torch.tensor([[3, 4, 9, 10, 0, 0, 0, 0]], dtype=torch.int32)
    warm = chunks(b, bt_b, 2 * P)
    tok = torch.tensor([7], dtype=torch.int32)
    for step in range(3):
        tmodel.forward_decode(tp, cache, tok,
                              torch.tensor([len(b) + 1 + step],
                                           dtype=torch.int32),
                              bt_b, cfg=cfg)
    for (k0, v0), k, v in zip(before, cache["k"], cache["v"]):
        assert torch.equal(k[:, shared], k0) and torch.equal(v[:, shared], v0)
    cold = chunks(b, torch.tensor([[20, 21, 22, 23, 0, 0, 0, 0]],
                                  dtype=torch.int32), 0)
    torch.testing.assert_close(warm, cold, atol=0.0, rtol=0.0)


# -- engine ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    from deepvision_tpu.engine.weights import init_params, save_npz

    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    save_npz(path, init_params(TINY_TEST, seed=0))
    return path


def _session(eng, turns):
    """A 3-turn session: every turn resends the growing transcript with
    the session's prefix key; returns each turn's greedy token ids."""
    out = []
    for prompt in turns:
        res = eng.submit_tokens(prompt, max_tokens=6, temperature=0.0,
                                prefix_key="sess-1").wait(300)
        assert res is not None and res.ok, res
        out.append(res.token_ids)
    return out


def _turns():
    rng = np.random.default_rng(12)
    t1 = rng.integers(1, 256, size=40).tolist()
    t2 = t1 + rng.integers(1, 256, size=21).tolist()
    t3 = t2 + rng.integers(1, 256, size=30).tolist()
    return [t1, t2, t3]


def test_engine_session_matches_the_jax_engine(tiny_npz):
    """``chunked_prefill=True`` with a prefix key on the CPU: greedy tokens
    of a 3-turn session, the prefix cache's hits and tokens saved equal the
    JAX engine's (interpret mode), and the warm (resumed) last turn equals
    a cold run with ``prefix_key=None``."""
    from deepvision_tpu.engine.engine import EngineConfig as JEngineConfig
    from deepvision_tpu.engine.engine import LLMEngine as JLLMEngine

    turns = _turns()
    cfg = dict(TINY, checkpoint_dir=tiny_npz, chunked_prefill=True,
               prefill_chunk_size=16)
    jeng = JLLMEngine(JEngineConfig(**cfg, interpret=True))
    try:
        want = _session(jeng, turns)
        want_stats = jeng.stats()["prefix_cache"]
    finally:
        jeng.shutdown()
    eng = LLMEngine(EngineConfig(**cfg, device="cpu", json_dfa=False))
    try:
        got = _session(eng, turns)
        stats = eng.stats()["prefix_cache"]
        cold = eng.submit_tokens(turns[2], max_tokens=6,
                                 temperature=0.0).wait(300)
        text, meta = eng.generate_text("共享的系统提示头部 " * 4, max_tokens=4,
                                       temperature=0.0, timeout=300,
                                       prefix_key="sess-2")
        again, _ = eng.generate_text("共享的系统提示头部 " * 4 + "下一个",
                                     max_tokens=4, temperature=0.0,
                                     timeout=300, prefix_key="sess-2")
        after = eng.stats()["prefix_cache"]
    finally:
        eng.shutdown()
    assert got == want
    assert stats["hits"] == want_stats["hits"] == 2
    assert stats["tokens_saved"] == want_stats["tokens_saved"] > 0
    assert stats == want_stats
    assert cold.token_ids == got[2]
    assert after["hits"] == stats["hits"] + 1   # generate_text's prefix_key
    assert meta["completion_tokens"] > 0


def test_long_prompt_prefill_job_interleaves_with_decode(tiny_npz):
    """A prompt with more fresh tokens than ``interleave_min_tokens``
    becomes a prefill job whose chunks run between K=1 decode steps of a
    request already decoding; both requests' tokens equal a run where the
    long prompt prefills in one batched call."""
    rng = np.random.default_rng(13)
    short = rng.integers(1, 256, size=9).tolist()
    long_ = rng.integers(1, 256, size=70).tolist()

    def run(interleave_min):
        eng = LLMEngine(EngineConfig(**TINY, checkpoint_dir=tiny_npz,
                                     device="cpu", json_dfa=False,
                                     chunked_prefill=True,
                                     prefill_chunk_size=16,
                                     decode_steps_per_call=4))
        eng.scheduler.interleave_min_tokens = interleave_min
        steps = []
        runner_step = eng.runner.prefill_chunk_step

        def counting_step(*a, **kw):
            steps.append(len(eng.scheduler._active))
            return runner_step(*a, **kw)

        eng.runner.prefill_chunk_step = counting_step
        try:
            reqs = [eng.submit_tokens(p, max_tokens=10, temperature=0.0)
                    for p in (short, long_)]
            res = [r.wait(300) for r in reqs]
        finally:
            eng.shutdown()
        assert all(r is not None and r.ok for r in res)
        return [r.token_ids for r in res], steps

    want, steps_plain = run(4096)
    got, steps_job = run(20)
    assert steps_plain == []                     # batched prefill only
    assert len(steps_job) == 5                   # ceil(70 / 16) chunks
    assert any(active > 0 for active in steps_job)   # decode interleaved
    assert got == want
