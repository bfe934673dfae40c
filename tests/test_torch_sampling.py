"""The port's sampler against the JAX package's.

Greedy (temperature 0) must agree exactly, token and next grammar state,
for every budget shape of the force-close mask.  Temperature > 0 draws come
from different random streams in the two packages, so they are checked by
properties only: the sample is an allowed token among the top-k.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine.config import TINY_TEST
from deepvision_tpu.engine.kv_cache import CacheConfig as JCacheConfig
from deepvision_tpu.engine.runner import ModelRunner as JModelRunner
from deepvision_tpu.engine.sampling import (
    sample_tokens_constrained as jsample_constrained,
)
from deepvision_tpu.engine.weights import init_params as jinit_params
from deepvision_tpu_torch.engine.kv_cache import CacheConfig
from deepvision_tpu_torch.engine.runner import ModelRunner
from deepvision_tpu_torch.engine.sampling import (
    pack_dfa_table,
    sample_tokens,
    sample_tokens_constrained,
)

torch.set_num_threads(2)

S, V, B = 9, 640, 8
BUDGET_ROWS = ([1, 2, 3, 4, 5, 6, 7, 1 << 20], [1 << 20] * 8, [2] * 8)


def _grammar(seed=7):
    rng = np.random.default_rng(seed)
    table = rng.integers(-1, S, size=(S, V)).astype(np.int32)
    table[0, :] = 0  # FREE row: all allowed
    dist = rng.integers(0, 6, size=S).astype(np.int32)
    dist[3] = 1 << 20  # INF sentinel (a state that cannot reach ACCEPT)
    dist[0] = 0
    logits = rng.normal(size=(B, V)).astype(np.float32)
    return table, dist, logits


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("budget_row", BUDGET_ROWS)
def test_greedy_constrained_matches_jax_exactly(budget_row):
    """T=0, packed table: the same tokens and next states as the JAX
    sampler's packed AND unpacked forms (the JAX test pins those two
    against each other; this pins the port against both)."""
    table, dist, logits = _grammar()
    packed = pack_dfa_table(table, dist)
    states = np.arange(B, dtype=np.int32)
    zeros = np.zeros(B, np.float32)
    topk = np.asarray([0, 40, 5, 0, 64, 1, 7, 0], np.int32)
    topp = np.asarray([1.0, 0.9, 1.0, 0.5, 0.95, 1.0, 1.0, 0.8], np.float32)
    buds = np.asarray(budget_row, np.int32)
    tok, st = sample_tokens_constrained(
        torch.from_numpy(logits), _gen(), torch.from_numpy(zeros),
        torch.from_numpy(topk), torch.from_numpy(topp),
        torch.from_numpy(states), torch.from_numpy(packed),
        budgets=torch.from_numpy(buds))
    key = jax.random.PRNGKey(42)
    for jtable, kw in ((table, {"dfa_dist": jnp.asarray(dist)}),
                       (packed, {"packed": True})):
        jt, js = jsample_constrained(
            jnp.asarray(logits), key, jnp.asarray(zeros), jnp.asarray(topk),
            jnp.asarray(topp), jnp.asarray(states), jnp.asarray(jtable),
            budgets=jnp.asarray(buds), **kw)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(st.numpy(), np.asarray(js))


def test_packed_table_parity_with_the_jax_runner():
    """The port's packed table (what the decode loop gathers) is the JAX
    runner's, byte for byte, including the vocab padding of the FREE row."""
    table, dist, _ = _grammar(3)
    table = table[:, : TINY_TEST.vocab_size - 12]   # exercise the padding
    params = jinit_params(TINY_TEST)
    jr = JModelRunner(TINY_TEST, JCacheConfig(num_pages=4, page_size=8,
                                              max_pages_per_seq=2),
                      params, max_slots=2, dfa_table=table, dfa_dist=dist,
                      interpret=True)
    tr = ModelRunner(TINY_TEST, CacheConfig(num_pages=4, page_size=8,
                                            max_pages_per_seq=2),
                     {}, device="cpu", max_slots=2, dfa_table=table,
                     dfa_dist=dist)
    np.testing.assert_array_equal(tr._dfa_packed.numpy(),
                                  np.asarray(jr._dfa_packed))
    assert tr.batch_buckets == jr.batch_buckets


@pytest.mark.parametrize("seed", range(6))
def test_sampling_stays_in_the_allowed_top_k(seed):
    """T>0: every sample is a grammar-allowed token and within the row's
    top-k of the masked logits."""
    table, dist, logits = _grammar(seed)
    packed = torch.from_numpy(pack_dfa_table(table, dist))
    states = torch.arange(B, dtype=torch.int32)
    temp = torch.full((B,), 1.3)
    topk = torch.tensor([3, 5, 1, 8, 2, 64, 4, 6], dtype=torch.int32)
    lg = torch.from_numpy(logits)
    for draw in range(5):
        tok, st = sample_tokens_constrained(
            lg, _gen(seed * 10 + draw), temp, topk, torch.ones(B), states,
            packed)
        for b in range(B):
            allowed = table[b] >= 0
            t = int(tok[b])
            assert allowed[t]
            assert int(st[b]) == table[b, t]
            masked = np.where(allowed, logits[b], -np.inf)
            k = int(topk[b])
            assert masked[t] >= np.sort(masked)[-k]


def test_greedy_rows_ignore_their_neighbours_temperature():
    _, _, logits = _grammar(1)
    lg = torch.from_numpy(logits[:2])
    tok = sample_tokens(lg, _gen(3), torch.tensor([0.0, 2.0]),
                        torch.zeros(2, dtype=torch.int32), torch.ones(2))
    assert int(tok[0]) == int(lg[0].argmax())


def test_top_p_collapses_to_greedy_on_a_peaked_distribution():
    lg = torch.full((2, 100), -10.0)
    lg[:, 7] = 10.0
    for seed in range(10):
        tok = sample_tokens(lg, _gen(seed), torch.ones(2),
                            torch.zeros(2, dtype=torch.int32),
                            torch.full((2,), 0.5))
        assert (tok == 7).all()


def test_generator_makes_draws_repeatable():
    _, _, logits = _grammar(2)
    lg = torch.from_numpy(logits)
    args = (torch.full((B,), 1.0), torch.zeros(B, dtype=torch.int32),
            torch.ones(B))
    a = sample_tokens(lg, _gen(5), *args)
    b = sample_tokens(lg, _gen(5), *args)
    assert torch.equal(a, b)
