"""The port's sharded serving functions against the JAX package's.

Each rank of a tensor-parallel group runs in a thread of this process, with
its own gloo group (``parallel.TPGroup``) joined through a file rendezvous
under ``tmp_path``: the vocab-sharded embedding against ``take``, the
candidate merge against an unsharded top-k and ``lax.top_k``, and sampling
and grammar-constrained sampling (the DFA state advance included) against
the unsharded sampler and the JAX sharded sampler under ``shard_map``.
``run_ranks`` is shared with ``test_torch_parallel_forwards.py``."""

import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine import model as jmodel
from deepvision_tpu.engine.parallel import make_mesh
from deepvision_tpu.engine.sampling import (
    sample_tokens_constrained as jsample_constrained,
)
from deepvision_tpu_torch.engine import model as tmodel
from deepvision_tpu_torch.engine import weights as tweights
from deepvision_tpu_torch.engine.parallel import TPGroup, shard
from deepvision_tpu_torch.engine.sampling import (
    MAX_K,
    _global_candidates,
    pack_dfa_table,
    sample_tokens,
    sample_tokens_constrained,
)

torch.set_num_threads(1)

JOIN_S = 60.0


def run_ranks(n, fn, tmp_path):
    """``fn(group)`` on ``n`` ranks, one thread each; returns the results
    in rank order (re-raises a rank's exception)."""
    store = os.path.join(tempfile.mkdtemp(dir=tmp_path), "rendezvous")
    out, errs = [None] * n, []

    def body(r):
        try:
            group = TPGroup.join(store, r, n, "cpu")
            out[r] = fn(group)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a rank did not finish"
    if errs:
        raise errs[0]
    return out


def test_group_collectives(tmp_path):
    """``TPGroup``'s collectives on 3 ranks: ``all_reduce`` of float32,
    bf16 and int32, ``all_gather`` along either axis in rank order,
    ``broadcast`` from a non-zero rank; each counted in ``calls``."""
    def fn(g):
        r = g.rank
        return (g.all_reduce(torch.full((2, 3), r + 1.0)),
                g.all_reduce(torch.full((4,), r + 0.5, dtype=torch.bfloat16)),
                g.all_reduce(torch.tensor([r, 1], dtype=torch.int32)),
                g.all_gather(torch.full((2, 1), float(r)), dim=-1),
                g.all_gather(torch.full((1, 2), float(r)), dim=0),
                g.broadcast(torch.full((3,), float(r)), src=1),
                g.calls)

    for f32, bf16, i32, cols, rows, bc, calls in run_ranks(3, fn, tmp_path):
        assert f32.eq(6.0).all() and bf16.eq(4.5).all()
        assert i32.tolist() == [3, 3]
        assert cols.tolist() == [[0.0, 1.0, 2.0]] * 2
        assert rows.tolist() == [[0.0, 0.0], [1.0, 1.0], [2.0, 2.0]]
        assert bc.tolist() == [1.0] * 3 and calls == 6


# -- embedding and candidates -------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_sharded_embedding_matches_take(n, tmp_path):
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    rs = np.random.RandomState(0)
    V, D = 512, 64
    embed = jnp.asarray(rs.randn(V, D), jnp.bfloat16)
    tokens = rs.randint(0, V, size=(3, 7)).astype(np.int32)
    want = np.asarray(jnp.take(embed, jnp.asarray(tokens), axis=0))
    mesh = make_mesh(n_model=n, devices=jax.devices()[:n])
    jsharded = shard_map(
        lambda p, t: jmodel._embed(p, t, "model", True), mesh=mesh,
        in_specs=({"embed": P("model", None)}, P()), out_specs=P(),
        check_rep=False)({"embed": embed}, jnp.asarray(tokens))
    full = tweights.from_numpy_params({"embed": np.asarray(embed)},
                                      device="cpu")["embed"]
    got = run_ranks(n, lambda g: tmodel._embed(
        {"embed": shard(full, 0, g.rank, n)}, torch.from_numpy(tokens),
        group=g, vocab_sharded=True), tmp_path)
    for r in range(n):
        np.testing.assert_array_equal(got[r].float().numpy(),
                                      want.astype(np.float32))
        np.testing.assert_array_equal(got[r].float().numpy(),
                                      np.asarray(jsharded, np.float32))


@pytest.mark.parametrize("n", [2, 4])
def test_global_candidates_match_unsharded_top_k(n, tmp_path):
    """The merged candidates equal ``lax.top_k`` over the full vocab, ties
    in id order: values, global ids, on every rank."""
    rs = np.random.RandomState(1)
    B, V = 6, 512
    logits = np.round(rs.randn(B, V) * 2, 1).astype(np.float32)  # many ties
    logits[0, 10] = logits[0, 300] = logits[0].max() + 1  # tie at the top
    logits[1, :] = -1e30                                   # all masked
    logits[1, 77] = 0.0
    jv, ji = jax.lax.top_k(jnp.asarray(logits), MAX_K)
    local = [shard(torch.from_numpy(logits), 1, r, n) for r in range(n)]
    got = run_ranks(n, lambda g: _global_candidates(local[g.rank], g),
                    tmp_path)
    for vals, idx in got:
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert got[0][1][0, 0] == 10   # the lower id of the tie


@pytest.mark.parametrize("temp,tk,tp_", [
    (0.0, 0, 1.0), (0.8, 0, 1.0), (1.0, 8, 1.0), (0.7, 0, 0.9),
    (0.9, 16, 0.95)])
def test_sample_tokens_sharded_equals_unsharded(temp, tk, tp_, tmp_path):
    """Every rank draws the unsharded sampler's tokens from the same
    generator seed; greedy is the full vocab's argmax."""
    n, B, V = 4, 8, 256
    logits = torch.from_numpy(
        np.random.RandomState(7).randn(B, V).astype(np.float32) * 3)
    temps = torch.full((B,), temp)
    tks = torch.full((B,), tk, dtype=torch.int32)
    tps = torch.full((B,), tp_)

    def gen():
        g = torch.Generator()
        g.manual_seed(11)
        return g

    want = sample_tokens(logits, gen(), temps, tks, tps)
    got = run_ranks(n, lambda g: sample_tokens(
        shard(logits, 1, g.rank, n), gen(), temps, tks, tps, group=g),
        tmp_path)
    for tok in got:
        np.testing.assert_array_equal(tok.numpy(), want.numpy())
    if temp == 0.0:
        np.testing.assert_array_equal(want.numpy(),
                                      logits.argmax(-1).numpy())


def _dfa(seed=3, S=5, V=256):
    rs = np.random.RandomState(seed)
    table = rs.randint(-1, S, size=(S, V)).astype(np.int32)
    table[0, :] = 0
    for s in range(S):
        table[s, s] = (s + 1) % S
    dist = rs.randint(0, 6, size=S).astype(np.int32)
    dist[0] = 0
    return table, dist


def test_constrained_sampling_and_state_advance_match_jax(tmp_path):
    """Greedy grammar-constrained sampling with budgets over the packed
    table: the port's sharded sampler gives the JAX sharded sampler's
    tokens and next states (``shard_map``, 4 devices), and at temperature
    > 0 the port's unsharded sampler's; sampled tokens obey the grammar."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    n, B, V = 4, 8, 256
    table, dist = _dfa(V=V)
    packed = pack_dfa_table(table, dist)
    rs = np.random.RandomState(5)
    logits = (rs.randn(B, V) * 2).astype(np.float32)
    states = rs.randint(0, 5, size=B).astype(np.int32)
    budgets = np.asarray([1, 2, 3, 1 << 20, 4, 2, 8, 1], np.int32)
    zeros = np.zeros(B, np.float32)
    mesh = make_mesh(n_model=n, devices=jax.devices()[:n])

    def jfn(lg, rng, temp, tk, tp_, st, dfa, bud):
        return jsample_constrained(lg, rng, temp, tk, tp_, st, dfa,
                                   budgets=bud, axis="model", packed=True)

    jtok, jstate = shard_map(
        jfn, mesh=mesh,
        in_specs=(P(None, "model"), P(), P(), P(), P(), P(),
                  P(None, "model"), P()),
        out_specs=(P(), P()), check_rep=False)(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(zeros),
        jnp.zeros(B, jnp.int32), jnp.ones(B, jnp.float32),
        jnp.asarray(states), jnp.asarray(packed), jnp.asarray(budgets))
    t = {k: torch.from_numpy(v) for k, v in dict(
        logits=logits, states=states, packed=packed, budgets=budgets).items()}

    def run(temps, tks, tps, group=None, rank=0):
        g = torch.Generator()
        g.manual_seed(4)
        lg, tb = t["logits"], t["packed"]
        if group is not None:
            lg, tb = shard(lg, 1, rank, n), shard(tb, 1, rank, n)
        return sample_tokens_constrained(
            lg, g, temps, tks, tps, t["states"], tb, budgets=t["budgets"],
            group=group)

    greedy = (torch.zeros(B), torch.zeros(B, dtype=torch.int32),
              torch.ones(B))
    for tok, state in run_ranks(
            n, lambda g: run(*greedy, group=g, rank=g.rank), tmp_path):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
    sampled = (torch.from_numpy(rs.uniform(0.1, 1.2, B).astype(np.float32)),
               torch.tensor([0, 4, 8, 0, 16, 0, 2, 64], dtype=torch.int32),
               torch.tensor([1.0, 0.9, 1.0, 0.8, 1.0, 0.95, 1.0, 1.0]))
    want_tok, want_state = run(*sampled)
    for tok, state in run_ranks(
            n, lambda g: run(*sampled, group=g, rank=g.rank), tmp_path):
        np.testing.assert_array_equal(tok.numpy(), want_tok.numpy())
        np.testing.assert_array_equal(state.numpy(), want_state.numpy())
        assert (table[states, tok.numpy()] >= 0).all()
