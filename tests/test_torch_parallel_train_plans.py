"""The port's training on a model group against the JAX package's, by
shard plan: ``Trainer(mesh, plan)`` with explicit vocab sharding, with
replicated multi-head K/V (H 8, KV 2 over 4 model ranks) and with the
clipping optimizer chain against the JAX ``Trainer(mesh, plan)``
(``tests/test_torch_parallel_train.py``'s check, whose docstring states
the tolerances), and ``forward_train(group=..., vocab_sharded=...)``
against the JAX forward under ``shard_map``.  Ranks are threads of this
process with their own gloo groups (a file rendezvous under
``tmp_path``).
"""

import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine import model as jmodel
from deepvision_tpu.engine.parallel import ShardPlan as JShardPlan
from deepvision_tpu.engine.parallel import make_mesh as jmake_mesh
from deepvision_tpu_torch.engine import model as tmodel
from deepvision_tpu_torch.engine import training as ttrain
from deepvision_tpu_torch.engine import weights as tweights
from deepvision_tpu_torch.engine.parallel import (
    ShardPlan,
    gather_params,
    make_mesh,
    shard_params,
)
from test_torch_parallel_train import (
    JOIN_S,
    _cfgs,
    _flat,
    _grad_tree,
    _inputs,
    check_against_the_jax_trainer,
)

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "case", ["dp2_tp2_vocab_sharded", "dp2_tp2_clipped", "tp4_h8_kv2"])
def test_trainer_with_a_plan_matches_the_jax_trainer(case, tmp_path):
    """Each plan against the JAX ``Trainer(mesh, plan)``; the clipped case
    checks that the gradients' norm is above the clip's limit."""
    check_against_the_jax_trainer(case, tmp_path)


@pytest.mark.parametrize("vocab_sharded", [False, True])
def test_forward_train_on_a_model_group_matches_jax(vocab_sharded,
                                                    tmp_path):
    """``forward_train(group=..., vocab_sharded=...)`` on 2 model ranks
    (threads), float32 activations: the full logits (gathered from the
    vocab shards, as the JAX forward does) against the JAX
    ``forward_train(axis="model")`` under ``shard_map``, within 1e-5 of
    the logits' range (float32 sums in another order), and every gathered
    gradient of the loss on them against one rank's within 1e-4 of the
    leaf's largest element (the f / g and gather backward included)."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    jcfg, tcfg = _cfgs({})
    init, batches = _inputs(jcfg)
    tokens = batches[0][:, :-1]
    mesh = jmake_mesh(n_model=2, devices=jax.devices()[:2])
    jplan = JShardPlan.for_model(jcfg, 2, vocab_sharded=vocab_sharded)
    jfwd = shard_map(
        lambda p, t: jmodel.forward_train(
            p, t, cfg=jcfg, axis="model", vocab_sharded=vocab_sharded,
            act_dtype=jnp.float32),
        mesh=mesh, in_specs=(jplan.param_specs(jcfg), P()), out_specs=P(),
        check_rep=False)
    want = np.asarray(jfwd(jax.tree.map(jnp.asarray, init),
                           jnp.asarray(tokens)))
    store = os.path.join(tempfile.mkdtemp(dir=tmp_path), "rendezvous")
    out, errs = [None] * 2, []

    def body(rank):
        try:
            mesh_r = make_mesh(2, 1, rank=rank, store_path=store,
                               device="cpu", timeout_s=JOIN_S)
            plan = ShardPlan.for_model(tcfg, 2, vocab_sharded=vocab_sharded)
            params = ttrain.as_trainable(shard_params(
                tweights.from_numpy_params(init, device="cpu"), plan, tcfg,
                rank), "cpu")
            logits = tmodel.forward_train(
                params, torch.from_numpy(tokens), cfg=tcfg,
                act_dtype=torch.float32, group=mesh_r.model,
                vocab_sharded=vocab_sharded)
            ttrain.cross_entropy_loss(
                logits, torch.from_numpy(batches[0][:, 1:])).backward()
            out[rank] = (logits.detach(), gather_params(
                _grad_tree(params), plan.param_dims(tcfg), mesh_r.model))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=body, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a rank did not finish"
    if errs:
        raise errs[0]
    one = ttrain.as_trainable(tweights.from_numpy_params(init, device="cpu"),
                              "cpu")
    ttrain.cross_entropy_loss(
        tmodel.forward_train(one, torch.from_numpy(tokens), cfg=tcfg,
                             act_dtype=torch.float32),
        torch.from_numpy(batches[0][:, 1:])).backward()
    want_grads = dict(_flat(_grad_tree(one)))
    for logits, grads in out:
        assert logits.shape == want.shape
        np.testing.assert_allclose(logits.numpy(), want,
                                   atol=1e-5 * np.abs(want).max(), rtol=0)
        for name, g in _flat(grads):
            scale = max(want_grads[name].abs().max().item(), 1e-6)
            torch.testing.assert_close(g, want_grads[name],
                                       atol=1e-4 * scale, rtol=1e-4,
                                       msg=name)
