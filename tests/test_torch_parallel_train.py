"""The port's DP x TP training step against the JAX package's.

``Trainer(cfg, mesh=make_mesh(n_model, n_data), plan=ShardPlan.for_model
(cfg, n_model))`` on each rank of a mesh, every rank a thread of this
process with its own gloo groups (a file rendezvous under ``tmp_path``),
against the JAX ``Trainer(mesh, plan)`` on the virtual CPU devices
(``tests/conftest.py``) from the same numpy init and batches: two steps'
losses, the first step's gradients leaf by leaf (averaged over the data
group, clipped, gathered over the model group) and the params gathered
after both steps, on the meshes (n_data, n_model) (2, 1), (1, 2) and
(2, 2) here, and in ``tests/test_torch_parallel_train_plans.py`` with
explicit vocab sharding, with replicated multi-head K/V (H 8, KV 2 over 4
model ranks) and with the clipping optimizer chain (the gradients' norm
above its limit).  Every case also runs here against the port's own
one-rank ``Trainer`` in float32 activations through the flash kernels'
plain versions, where the split is exact up to summation order.
"""

import dataclasses
import functools
import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepvision_tpu.engine import model as jmodel
from deepvision_tpu.engine.config import TINY_TEST as JTINY
from deepvision_tpu.engine.parallel import ShardPlan as JShardPlan
from deepvision_tpu.engine.parallel import make_mesh as jmake_mesh
from deepvision_tpu.engine.training import Trainer as JTrainer
from deepvision_tpu.engine.training import cross_entropy_loss as jce
from deepvision_tpu_torch.engine import training as ttrain
from deepvision_tpu_torch.engine import weights as tweights
from deepvision_tpu_torch.engine.config import get_model_config
from deepvision_tpu_torch.engine.parallel import (
    ShardPlan,
    gather_params,
    make_mesh,
)

torch.set_num_threads(1)

JOIN_S = 60.0
LR, STEPS = 1e-2, 2
TTINY = get_model_config("dv-tiny-test")

# name: (n_data, n_model, config change, plan kwargs, optimizer)
CASES = {
    "dp2": (2, 1, {}, {}, "adamw"),
    "tp2": (1, 2, {}, {}, "adamw"),
    "dp2_tp2": (2, 2, {}, {}, "adamw"),
    "dp2_tp2_vocab_sharded": (2, 2, {}, {"vocab_sharded": True}, "adamw"),
    "dp2_tp2_clipped": (2, 2, {}, {}, "chain"),
    "tp4_h8_kv2": (1, 4, {"n_heads": 8, "n_kv_heads": 2}, {}, "adamw"),
}


def _cfgs(change):
    return (dataclasses.replace(JTINY, **change),
            dataclasses.replace(TTINY, **change))


def _flat(tree, prefix=""):
    for name in sorted(tree):
        leaf = tree[name]
        if isinstance(leaf, dict):
            yield from _flat(leaf, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", leaf


def _np_tree(tree):
    return {k: (_np_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


def _inputs(jcfg, seed=4):
    from deepvision_tpu.engine import weights as jweights

    init = _np_tree(jweights.init_params(jcfg, seed=seed, dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    batches = [rng.integers(1, jcfg.vocab_size, size=(4, 17)).astype(np.int32)
               for _ in range(STEPS)]
    return init, batches


def _optimizers(kind):
    """(optax, port) optimizers; the chain as train_model.py's with a
    constant rate after one warmup step, so both steps' updates count."""
    if kind == "adamw":
        return optax.adamw(LR), ttrain.AdamW(LR)
    sched = optax.warmup_cosine_decay_schedule(0.0, LR, 1, 1 + STEPS,
                                               end_value=LR * 0.05)
    return (optax.chain(optax.clip_by_global_norm(1.0),
                        optax.adamw(sched, weight_decay=0.01)),
            ttrain.train_model_chain(LR, 1, 1 + STEPS))


def _grad_tree(params):
    return {k: (_grad_tree(v) if isinstance(v, dict) else v.grad)
            for k, v in params.items()}


def run_mesh(n_data, n_model, tcfg, init, batches, tx, plan_kw, tmp_path,
             act_dtype, use_kernel):
    """Each rank's ``(losses, first step's gathered gradients, gathered
    params)`` from ``STEPS`` steps of the port's ``Trainer`` on a mesh,
    every rank a thread; re-raises a rank's exception."""
    n = n_data * n_model
    store = os.path.join(tempfile.mkdtemp(dir=tmp_path), "rendezvous")
    out, errs = [None] * n, []

    def body(rank):
        try:
            mesh = make_mesh(n_model, n_data, rank=rank, store_path=store,
                             device="cpu", timeout_s=JOIN_S)
            plan = ShardPlan.for_model(tcfg, n_model, **plan_kw)
            trainer = ttrain.Trainer(
                tcfg, mesh=mesh, plan=plan, tx=tx, act_dtype=act_dtype,
                use_kernel=use_kernel,
                init=tweights.from_numpy_params(init, device="cpu"))
            losses = [trainer.train_step(batches[0])]
            grads = gather_params(_grad_tree(trainer.params),
                                  plan.param_dims(tcfg), mesh.model)
            losses += [trainer.train_step(b) for b in batches[1:]]
            out[rank] = (losses, grads, trainer.full_params())
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


def _same_on_every_rank(out):
    """Every rank returns the same losses, and the ranks of one model
    column the same gathered params (bit for bit)."""
    for losses, _, params in out[1:]:
        assert losses == out[0][0]
        for (name, a), (_, b) in zip(_flat(params), _flat(out[0][2])):
            assert torch.equal(a, b), name


@functools.lru_cache(maxsize=None)
def _jax_grads(jcfg):
    """The JAX gradients of the first step's loss (the same for every
    mesh: GSPMD computes the logical model)."""
    init, batches = _inputs(jcfg)

    def loss_fn(p, tokens):
        logits = jmodel.forward_train(p, tokens[:, :-1], cfg=jcfg)
        return jce(logits, tokens[:, 1:])

    return jax.grad(loss_fn)(jax.tree.map(jnp.asarray, init),
                             jnp.asarray(batches[0]))


def _jax_run(jcfg, init, batches, n_data, n_model, plan_kw, tx, clip):
    """The JAX ``Trainer(mesh, plan)``'s losses and params after the steps,
    and the first step's gradients (``jax.value_and_grad`` of the same
    logical loss, through the optimizer's clip where it has one)."""
    mesh = jmake_mesh(n_model=n_model, n_data=n_data,
                      devices=jax.devices()[:n_data * n_model])
    plan = JShardPlan.for_model(jcfg, n_model, **plan_kw)
    trainer = JTrainer(jcfg, mesh=mesh, plan=plan, tx=tx,
                       init=jax.tree.map(jnp.asarray, init))
    losses = [trainer.train_step(b) for b in batches]

    grads = _jax_grads(jcfg)
    norm = float(optax.global_norm(grads))
    if clip:
        clipper = optax.clip_by_global_norm(1.0)
        grads, _ = clipper.update(grads, clipper.init(grads))
    return losses, _np_tree(grads), _np_tree(trainer.params), norm


def check_against_the_jax_trainer(case, tmp_path):
    """The port's ``Trainer(mesh, plan)`` against the JAX one, both with
    bf16 activations and plain attention, from one numpy init.

    Tolerances: both frameworks round to bf16 at the same points, but a
    value summed in another order may round one bf16 step (2^-8 relative)
    apart, and such steps compound through the layers and the backward.
    The port's one-rank step is already that far from the JAX one on these
    inputs (measured: losses up to 8e-4 relative, gradient leaves up to
    1.8e-2 relative L2 error); Adam's first update is ``lr * sign(g)`` on
    each element, so an element whose gradient lies within those rounding
    steps of 0 moves ``2 lr`` apart, and each leaf's total update ``p_2 -
    p_0`` differs by up to 0.15 relative L2 error there.  The bounds give
    the mesh's other summation order 1.5-2x that room: losses 2e-3
    relative, gradient leaves 3e-2, updates 0.3.  A layout fault (a wrong
    shard, a missing sum over the ranks) moves them by O(1)."""
    n_data, n_model, change, plan_kw, kind = CASES[case]
    jcfg, tcfg = _cfgs(change)
    init, batches = _inputs(jcfg)
    jtx, ttx = _optimizers(kind)
    jlosses, jgrads, jparams, norm = _jax_run(jcfg, init, batches, n_data,
                                              n_model, plan_kw, jtx,
                                              clip=kind == "chain")
    if kind == "chain":
        assert norm > 1.0, norm        # the clip bites
    out = run_mesh(n_data, n_model, tcfg, init, batches, ttx, plan_kw,
                   tmp_path, torch.bfloat16, use_kernel=False)
    _same_on_every_rank(out)
    losses, grads, params = out[0]
    np.testing.assert_allclose(losses, jlosses, rtol=2e-3)
    want = dict(_flat(jgrads))
    assert set(want) == {n for n, _ in _flat(grads)}
    for name, g in _flat(grads):
        err = np.linalg.norm(g.float().numpy() - want[name])
        assert err <= 3e-2 * np.linalg.norm(want[name]), (name, err)
    start, want = dict(_flat(init)), dict(_flat(jparams))
    for name, p in _flat(params):
        moved = np.linalg.norm(want[name] - start[name])
        assert moved > 0, name
        err = np.linalg.norm(p.float().numpy() - want[name])
        assert err <= 0.3 * moved, (name, err / moved)


@pytest.mark.parametrize("case", ["dp2", "tp2", "dp2_tp2"])
def test_trainer_on_a_mesh_matches_the_jax_trainer(case, tmp_path):
    """Each mesh shape against the JAX ``Trainer(mesh, plan)``
    (``check_against_the_jax_trainer``; the plans' cases are in
    ``tests/test_torch_parallel_train_plans.py``)."""
    check_against_the_jax_trainer(case, tmp_path)


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_on_a_mesh_matches_one_rank(case, tmp_path):
    """The same mesh against the port's one-rank ``Trainer`` in float32
    activations, attention through the flash kernels' plain versions (the
    ``Function`` with its lse and backward formulas): the split changes
    only the order of float32 sums.  The first step's loss within 1e-5
    relative (measured: up to 1.3e-6) and each of its gradient leaves
    within 1e-4 of the leaf's largest element (measured: 1.6e-6).  Adam
    divides each element by its own gradient's magnitude, so a rounding
    difference in a near-zero gradient shows in the update: each leaf's
    total update within 5e-3 relative L2 error (measured: up to 1.1e-3),
    and the second step's loss, taken on the updated params, within 1e-4
    (measured: up to 5e-6)."""
    n_data, n_model, change, plan_kw, kind = CASES[case]
    jcfg, tcfg = _cfgs(change)
    init, batches = _inputs(jcfg)
    _, ttx = _optimizers(kind)
    out = run_mesh(n_data, n_model, tcfg, init, batches, ttx, plan_kw,
                   tmp_path, torch.float32, use_kernel=True)
    _same_on_every_rank(out)
    losses, grads, params = out[0]
    _, ttx1 = _optimizers(kind)
    one = ttrain.Trainer(tcfg, tx=ttx1, device="cpu",
                         act_dtype=torch.float32, use_kernel=True,
                         init=tweights.from_numpy_params(init, device="cpu"))
    want_losses = [one.train_step(batches[0])]
    want_grads = dict(_flat(_grad_tree(one.params)))
    want_grads = {k: v.clone() for k, v in want_grads.items()}
    want_losses += [one.train_step(b) for b in batches[1:]]
    np.testing.assert_allclose(losses[0], want_losses[0], rtol=1e-5)
    np.testing.assert_allclose(losses[1:], want_losses[1:], rtol=1e-4)
    for name, g in _flat(grads):
        scale = max(want_grads[name].abs().max().item(), 1e-6)
        torch.testing.assert_close(g, want_grads[name], atol=1e-4 * scale,
                                   rtol=1e-4, msg=name)
    start, want = dict(_flat(init)), dict(_flat(one.params))
    for name, p in _flat(params):
        w = want[name].detach().numpy()
        moved = np.linalg.norm(w - start[name])
        assert moved > 0, name
        assert np.linalg.norm(p.numpy() - w) <= 5e-3 * moved, name


def test_mesh_places_ranks_in_the_jax_order(tmp_path):
    """Rank r of a (2, 2) mesh is data index r // 2 and model index r % 2,
    and takes the rows of the global batch that ``P("data", None)`` places
    on device row r // 2; its model and data groups hold the right ranks
    (an all_reduce of each rank's number over each group)."""
    store = os.path.join(tempfile.mkdtemp(dir=tmp_path), "rendezvous")
    batch = np.arange(8 * 3, dtype=np.int32).reshape(8, 3)
    jmesh = jmake_mesh(n_model=2, n_data=2, devices=jax.devices()[:4])
    placed = jax.device_put(jnp.asarray(batch), jax.sharding.NamedSharding(
        jmesh, jax.sharding.PartitionSpec("data", None)))
    jrows = {}
    for shard in placed.addressable_shards:
        d = int(np.argwhere(jmesh.devices == shard.device)[0][0])
        jrows[d] = np.asarray(shard.data)
    out, errs = [None] * 4, []

    def body(rank):
        try:
            mesh = make_mesh(2, 2, rank=rank, store_path=store,
                             device="cpu", timeout_s=JOIN_S)
            trainer = ttrain.Trainer(TTINY, mesh=mesh,
                                     plan=ShardPlan.for_model(TTINY, 2),
                                     device="cpu")
            me = torch.tensor([float(rank)])
            out[rank] = (mesh.data_index, mesh.model_index,
                         trainer.place_batch(batch).numpy(),
                         mesh.model.all_reduce(me.clone()).item(),
                         mesh.data.all_reduce(me.clone()).item())
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=body, args=(r,)) for r in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    if errs:
        raise errs[0]
    for rank, (d, m, rows, model_sum, data_sum) in enumerate(out):
        assert (d, m) == (rank // 2, rank % 2)
        np.testing.assert_array_equal(rows, jrows[d])
        assert model_sum == 2 * (rank // 2) * 2 + 1      # ranks 2d, 2d + 1
        assert data_sum == 2 + 2 * (rank % 2)          # ranks m, m + 2


def test_trainer_rejects_a_plan_without_a_mesh():
    with pytest.raises(ValueError, match="together"):
        ttrain.Trainer(TTINY, plan=ShardPlan.for_model(TTINY, 2),
                       device="cpu")
