"""The port's GPipe pipeline parallelism against the JAX package's.

The counterpart of ``tests/test_pipeline_parallel.py``: the JAX pipeline
runs on the virtual CPU devices (``tests/conftest.py``), the port's on
stage ranks that are threads of this process, each with its own gloo group
(``make_pp_mesh``, a file rendezvous under ``tmp_path``), from one numpy
init.  The explicit schedule must give the single-device loss and
gradients (microbatches split the batch's mean exactly, up to float32
summation order), keep only each stage's layers on it, train like one
device, and ``train_model --pp`` must write a checkpoint with the whole
layer stack that the JAX ``load_npz`` reads.
"""

import dataclasses
import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.engine import weights as jweights
from deepvision_tpu.engine.config import TINY_TEST as JTINY
from deepvision_tpu.engine.pipeline_parallel import (
    make_pp_loss_fn as jmake_pp_loss_fn,
)
from deepvision_tpu.engine.pipeline_parallel import make_pp_mesh as jmesh
from deepvision_tpu.engine.pipeline_parallel import (
    place_pp_params as jplace,
)
from deepvision_tpu_torch import train_model
from deepvision_tpu_torch.engine import model as tmodel
from deepvision_tpu_torch.engine import training as ttrain
from deepvision_tpu_torch.engine import weights as tweights
from deepvision_tpu_torch.engine.config import get_model_config
from deepvision_tpu_torch.engine.pipeline_parallel import (
    gather_pp_params,
    make_pp_loss_fn,
    make_pp_mesh,
    make_pp_train_step,
    place_pp_params,
    pp_param_specs,
    pp_stage_layers,
    pp_value_and_grad,
)

torch.set_num_threads(1)

JOIN_S = 60.0
# 4 layers over 4 stages (and 2), 4 microbatches, as the JAX tests
JCFG = dataclasses.replace(JTINY, name="dv-tiny-pp", n_layers=4)
TCFG = dataclasses.replace(get_model_config("dv-tiny-test"),
                           name="dv-tiny-pp", n_layers=4)
N_MICRO, B, SEQ = 4, 8, 16


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


@pytest.fixture(scope="module")
def setup():
    init = _np_tree(jweights.init_params(JCFG, seed=0, dtype=jnp.float32))
    tokens = np.random.default_rng(7).integers(
        0, JCFG.vocab_size, (B, SEQ + 1)).astype(np.int32)
    return init, tokens


def run_stages(n, fn, tmp_path):
    """``fn(group)`` on ``n`` stage ranks, one thread each; the results in
    rank order (re-raises a rank's exception)."""
    store = os.path.join(tempfile.mkdtemp(dir=tmp_path), "rendezvous")
    out, errs = [None] * n, []

    def body(r):
        try:
            out[r] = fn(make_pp_mesh(n, rank=r, store_path=store,
                                     device="cpu"))
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


def _stage_params(init, group):
    full = tweights.from_numpy_params(init, device="cpu")
    return ttrain.as_trainable(place_pp_params(full, group, TCFG), "cpu")


def _single(init, tokens):
    """Loss and gradients of the single-device float32 forward."""
    params = ttrain.as_trainable(
        tweights.from_numpy_params(init, device="cpu"), "cpu")
    t = torch.from_numpy(tokens)
    loss = ttrain.cross_entropy_loss(
        tmodel.forward_train(params, t[:, :-1], cfg=TCFG,
                             act_dtype=torch.float32), t[:, 1:])
    loss.backward()
    return loss.item(), {n: p.grad for n, p in _flat(params)}


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pp_loss_matches_jax_and_single_device(setup, n_stages, tmp_path):
    """The forward schedule's loss, equal on every stage, against the JAX
    ``make_pp_loss_fn`` and the single-device loss at 1e-5 relative (the
    JAX test's bound: float32 sums in another order)."""
    init, tokens = setup
    mesh = jmesh(n_stages, devices=jax.devices()[:n_stages])
    jloss = float(jax.jit(jmake_pp_loss_fn(JCFG, mesh, N_MICRO))(
        jplace(jax.tree.map(jnp.asarray, init), mesh, JCFG),
        jnp.asarray(tokens)))

    def fn(group):
        loss_fn = make_pp_loss_fn(TCFG, group, N_MICRO)
        return loss_fn(_stage_params(init, group),
                       torch.from_numpy(tokens)).item()

    losses = run_stages(n_stages, fn, tmp_path)
    assert len(set(losses)) == 1
    assert losses[0] == pytest.approx(jloss, rel=1e-5)
    assert losses[0] == pytest.approx(_single(init, tokens)[0], rel=1e-5)


def test_pp_grads_match_single_device(setup, tmp_path):
    """Every gradient leaf, the stages' layer chunks gathered to the full
    stack, against the single-device float32 gradients at the JAX test's
    tolerance (2e-4 relative, 2e-5 absolute): the embedding's is the first
    stage's lookup plus the last stage's tied head, the final norm's the
    last stage's, summed over the stages."""
    init, tokens = setup

    def fn(group):
        params = _stage_params(init, group)
        loss = pp_value_and_grad(params, torch.from_numpy(tokens), cfg=TCFG,
                                 group=group, n_micro=N_MICRO)
        grads = {k: ({n: p.grad for n, p in v.items()}
                     if isinstance(v, dict) else v.grad)
                 for k, v in params.items()}
        return loss.item(), gather_pp_params(grads, group, TCFG)

    out = run_stages(4, fn, tmp_path)
    want_loss, want = _single(init, tokens)
    for loss, grads in out:
        assert loss == pytest.approx(want_loss, rel=1e-5)
        got = dict(_flat(grads))
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name].numpy(),
                                       want[name].numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=name)


def test_pp_blocks_are_stage_local(setup, tmp_path):
    """4 layers over 4 stages: each stage holds one layer of every block
    leaf, its own, and the whole embedding; ``gather_pp_params`` gives the
    full tree back bit for bit."""
    init, _ = setup

    def fn(group):
        params = _stage_params(init, group)
        return ({n: tuple(p.shape) for n, p in _flat(params)},
                params["blocks"]["wq"].detach().clone(),
                gather_pp_params(params, group, TCFG))

    out = run_stages(4, fn, tmp_path)
    full = dict(_flat(init))
    for stage, (shapes, wq, gathered) in enumerate(out):
        assert shapes["blocks/wq"] == (1,) + full["blocks/wq"].shape[1:]
        assert shapes["embed"] == full["embed"].shape
        np.testing.assert_array_equal(wq.numpy(),
                                      full["blocks/wq"][stage:stage + 1])
        for name, leaf in _flat(gathered):
            np.testing.assert_array_equal(leaf.numpy(), full[name])


def test_pp_training_tracks_single_device(setup, tmp_path):
    """Three steps of ``make_pp_train_step`` (the clipping chain, whose
    norm takes every stage's layers) against the single-device trainer on
    the same batch: losses within 1e-4 relative, as the JAX test holds its
    pipeline, and the loss falls."""
    init, tokens = setup

    def chain():
        return ttrain.train_model_chain(1e-2, 1, 4)

    def fn(group):
        params = _stage_params(init, group)
        tx = chain()
        state = tx.init(params)
        step = make_pp_train_step(TCFG, tx, group, N_MICRO)
        return [step(params, state, torch.from_numpy(tokens)).item()
                for _ in range(3)]

    out = run_stages(2, fn, tmp_path)
    ref = ttrain.Trainer(TCFG, tx=chain(), device="cpu",
                         act_dtype=torch.float32,
                         init=tweights.from_numpy_params(init, device="cpu"))
    want = [ref.train_step(tokens) for _ in range(3)]
    assert out[0] == out[1]
    np.testing.assert_allclose(out[0], want, rtol=1e-4)
    assert out[0][-1] < out[0][0]


def test_pp_stage_layers_divisibility():
    assert pp_stage_layers(TCFG, 4) == 1
    assert pp_stage_layers(TCFG, 2) == 2
    with pytest.raises(ValueError, match="not divisible"):
        pp_stage_layers(TCFG, 3)


@pytest.mark.parametrize("tied", [True, False])
def test_pp_specs_cover_all_params(tied):
    """A dim (or None) for every leaf of the params tree, tied head or
    untied ``lm_head``: the same tree structure."""
    cfg = dataclasses.replace(TCFG, tie_embeddings=tied)
    params = tweights.init_params(cfg, device="meta")
    specs = pp_param_specs(cfg)
    assert [n for n, _ in _flat(params)] == [n for n, _ in _flat(specs)]
    assert all(d == (0 if n.startswith("blocks/") else None)
               for n, d in _flat(specs))


def _corpus(path):
    path.write_text("访谈问答示例，流程与预算。\n" * 400, encoding="utf-8")


def test_train_model_cli_pp_smoke(tmp_path, capsys):
    """``python -m deepvision_tpu_torch.train_model --pp 2 --pp-micro 2``
    on the CPU: rank 0 (this process) spawns the second stage, both train
    2 steps, and the checkpoint holds the whole re-gathered layer stack,
    which the JAX ``load_npz`` reads; no stage process outlives the run."""
    import multiprocessing

    corpus = tmp_path / "c.txt"
    _corpus(corpus)
    out = tmp_path / "pp.npz"
    train_model.main([
        "--model", "dv-tiny-test", "--tokenizer", "byte",
        "--corpus", str(corpus), "--out", str(out), "--steps", "2",
        "--batch", "4", "--seq", "32", "--pp", "2", "--pp-micro", "2",
        "--log-every", "1", "--save-every", "100", "--val-frac", "0.2",
        "--device", "cpu"])
    log = capsys.readouterr().out
    assert ("pipeline parallel: 2 stages x 1 layers, 2 microbatches"
            in log), log
    assert "step 2/2 loss=" in log and "final val_loss=" in log
    assert not multiprocessing.active_children()
    params = jweights.load_npz(str(out))
    assert params["blocks"]["wq"].shape[0] == 2  # full stack re-gathered
    assert params["blocks"]["wq"].dtype == jnp.bfloat16


@pytest.mark.parametrize("argv, why", [
    (["--pp", "2", "--batch", "3", "--pp-micro", "2"], "microbatches"),
    (["--pp", "3", "--batch", "3", "--pp-micro", "3"], "not divisible"),
])
def test_train_model_cli_pp_checks(tmp_path, argv, why):
    """The CLI's checks, before any stage is spawned: the batch must split
    into the microbatches, the layers into the stages (``ValueError``)."""
    corpus = tmp_path / "c.txt"
    _corpus(corpus)
    with pytest.raises(ValueError, match=why):
        train_model.main(["--model", "dv-tiny-test", "--tokenizer", "byte",
                          "--corpus", str(corpus), "--seq", "32",
                          "--out", str(tmp_path / "x.npz"),
                          "--device", "cpu"] + argv)


def test_rank_processes_report_a_failure_and_end_every_rank(tmp_path):
    """The launcher: a stage that fails (a missing checkpoint to resume
    from) is raised with its traceback, and a stage left waiting for a
    peer that never joins is ended at the deadline; no child process
    survives either."""
    import multiprocessing

    from deepvision_tpu_torch.engine.parallel import RankError, RankProcesses
    from deepvision_tpu_torch.engine.pipeline_parallel import pp_stage_main

    spec = {"cfg": TCFG, "resume": str(tmp_path / "missing.npz"),
            "seed": 0, "device": "cpu", "n_stages": 2, "n_micro": 2,
            "chain": (1e-3, 1, 2)}
    with RankProcesses(pp_stage_main, [1], (spec,)) as ranks:
        with pytest.raises(RankError, match="rank 1 failed"):
            ranks.results(60.0)
    assert not multiprocessing.active_children()
    with RankProcesses(pp_stage_main, [1], (dict(spec, resume=""),)) as ranks:
        with pytest.raises(RankError, match="did not finish"):
            ranks.results(3.0)
    assert not multiprocessing.active_children()
