"""The port's training path against the JAX package's.

One training step's loss and gradients (``forward_train(use_kernel=True)``,
the flash backward's plain versions on the CPU, against
``jax.value_and_grad`` with the Pallas kernels in interpret mode), the
optimizer (``torch.optim.AdamW`` behind optax's settings) and ``Trainer``
steps against optax from the same numpy init, ``.npz`` checkpoint
interchange, ``load_or_init`` and ``EngineConfig`` against the JAX
package's, and the training CLI end to end on a tiny corpus.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepvision_tpu.engine import model as jmodel
from deepvision_tpu.engine import weights as jweights
from deepvision_tpu.engine.config import TINY_TEST
from deepvision_tpu.engine.engine import EngineConfig as JEngineConfig
from deepvision_tpu.engine.training import cross_entropy_loss as jce
from deepvision_tpu_torch import train_model
from deepvision_tpu_torch.engine import model as tmodel
from deepvision_tpu_torch.engine import training as ttrain
from deepvision_tpu_torch.engine import weights as tweights
from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine

torch.set_num_threads(2)


def _np_tree(tree):
    return {k: (_np_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    for name in sorted(tree):
        leaf = tree[name]
        if isinstance(leaf, dict):
            yield from _flat(leaf, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", leaf


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(
        1, TINY_TEST.vocab_size, size=(B, S)).astype(np.int32)


def _init_np(seed=0):
    return _np_tree(jweights.init_params(TINY_TEST, seed=seed,
                                         dtype=jnp.float32))


def _trainable(init_np):
    return ttrain.as_trainable(
        tweights.from_numpy_params(init_np, device="cpu"), "cpu")


def tmodel_forward(params, tokens, act_dtype, use_kernel=True):
    return tmodel.forward_train(params, tokens, cfg=TINY_TEST,
                                act_dtype=act_dtype, use_kernel=use_kernel)


# -- one training step: loss and every gradient leaf --------------------------

@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_train_step_loss_and_grads_match_jax(act):
    """Loss and gradients of next-token cross-entropy through
    ``forward_train(use_kernel=True)`` on dv-tiny-test, float32 params.

    Tolerances: float32 activations — summation order only (loss 1e-5,
    each leaf within 1e-4 of its largest gradient); bf16 activations —
    both frameworks round to bf16 at the same points, but an input that
    differs in its last float32 bits may round one bf16 step (2^-8
    relative) apart, and such steps compound through the layers and the
    backward: loss within 1e-3 relative, each leaf's relative L2 error
    within 2e-2.
    """
    jdt = jnp.float32 if act == "float32" else jnp.bfloat16
    tdt = torch.float32 if act == "float32" else torch.bfloat16
    init = _init_np()
    tokens = _tokens(2, 33)

    def jloss(p):
        logits = jmodel.forward_train(
            p, jnp.asarray(tokens[:, :-1]), cfg=TINY_TEST, use_kernel=True,
            interpret=True, act_dtype=jdt)
        return jce(logits, jnp.asarray(tokens[:, 1:]))

    jval, jgrads = jax.value_and_grad(jloss)(
        jax.tree.map(jnp.asarray, init))
    params = _trainable(init)
    t = torch.from_numpy(tokens)
    loss = ttrain.cross_entropy_loss(
        tmodel_forward(params, t[:, :-1], tdt), t[:, 1:])
    loss.backward()
    want = dict(_flat(_np_tree(jgrads)))
    got = {n: p.grad for n, p in _flat(params)}
    assert set(got) == set(want)
    if act == "float32":
        assert abs(loss.item() - float(jval)) <= 1e-5
        for name in want:
            scale = max(float(np.abs(want[name]).max()), 1e-6)
            np.testing.assert_allclose(got[name].numpy(), want[name],
                                       atol=1e-4 * scale, rtol=1e-4,
                                       err_msg=name)
    else:
        assert abs(loss.item() - float(jval)) <= 1e-3 * float(jval)
        for name in want:
            err = np.linalg.norm(got[name].numpy() - want[name])
            ref = np.linalg.norm(want[name])
            assert err <= 2e-2 * ref, (name, err / ref)


def test_kernel_and_plain_attention_give_the_same_gradients():
    """``use_kernel=True`` (the Function: lse, D and the explicit backward
    formulas) against ``False`` (autograd of the plain attention), in
    float32: the same function, so summation order only (1e-4)."""
    init = _init_np(seed=1)
    t = torch.from_numpy(_tokens(2, 25, seed=1))
    grads = []
    for use_kernel in (True, False):
        params = _trainable(init)
        loss = ttrain.cross_entropy_loss(
            tmodel_forward(params, t[:, :-1], torch.float32, use_kernel),
            t[:, 1:])
        loss.backward()
        grads.append({n: p.grad for n, p in _flat(params)})
    for name in grads[0]:
        scale = max(grads[1][name].abs().max().item(), 1e-6)
        torch.testing.assert_close(grads[0][name], grads[1][name],
                                   atol=1e-4 * scale, rtol=1e-4)


# -- the optimizer ------------------------------------------------------------

def test_schedule_matches_optax():
    ours = ttrain.warmup_cosine_decay_schedule(0.0, 3e-4, 20, 200,
                                               end_value=1.5e-5)
    theirs = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 20, 200,
                                                end_value=1.5e-5)
    for count in (0, 1, 7, 19, 20, 21, 100, 199, 200, 250):
        assert ours(count) == pytest.approx(float(theirs(count)), rel=1e-6,
                                            abs=1e-12), count


def _optax_chain(kind, lr, steps):
    if kind == "adamw":
        return optax.adamw(lr), ttrain.AdamW(lr)
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, 1, steps,
                                               end_value=lr * 0.05)
    return (optax.chain(optax.clip_by_global_norm(1.0),
                        optax.adamw(sched, weight_decay=0.01)),
            ttrain.train_model_chain(lr, 1, steps))


@pytest.mark.parametrize("kind", ["train_model_chain", "adamw"])
def test_optimizer_matches_optax_on_given_gradients(kind):
    """The same gradients (one step's norm far above the clip, one below)
    through optax and through the port's ``AdamW``.  The two evaluate the
    update formula in another order, so each step may round a few float32
    ulps apart (1e-6 absolute on O(1) params over 4 steps)."""
    rng = np.random.default_rng(5)
    p0 = {"a": rng.standard_normal((4, 8)).astype(np.float32),
          "b": {"c": rng.standard_normal(16).astype(np.float32)}}
    grads = [{"a": s * rng.standard_normal((4, 8)).astype(np.float32),
              "b": {"c": s * rng.standard_normal(16).astype(np.float32)}}
             for s in (5.0, 0.01, 1.0, 0.2)]
    tx, ours = _optax_chain(kind, 1e-2, 4)
    jp = jax.tree.map(jnp.asarray, p0)
    state = tx.init(jp)
    tp = _trainable(p0)
    tstate = ours.init(tp)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for name, leaf in _flat(tp):
            leaf.grad = torch.from_numpy(dict(_flat(g))[name].copy())
        ours.update(tstate)
    want = dict(_flat(_np_tree(jp)))
    for name, leaf in _flat(tp):
        np.testing.assert_allclose(leaf.detach().numpy(), want[name],
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kind", ["train_model_chain", "adamw"])
def test_trainer_steps_match_optax(kind):
    """Three ``Trainer`` steps (float32 params and activations, plain
    attention) against the same steps in JAX with optax, from one numpy
    init: losses and every param leaf.

    The forwards agree to float32 summation order (losses 1e-4
    relative), but Adam divides each gradient element by its own running
    magnitude, so an element whose gradients nearly cancel between steps
    turns a rounding difference into a visible one.  Each leaf's total
    update ``p_3 - p_0`` is therefore held to 1e-2 relative L2 error
    (measured: ~5e-4 with a constant lr, ~1e-5 with the chain); a wiring
    fault (gradients not zeroed, the schedule not stepped, a wrong leaf)
    moves it by O(1).  ``test_optimizer_matches_optax_on_given_gradients``
    holds the update formula itself to float32 rounding.
    """
    lr, steps = 1e-2, 3
    tx, ours = _optax_chain(kind, lr, steps)
    init = _init_np(seed=2)
    batches = [_tokens(2, 17, seed=s) for s in range(steps)]

    def jstep(p, s, tokens):
        def loss_fn(p_):
            logits = jmodel.forward_train(
                p_, tokens[:, :-1], cfg=TINY_TEST, act_dtype=jnp.float32)
            return jce(logits, tokens[:, 1:])

        loss, grads = jax.value_and_grad(loss_fn)(p)
        upd, s = tx.update(grads, s, p)
        return optax.apply_updates(p, upd), s, loss

    jp = jax.tree.map(jnp.asarray, init)
    js = tx.init(jp)
    jlosses = []
    for b in batches:
        jp, js, loss = jax.jit(jstep)(jp, js, jnp.asarray(b))
        jlosses.append(float(loss))

    trainer = ttrain.Trainer(
        TINY_TEST, tx=ours, device="cpu", act_dtype=torch.float32,
        init=tweights.from_numpy_params(init, device="cpu"))
    losses = [trainer.train_step(b) for b in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    want = dict(_flat(_np_tree(jp)))
    start = dict(_flat(init))
    for name, leaf in _flat(trainer.params):
        got = leaf.detach().numpy()
        moved = np.linalg.norm(want[name] - start[name])
        assert moved > 0, name
        assert np.linalg.norm(got - want[name]) <= 1e-2 * moved, name


def test_train_step_async_returns_the_loss_on_the_device():
    trainer = ttrain.Trainer(TINY_TEST, device="cpu", seed=0)
    loss = trainer.train_step_async(_tokens(2, 9))
    assert isinstance(loss, torch.Tensor) and loss.ndim == 0
    assert not loss.requires_grad and trainer.step_count == 1
    assert all(p.requires_grad and p.is_leaf
               for _, p in _flat(trainer.params))


def test_trainer_device_rules():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttrain.Trainer(TINY_TEST)
    with pytest.raises(NotImplementedError, match="multi-device"):
        ttrain.Trainer(TINY_TEST, mesh=object(), device="cpu")


# -- checkpoints --------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_npz_interchange_with_jax_bit_for_bit(tmp_path, dtype):
    """The port's ``save_npz`` read by the JAX ``load_npz``, and the JAX
    ``save_npz`` read by the port's ``load_npz``: the same keys and bits."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = jweights.init_params(TINY_TEST, seed=3, dtype=jdt)
    tp = tweights.from_numpy_params(_np_tree(jp), device="cpu")
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tweights.save_npz(ours, tp)
    jweights.save_npz(theirs, jp)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    for path in (ours, theirs):
        back_j = dict(_flat(_np_tree(jweights.load_npz(path))))
        back_t = dict(_flat(tweights.load_npz(path, device="cpu")))
        for name, want in _flat(_np_tree(jp)):
            bits = np.uint16 if dtype == "bfloat16" else np.uint32
            np.testing.assert_array_equal(back_j[name].view(bits),
                                          want.view(bits))
            got = back_t[name]
            ibits = torch.int16 if dtype == "bfloat16" else torch.int32
            np.testing.assert_array_equal(
                got.view(ibits).numpy().view(bits), want.view(bits))


def test_load_or_init_matches_jax_choices(tmp_path):
    """Fault 2: a ``.npz`` loads; a directory is an orbax checkpoint in both
    packages (restored bit for bit against the JAX ``load_or_init``; an
    empty one raises FileNotFoundError in both); a missing path or None
    gives random weights from the seed, as the JAX ``load_or_init`` falls
    back to ``init_params``."""
    path = str(tmp_path / "tiny.npz")
    jweights.save_npz(path, jweights.init_params(TINY_TEST, seed=4))
    loaded = tweights.load_or_init(TINY_TEST, path, device="cpu")
    want = tweights.load_npz(path, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(_flat(loaded), _flat(want)))
    ckpt = str(tmp_path / "ckpt")
    jweights.save_checkpoint(ckpt, jweights.init_params(TINY_TEST, seed=4))
    got = dict(_flat(tweights.load_or_init(TINY_TEST, ckpt, device="cpu")))
    jgot = dict(_flat(_np_tree(jweights.load_or_init(TINY_TEST, ckpt))))
    assert set(got) == set(jgot)
    for name, t in got.items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy().view(np.uint16),
            jgot[name].view(np.uint16))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tweights.load_or_init(TINY_TEST, str(empty), device="cpu")
    with pytest.raises(FileNotFoundError):
        jweights.load_or_init(TINY_TEST, str(empty))
    fresh = tweights.init_params(TINY_TEST, device="cpu", seed=7)
    for spec in (str(tmp_path / "missing.npz"), None, ""):
        got = tweights.load_or_init(TINY_TEST, spec, 7, device="cpu")
        assert all(torch.equal(a, b) for (_, a), (_, b)
                   in zip(_flat(got), _flat(fresh)))
        # the JAX package makes the same choice: random init, no error
        jgot = jweights.load_or_init(TINY_TEST, spec, 7)
        assert set(jgot) == set(got)


def test_engine_boots_through_load_or_init(tmp_path):
    tiny = dict(model="dv-tiny-test", tokenizer="byte", device="cpu",
                max_slots=2, num_pages=16, page_size=16,
                max_pages_per_seq=4, json_dfa=False)
    eng = LLMEngine(EngineConfig(
        **tiny, checkpoint_dir=str(tmp_path / "missing.npz")))
    eng.shutdown()
    ckpt = str(tmp_path / "ckpt")
    jparams = jweights.init_params(TINY_TEST, seed=2)
    jweights.save_checkpoint(ckpt, jparams)
    eng = LLMEngine(EngineConfig(**tiny, checkpoint_dir=ckpt))
    try:
        got = dict(_flat(eng.runner.params))
        for name, want in _flat(_np_tree(jparams)):
            np.testing.assert_array_equal(
                got[name].view(torch.int16).numpy().view(np.uint16),
                want.view(np.uint16))
    finally:
        eng.shutdown()


# -- EngineConfig -------------------------------------------------------------

def _server_kwargs():
    """What ``deepvision_tpu/web/server.py:253-283`` passes, at the
    server's default settings."""
    return dict(
        model="dv-tiny-test", tokenizer="byte", checkpoint_dir=None,
        max_slots=8, num_pages=1024, page_size=64, max_pages_per_seq=32,
        tp=1, decode_steps_per_call=8, pipeline_decode=False,
        max_chained_decodes=4, chunked_prefill=True, prefill_chunk_size=256,
        quantize="", kv_quantize="", fuse_projections=False, warmup=False)


def test_engine_config_takes_the_servers_kwargs():
    """Fault 3: the port's ``EngineConfig`` has every field of the JAX
    one, with the same defaults, and takes the app's kwargs."""
    ours = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JEngineConfig)}
    assert set(theirs) <= set(ours), set(theirs) - set(ours)
    for name, default in theirs.items():
        assert ours[name] == default, name
    cfg = EngineConfig(**_server_kwargs(), device="cpu")
    jcfg = JEngineConfig(**_server_kwargs())
    for name in theirs:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    eng = LLMEngine(dataclasses.replace(cfg, num_pages=64, json_dfa=False))
    eng.shutdown()


@pytest.mark.parametrize("setting, why", [
    ({"vocab_sharded": True}, "multi-device"),
    ({"vocab_sharded": False}, "multi-device"),
    ({"warmup_buckets": (256, 2048)}, "batch_buckets"),
])
def test_unported_fields_raise(setting, why):
    """``warmup_buckets`` still raises.  ``vocab_sharded`` is ported with
    tensor-parallel serving (the name is the one this test had while it
    raised too): at the server's ``tp=1`` it changes nothing, as in the
    JAX engine, whose plan exists only under ``tp > 1``."""
    cfg = EngineConfig(**{**_server_kwargs(), "num_pages": 64},
                       device="cpu", **setting)
    if why == "multi-device":
        eng = LLMEngine(dataclasses.replace(cfg, json_dfa=False))
        assert eng.plan is None
        eng.shutdown()
        return
    with pytest.raises(NotImplementedError, match=why):
        LLMEngine(cfg)


def test_interpret_is_accepted_and_changes_nothing():
    for value in (None, True, False):
        eng = LLMEngine(EngineConfig(**{**_server_kwargs(), "num_pages": 64},
                                     device="cpu", json_dfa=False,
                                     interpret=value))
        eng.shutdown()


# -- the CLI ------------------------------------------------------------------

def _corpus(path, n_docs=40):
    rng = np.random.default_rng(0)
    topics = ["库存系统", "会员体系", "招投标", "用户研究"]
    docs = [f"访谈主题：{topics[i % 4]}\n问题{i}：请说明现状。\n回答："
            + "、".join(rng.choice(["目标", "预算", "时间", "风险", "流程"],
                                   size=4)) for i in range(n_docs)]
    path.write_text("<|eot|>".join(docs), encoding="utf-8")


def test_cli_trains_saves_resumes_and_serves(tmp_path, capsys):
    """``python -m deepvision_tpu_torch.train_model`` on a tiny corpus: 3
    steps with ``--save-every 2`` write the checkpoint and its ``.best``,
    a resume continues from it, and the checkpoint serves one
    ``generate_text`` on the CPU (and loads in the JAX package)."""
    corpus = tmp_path / "corpus.txt"
    _corpus(corpus)
    out = str(tmp_path / "ckpt" / "tiny.npz")
    common = ["--model", "dv-tiny-test", "--tokenizer", "byte",
              "--corpus", str(corpus), "--out", out, "--batch", "2",
              "--seq", "32", "--log-every", "1", "--val-frac", "0.2",
              "--lr", "1e-3", "--device", "cpu", "--early-stop", "5"]
    train_model.main(common + ["--steps", "3", "--save-every", "2"])
    log = capsys.readouterr().out
    assert "step 3/3 loss=" in log and "step 2: val_loss=" in log
    assert "[best]" in log and "--- sample ---" in log
    assert os.path.isfile(out) and os.path.isfile(out + ".best")
    jp = jweights.load_npz(out)
    assert jp["blocks"]["wq"].dtype == jnp.bfloat16

    train_model.main(common + ["--steps", "1", "--save-every", "0",
                               "--resume", out])
    assert f"resumed params from {out}" in capsys.readouterr().out

    eng = LLMEngine(EngineConfig(model="dv-tiny-test", tokenizer="byte",
                                 checkpoint_dir=out, device="cpu",
                                 max_slots=2, num_pages=32, page_size=16,
                                 max_pages_per_seq=8, json_dfa=False))
    try:
        text, meta = eng.generate_text("访谈主题：", max_tokens=8,
                                       temperature=0.0, timeout=120)
        assert meta["completion_tokens"] >= 1 and isinstance(text, str)
    finally:
        eng.shutdown()


def test_cli_pipeline_parallel_is_not_ported():
    with pytest.raises(NotImplementedError, match="multi-device"):
        train_model.main(["--pp", "2", "--device", "cpu"])
