"""The port's spans (``engine/spans.py``): a shared no-op with no profiler
running, the phases of a ``Trainer`` step and of a scheduler step under a
CPU ``torch.profiler``, and the scheduler's ``decode_time_s`` /
``readback_wait_s``, which share their ``with`` statement with a span."""

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepvision_tpu_torch.engine import spans
from deepvision_tpu_torch.engine.config import TINY_TEST
from deepvision_tpu_torch.engine.engine import EngineConfig, LLMEngine
from deepvision_tpu_torch.engine.scheduler import GenerationRequest
from deepvision_tpu_torch.engine.training import Trainer, train_model_chain

torch.set_num_threads(2)

ENGINE = dict(model="dv-tiny-test", tokenizer="byte", max_slots=4,
              num_pages=128, page_size=16, max_pages_per_seq=8,
              decode_steps_per_call=4, max_chained_decodes=3, seed=0,
              device="cpu")
PROMPTS = ["访谈主题：库存系统。请生成下一个问题：",
           "report draft about constraints"]
TRAIN_ORDER = ["train.step", "train.zero_grad", "train.forward",
               "train.embed", "train.blocks", "train.head", "train.loss",
               "train.backward", "train.clip", "train.optimizer"]


def _trainer():
    return Trainer(TINY_TEST, tx=train_model_chain(1e-3, 2, 10), seed=0,
                   device="cpu")


def _batch():
    g = torch.Generator().manual_seed(0)
    return torch.randint(0, TINY_TEST.vocab_size, (2, 33), generator=g)


def _ranges(prof, prefix):
    """The profiled ranges named ``prefix...`` as (start, end, name), in
    order of start."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.name.startswith(prefix))


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _named(ranges, name):
    return [r for r in ranges if r[2] == name]


def _step_by_hand(eng, max_tokens, n=1):
    """``n`` requests served by ``step()`` calls on this thread (the
    profiler records the thread that starts it)."""
    sched = eng.scheduler
    reqs = [sched.submit(GenerationRequest(
        eng.tokenizer.encode(PROMPTS[i % len(PROMPTS)]),
        max_tokens=max_tokens, temperature=0.0,
        stop_token_ids=[eng.tokenizer.eos_id])) for i in range(n)]
    for _ in range(500):
        sched.step()
        if all(r.wait(0) is not None for r in reqs):
            break
    results = [r.wait(0) for r in reqs]
    assert all(r is not None and r.ok for r in results), results
    return results


def test_no_profiler_no_range(monkeypatch):
    entered = []

    def refuse(*args, **kwargs):
        entered.append(args)
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not spans.recording()
    assert spans.span("train.step", step=1) is spans.span("sched.step")
    assert math.isfinite(_trainer().train_step(_batch()))
    eng = LLMEngine(EngineConfig(**ENGINE, pipeline_decode=True))
    try:
        text, meta = eng.generate_text(PROMPTS[0], max_tokens=23,
                                       temperature=0.0, timeout=300)
    finally:
        eng.shutdown()
    assert meta["completion_tokens"] > 0
    assert eng.scheduler.decode_time_s > 0.0
    assert 0.0 < eng.scheduler.readback_wait_s < eng.scheduler.decode_time_s
    assert not entered


def test_trainer_step_spans():
    trainer = _trainer()
    batch = _batch()
    trainer.train_step(batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(batch)
    r = _ranges(prof, "train.")
    assert [x[2] for x in r] == TRAIN_ORDER
    by = {x[2]: x for x in r}
    for name in TRAIN_ORDER[1:]:
        assert _inside(by[name], by["train.step"]), name
    for name in ("train.embed", "train.blocks", "train.head"):
        assert _inside(by[name], by["train.forward"]), name
    phases = ["train.zero_grad", "train.forward", "train.loss",
              "train.backward", "train.clip", "train.optimizer"]
    for a, b in zip(phases, phases[1:]):
        assert by[a][1] <= by[b][0], (a, b)


def test_scheduler_step_spans():
    eng = LLMEngine(EngineConfig(**ENGINE))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step_by_hand(eng, max_tokens=9)
    r = _ranges(prof, "sched.")
    steps = _named(r, "sched.step")
    assert steps
    for name in ("sched.admit", "sched.prefill_chunk", "sched.gather",
                 "sched.decode", "sched.emit"):
        found = _named(r, name)
        assert found, name
        assert all(any(_inside(x, s) for s in steps) for x in found), name
    assert len(_named(r, "sched.admit")) == len(steps)
    # every emit follows a decode of its own step
    for e in _named(r, "sched.emit"):
        step = next(s for s in steps if _inside(e, s))
        assert any(_inside(d, step) and d[1] <= e[0]
                   for d in _named(r, "sched.decode"))
    assert not _named(r, "sched.readback")   # unpipelined: no readback


@pytest.mark.parametrize("pipeline", [False, True])
def test_counters_time_their_spans(pipeline):
    """``decode_time_s`` adds up the ``sched.decode`` intervals and
    ``readback_wait_s`` the ``sched.readback`` ones (each counter's clock
    runs inside its range); the readbacks of a chain lie in its decode."""
    eng = LLMEngine(EngineConfig(**ENGINE, pipeline_decode=pipeline))
    sched = eng.scheduler
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step_by_hand(eng, max_tokens=23, n=2)
    r = _ranges(prof, "sched.")
    for counter, name in (("decode_time_s", "sched.decode"),
                          ("readback_wait_s", "sched.readback")):
        found = _named(r, name)
        total = sum(e - s for s, e, _ in found) / 1e6
        value = getattr(sched, counter)
        assert value <= total + 1e-4, (counter, value, total)
        assert value >= total - 2e-3 * len(found) - 0.05 * total, (
            counter, value, total)
    decodes = _named(r, "sched.decode")
    readbacks = _named(r, "sched.readback")
    assert bool(readbacks) == pipeline
    assert (sched.readback_wait_s > 0.0) == pipeline
    for x in readbacks:
        assert any(_inside(x, d) for d in decodes)
