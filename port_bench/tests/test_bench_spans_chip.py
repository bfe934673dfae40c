"""On the card: a small traced ``Trainer``'s spans and the device trace share
one clock, nearly all of its device time falls in a span, and the spans
change no kernel.  Skips without a card.

    python3 -m pytest port_bench/tests/test_bench_spans_chip.py -q
"""

from collections import Counter

import pytest
import torch

from port_bench import spans
from port_bench.tests import tiny


@pytest.fixture(scope="module")
def trainer():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from deepvision_tpu_torch.engine.config import ModelConfig
    from deepvision_tpu_torch.engine.training import (
        Trainer,
        train_model_chain,
    )

    cfg = {k: v for k, v in tiny.TINY_MODEL.items() if k != "name"}
    t = Trainer(ModelConfig(name="dv-tiny", **cfg),
                tx=train_model_chain(3e-4, 2, 100),
                param_dtype=torch.float32, use_kernel=True, device="cuda")
    g = torch.Generator().manual_seed(0)
    batch = torch.randint(0, cfg["vocab_size"], (4, 513), generator=g,
                          dtype=torch.int32).cuda()
    for _ in range(2):
        t.train_step_async(batch)
    return t, batch


def _trace(trainer, steps=2):
    from torch.profiler import ProfilerActivity, profile

    t, batch = trainer
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            t.train_step_async(batch)
        torch.cuda.synchronize()
    return list(prof.events())


@pytest.mark.cuda
def test_kernels_start_after_their_launch(trainer):
    _, tied = spans.attribute(_trace(trainer))
    in_train = [(k, t) for k, t, names, _ in tied
                if any(n.startswith("train.") for n in names)]
    assert len(in_train) > 100
    late = [k.name for k, t in in_train if k.time_range.start < t]
    assert not late, late[:5]


@pytest.mark.cuda
def test_nearly_all_device_time_in_spans(trainer):
    events = _trace(trainer)
    acc = spans.account(events)["spans"]
    busy = spans.harness.busy_and_gaps(
        [(k.time_range.start, k.time_range.end)
         for k in spans.kernels(events)])[0] / 1e6
    assert acc["train.step"]["n"] == 2
    none = acc.get(spans.NONE, {"device_s": 0.0})["device_s"]
    assert none < 0.01 * busy, (none, busy)


@pytest.mark.cuda
def test_spans_change_no_kernel(trainer, monkeypatch):
    from deepvision_tpu_torch.engine import spans as program

    on = Counter(k.name for k in spans.kernels(_trace(trainer)))
    monkeypatch.setattr(program, "recording", lambda: False)
    events = _trace(trainer)
    assert not spans.program_spans(events)
    assert Counter(k.name for k in spans.kernels(events)) == on
