"""``port_bench.spans`` on planted profiler events: kernels put down to the
span whose host interval holds their launch, on any thread and whenever
they run on the device; nested spans; idle gaps by the span open at their
middle; kernels outside every span under ``"(none)"``."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from port_bench import spans

MAIN, AUTOGRAD = 1, 2


def _ev(name, start, end, *, device="CPU", id=0, thread=MAIN,
        annotation=False):
    return SimpleNamespace(
        name=name, device_type=getattr(DeviceType, device),
        time_range=SimpleNamespace(start=start, end=end), id=id,
        thread=thread, is_user_annotation=annotation)


def _span(name, start, end, thread=MAIN):
    return [_ev(name, start, end, thread=thread, annotation=True),
            # the range's mirror on the device's timeline is no kernel
            _ev(name, start, end + 5, device="CUDA", annotation=True)]


def _launch(op_id, cupti_id, t, kernel, k_start, k_end, thread=MAIN):
    """A torch op at ``t`` on ``thread``, its runtime call, and the kernel
    it launched, running on the device from ``k_start`` to ``k_end``."""
    return [_ev("aten::mm", t, t + 3, id=op_id, thread=thread),
            _ev("cudaLaunchKernel", t + 1, t + 2, id=cupti_id,
                thread=thread),
            _ev(kernel, k_start, k_end, device="CUDA", id=cupti_id)]


def _slice():
    """train.step [0, 100] holds train.forward [10, 40] (train.blocks [15,
    35] inside) and train.backward [50, 80]; sched.step [200, 260] holds
    sched.decode [205, 240]."""
    return (_span("train.step", 0, 100) + _span("train.forward", 10, 40)
            + _span("train.blocks", 15, 35)
            + _span("train.backward", 50, 80)
            # launched in train.blocks, runs after train.forward closed
            + _launch(1, 101, 16, "gemm_fwd", 30, 45)
            # launched by autograd's thread while backward() blocks
            + _launch(2, 102, 59, "gemm_bwd", 62, 70, thread=AUTOGRAD)
            # launched between the steps; a torch op in train.backward
            # whose own id is the copy's correlation id is no launch
            + _launch(3, 103, 110, "copy", 112, 115)
            + [_ev("aten::add", 55, 56, id=103)]
            + _span("sched.step", 200, 260) + _span("sched.decode", 205, 240)
            + _launch(4, 104, 210, "decode", 215, 220))


@pytest.fixture
def account():
    return spans.account(_slice())


def test_kernel_run_after_its_span_closed_counts_to_it(account):
    s = account["spans"]
    assert s["train.forward"]["device_s"] == pytest.approx(15e-6)
    assert s["train.blocks"]["device_s"] == pytest.approx(15e-6)


def test_launch_on_another_thread_counts(account):
    assert account["spans"]["train.backward"]["kernel_n"] == 1
    assert account["spans"]["train.backward"]["device_s"] == \
        pytest.approx(8e-6)


def test_nested_spans_give_the_kernel_to_the_innermost(account):
    s = account["spans"]
    assert s["train.blocks"]["device_self_s"] == pytest.approx(15e-6)
    assert s["train.forward"]["device_self_s"] == 0.0
    assert s["train.step"]["device_self_s"] == 0.0
    # each enclosing span's device time holds its children's
    assert s["train.step"]["kernel_n"] == 2
    assert s["train.step"]["device_s"] == pytest.approx(23e-6)


def test_kernels_outside_every_span_go_to_none(account):
    none = account["spans"][spans.NONE]
    assert none["kernel_n"] == 1
    assert none["device_s"] == pytest.approx(3e-6)


def test_gaps_by_the_span_open_at_their_middle(account):
    idle = account["idle_by_span"]
    # 45 -> 62 (middle 53.5, in train.backward); 70 -> 112 (middle 91, in
    # train.step alone); 115 -> 215 (middle 165, in no span)
    assert idle["train.backward"] == pytest.approx(17e-6)
    assert idle["train.step"] == pytest.approx(42e-6)
    assert idle[spans.NONE] == pytest.approx(100e-6)
    assert set(idle) == {"train.backward", "train.step", spans.NONE}


def test_host_times(account):
    s = account["spans"]
    assert s["train.step"]["n"] == 1
    assert s["train.step"]["host_s"] == pytest.approx(100e-6)
    assert s["train.step"]["host_self_s"] == pytest.approx(40e-6)
    assert s["train.forward"]["host_self_s"] == pytest.approx(10e-6)
    assert s["sched.step"]["host_self_s"] == pytest.approx(25e-6)
    assert s["sched.decode"]["device_s"] == pytest.approx(5e-6)


def test_device_annotations_are_no_kernels():
    ks = spans.kernels(_slice())
    assert sorted(k.name for k in ks) == ["copy", "decode", "gemm_bwd",
                                          "gemm_fwd"]


def test_kernel_without_its_launch_goes_to_none():
    events = [e for e in _slice() if not (e.name == "cudaLaunchKernel"
                                          and e.id == 101)]
    s = spans.account(events)["spans"]
    assert s["train.blocks"]["kernel_n"] == 0
    assert s[spans.NONE]["kernel_n"] == 2


def test_step_ms(account):
    s = account["spans"]
    assert spans.step_ms(s, ("train.forward",), 1) == pytest.approx(0.015)
    assert spans.step_ms(s, ("train.backward", "train.forward"), 2) == \
        pytest.approx(0.0115)
    assert spans.step_ms(s, ("train.clip",), 1) is None
