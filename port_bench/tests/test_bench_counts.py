"""The metric readers' arithmetic on a small shape, against values worked
out by hand."""

import os

import pytest

from port_bench import harness

CFG = {"d_model": 4, "d_ff": 8, "n_heads": 2, "n_kv_heads": 1,
       "head_dim": 2, "n_layers": 1, "vocab_size": 10}
# matmul params: wq + wo 4*4*2, wk + wv 2*4*2, three MLP 3*4*8, head 4*10
PARAMS = 32 + 16 + 96 + 40


def _reader(name):
    return harness.load_module(
        os.path.join(harness.BENCH_DIR, "metrics", name + ".py"),
        "counts_" + name.replace(".", "_"))


def test_train_flops():
    m = _reader("mfu.train")
    assert PARAMS == 184
    # 6 x 184 x 2 tokens + 12 x H x HD x S(S+1)/2 = 2208 + 144
    assert m.step_flops(CFG, 1, 2) == 2352
    run = {"config": CFG, "counters": {"steps": 10, "batch": 1, "seq": 2,
                                       "window_s": 1e-9}}
    assert m.read(run) == pytest.approx(100 * 23520 / 1e-9 / 989e12)


def test_serve_flops():
    m = _reader("mfu.serve")
    # 3 tokens through the model: 2 x 184 x 3 + 4 x H x HD x (1 + 2 + 3)
    assert m.request_flops(CFG, 2, 2) == 1200


def test_flash_bounds():
    fwd, bwd = _reader("flash_fwd_roofline"), _reader("flash_bwd_roofline")
    # forward: 48 FLOPs; q, out 2 x 8 and k, v 2 x 4 bf16 values, lse 4
    # float32: 64 bytes, which bound it
    assert fwd.call_bound_s(CFG, 1, 2) == pytest.approx(64 / 3.35e12)
    # backward: 120 FLOPs; q, dout, dq 3 x 8 and k, v, dk, dv 4 x 4 bf16,
    # lse and delta 2 x 4 float32: 112 bytes
    assert bwd.call_bound_s(CFG, 1, 2) == pytest.approx(112 / 3.35e12)
    run = {"config": CFG, "counters": {"batch": 1, "seq": 2},
           "trace": {"kernel_n": {"flash_bwd_dq_tc_kernel<2>": 3,
                                  "flash_bwd_dkv_tc_kernel<2>": 3},
                     "kernel_s": {"flash_bwd_dq_tc_kernel<2>": 1e-9,
                                  "flash_bwd_dkv_tc_kernel<2>": 2e-9}}}
    assert bwd.read(run) == pytest.approx(100 * 3 * 112 / 3.35e12 / 3e-9)


def test_decode_bytes():
    m = _reader("paged_decode_roofline")
    # a token at context 3: K and V of 3 rows, its own row, q and out
    assert m.token_bytes(CFG, 3) == 2 * (12 + 4 + 8)
    # slot 0 idle; slot 1 has 2 tokens of budget left in a 4-step call
    calls = [([1, 3], [5, 2], 4)]
    run = {"config": CFG, "trace": {"decode_calls": calls, "kernel_s": {
        "paged_decode_kernel<bf16>": 0.5e-9, "dv_decode_merge_kernel": 0.5e-9,
        "other": 7.0}}}
    assert m.read(run) == pytest.approx(100 * (48 + 56) / 3.35e12 / 1e-9)


def test_busy_union_and_idle():
    busy, gaps = harness.busy_and_gaps([(0, 2, "a"), (1, 3, "b"),
                                        (5, 6, "c")])
    assert busy == 4 and gaps == [(2, 3, 5)]
    run = {"trace": {"busy_s": 1.5, "window_s": 2.0}}
    assert _reader("device_idle.serve").read(run) == pytest.approx(25.0)


def test_counters():
    run = {"counters": {"decode_steps": 40, "decode_time_s": 0.5,
                        "requests": [{"ttft_ms": float(v)}
                                     for v in range(1, 21)],
                        "prefix_cache": True, "tokens_saved": 30,
                        "prompt_tokens_submitted": 120,
                        "window_peak_bytes": 3 * 2 ** 30}}
    assert _reader("decode_step_ms.serve").read(run) == 12.5
    # the inclusive 95th percentile of 1..20
    assert _reader("ttft_p95_ms.serve").read(run) == pytest.approx(19.05)
    assert _reader("prefix_hit_share.serve").read(run) == 25.0
    assert _reader("peak_mem_gib.train").read(run) == 3.0
