"""``flash_fwd_roofline``: kernel #2 (``csrc/flash_fwd.cu``) in the traced
training steps: the least time the H100 needs for its calls (the larger of
operations over 989 TFLOP/s bf16 and bytes over 3.35 TB/s) over the
profiler's device time of the kernels named ``flash_fwd``.  A call is one
layer's causal forward of the whole batch: 4 x H x HD x S(S+1)/2 FLOPs a
row; q, k, v read and the output written once in bf16, the row
log-sum-exp written in float32."""

PEAK_FLOP_S = 989e12
HBM_BYTES_S = 3.35e12
PATTERN = "flash_fwd"


def call_bound_s(cfg: dict, B: int, S: int) -> float:
    H, KV, HD = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    flops = B * 4 * H * HD * S * (S + 1) / 2
    nbytes = 2 * (2 * B * H * S * HD + 2 * B * KV * S * HD) + 4 * B * H * S
    return max(flops / PEAK_FLOP_S, nbytes / HBM_BYTES_S)


def read(run: dict):
    t = run["trace"]
    if not t:
        return None
    calls = sum(n for k, n in t["kernel_n"].items() if PATTERN in k)
    secs = sum(s for k, s in t["kernel_s"].items() if PATTERN in k)
    if not calls or secs <= 0:
        return None
    c = run["counters"]
    return 100.0 * calls * call_bound_s(run["config"], c["batch"],
                                        c["seq"]) / secs
