"""``flash_bwd_roofline``: kernels #4 and #5 (``csrc/flash_bwd.cu``, dQ and
dK/dV) together in the traced training steps: the least time the H100
needs for one layer's causal attention backward (the larger of operations
over 989 TFLOP/s bf16 and bytes over 3.35 TB/s) times the dQ kernels'
count, over the profiler's device time of both kernels.  The backward
needs five matmuls (the scores again, dP, dV, dQ, dK): 10 x H x HD x
S(S+1)/2 FLOPs a row; what the two kernels compute twice is not counted.
Bytes: q, k, v, dout in bf16 and the row log-sum-exp and delta in float32
read once, dq, dk, dv written once in bf16."""

PEAK_FLOP_S = 989e12
HBM_BYTES_S = 3.35e12
DQ, DKV = "flash_bwd_dq", "flash_bwd_dkv"


def call_bound_s(cfg: dict, B: int, S: int) -> float:
    H, KV, HD = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    flops = B * 10 * H * HD * S * (S + 1) / 2
    q_like, kv_like = B * H * S * HD, B * KV * S * HD
    nbytes = 2 * (3 * q_like + 4 * kv_like) + 2 * 4 * B * H * S
    return max(flops / PEAK_FLOP_S, nbytes / HBM_BYTES_S)


def read(run: dict):
    t = run["trace"]
    if not t:
        return None
    calls = sum(n for k, n in t["kernel_n"].items() if DQ in k)
    secs = sum(s for k, s in t["kernel_s"].items() if DQ in k or DKV in k)
    if not calls or secs <= 0:
        return None
    c = run["counters"]
    return 100.0 * calls * call_bound_s(run["config"], c["batch"],
                                        c["seq"]) / secs
