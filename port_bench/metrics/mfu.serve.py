"""``mfu.serve``: the model FLOPs of every request finished in the serving
window, over the window's time, as a share of one H100's dense bf16 peak
(989 TFLOP/s, NVIDIA's data sheet for the SXM part at 700 W).  A request
of n = prompt + output tokens runs n - 1 tokens through the model (the
last output token is never fed back): 2 x matmul parameters a token, plus
attention 4 x heads x head_dim x (p + 1) a layer for the token at position
p.  Counted from the requests' lengths, whatever the prefix cache saved."""

PEAK_FLOP_S = 989e12


def request_flops(cfg: dict, prompt: int, output: int) -> float:
    D, F, HD = cfg["d_model"], cfg["d_ff"], cfg["head_dim"]
    H, KV, L, V = (cfg["n_heads"], cfg["n_kv_heads"], cfg["n_layers"],
                   cfg["vocab_size"])
    matmul_params = L * (D * H * HD * 2 + 2 * D * KV * HD + 3 * D * F) + D * V
    n = prompt + output - 1
    return 2 * matmul_params * n + 4 * L * H * HD * n * (n + 1) / 2


def read(run: dict):
    c = run["counters"]
    if not c["requests"]:
        return None
    flops = sum(request_flops(run["config"], r["prompt"], r["output"])
                for r in c["requests"])
    return 100.0 * flops / c["window_s"] / PEAK_FLOP_S
