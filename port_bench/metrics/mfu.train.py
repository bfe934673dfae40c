"""``mfu.train``: the training window's model FLOPs over the window's time,
as a share of one H100's dense bf16 peak (989 TFLOP/s, NVIDIA's data sheet
for the SXM part at 700 W).  Model FLOPs a step: 6 x matmul parameters x
tokens (the blocks' projections and the LM head; the embedding lookup is
free) plus causal attention, 12 x heads x head_dim x S(S+1)/2 a layer and
sequence (forward 2 matmuls, backward 4); recomputation is not counted."""

PEAK_FLOP_S = 989e12


def step_flops(cfg: dict, batch: int, seq: int) -> float:
    D, F, HD = cfg["d_model"], cfg["d_ff"], cfg["head_dim"]
    H, KV, L, V = (cfg["n_heads"], cfg["n_kv_heads"], cfg["n_layers"],
                   cfg["vocab_size"])
    matmul_params = L * (D * H * HD * 2 + 2 * D * KV * HD + 3 * D * F) + D * V
    attention = L * 12 * H * HD * seq * (seq + 1) / 2
    return batch * (6 * matmul_params * seq + attention)


def read(run: dict):
    c = run["counters"]
    if not c.get("steps"):
        return None
    flops = step_flops(run["config"], c["batch"], c["seq"]) * c["steps"]
    return 100.0 * flops / c["window_s"] / PEAK_FLOP_S
