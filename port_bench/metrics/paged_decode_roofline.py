"""``paged_decode_roofline``: kernel #1 (``csrc/paged_decode.cu`` and its
split merge, ``dv_decode_merge_kernel``) over the decode calls of the
traced slice: the byte bound (3.35 TB/s) of the tokens those calls
generated for requests, over the profiler's device time of the kernels.
A generated token at context length c (its own row included) reads its
context's K and V once a layer, writes its own K/V row and reads q and
writes the output, all bf16.  Counted from the requests' lengths and
budgets: idle slots and steps past a request's end count nothing."""

HBM_BYTES_S = 3.35e12
PATTERNS = ("paged_decode_kernel", "dv_decode_merge_kernel")


def token_bytes(cfg: dict, c: int) -> float:
    H, KV, HD, L = (cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                    cfg["n_layers"])
    return L * 2 * (2 * KV * HD * c + 2 * KV * HD + 2 * H * HD)


def read(run: dict):
    t = run["trace"]
    if not t or not t.get("decode_calls"):
        return None
    secs = sum(s for k, s in t["kernel_s"].items()
               if any(p in k for p in PATTERNS))
    if secs <= 0:
        return None
    cfg = run["config"]
    nbytes = 0.0
    for lens, budgets, K in t["decode_calls"]:
        for c, b in zip(lens, budgets):
            if c > 1:
                nbytes += sum(token_bytes(cfg, int(c) + j)
                              for j in range(min(K, int(b))))
    return 100.0 * nbytes / HBM_BYTES_S / secs
