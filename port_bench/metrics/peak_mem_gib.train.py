"""``peak_mem_gib.train``: ``torch.cuda.max_memory_allocated()`` over the
training window (the peak is reset when the window opens), in GiB."""


def read(run: dict):
    peak = run["counters"].get("window_peak_bytes")
    return peak / 2 ** 30 if peak else None
