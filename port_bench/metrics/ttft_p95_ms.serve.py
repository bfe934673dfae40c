"""``ttft_p95_ms.serve``: the 95th percentile of the time to the first
token (the engine's ``queue_wait_ms + prefill_ms``) of every request that
finished in the window."""

import statistics


def read(run: dict):
    vals = [r["ttft_ms"] for r in run["counters"]["requests"]]
    if len(vals) < 2:
        return None
    return statistics.quantiles(vals, n=20, method="inclusive")[18]
