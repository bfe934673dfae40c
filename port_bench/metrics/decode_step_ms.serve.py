"""``decode_step_ms.serve``: the scheduler's wall time in decode calls over
its decode steps (``LLMEngine.stats()`` ``decode_time_s`` /
``decode_steps``, deltas across the window; a K-step call counts K)."""


def read(run: dict):
    c = run["counters"]
    if not c["decode_steps"]:
        return None
    return 1e3 * c["decode_time_s"] / c["decode_steps"]
