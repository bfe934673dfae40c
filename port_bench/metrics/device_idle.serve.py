"""Share of the traced slice in which no kernel or copy ran on the device
(the union of the profiler's device intervals against the slice's host
time)."""


def read(run: dict):
    t = run["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
