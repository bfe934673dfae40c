"""``prefix_hit_share.serve``: prompt tokens the prefix cache saved
(``PrefixCache.stats()`` ``tokens_saved``, delta across the window) over
the prompt tokens submitted in the window."""


def read(run: dict):
    c = run["counters"]
    if not c["prefix_cache"] or not c["prompt_tokens_submitted"]:
        return None
    return 100.0 * c["tokens_saved"] / c["prompt_tokens_submitted"]
