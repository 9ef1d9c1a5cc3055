"""search_redo_wait_us_per_read.align: the span `search.redo_wait` of
ops/batch_search.py, the main thread's wait for the exact host redo of
the reads the device search handed back, inside `search`, on the host
clock without a synchronise (utils/spans.py), summed over the window's
samples, in us a read; nothing where the program has no such span."""

STAGE = "search.redo_wait"


def read(ctx):
    r = ctx["readings"]
    t = r.get("stage_t", {}).get(STAGE)
    if t is None or not r.get("reads"):
        return None
    return t / r["reads"] * 1e6
