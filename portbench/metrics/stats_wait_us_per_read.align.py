"""stats_wait_us_per_read.align: the span `wait.stats` of align/driver.py,
the main thread's waits on the stats worker (the queue's put and the
final join), on the host clock without a synchronise (utils/spans.py),
summed over the window's samples, in us a read; nothing where the
program has no such span."""

STAGE = "wait.stats"


def read(ctx):
    r = ctx["readings"]
    t = r.get("stage_t", {}).get(STAGE)
    if t is None or not r.get("reads"):
        return None
    return t / r["reads"] * 1e6
