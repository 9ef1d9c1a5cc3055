"""wait_prefetch_us_per_read.wgs: the span `wait.prefetch` of
align/driver.py, the main thread's join of the prefetch thread that reads
and filters the next batch: how long the reader holds the aligner back,
on the host clock (utils/spans.py), summed over the window's samples, in
us a read."""

STAGE = "wait.prefetch"


def read(ctx):
    r = ctx["readings"]
    t = r.get("stage_t", {}).get(STAGE)
    if t is None or not r.get("reads"):
        return None
    return t / r["reads"] * 1e6
