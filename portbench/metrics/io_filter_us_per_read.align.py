"""io_filter_us_per_read.align: align/driver.py's `stage_t["io+filter"]`
(host clock, no synchronise) summed over the window's samples, in us a
read."""

STAGE = "io+filter"


def read(ctx):
    r = ctx["readings"]
    t = r.get("stage_t", {}).get(STAGE)
    if t is None or not r.get("reads"):
        return None
    return t / r["reads"] * 1e6
