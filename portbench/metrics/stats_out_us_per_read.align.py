"""stats_out_us_per_read.align: align/driver.py's `stage_t["stats+out"]`
(host clock, no synchronise) summed over the window's samples, in us a
read."""

STAGE = "stats+out"


def read(ctx):
    r = ctx["readings"]
    t = r.get("stage_t", {}).get(STAGE)
    if t is None or not r.get("reads"):
        return None
    return t / r["reads"] * 1e6
