"""refine_us_per_read.align: the span `refine` of align/driver.py, the
gapped refinement and MD tags on the main thread, on the host clock
without a synchronise (utils/spans.py), summed over the window's
samples, in us a read; nothing where the program has no such span."""

STAGE = "refine"


def read(ctx):
    r = ctx["readings"]
    t = r.get("stage_t", {}).get(STAGE)
    if t is None or not r.get("reads"):
        return None
    return t / r["reads"] * 1e6
