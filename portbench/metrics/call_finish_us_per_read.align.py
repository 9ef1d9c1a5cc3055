"""call_finish_us_per_read.align: the span `call.finish` of
align/driver.py, the call's finish on the main thread (the BAM writer
drained and closed, the dense sums drained and the distributions
written), on the host clock without a synchronise (utils/spans.py),
summed over the window's samples, in us a read; nothing where the
program has no such span."""

STAGE = "call.finish"


def read(ctx):
    r = ctx["readings"]
    t = r.get("stage_t", {}).get(STAGE)
    if t is None or not r.get("reads"):
        return None
    return t / r["reads"] * 1e6
