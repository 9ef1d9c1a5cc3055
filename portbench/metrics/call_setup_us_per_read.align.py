"""call_setup_us_per_read.align: the span `call.setup` of align/driver.py,
the call's set-up on the main thread (the index load, the sites and
their tables on the card, the FM index on the card, the writers opened),
on the host clock without a synchronise (utils/spans.py), summed over
the window's samples, in us a read; nothing where the program has no
such span."""

STAGE = "call.setup"


def read(ctx):
    r = ctx["readings"]
    t = r.get("stage_t", {}).get(STAGE)
    if t is None or not r.get("reads"):
        return None
    return t / r["reads"] * 1e6
