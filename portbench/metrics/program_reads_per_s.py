"""program_reads_per_s: every row of every batch run in the window, over
the time from the first call's start to the last one's return."""


def read(ctx):
    return ctx["units"] / ctx["span_s"] if ctx["span_s"] > 0 else None
