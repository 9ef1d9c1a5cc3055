"""align_reads_per_s: every read (both ends) of every sample started in
the window, over the time from the first sample's start to the last
one's return, after its product files are written."""


def read(ctx):
    return ctx["units"] / ctx["span_s"] if ctx["span_s"] > 0 else None
