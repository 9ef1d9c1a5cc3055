"""setup_s: process start to the window's start (kernels' build or load,
the index's build or load, the samples, the warm-up)."""


def read(ctx):
    return ctx["setup_s"]
