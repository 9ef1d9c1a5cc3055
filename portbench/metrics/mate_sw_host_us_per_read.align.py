"""mate_sw_host_us_per_read.align: mate rescue's host part, the span
`mate-sw` of align/driver.py less its child `sw.device` of
ops/sw_kernels.py (the two device passes: copies in, kernel, copy back),
on the host clock without a synchronise (utils/spans.py), summed over
the window's samples, in us a read; nothing where the program has no
`sw.device`."""


def read(ctx):
    r = ctx["readings"]
    st = r.get("stage_t", {})
    if "mate-sw" not in st or "sw.device" not in st or not r.get("reads"):
        return None
    return (st["mate-sw"] - st["sw.device"]) / r["reads"] * 1e6
