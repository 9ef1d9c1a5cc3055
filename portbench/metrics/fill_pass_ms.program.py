"""fill_pass_ms.program: the second pass's stages in run_with_fill's
`times` (each synchronised; everything but first_pass and host_redo), in
ms a call."""

NOT_FILL = ("first_pass", "host_redo")


def read(ctx):
    r = ctx["readings"]
    t = r.get("times", {})
    if not t or not r.get("calls"):
        return None
    return sum(v for k, v in t.items() if k not in NOT_FILL) / r["calls"] * 1e3
