"""host_redo_share.program: run_with_fill's `times["host_redo"]` (the
native engine's exact redo of the fallback reads) over the calls' wall."""


def read(ctx):
    r = ctx["readings"]
    t = r.get("times", {}).get("host_redo")
    if t is None or not r.get("wall"):
        return None
    return t / r["wall"]
