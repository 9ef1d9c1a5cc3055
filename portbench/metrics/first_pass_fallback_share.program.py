"""first_pass_fallback_share.program: the resident search's first-pass
fallback reads (run_with_fill's count) over the rows it searched."""


def read(ctx):
    r = ctx["readings"]
    if not r.get("rows_searched"):
        return None
    return r["first_fallback"] / r["rows_searched"]
