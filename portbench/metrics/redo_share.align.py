"""redo_share.align: the reads the device search handed to the exact
host redo over the reads it searched (driver.LAST_RUN_STATS, summed over
the window's samples)."""


def read(ctx):
    r = ctx["readings"]
    if not r.get("searched"):
        return None
    return r["fallback"] / r["searched"]
