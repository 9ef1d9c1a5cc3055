"""filter_pass_share.wgs: the reads the k-mer filter kept, which the
device search then searched (driver.LAST_RUN_STATS "searched"), over every
read of the window's samples.

A check of the workload rather than a score: the share is a property of
the seed's sample and reads the same on any correct program.  A program
that lowers it by dropping reads of a flank fails the judge's
misplaced_share, which counts such a read as misplaced."""


def read(ctx):
    r = ctx["readings"]
    if not r.get("reads") or "searched" not in r:
        return None
    return r["searched"] / r["reads"]
