"""search_roofline.program: the fill pass's search (csrc/search.cu,
``fq_search_chain_kernel``) as a share of its bound.

The bound is ``bounds_program.search_bound`` of the fill pass's counted
rows, busy steps and hit rows (the last call's, qc_program.LAST_RUN_STATS);
the time is the mean device time a call of the fill pass's launches in the
traced window.
"""

from ..bounds_program import search_bound
from ..program_passes import fill_pass_s, program_counts

KERNELS = ("fq_search_chain_kernel",)


def read(ctx):
    c = program_counts()
    if c is None:
        return None
    s1, s2 = c["first_pass"]["search"], c["fill_pass"]["search"]
    t = fill_pass_s(ctx["trace"], KERNELS, s1["launches"], s2["launches"])
    if not t:
        return None
    b, _ = search_bound(s2["L"], s2["seed_len"], s2["rows"],
                        s2["table_bytes"], s2["hit_rows"], s2["busy_steps"])
    return 100.0 * b / t
