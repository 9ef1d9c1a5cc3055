"""pairing_roofline.program: the fill pass's pairing launches
(csrc/pairing.cu, ``fq_pairing_warp_kernel`` or ``fq_pairing_block_kernel``:
the sweep over every pair, then over the pairs the occurrence cap cut) as
a share of their bound.

The bound is the sum of ``bounds_program.pairing_bound`` over the fill
pass's sweeps, of each one's counted pairs, entries, reverse entries,
words, compares and penalty table (the last call's,
qc_program.LAST_RUN_STATS); the time is the mean device time a call of the
fill pass's launches in the traced window.
"""

from ..bounds_program import pairing_bound
from ..program_passes import fill_pass_s, program_counts

KERNELS = ("fq_pairing_warp_kernel", "fq_pairing_block_kernel")


def read(ctx):
    c = program_counts()
    if c is None:
        return None
    sweeps = c["fill_pass"]["pairing"]
    t = fill_pass_s(ctx["trace"], KERNELS, len(c["first_pass"]["pairing"]),
                    len(sweeps))
    if not t:
        return None
    b = sum(pairing_bound(s["pairs"], s["valid"], s["reverse"], s["words"],
                          s["compares"], s["penalty_len"])[0] for s in sweeps)
    return 100.0 * b / t
