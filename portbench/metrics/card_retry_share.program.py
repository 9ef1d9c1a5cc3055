"""card_retry_share.program: the first pass's fallback rows that the card's
retry of pool overflows finished, over the first pass's fallback rows
(run_with_fill's counters ``card_retry_done`` and ``first_pass_fallback``,
the last call's: qc_program.LAST_RUN_STATS).  None where the program has
no such counter."""

import sys


def read(ctx):
    mod = sys.modules.get("fastquick_tpu_torch.qc_program")
    c = (getattr(mod, "LAST_RUN_STATS", None) or {}).get("counts") or {}
    if "card_retry_done" not in c or not c.get("first_pass_fallback"):
        return None
    return c["card_retry_done"] / c["first_pass_fallback"]
