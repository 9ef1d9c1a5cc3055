"""What the two new rooflines of the one-program cell read: the last
``run_with_fill`` call's counts (``qc_program.LAST_RUN_STATS``, published
only by a program that has them, and with each pass's work only when the
call was timed) and, from the traced window, the fill pass's launches of
one kind.

Every call of the cell replays the same batch, so the last call's counts
stand for each call's.  A call launches the kind ``first`` times in its
first pass, then ``fill`` times in its fill pass; the window's launches of
the kind, in start order, are whole calls of first + fill each.
"""

from __future__ import annotations

import sys


def program_counts() -> dict | None:
    """The last run_with_fill call's counts with both passes' work, or
    None (no such call in this process, or a program without them)."""
    mod = sys.modules.get("fastquick_tpu_torch.qc_program")
    st = getattr(mod, "LAST_RUN_STATS", None) or {}
    c = st.get("counts") or {}
    return c if "first_pass" in c and "fill_pass" in c else None


def fill_pass_s(tr, names: tuple, first: int, fill: int) -> float | None:
    """Mean device seconds a call of the fill pass's launches whose name
    holds one of `names`, or None where the window's launches are not
    whole calls."""
    if tr is None or fill <= 0:
        return None
    per = first + fill
    iv = sorted((a, b) for (a, b), n in zip(tr.dev_in, tr.names_in)
                if any(k in n for k in names))
    if not iv or len(iv) % per:
        return None
    calls = [iv[k: k + per][first:] for k in range(0, len(iv), per)]
    return sum(b - a for c in calls for a, b in c) / len(calls) / 1e6
