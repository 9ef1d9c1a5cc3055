"""accumulate_roofline: the one-program step's accumulation
(csrc/accumulate.cu: the walk, then the order's scan, fill and select,
with the memsets that zero their outputs) as a share of its bound.

The bound is ``bounds.walk_bound`` of the batch's own counts, worked out
by the reference from the rows the step reported.  The time is the device
time, in the traced window, from the memsets just before each
``fq_accum_walk`` launch to the end of the ``fq_accum_select`` launch
after it; run_with_fill runs two passes a call, and only the second
(every second group) runs over the batch's full placements, so only
those are timed.
"""

from ..bounds import walk_bound

FIRST = "fq_accum_walk"
LAST = "fq_accum_select"
ZERO = "Memset"


def _groups(tr):
    iv, names = tr.dev_in, tr.names_in
    order = sorted(range(len(names)), key=lambda i: iv[i][0])
    out = []
    for j, i in enumerate(order):
        if FIRST not in names[i]:
            continue
        a = j
        while a > 0 and names[order[a - 1]].startswith(ZERO):
            a -= 1
        b = j
        while b + 1 < len(order) and LAST not in names[order[b]]:
            b += 1
        if LAST not in names[order[b]]:
            continue
        out.append(sum(iv[order[k]][1] - iv[order[k]][0]
                       for k in range(a, b + 1)) / 1e6)
    return out


def read(ctx):
    tr, w = ctx["trace"], ctx.get("work")
    if tr is None or not w:
        return None
    second = _groups(tr)[1::2]
    if not second:
        return None
    t = sum(second) / len(second)
    b, _ = walk_bound(w["B"], w["n_cover"], w["n_reg"], w["n_entry_reads"],
                      w["S"], w["M"], w["cap"])
    return 100.0 * b / t
