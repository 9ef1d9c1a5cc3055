"""kmer_filter_us_per_read.wgs: the span `kmer.filter` of align/driver.py,
the device k-mer filter of a batch after the one-time `kmer.upload` (the
planes filled, ops/kmer.filter_reads and its copy back, the reader's
layout restored), once a batch and an end, inside `io+filter`, on the host
clock (utils/spans.py), summed over the window's samples, in us a read;
nothing where the program has no such span."""

STAGE = "kmer.filter"


def read(ctx):
    r = ctx["readings"]
    t = r.get("stage_t", {}).get(STAGE)
    if t is None or not r.get("reads"):
        return None
    return t / r["reads"] * 1e6
