"""kmer_upload_us_per_read.align: the span `kmer.upload` of
align/driver.py, the k-mer bitmaps (6 x 512 MiB) read from their mmap
and copied to the card, once a call, inside `io+filter`, on the host
clock without a synchronise (utils/spans.py), summed over the window's
samples, in us a read; nothing where the program has no such span."""

STAGE = "kmer.upload"


def read(ctx):
    r = ctx["readings"]
    t = r.get("stage_t", {}).get(STAGE)
    if t is None or not r.get("reads"):
        return None
    return t / r["reads"] * 1e6
