"""io_read_us_per_read.wgs: the span `io.read` of align/driver.py, the
FASTQ reader's `read_batch` (gzip decode, parse, trim and the Read
objects; native or Python route), once a batch and an end, inside
`io+filter`, on the host clock without a synchronise (utils/spans.py),
summed over the window's samples, in us a read; nothing where the program
has no such span."""

STAGE = "io.read"


def read(ctx):
    r = ctx["readings"]
    t = r.get("stage_t", {}).get(STAGE)
    if t is None or not r.get("reads"):
        return None
    return t / r["reads"] * 1e6
