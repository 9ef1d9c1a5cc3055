"""fastquick_tpu's one-program step as the oracle of the port's, given each
read in the orientation that align --device_qc gives it.

Both packages' steps take bwa's store of a read: seqs the read reversed,
rseqs its reverse complement, quals in read order.  fastquick_tpu's
accumulation reads rseqs and quals as if they too were stored reversed
(fastquick_tpu/ops/qc_full.py:629-632), so a strand-1 read's bases come
out complemented in reverse and every read's qualities reversed; the
port's reads them as stored.  fastquick_tpu's search and k-mer filter read
seqs alone.  ``relay`` lays out rseqs and quals as that accumulation reads
them, made from seqs and quals the way DeviceDenseStats.add orients a read
(strand 1: its reverse complement, its qualities reversed); given them,
every output of fastquick_tpu's step is the port's oracle: the dense sums,
the empirical distributions and the pileups with the rest.
"""

import contextlib
import functools
from unittest import mock

import jax.numpy as jnp

from fastquick_tpu.ops import qc_full as jq


def relay(seqs, rseqs, quals, lens):
    """(seqs, rseqs', quals', lens): rseqs' the complement of the read as
    sequenced, quals' its qualities reversed (rseqs is not read)."""
    seqs = jnp.asarray(seqs)
    fwd = jq.ragged_unreverse(seqs, jnp.asarray(lens))
    comp = jnp.where(fwd < 4, 3 - fwd, 4).astype(seqs.dtype)
    return seqs, comp, jq.ragged_unreverse(jnp.asarray(quals),
                                           jnp.asarray(lens), fill=0), lens


def step(fn=jq.qc_step_full):
    """fn (fastquick_tpu's qc_step_full) over relaid planes."""
    @functools.wraps(fn)
    def run(fm, tables, opt_args, seqs, rseqs, quals, lens, *a, **k):
        return fn(fm, tables, opt_args, *relay(seqs, rseqs, quals, lens),
                  *a, **k)
    return run


@contextlib.contextmanager
def oriented():
    """Inside the block, fastquick_tpu.ops.qc_full.qc_step_full (as the
    reference tests' helpers import it) runs over relaid planes."""
    with mock.patch.object(jq, "qc_step_full", step(jq.qc_step_full)):
        yield
