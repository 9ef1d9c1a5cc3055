"""The set-up decisions every path that runs a sample makes the same way:
the index's search options, the statistics collector and the exact engine
for the reads a device search cannot finish.

``align`` and ``merge`` (align/driver.py), the one-program step
(qc_program.world_from_files and write_product), its fill's host redo
(ops/host_redo.py), the device search (ops/batch_search.BatchEngine) and
the collector oracle (testing/collector_oracle.py) take them from here.
"""

from __future__ import annotations

import os

from ..index.builder import read_param
from ..stats.keyed_collector import KeyedStatCollector
from .engine import HostEngine, NativeEngine
from .opts import GapOpt


def index_options(index_prefix: str) -> tuple[str, GapOpt, dict]:
    """(new_ref, opt, params): the index's reduced reference, a GapOpt
    carrying the four fields the index fixes (its variant counts and flank
    lengths) and the parsed ``.param`` file (reference
    src/FASTQuick.cpp:365-467)."""
    new_ref = index_prefix + ".FASTQuick.fa"
    params = read_param(new_ref)
    opt = GapOpt()
    opt.num_variant_long = params["NUM_VAR_LONG"]
    opt.num_variant_short = params["NUM_VAR_SHORT"]
    opt.flank_len = params["SHORT_FLANK_LENGTH"]
    opt.flank_long_len = params["LONG_FLANK_LENGTH"]
    return new_ref, opt, params


def load_contig_sizes(ref_path: str) -> tuple[list[tuple[str, int]], int, int]:
    """LoadContigSize (src/BwtIndexer.cpp:764-802): whole-genome .fai for
    contig sizes + .amb (bwa index of the full genome) for the N count."""
    contig_sizes = []
    genome_size = 0
    n_size = 0
    fai = ref_path + ".fai"
    if os.path.exists(fai):
        with open(fai) as fh:
            for line in fh:
                parts = line.split("\t")
                chrom = parts[0]
                if chrom.lower().startswith("chr"):
                    chrom = chrom[3:]
                contig_sizes.append((chrom, int(parts[1])))
                genome_size += int(parts[1])
    amb = ref_path + ".amb"
    if os.path.exists(amb):
        with open(amb) as fh:
            fh.readline()
            for line in fh:
                parts = line.split()
                if len(parts) >= 2:
                    n_size += int(parts[1])
    return contig_sizes, genome_size, n_size


def sample_collector(new_ref: str, opt: GapOpt,
                     params: dict | None = None) -> KeyedStatCollector:
    """A collector over the index's sites and flanks.  With ``params``
    (index_options'), also the whole genome's size and N count and the
    index's target region, as ``align`` and ``merge`` set them; the
    one-program step's collectors are built without."""
    collector = KeyedStatCollector()
    collector.restore_vcf_sites(new_ref, opt)
    if params is not None:
        _, genome_size, n_size = load_contig_sizes(params["REFERENCE_PATH"])
        collector.set_genome_size(genome_size, n_size)
        if params["TARGET_REGION_PATH"] != "Empty":
            collector.set_target_region(params["TARGET_REGION_PATH"])
    return collector


def exact_engine(idx):
    """The exact engine: native, else the Python oracle when the native
    aligner's library is unavailable (NativeEngine's RuntimeError); any
    other failure of the native engine's set-up propagates."""
    try:
        return NativeEngine(idx)
    except RuntimeError:
        return HostEngine(idx)
