"""The port's host modules are copies of the reference package's.

Every framework-free module that fastquick_tpu_torch carries over must
equal its original after the single substitution fastquick_tpu ->
fastquick_tpu_torch; the modules of REWRITTEN are rewritten in part and
only checked for existence.  A static check holds the port (and
chip_smoke.py) to its rule: nothing imports jax or the fastquick_tpu
package.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF = REPO / "fastquick_tpu"
PORT = REPO / "fastquick_tpu_torch"

COPIES = (
    "params.py", "utils/__init__.py", "utils/logging.py",
    "io/__init__.py", "io/fasta.py", "io/bam.py", "io/bgzf.py", "io/gc.py",
    "io/region.py", "io/vcf.py",
    "index/__init__.py", "index/seq.py", "index/fmindex.py",
    "index/kmerfilter.py", "index/builder.py", "index/refbuilder.py",
    "align/__init__.py", "align/core.py", "align/dp.py", "align/opts.py",
    "align/rand.py", "align/refine.py", "align/seqs.py", "align/sam.py",
    "align/engine.py",
    "stats/__init__.py", "stats/collector.py", "stats/sites.py",
    "stats/insertsize.py", "stats/device_merge.py", "stats/shard.py",
    "pop/__init__.py", "pop/baq.py", "pop/pileup.py", "pop/svd.py",
    "pop/estimator.py", "report/__init__.py", "report/report.py",
    "native/__init__.py", "native/aligner.cpp", "native/fastq_loader.cpp",
    "native/sw.cpp",
    "testing/__init__.py", "ops/__init__.py", "parallel/__init__.py",
)
REWRITTEN = ("align/driver.py", "align/pe.py", "testing/synthworld.py",
             "pop/device_llk.py", "pop/driver.py", "pipeline.py",
             "parallel/mesh.py", "parallel/scaling.py")


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_reference(rel):
    want = (REF / rel).read_text().replace("fastquick_tpu",
                                           "fastquick_tpu_torch")
    assert (PORT / rel).read_text() == want, rel


@pytest.mark.parametrize("rel", REWRITTEN)
def test_rewritten_module_present(rel):
    assert (REF / rel).exists() and (PORT / rel).exists()


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


PORT_SOURCES = sorted(str(p.relative_to(REPO))
                      for p in PORT.rglob("*.py")) + ["chip_smoke.py"]


@pytest.mark.parametrize("rel", PORT_SOURCES)
def test_no_jax_or_reference_import(rel):
    bad = _imported_roots(REPO / rel) & {"jax", "jaxlib", "fastquick_tpu"}
    assert not bad, f"{rel} imports {sorted(bad)}"


def test_import_ban_covers_the_mesh():
    """The mesh modules (parallel/) and the mesh's rank functions are
    among the sources the ban checks."""
    want = {f"fastquick_tpu_torch/{m}" for m in (
        "parallel/__init__.py", "parallel/mesh.py", "parallel/scaling.py",
        "testing/mesh_cases.py")}
    assert want <= set(PORT_SOURCES)


def test_import_ban_covers_the_bench():
    """The bench, its configs, the sweep and the bounds they share are
    among the sources the ban checks."""
    want = {f"fastquick_tpu_torch/{m}" for m in (
        "bench.py", "bench_configs.py", "sweep.py", "utils/bounds.py")}
    assert want <= set(PORT_SOURCES)
