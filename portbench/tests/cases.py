"""Tiny cells for the CPU tests: the benchmark's cells with the world cut
to 30 markers and a sample to a few hundred pairs, on the port's plain
PyTorch versions (``--device cpu``)."""

from __future__ import annotations

import copy
import os

from portbench import run

# the plain search on the CPU: a low step cap hands long searches to the
# exact host redo sooner (the results are the same)
os.environ.setdefault("FQ_BS_STEPCAP", "400")

TINY_WORLD = dict(n_markers=30)
TINY_INDEX = dict(var_long=5, var_short=25)


def tiny_cell(workload: str = "align.panel", pairs: int = 150) -> dict:
    c = run.cell(run.load_json(run.ROOT, "BENCHMARK.json"), workload)
    c = copy.deepcopy(c)
    c["cfg"]["world"].update(TINY_WORLD)
    c["cfg"]["index"].update(TINY_INDEX)
    c["cfg"].update(sample_pairs=pairs, distinct_samples=1)
    return c


def tiny_program_cell(pairs: int = 150) -> dict:
    """The one-program cell (not in BENCHMARK.json; see PERF.md) at the
    tiny size, without the k-mer bitmaps on the CPU."""
    cfg = run.load_json(run.HERE, "configs", "fqdefault_program.json")
    cfg["world"].update(TINY_WORLD)
    cfg["index"].update(TINY_INDEX)
    cfg.update(batch_pairs=pairs, bitmaps=False)
    return dict(wl={"name": "program.panel", "config": cfg["name"],
                    "traffic": "panel", "chips": 1},
                cfg=cfg, mix=run.load_json(run.HERE, "traffic", "panel.json"),
                e2e=[], per_layer=[])
