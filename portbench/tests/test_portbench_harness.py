"""The harness itself: BENCHMARK.json's shape, the look for a card, the
modules a run loads, and a checkout without the program."""

import json
import os
import re
import shutil
import subprocess
import sys

from portbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    return run.load_json(run.ROOT, "BENCHMARK.json")


def test_benchmark_json_shape():
    b = _spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    cells = {w["name"] for w in b["workloads"]}
    configs = {c["name"] for c in b["configs"]}
    assert {w["config"] for w in b["workloads"]} == configs
    for c in b["configs"]:
        cfg = run.load_json(run.ROOT, c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(run.HERE, "drivers",
                                           cfg["driver"] + ".py"))
        assert len(c["source"]) <= 200
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert os.path.exists(os.path.join(run.HERE, "traffic",
                                           w["traffic"] + ".json"))
    names = set()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(run.HERE, "metrics",
                                           m["name"] + ".py"))
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in cells:
        c = run.cell(b, w)
        assert "setup_s" in {m["name"] for m in c["e2e"]}
        assert len(c["e2e"]) >= 2 and c["per_layer"]
    assert len(json.dumps(b)) < 64 * 1024


def test_no_card_no_result():
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "align.panel", "--seed", "5", "--seconds", "1",
                        "--trace", "0"], cwd=run.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA card" in r.stderr


def test_forbidden_modules_by_top_level_name(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fastquick_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    monkeypatch.setitem(sys.modules, "fastquick_tpu.ops", sys)
    assert run.forbidden_modules() == ["fastquick_tpu", "jaxlib"]


def test_a_run_loads_no_jax():
    code = ("import json, sys\n"
            "from portbench.tests.cases import tiny_cell\n"
            "from portbench import run\n"
            "res = run.run_cell(tiny_cell(), 7, 0.01, True, device='cpu')\n"
            "print(json.dumps([res['correct'], run.forbidden_modules(),\n"
            "                  sorted(res['metrics'])]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    correct, bad, metrics = json.loads(r.stdout.splitlines()[-1])
    assert correct and bad == []
    assert "io_filter_us_per_read.align" in metrics


def test_without_the_program_it_fails(tmp_path):
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(run.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    for cmd in (["-m", "portbench.run", "--workload", "align.panel",
                 "--seed", "5", "--seconds", "1", "--trace", "0"],
                ["-c", "from portbench.tests.cases import tiny_cell\n"
                 "from portbench import run\n"
                 "print(run.run_cell(tiny_cell(), 5, 0.01, False, "
                 "device='cpu'))"]):
        r = subprocess.run([sys.executable, *cmd], cwd=tmp_path,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0 and r.stdout == ""
    assert "fastquick_tpu_torch" in r.stderr
