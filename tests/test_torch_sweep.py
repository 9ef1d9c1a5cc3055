"""The port's search sweep (fastquick_tpu_torch/sweep.py) on the CPU: two
resident configs, chain 1 and chain 4, each held to the native engine's
hits; a TPU ablation token and a config that fails make it exit
non-zero.  The world is cut to 200 kbp and 256 reads, the step cap
lowered so the plain search's passes stay short."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu_torch import sweep  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SMALL = {"FQ_BENCH_REF_BP": "200000", "FQ_SWEEP_READS": "256",
         "FQ_SWEEP_REPS": "1", "FQ_BS_STEPCAP": "400"}


def _lines(capsys) -> list[dict]:
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def test_chain_1_and_4_agree_with_native(monkeypatch, capsys):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    assert sweep.main(["--device", "cpu", "1024,512,1", "1024,512,4"]) == 0
    lines = _lines(capsys)
    assert [ln["config"] for ln in lines] == ["1024,512,1", "1024,512,4"]
    for ln in lines:
        assert ln["ok"] is True and "error" not in ln, ln
        assert ln["kernel"] == "resident" and ln["device"] == "cpu"
        assert ln["reads_per_sec"] > 0 and ln["bytes_moved"] > 0
        assert ln["hbm_sol_frac"] is None  # no device rate from the CPU
        assert 0 < ln["busy_frac"] <= 1


def test_failing_config_exits_nonzero(monkeypatch, capsys):
    """The scan kernel walks one base a step: chain 4 on it fails, is
    printed with its error, and the sweep exits non-zero."""
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    assert sweep.main(["--device", "cpu", "1024,512,4,32,scan"]) == 1
    (line,) = _lines(capsys)
    assert line["config"] == "1024,512,4,32,scan"
    assert "ValueError" in line["error"] and "chain 4" in line["error"]


def test_ablation_token_exits_nonzero():
    """The root sweep's FQ_BS_ABLATE tokens name blocks of the TPU kernel:
    the port refuses them before it builds anything."""
    with pytest.raises(ValueError, match="ablations are not ported"):
        sweep.parse_config("1024,512,4,32,noocc")
    r = subprocess.run([sys.executable, "-m", "fastquick_tpu_torch.sweep",
                        "--device", "cpu", "1024,512,4,32,noocc+nopush"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and not r.stdout.strip()
    assert "ablations are not ported" in r.stderr
