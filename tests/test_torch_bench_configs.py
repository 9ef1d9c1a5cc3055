"""The port's benchmark configs (fastquick_tpu_torch/bench_configs.py) on
the CPU: wgs_stream on the smallest synthetic PE world (two --shard_out
device runs and their merge, byte-identical to the native engine's), and
example, which needs the reference tree, raising FileNotFoundError."""

import json

import pytest
import torch

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu_torch import bench_configs  # noqa: E402

CPU = torch.device("cpu")


def test_wgs_stream_on_small_world():
    line = bench_configs.run("wgs_stream", CPU, n_markers=12, depth=20)
    assert line["config"] == "wgs_stream"
    assert line["metric"] == "sharded_align_merge_wall"
    assert line["unit"] == "s" and line["value"] > 0
    assert (line["n_shards"], line["world"], line["device"]) == (
        2, "synth_pe", "cpu")
    # two shard BAMs and the 11 merged files equal the native engine's
    assert line["files_identical"] == 13
    assert line["reads"] > 0


def test_example_needs_the_reference_tree(monkeypatch, capsys):
    monkeypatch.delenv("FQ_REFERENCE", raising=False)
    with pytest.raises(FileNotFoundError, match="example/ and resource/"):
        bench_configs.run("example", CPU)
    assert bench_configs.main(["--device", "cpu", "example"]) == 1
    (line,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert line["config"] == "example"
    assert line["error"].startswith("FileNotFoundError")
