"""The port's public constructors run on the card unless the caller asks
for the CPU: with no device given, each raises on a host without CUDA
(never falling back to the CPU)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu_torch.align.device_qc import DeviceDenseStats  # noqa: E402
from fastquick_tpu_torch.bench import build_index  # noqa: E402
from fastquick_tpu_torch.ops.batch_search import BatchEngine  # noqa: E402
from fastquick_tpu_torch.ops.fm import DeviceFM  # noqa: E402
from fastquick_tpu_torch.ops.kmer import load_kmer_bitmaps  # noqa: E402
from fastquick_tpu_torch.ops.qc_full import synthetic_site_tables  # noqa: E402
from fastquick_tpu_torch.ops.site_tables import build_site_tables  # noqa: E402

CASES = {
    "BatchEngine": lambda idx: BatchEngine(idx),
    "DeviceFM.build": lambda idx: DeviceFM.build(idx.fm_fwd, idx.fm_rev),
    "DeviceDenseStats": lambda idx: DeviceDenseStats(idx, None, None),
    "load_kmer_bitmaps": lambda idx: load_kmer_bitmaps(
        [np.zeros(8, np.uint8)] * 6),
    "build_site_tables": lambda idx: build_site_tables(idx, None, None),
    "synthetic_site_tables": lambda idx: synthetic_site_tables(idx.text),
}


@pytest.fixture(scope="module")
def idx():
    return build_index(4096)


@pytest.mark.parametrize("name", sorted(CASES))
def test_default_device_is_cuda(name, idx, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("FQ_BS_PALLAS", raising=False)
    with pytest.raises(RuntimeError, match="is_available"):
        CASES[name](idx)
