"""A run driven past the look for a card, with the timed path broken
underneath, comes out not correct: once for each fault the align cell
can have (it keeps no state across chips and no training state), and
once for the control, the port's own lower-tolerance search."""

import torch

from portbench import run

from .cases import tiny_cell

torch.set_num_threads(2)
SEED = 2**31 + 11


def _run(control=False):
    return run.run_cell(tiny_cell(), SEED, 0.01, False, device="cpu",
                        control=control)


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"] and res["failed"] == 0
    assert set(res["checks"]) == set(tiny_cell()["cfg"]["limits"])


def test_half_the_batch_left_out(monkeypatch):
    from fastquick_tpu_torch.align import driver

    real = driver.PairEndMapper._next_batch

    def half(self, *a, **k):
        return real(self, *a, **k)[::2]

    monkeypatch.setattr(driver.PairEndMapper, "_next_batch", half)
    res = _run()
    assert not res["correct"]
    assert res["checks"]["misplaced_share"]["value"] > 0.3


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from fastquick_tpu_torch.align import sam

    real = sam.SamWriter.write_pair
    seen = set()

    def moved(self, idx, p, q, opt):
        # the first mapped read each call writes, one base to the right
        if id(self) not in seen and p.type != 0 and p.mapQ >= 20:
            seen.add(id(self))
            p.pos += 1
        return real(self, idx, p, q, opt)

    monkeypatch.setattr(sam.SamWriter, "write_pair", moved)
    res = _run()
    assert seen and not res["correct"]


def test_statistics_left_unchanged(monkeypatch):
    from fastquick_tpu_torch.align import device_qc

    monkeypatch.setattr(device_qc.DeviceDenseStats, "flush",
                        lambda self, collector: None)
    res = _run()
    assert not res["correct"]
    assert res["checks"]["dense_off"]["value"] > 0


def test_control_is_not_correct():
    res = _run(control=True)
    assert not res["correct"]
    assert res["checks"]["misplaced_share"]["value"] > 0.1
