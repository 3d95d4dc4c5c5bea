"""A run with its timed path broken underneath comes out not correct, once
for each fault a cell can have: a step that leaves its state unchanged;
half of the batch left out, the mean taken over the rest; an answer altered
where it is produced. Small cells on the CPU, held to the full cells'
limits; the same runs unbroken come out correct."""

from __future__ import annotations

import os
import sys

import pytest

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__))]

import readings  # noqa: E402
import tiny  # noqa: E402


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make_tree(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("name", ["tiny.psnr_train", "tiny.gan_train", "tiny.tiny_sr"])
def test_sound_run_is_correct(bench, name):
    res = tiny.run(bench, name)
    assert res["correct"], res["checks"]


def _state_unchanged(monkeypatch):
    import esrganplus_tpu_torch.train.gan_model as gm
    import esrganplus_tpu_torch.train.sr_model as sm

    noop = lambda params, updates, lr: None
    monkeypatch.setattr(sm, "apply_updates", noop)
    monkeypatch.setattr(gm, "apply_updates", noop)


def _half_batch(monkeypatch):
    readings.half_batch(monkeypatch.setattr)


def _answer_altered(monkeypatch):
    from esrganplus_tpu_torch.infer import SRInferencer

    up = SRInferencer.upscale

    def altered(self, img, *a, **k):
        out = up(self, img, *a, **k)
        out[..., 0] = 1.0 - out[..., 0]
        return out

    monkeypatch.setattr(SRInferencer, "upscale", altered)


@pytest.mark.parametrize("name,fault", [
    ("tiny.psnr_train", _state_unchanged), ("tiny.gan_train", _state_unchanged),
    ("tiny.psnr_train", _half_batch), ("tiny.gan_train", _half_batch),
    ("tiny.tiny_sr", _answer_altered)])
def test_fault_is_not_correct(bench, monkeypatch, name, fault):
    fault(monkeypatch)
    res = tiny.run(bench, name)
    assert not res["correct"], res["checks"]
