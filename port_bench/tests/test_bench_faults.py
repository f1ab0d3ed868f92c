"""The harness, with its look for a card skipped, drives a whole run at narrow
widths on the CPU with the timed path broken underneath, and sees ``correct``
come out false, once for each fault the cell can have: an answer altered where
it is produced, half of the batch left out, and in training a step that returns
its state unchanged and a step whose mean is taken over half of the batch (the
cells take one chip, so there is no exchange between chips to leave out). The
same run unbroken comes out correct. The limits are the cells' own."""

import pytest
import torch

import tiny
from port_bench import harness

SEED = 2**31 + 1234


def run(cell_name, seconds=0.3):
    bench = tiny.bench()
    spec = {w["name"]: w for w in bench["workloads"]}[cell_name]
    cell = harness.Cell(bench, cell_name,
                        config=tiny.config(spec["config"], compute_dtype="float32"),
                        traffic=tiny.traffic(spec["traffic"]))
    return harness.run_cell(cell, SEED, seconds, False, device="cpu")


SYNTH = ["flagship.synth-batch32", "streaming.synth-batch64", "flagship.request-b1"]


def _patch_decode(monkeypatch, change):
    from self_attention_tacotron_torch import synthesis

    real = synthesis.decode_incrementally

    def broken(**kwargs):
        result = real(**kwargs)
        change(result)
        return result

    monkeypatch.setattr(synthesis, "decode_incrementally", broken)


@pytest.mark.parametrize("cell_name", SYNTH)
def test_sound_synthesis_is_correct(cell_name):
    assert run(cell_name)["correct"]


@pytest.mark.parametrize("cell_name", SYNTH)
def test_an_altered_frame_is_not_correct(cell_name, monkeypatch):
    def alter(result):
        # lane 0's first step: its r frames moved by the largest frame value
        r = result.frames["mel"].shape[1] // result.alignments[0].shape[1]
        result.frames["mel"][0, :r] += float(result.frames["mel"].abs().max()) + 0.1

    _patch_decode(monkeypatch, alter)
    assert not run(cell_name)["correct"]


@pytest.mark.parametrize("cell_name", ["flagship.synth-batch32", "streaming.synth-batch64"])
def test_half_the_batch_left_out_is_not_correct(cell_name, monkeypatch):
    def drop(result):
        half = result.frames["mel"].shape[0] // 2
        result.frames["mel"][half:] = 0.0
        result.stop_probs[half:] = 0.0
        for a in result.alignments:
            a[half:] = 0.0

    _patch_decode(monkeypatch, drop)
    assert not run(cell_name)["correct"]


def test_sound_training_is_correct():
    assert run("flagship-init.train-batch32")["correct"]


def test_a_step_that_keeps_its_state_is_not_correct(monkeypatch):
    from self_attention_tacotron_torch.training import trainer

    class Still(torch.optim.Adam):
        def step(self, closure=None):
            return None

    real = trainer.make_optimizer
    monkeypatch.setattr(trainer, "make_optimizer",
                        lambda hp, params: Still(real(hp, params).param_groups))
    result = run("flagship-init.train-batch32")
    assert not result["correct"]
    # about 1: a leaf under the median one is measured against the median leaf
    assert result["checks"]["update_median_gap"]["value"] > 0.9


def test_a_step_over_half_the_batch_is_not_correct(monkeypatch):
    from self_attention_tacotron_torch.training.trainer import Trainer

    real = Trainer._batch

    def half(self, batch):
        out = real(self, batch)
        rows = out["source"].shape[0] // 2
        return {k: v[:rows] for k, v in out.items()}

    monkeypatch.setattr(Trainer, "_batch", half)
    assert not run("flagship-init.train-batch32")["correct"]
