"""``tools/replay_steps.py`` on the CPU at narrow widths (about 10 s on one worker).

A run of the convergence tool's flagship hparams (narrowed as
``test_torch_convergence.py``'s ``TINY``; bfloat16, dropout and zoneout on) trains 3
steps with a checkpoint and a metrics record after every step; the tool restores the
checkpoint of step 1 and replays updates 2 and 3 through its four paths. On the CPU
every path runs the plain versions (the kernels' wrappers take their plain version
on CPU tensors), so path ``a`` must give the loop's logged loss parts and ``grad_norm``
bit for bit; the JSON lines carry every field the tool promises; and a checkpoint of
another seed's run, put in the place of step 1's, makes the tool fail.
"""

import functools
import json
import os
import shutil

import pytest

from self_attention_tacotron_torch import train
from self_attention_tacotron_torch.tools import convergence_run as run
from self_attention_tacotron_torch.tools import replay_steps
from self_attention_tacotron_torch.training import trainer as trainer_lib
from self_attention_tacotron_torch.training.metrics import MetricsWriter

# test_torch_convergence.py's TINY, with a checkpoint and a record after every step
LOOP = ("embedding_dim=16,encoder_prenet_out_units=16+8,cbhg_out_units=16,conv_channels=8,"
        "max_filter_width=3,projection1_out_channels=8,projection2_out_channels=8,num_highway=1,"
        "self_attention_out_units=16,self_attention_transformer_ffn_units=24,"
        "decoder_prenet_out_units=16+8,attention_out_units=16,attention1_out_units=12,"
        "attention2_out_units=4,decoder_out_units=16,decoder_self_attention_out_units=16,"
        "num_mels=8,sample_rate=8000,num_freq=129,frame_length_ms=32,frame_shift_ms=16,"
        "batch_size=4,batch_bucket_width=16,max_iters=20,save_checkpoints_steps=1,"
        "log_step_count_steps=1,save_summary_steps=1,alignment_save_steps=1000")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two runs on one corpus: seed 1234 for 3 steps, seed 1235 for 1."""
    saved = trainer_lib.MetricsWriter, os.environ.get("SATT_PLATFORM")
    os.environ["SATT_PLATFORM"] = "cpu"                 # the command line takes the CPU
    # the scalars go to metrics.jsonl alone: importing the TensorBoard writer takes seconds
    trainer_lib.MetricsWriter = functools.partial(MetricsWriter, use_tensorboard=False)
    try:
        root = tmp_path_factory.mktemp("replay")
        run.EXTRA.clear()
        run.EXTRA.update(run.parse_extra(LOOP))
        data, lists = str(root / "data"), str(root / "lists")
        run.generate(data, lists, 12, 4, 8, device="cpu")
        dirs = {}
        for seed, steps in ((1234, 3), (1235, 1)):
            run_dir = root / f"run_{seed}"
            os.makedirs(run_dir)
            for sub in ("data", "lists"):
                os.symlink(root / sub, run_dir / sub)
            train.main([f"--source-data-root={data}",
                        f"--checkpoint-dir={run_dir / 'checkpoints'}",
                        f"--selected-list-dir={lists}", f"--steps={steps}",
                        f"--hparams={run.hp_string(dict(random_seed=seed))}"])
            dirs[seed] = str(run_dir)
        yield dirs
    finally:
        trainer_lib.MetricsWriter = saved[0]
        if saved[1] is None:
            os.environ.pop("SATT_PLATFORM", None)
        else:
            os.environ["SATT_PLATFORM"] = saved[1]
        run.EXTRA.clear()


def _replay(run_dir, seed, out):
    return replay_steps.main(["--run-dir", run_dir, "--from-step", "1", "--count", "2",
                              "--hparams-extra", f"{LOOP},random_seed={seed}", "--out", out,
                              "--device", "cpu"])


def test_path_a_reproduces_the_logged_steps_and_the_lines_hold_every_field(runs, tmp_path,
                                                                          monkeypatch):
    monkeypatch.setenv("SATT_PLATFORM", "cpu")          # --device cpu sets it; put back after
    out = str(tmp_path / "replay.jsonl")
    records = _replay(runs[1234], 1234, out)
    with open(out) as f:
        lines = [json.loads(line) for line in f]
    assert lines == json.loads(json.dumps(records))
    meta, rows = lines[0], lines[1:]
    assert meta["checkpoint_step"] == 1 and meta["updates"] == [2, 3]
    assert meta["logged_bit_for_bit"] and meta["random_seed"] == 1234
    assert meta["compute_dtype"] == "bfloat16" and meta["card"] is None
    assert [(r["step"], r["path"]) for r in rows] == [(s, p) for s in (2, 3) for p in "abcd"]
    logged = {r["step"]: r for r in run.read_metrics(os.path.join(runs[1234], "checkpoints", "log"))
              if "loss" in r}
    for row in rows:
        assert set(row) >= {"loss_parts", "grad_norm", "rate", "launches", "lanes",
                            "after_update", "adam"}
        assert set(row["loss_parts"]) == {"loss", "mel_loss", "done_loss"}
        assert not any(row["launches"].values())          # the CPU launches nothing
        lanes = row["lanes"]
        assert len(lanes["done_loss"]) == len(lanes["done_share"]) == len(lanes["mel_share"]) == 4
        assert abs(sum(lanes["done_share"]) - 1.0) < 1e-3
        assert abs(sum(lanes["mel_share"]) - 1.0) < 1e-3
        assert set(row["after_update"]) == set(row["loss_parts"])
        adam = row["adam"]
        assert adam["update_over_rate"]["max"] > 0 and len(adam["update_over_rate"]["largest"]) == 8
        assert all(v >= 0 for _, v in adam["smallest_second_moment"])
        if row["path"] == "a":
            # bit for bit: the replayed floats are the logged ones
            assert row["logged"] == {**row["loss_parts"], "grad_norm": row["grad_norm"]}
            assert row["logged"] == {k: logged[row["step"]][k] for k in row["logged"]}
        if row["path"] == "b":
            assert "grads_against_b" not in row
        else:
            against = row["grads_against_b"]
            assert set(against) == {"max", "median", "worst", "leaves"}
            assert len(against["leaves"]) == len(rows[0]["grads_against_b"]["leaves"])
            assert len(against["worst"]) == 8
            assert len(row["update_against_b_over_rate"]) == 8
    by = {(r["step"], r["path"]): r for r in rows}
    for step in (2, 3):
        # on the CPU the kernel path is the plain path: a and b are one computation
        assert by[(step, "a")]["grads_against_b"]["max"] == 0.0
        assert by[(step, "a")]["loss_parts"] == by[(step, "b")]["loss_parts"]
        # float32 compute is another computation; in bfloat16 path d moves the
        # embedding table by one part in 1e7 (at these widths no bfloat16 rounding of
        # it flips, so its gradients may be b's)
        assert by[(step, "c")]["grads_against_b"]["max"] > 0.0
        assert by[(step, "d")]["update_against_b_over_rate"][0][0] == "embedding.embedding"


def test_a_checkpoint_of_another_seed_makes_the_tool_fail(runs, tmp_path, monkeypatch):
    monkeypatch.setenv("SATT_PLATFORM", "cpu")
    other = os.path.join(runs[1235], "checkpoints", "ckpt-00000001.pt")
    run_dir = tmp_path / "swapped"
    shutil.copytree(runs[1234], run_dir, symlinks=True)
    shutil.copy(other, run_dir / "checkpoints" / "ckpt-00000001.pt")
    out = str(tmp_path / "replay.jsonl")
    with pytest.raises(SystemExit, match="does not reproduce the run's step 2 bit for bit"):
        _replay(str(run_dir), 1234, out)
    assert not os.path.exists(out)                     # nothing written before the check
