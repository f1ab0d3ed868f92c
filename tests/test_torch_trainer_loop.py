"""The port's training loop, checkpoints and artifacts against the JAX package's, on the CPU.

* A narrow flagship (``test_torch_training.py``'s, every stochastic rate 0) starts
  JAX ``Trainer.train`` and the port's ``Trainer.train`` from the same weights (JAX
  ``state=``, through ``convert``) and runs 3 steps on the same batches, with a
  checkpoint every 2 steps, the evaluation after it and the training-cadence PNGs at
  step 3. Compared: every record of ``metrics.jsonl`` (the loss parts, ``grad_norm``,
  the ``eval_*`` means) and every final leaf to 1e-4, and the names of the PNGs.
* Resume: 2 steps, a new trainer on the same directory, 1 more, equals 3 straight
  steps bit for bit, with dropout and zoneout on (the generator of a step is derived
  from the seed and the step); the checkpoint restores step, weights, batch-norm
  buffers and Adam's moments bit for bit.
* ``keep_checkpoint_max`` eviction, with and without the hours grid, against orbax's
  preservation policies (what JAX's ``CheckpointManagerOptions`` builds).
* ``restore_inference`` with ``use_gradient_clipping`` flipped, and on an empty
  directory; the warm start from an npz exported from JAX's state equals JAX's own
  warm start, and the one from another run's directory takes its weights alone.
* The PNG writer without matplotlib: the import patched away, the file decoded.

About 70 s on one worker (JAX compiles a train and an eval step).
"""

import datetime
import glob
import json
import os
import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from orbax.checkpoint._src.checkpoint_managers import preservation_policy as orbax_policy

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.parallel import make_mesh
from self_attention_tacotron_tpu.training import trainer as jax_trainer

from self_attention_tacotron_torch import convert
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.tools.flagship import training_batch
from self_attention_tacotron_torch.training import metrics as metrics_lib
from self_attention_tacotron_torch.training.trainer import CheckpointManager, Trainer

from test_torch_helpers import flat_variables
from test_torch_training import _NARROW, _load_flat

B, S, FRAMES = 3, 9, 10
ATOL = 1e-4
LOOP = dict(log_step_count_steps=1, save_summary_steps=100, save_checkpoints_steps=2,
            alignment_save_steps=3, num_evaluation_steps=2, eval_start_delay_secs=0,
            eval_throttle_secs=0, save_training_time_metrics=False)
KW = dict(_NARROW, **LOOP)
# the same structure with every stochastic part on (the narrow values' defaults)
STOCHASTIC = dict(KW, encoder_prenet_drop_rate=0.5, self_attention_drop_rate=0.1,
                  decoder_prenet_drop_rate=0.5, decoder_self_attention_drop_rate=0.1,
                  zoneout_factor_cell=0.1, zoneout_factor_output=0.1)


def _batches(n=3, seed=11):
    out = []
    for i in range(n):
        batch = training_batch(np.random.default_rng(seed + i), B, FRAMES, S, num_mels=6,
                               outputs_per_step=2, shortest=2)
        out.append({k: (v.astype(np.int32) if v.dtype == np.int64 else v)
                    for k, v in batch.items()})
    return out


def _jax_start(kw, batch):
    """Flax init of the narrow flagship, moved by seeded noise; flat and as a state."""
    jax_model = jax_factory(JaxHParams(**kw))
    net = jax_model.network(is_training=True)
    key = jax.random.PRNGKey(9)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda: net.init(
        {"params": key, "dropout": jax.random.fold_in(key, 1), "zoneout": jax.random.fold_in(key, 2)},
        jbatch["source"], jbatch["source_lengths"], jbatch["mel"], jbatch["target_lengths"],
    ))()
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)),
        variables["params"],
    )
    return jax_model, params, variables.get("batch_stats", {})


def _metrics(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _pngs(log_dir):
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(log_dir, "*.png")))


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    """Three steps of both loops from the same weights, with an evaluation."""
    batches, evals = _batches(), _batches(2, seed=40)
    jax_model, params, stats = _jax_start(KW, batches[0])
    start = flat_variables({"params": params, "batch_stats": stats})
    single = make_mesh((1, 1), devices=jax.devices()[:1])
    jt = jax_trainer.Trainer(jax_model, str(tmp_path_factory.mktemp("jax")), mesh=single)
    state = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                   opt_state=jt.tx.init(params), batch_stats=stats)
    final = jt.train(iter(batches), 3, state=state, eval_batches_fn=lambda: iter(evals))
    want = flat_variables({"params": final.params, "batch_stats": final.batch_stats})

    hp = HParams(**KW)
    model = tacotron_model_factory(hp)
    trainer = Trainer(model, str(tmp_path_factory.mktemp("port")), device="cpu")
    tstate = trainer.train(iter(batches), 3, state=trainer.init_state(_load_flat(model, start, hp)),
                           eval_batches_fn=lambda: iter(evals))
    return dict(jt=jt, trainer=trainer, state=tstate, want=want, start=start,
                got=convert.torch_to_flax_flat(tstate.net), batches=batches, evals=evals)


def test_metrics_jsonl_equals_jax(loops):
    got, want = _metrics(loops["trainer"].log_dir), _metrics(loops["jt"].log_dir)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 2, 3]
    assert "eval_loss" in got[2] and "grad_norm" in got[0]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in set(w) - {"step", "time"}:
            assert np.isfinite(g[key])
            np.testing.assert_allclose(g[key], w[key], atol=ATOL, rtol=1e-4, err_msg=key)


def test_final_leaves_equal_jax(loops):
    assert loops["state"].step == 3
    assert set(loops["got"]) == set(loops["want"])
    for key, want in loops["want"].items():
        np.testing.assert_allclose(loops["got"][key], want, atol=ATOL, rtol=0, err_msg=key)


def test_checkpoints_and_artifacts_as_in_jax(loops):
    trainer = loops["trainer"]
    assert trainer.checkpoints.steps() == [2, 3]
    assert _pngs(trainer.log_dir) == _pngs(loops["jt"].log_dir)
    assert "train_alignment_step00000003.png" in _pngs(trainer.log_dir)
    assert "mel_step00000002_utt2.png" in _pngs(trainer.log_dir)
    # evaluate on its own: the eval_* means of the state's step and the first batch's PNGs
    means = trainer.evaluate(loops["state"], iter(loops["evals"]))
    assert {"eval_loss", "eval_mel_loss", "eval_done_loss"} <= set(means)
    assert _metrics(trainer.log_dir)[-1]["step"] == 3
    np.testing.assert_allclose(_metrics(trainer.log_dir)[-1]["eval_loss"], means["eval_loss"])
    assert "alignment_step00000003_utt2.png" in _pngs(trainer.log_dir)


def _state_dicts(state):
    return state.net.state_dict(), state.optimizer.state_dict()


def _assert_bitwise(a, b, where=""):
    if torch.is_tensor(a):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_bitwise(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def test_a_resumed_run_equals_the_straight_run_bit_for_bit(tmp_path):
    hp = HParams(**STOCHASTIC)
    model = tacotron_model_factory(hp)
    batches = _batches()
    torch.manual_seed(0)
    start = model.network(device="cpu").state_dict()

    def fresh(directory):
        trainer = Trainer(model, str(tmp_path / directory), device="cpu")
        net = model.network(device="cpu")
        net.load_state_dict(start)
        return trainer, trainer.init_state(net)

    straight, state = fresh("straight")
    straight_state = straight.train(iter(batches), 3, state=state)
    first, state = fresh("resumed")
    at_two = first.train(iter(batches[:2]), 2, state=state)
    assert first.checkpoints.steps() == [2]
    second = Trainer(model, str(tmp_path / "resumed"), device="cpu")
    restored = second.restore_or_init()
    assert restored.step == 2
    _assert_bitwise(_state_dicts(restored), _state_dicts(at_two))
    assert any(k.endswith("running_mean") for k in restored.net.state_dict())
    assert restored.optimizer.state_dict()["state"], "Adam's moments are restored"
    resumed = second.train(iter(batches[2:]), 1)
    assert resumed.step == 3
    _assert_bitwise(_state_dicts(resumed), _state_dicts(straight_state))
    steps = [r["step"] for r in _metrics(second.log_dir) if "loss" in r]
    assert steps == [1, 2, 3]          # the step after a resume is logged


@pytest.mark.parametrize("keep,hours", [(2, 0), (1, 1), (3, 1)])
def test_eviction_as_orbax_keeps(keep, hours, tmp_path, monkeypatch):
    times = iter([0.0, 1000.0, 3000.0, 3700.0, 5000.0, 7300.0, 7400.0, 11000.0])
    now = {"t": 0.0}

    def clock():
        return now["t"]

    monkeypatch.setattr("self_attention_tacotron_torch.training.trainer.time.time", clock)
    manager = CheckpointManager(str(tmp_path), keep, 3600.0 * hours)
    saved = []
    for step, t in zip(range(1, 9), times):
        now["t"] = t
        assert manager.save(step, {"step": step})
        saved.append((step, t))
    assert not manager.save(8, {"step": 8})            # a saved step is not written again

    class Info:
        def __init__(self, step, t):
            self.step, self.metrics = step, None
            self.time = datetime.datetime.fromtimestamp(t, datetime.timezone.utc)

    policies = [orbax_policy.LatestN(n=keep)]
    if hours:
        policies.append(orbax_policy.EveryNSeconds(interval_secs=3600 * hours))
    # orbax evicts after every save, over what survived the saves before
    alive = []
    for step, t in saved:
        alive.append(Info(step, t))
        flags = orbax_policy.AnyPreservationPolicy(policies).should_preserve(
            alive, context=orbax_policy.PreservationContext())
        alive = [info for info, kept in zip(alive, flags) if kept]
    assert manager.steps() == [info.step for info in alive]
    assert manager.load(manager.latest_step())["step"] == 8


def test_trainer_eviction_with_the_default_hours_grid(tmp_path):
    hp = HParams(**dict(KW, save_checkpoints_steps=1, keep_checkpoint_max=2,
                        alignment_save_steps=1000))
    model = tacotron_model_factory(hp)
    trainer = Trainer(model, str(tmp_path), device="cpu")
    trainer.train(iter(_batches(4)), 4)
    # the last two, and the first: the first checkpoint opens the one-hour grid
    assert trainer.checkpoints.steps() == [1, 3, 4]
    assert not glob.glob(os.path.join(str(tmp_path), "*.tmp-*"))


def test_restore_inference_with_other_optimizer_hparams(tmp_path):
    hp = HParams(**dict(KW, use_gradient_clipping=False))
    model = tacotron_model_factory(hp)
    trainer = Trainer(model, str(tmp_path / "run"), device="cpu")
    saved = trainer.train(iter(_batches(2)), 2)
    flipped = tacotron_model_factory(HParams(**dict(KW, use_gradient_clipping=True,
                                                    initial_learning_rate=5e-3)))
    restored = Trainer(flipped, str(tmp_path / "run"), device="cpu").restore_inference()
    assert restored.step == 2
    _assert_bitwise(restored.net.state_dict(), saved.net.state_dict())
    assert not restored.optimizer.state_dict()["state"], "Adam is fresh"
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        Trainer(model, str(tmp_path / "empty"), device="cpu").restore_inference()


def test_warm_start_from_a_jax_npz_equals_jax_s(loops, tmp_path):
    path = str(tmp_path / "donor.npz")
    np.savez(path, **loops["want"])
    hp = HParams(**KW)
    batch = {k: jnp.asarray(v) for k, v in loops["batches"][0].items()}
    single = make_mesh((1, 1), devices=jax.devices()[:1])
    jt = jax_trainer.Trainer(jax_factory(JaxHParams(**KW)), str(tmp_path / "jax"), mesh=single)
    jstate = jt.restore_or_init(jax.random.PRNGKey(0), batch, warm_start_from=path)
    want = flat_variables({"params": jstate.params, "batch_stats": jstate.batch_stats})
    trainer = Trainer(tacotron_model_factory(hp), str(tmp_path / "port"), device="cpu")
    state = trainer.restore_or_init(warm_start_from=path)
    assert state.step == int(jstate.step) == 0
    assert not state.optimizer.state_dict()["state"]
    got = convert.torch_to_flax_flat(state.net)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # from another run's checkpoint directory: its weights, a fresh step and Adam
    other = Trainer(tacotron_model_factory(hp), str(tmp_path / "other"), device="cpu")
    warm = other.restore_or_init(warm_start_from=loops["trainer"].checkpoint_dir)
    assert warm.step == 0 and not warm.optimizer.state_dict()["state"]
    _assert_bitwise(warm.net.state_dict(), loops["state"].net.state_dict())
    with pytest.raises(FileNotFoundError, match="has no checkpoints"):
        Trainer(tacotron_model_factory(hp), str(tmp_path / "x"), device="cpu").restore_or_init(
            warm_start_from=str(tmp_path / "nothing"))


def _decode_png(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(kind + body)
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    width, height, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, colour) == (8, 0)
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(height, width + 1)
    assert not rows[:, 0].any()
    return rows[:, 1:]


def _grey(matrix):
    """What a viewer should see: matrix.T, first row at the bottom, min-max to 0..255."""
    a = np.asarray(matrix, np.float64).T[::-1]
    return np.round((a - a.min()) / (a.max() - a.min()) * 255).astype(np.uint8)


def test_the_png_writer_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)     # the import fails
    assert metrics_lib.image_writer() == "greyscale"
    rng = np.random.default_rng(5)
    aligns = [rng.random((12, 9)).astype(np.float32), rng.random((12, 9)).astype(np.float32)]
    path = str(tmp_path / "align.png")
    metrics_lib.save_alignment_png(aligns, path, info="x", source_length=7, decoder_steps=10)
    got = _decode_png(path)
    want = np.concatenate([_grey(a[:10, :7]) for a in aligns], axis=1)
    np.testing.assert_array_equal(got, want)
    mel, target = rng.random((20, 6)), rng.random((25, 6))
    metrics_lib.save_mel_comparison_png(mel, target, str(tmp_path / "mel.png"), length=15)
    np.testing.assert_array_equal(_decode_png(str(tmp_path / "mel.png")),
                                  np.concatenate([_grey(mel[:15]), _grey(target[:15])]))
    metrics_lib.save_mel_comparison_png(mel, None, str(tmp_path / "mel1.png"))
    np.testing.assert_array_equal(_decode_png(str(tmp_path / "mel1.png")), _grey(mel))
