"""Data-parallel and model-axis training steps of the port against its single-device step.

Ranks are gloo processes on the CPU, spawned through ``parallel.spawn`` and running
``tests/torch_mesh_workers.py`` (which imports no JAX). The network is a narrow
flagship with every stochastic rate on (prenet dropout, self-attention dropout,
zoneout) and batch norm in train mode; the batch has ragged lengths, so that the
ranks hold unequal frame counts (equal counts would hide a gradient averaged where
it must be summed).

* One ``Trainer.train_step`` at mesh (2, 1), (2, 2) and the model axis alone
  (1, 2) against the single-device step on the same global batch and generator:
  loss parts and ``grad_norm`` within 1e-5 relative (each rank's loss is its share
  of the global loss; the shares differ from the whole by float32 summation
  order), every gradient leaf within 1e-4 of its largest entry (Adam's first step
  is about lr * sign(g), so gradients are held tightly), the updated parameters
  within 1e-4 (``tests/test_torch_training.py``'s ``ATOL``), the batch-norm running
  averages within 1e-6 (they move by the global statistics, 0.01 of a step).
* With every rate 0, the (2, 1) step against JAX ``Trainer`` on a mesh of two
  virtual devices, at ``tests/test_torch_training.py``'s tolerances.
* A batch of 5 at data 2, padded by ``shard_batch`` (the pad row's lengths masked;
  batch norm counts it, as JAX's does), against the single-device step on the same
  padded rows.
* A checkpoint written at (2, 1) restored at world 1, and one written at world 1
  restored at (2, 2): weights, buffers and Adam's moments bit for bit.
* ``Trainer.train`` at (2, 1) with evaluation after every checkpoint, one rank's
  clock far ahead of the other's: rank 0's clock decides for both when to evaluate
  (``evaluate`` runs collectives; ranks that disagree would hang).

About 120 s on one worker (each spawn about 7 s; JAX's mesh step compiles once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.parallel import mesh as jax_mesh
from self_attention_tacotron_tpu.training import trainer as jax_trainer

from self_attention_tacotron_torch import convert
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.parallel import Mesh, shard_batch, spawn

import torch_mesh_workers as workers
from test_torch_helpers import flat_variables

LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-4
ATOL = 1e-4
BN_ATOL = 1e-6
NO_DROPOUT = dict(encoder_prenet_drop_rate=0.0, decoder_prenet_drop_rate=0.0,
                  self_attention_drop_rate=0.0, decoder_self_attention_drop_rate=0.0,
                  zoneout_factor_cell=0.0, zoneout_factor_output=0.0)


def _padded(b, data):
    """The global batch as ``shard_batch`` pads it for ``data`` ranks."""
    whole = workers.batch(b)
    parts = [shard_batch(whole, Mesh((data, 1), rank=r)) for r in range(data)]
    return {k: np.concatenate([p[k] for p in parts]) for k in whole}


@pytest.fixture(scope="module")
def single():
    """The single-device step on the batch of 4 and on the padded batch of 5."""
    with pytest.warns(UserWarning, match="padding 1 masked rows"):
        padded = _padded(5, 2)
    return {4: workers.train_steps(workers.NARROW, workers.batch(4), None),
            5: workers.train_steps(workers.NARROW, padded, None)}


def _compare(got, want, loss_rtol=LOSS_RTOL):
    assert set(got["metrics"]) == set(want["metrics"])
    for key, value in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][key], value, rtol=loss_rtol, err_msg=key)
    assert set(got["grads"]) == set(want["grads"])
    for key, value in want["grads"].items():
        largest = float(value.abs().max())
        np.testing.assert_allclose(got["grads"][key].numpy(), value.numpy(),
                                   atol=GRAD_SHARE * max(largest, 1e-3), rtol=0, err_msg=key)
    assert set(got["state"]) == set(want["state"])
    for key, value in want["state"].items():
        if value.dtype == torch.int64:       # the batch-norm step counters
            assert torch.equal(got["state"][key], value), key
            continue
        tol = BN_ATOL if ".running_" in key else ATOL
        np.testing.assert_allclose(got["state"][key].numpy(), value.numpy(), atol=tol, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2), (1, 2)], ids=["data", "both", "model"])
def test_a_step_on_the_mesh_is_the_single_device_step(single, mesh_shape):
    results = spawn(workers.train_steps, mesh_shape[0] * mesh_shape[1],
                    (workers.NARROW, workers.batch(4), mesh_shape))
    for got in results:      # every rank holds the same whole state
        _compare(got, single[4])
        assert got["warnings"] == []
    placed = dict(results[0]["placed"])
    if mesh_shape[1] == 1:
        assert placed == {}
    else:   # a flax kernel (in, out) split on out is nn.Linear.weight's dim 0
        assert placed["embedding.embedding"] == 1
        assert placed["encoder.self_attention.block_0.mha.qkv.weight"] == 0
        assert placed["encoder.self_attention.block_0.ffn1.weight"] == 0
        assert placed["encoder.self_attention.block_0.ffn2.weight"] == 1
        assert placed["decoder.output_projection.weight"] == 0


def test_an_uneven_batch_is_padded_and_masked(single):
    results = spawn(workers.train_steps, 2, (workers.NARROW, workers.batch(5), (2, 1)))
    for got in results:
        _compare(got, single[5])
        assert got["warnings"] == [
            "batch of 5 does not divide the data axis (2); padding 1 masked rows to keep "
            "data parallelism"]


def test_with_rates_zero_the_data_parallel_step_is_jax_s(tmp_path):
    kw = dict(workers.NARROW, **NO_DROPOUT)
    batch = workers.batch(4)
    jmodel = jax_factory(JaxHParams(**kw))
    mesh = jax_mesh.make_mesh((2, 1), devices=jax.devices()[:2])
    jt = jax_trainer.Trainer(jmodel, str(tmp_path / "jax"), mesh=mesh)
    key = jax.random.PRNGKey(9)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda: jt.net.init(
        {"params": key, "dropout": jax.random.fold_in(key, 1), "zoneout": jax.random.fold_in(key, 2)},
        jbatch["source"], jbatch["source_lengths"], jbatch["mel"], jbatch["target_lengths"],
    ))()
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)),
        variables["params"])
    params = jax_mesh.shard_params(params, mesh)
    state = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                   opt_state=jt.tx.init(params),
                                   batch_stats=variables["batch_stats"])
    start = flat_variables({"params": state.params, "batch_stats": state.batch_stats})
    state, metrics = jt._train_step(state, jax_mesh.shard_batch(batch, mesh), key)
    want = flat_variables({"params": state.params, "batch_stats": state.batch_stats})

    hp = HParams(**kw)
    model, net = workers.network(kw)
    start_state = convert.flax_to_torch_state(start, hp, net)
    # train_steps(kw, batch, mesh_shape, steps, seed, checkpoint_dir, restore, start)
    got = spawn(workers.train_steps, 2, (kw, batch, (2, 1), 1, 0, None, False, start_state))[0]
    for name, value in metrics.items():
        np.testing.assert_allclose(got["metrics"][name], float(value), atol=ATOL, rtol=1e-4,
                                   err_msg=name)
    net.load_state_dict(got["state"])
    for name, value in convert.torch_to_flax_flat(net).items():
        np.testing.assert_allclose(value, want[name], atol=ATOL, rtol=0, err_msg=name)


def _close_bitwise(got, want):
    assert set(got["state"]) == set(want["state"])
    for key, value in want["state"].items():
        assert torch.equal(got["state"][key], value), key
    got_opt, want_opt = got["optimizer"], want["optimizer"]
    assert set(got_opt["state"]) == set(want_opt["state"])
    for index, entry in want_opt["state"].items():
        for name, value in entry.items():
            assert torch.equal(got_opt["state"][index][name].cpu(), value.cpu()), (index, name)


def test_checkpoints_cross_mesh_sizes(tmp_path):
    batch = workers.batch(4)
    # written at (2, 1), restored at world 1
    wrote = spawn(workers.train_steps, 2, (workers.NARROW, batch, (2, 1), 1, 0, str(tmp_path / "a")))
    restored = workers.train_steps(workers.NARROW, batch, None, checkpoint_dir=str(tmp_path / "a"),
                                   restore=True)
    assert restored["step"] == 1
    _close_bitwise(restored, wrote[0])
    # written at world 1, restored at (2, 2): the placed leaves and their moments sliced
    wrote = workers.train_steps(workers.NARROW, batch, None, checkpoint_dir=str(tmp_path / "b"))
    restored = spawn(workers.train_steps, 4,
                     (workers.NARROW, None, (2, 2), 1, 0, str(tmp_path / "b"), True))
    for got in restored:
        assert got["step"] == 1
        _close_bitwise(got, wrote)



def test_rank_zero_s_clock_decides_when_every_rank_evaluates(tmp_path):
    kw = dict(workers.NARROW, save_checkpoints_steps=1, eval_start_delay_secs=0,
              eval_throttle_secs=3600, num_evaluation_steps=1)
    batches = [workers.batch(4, seed=s) for s in (11, 12, 13)]
    results = spawn(workers.train_with_eval, 2,
                    (kw, batches, [workers.batch(4, seed=21)], str(tmp_path)))
    # rank 0 evaluates after the first checkpoint, then its throttle holds; rank 1,
    # whose clock says the throttle has passed at every checkpoint, follows rank 0
    assert [r["evaluated"] for r in results] == [[1], [1]]
    assert len(results[0]["eval_lines"]) == 1
    assert sorted(p.name for p in tmp_path.joinpath("log").glob("alignment_step*.png")) == [
        f"alignment_step00000001_utt{u}.png" for u in range(3)]
