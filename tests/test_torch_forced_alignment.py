"""Forced-alignment mode (teacher-forcing attention) against the JAX package, on the CPU.

* ``TeacherForcingAttention`` in eval mode against the JAX module of that name over
  six steps (a ratio per lane, a ragged mask, a centre that reaches the last
  position), on the parameters of the forward attention that the JAX training
  network builds under the same name; in train mode it is that forward attention.
* ``make_predict_fn`` of the narrow flagship in forced-alignment mode (as
  ``predict_mel.py`` sets it) with ``target_lengths`` against JAX
  ``make_predict_fn(use_fused=False)``: frames, stop probabilities and alignments to
  1e-4, lengths, flags and step counts exact, and each alignment row's peak at the
  position nearest ``min(t * ratio, S - 1)`` within the lane's mask.
* ``use_fused=True`` raises ``ValueError`` (the kernel does not serve the mode, as the
  Pallas kernel does not), and auto mode on the card takes the step-by-step loop.
* One ``train_step`` (every loss part, every gradient leaf) and an ``eval_step`` with
  ``attention="teacher_forcing_forward"`` against the JAX trainer.
* The teacher-forced forward of the evaluation network with a ``teacher_ratio`` per
  lane (``TacotronNetwork.forward`` places it on the conditioning, as JAX
  ``models.py:192-197`` does): frames, stop logits and alignments to 1e-4, each
  alignment row's peak where the ratio puts it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models import attention as ja
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.training import trainer as jax_trainer

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models import attention
from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.synthesis import decode_fused, make_predict_fn
from self_attention_tacotron_torch.tools.flagship import config_batch
from self_attention_tacotron_torch.training.trainer import Trainer

from test_torch_configs import (
    ATOL,
    jax_variables,
    B,
    FRAMES,
    NO_DROPOUT,
    S,
    _int32,
    compare_synthesis,
    compare_training,
    config_kw,
    port_network,
    request,
    synthesis_pair,
    training_pair,
)
from test_torch_helpers import assert_close, load_from_flax, t

FORCED = dict(attention="teacher_forcing_forward", use_forced_alignment_mode=True)
MS, E, Q, U = 7, 10, 12, 8
MASK = np.arange(MS)[None, :] < np.array([7, 5, 3])[:, None]
RATIO = np.array([1.5, 0.75, 2.25], np.float32)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_teacher_forcing_attention_against_jax():
    memory = _randn(0, 3, MS, E)
    query = _randn(1, 3, Q)
    jforward = ja.ForwardAttention(num_units=U)
    state_j = ja.initial_attention_state(3, MS, initial_alignment="one_hot")
    variables = jforward.init(jax.random.PRNGKey(0), jnp.asarray(query), jnp.zeros((3, MS, U)),
                              jnp.asarray(memory), jnp.asarray(MASK), state_j)
    keys_vars = jforward.init(jax.random.PRNGKey(1), jnp.asarray(memory),
                              method=ja.ForwardAttention.compute_keys)
    params = dict(variables["params"], memory_layer=keys_vars["params"]["memory_layer"])
    port = attention.attention_factory("teacher_forcing_forward", U, HParams(), query_units=Q,
                                       memory_units=E)
    assert isinstance(port, attention.TeacherForcingAttention)
    assert isinstance(port, attention.ForwardAttention)
    load_from_flax(port, {"params": params})
    # the prediction network's module reads the memory layer alone
    jforced = ja.TeacherForcingAttention(num_units=U)
    forced_vars = {"params": {"memory_layer": params["memory_layer"]}}
    keys_j = jforced.apply(forced_vars, jnp.asarray(memory),
                           method=ja.TeacherForcingAttention.compute_keys)
    keys = port.compute_keys(t(memory))
    assert_close(keys, np.asarray(keys_j), atol=1e-5)
    state_j = ja.initial_attention_state(3, MS, initial_alignment=jforced.initial_alignment)
    state = attention.initial_attention_state(3, MS, initial_alignment="one_hot")
    with torch.no_grad():
        for step in range(6):
            want_ctx, want_probs, state_j = jforced.apply(
                forced_vars, jnp.asarray(query), keys_j, jnp.asarray(memory), jnp.asarray(MASK),
                state_j, ratio=jnp.asarray(RATIO))
            ctx, probs, state = port(t(query), keys, t(memory), t(MASK), state, ratio=t(RATIO))
            assert_close(ctx, np.asarray(want_ctx), atol=1e-5)
            assert_close(probs, np.asarray(want_probs), atol=1e-5)
            assert_close(state.cumulative, np.asarray(state_j.cumulative), atol=1e-5)
            assert state.step == int(state_j.step) == step + 1
            centre = np.minimum(np.float32(step) * RATIO, np.float32(MS - 1))
            # the nearest position within the mask (a tie at .5 goes either way)
            peak = np.minimum(centre, MASK.sum(axis=1) - 1)
            assert np.all(np.abs(probs.argmax(dim=-1).numpy() - peak) <= 0.5)
        # without a ratio the window moves one position a step
        _, probs, _ = port(t(query), keys, t(memory), None, state.replace(step=2))
        assert probs.argmax(dim=-1).tolist() == [2, 2, 2]
    # train mode: the forward attention the JAX training network builds
    forward = attention.ForwardAttention(Q, E, U)
    forward.load_state_dict(port.state_dict())
    port.train()
    start = attention.initial_attention_state(3, MS, initial_alignment="one_hot")
    with torch.no_grad():
        got = port(t(query), keys, t(memory), t(MASK), start, ratio=t(RATIO))
        want = forward(t(query), keys, t(memory), t(MASK), start)
    assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))


def _forced_kw(**overrides):
    return config_kw("ljspeech_selfattention", **FORCED, **overrides)


def test_forced_synthesis_with_target_lengths_against_jax():
    kw = _forced_kw()
    req = request(kw, seed=8)
    req["target_lengths"] = np.array([20, 9, 5])
    got, want = synthesis_pair(kw, req)
    compare_synthesis(got, want, postnets=False)
    r = kw["outputs_per_step"]
    # the centre as the mechanism computes it, in float32 (a tie at .5 goes either way)
    ratio = (req["source_lengths"].astype(np.float32)
             / np.maximum(req["target_lengths"] // r, 1).astype(np.float32))
    align = got["alignments"][0].numpy()
    for b in range(B):
        steps = int(got["lengths"][b]) // r
        centre = np.minimum(np.arange(steps, dtype=np.float32) * ratio[b], np.float32(S - 1))
        peak = np.minimum(centre, req["source_lengths"][b] - 1)
        assert np.all(np.abs(align[b, :steps].argmax(axis=-1) - peak) <= 0.5), b


def test_the_fused_decode_does_not_serve_forced_alignment():
    hp = HParams(**_forced_kw())
    net = tacotron_model_factory(hp).network(device="cpu")
    with pytest.raises(ValueError, match="not supported by the fused decode kernel"):
        make_predict_fn(net, device="cpu", use_fused=True)
    # auto mode on the card: the step-by-step loop, as the JAX package takes its XLA loop
    assert decode_fused(hp, None, "cuda") is False
    assert decode_fused(HParams(**config_kw("ljspeech_selfattention")), None, "cuda") is True


def test_one_train_step_and_an_eval_step_with_teacher_forcing_forward(tmp_path_factory):
    kw = _forced_kw(**NO_DROPOUT)
    run = training_pair(kw, tmp_path_factory)
    compare_training(run, {"loss", "mel_loss", "done_loss", "grad_norm"})
    # evaluation: the JAX package's evaluation network has the forced window, no ratio
    hp = HParams(**kw)
    batch = _int32(run["batch"])
    jmodel = jax_factory(JaxHParams(**kw))
    jt = jax_trainer.Trainer(jmodel, str(tmp_path_factory.mktemp("ckpt")))
    state = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=run["variables"]["params"],
                                   opt_state=None, batch_stats=run["variables"]["batch_stats"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, want_out = jax.jit(jt._eval_step_impl)(state, jbatch, jax.random.PRNGKey(3))
    trainer = Trainer(tacotron_model_factory(hp), device="cpu")
    tstate = trainer.init_state(port_network(kw, run["variables"], hp))
    got, out = trainer.eval_step(tstate, batch)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), atol=ATOL, rtol=1e-4,
                                   err_msg=key)
    assert_close(out.alignments[0], np.asarray(want_out.alignments[0]), atol=ATOL)
    n = FRAMES // kw["outputs_per_step"]
    assert out.alignments[0].argmax(dim=-1)[0].tolist() == [min(i, S - 1) for i in range(n)]


def test_an_eval_forward_with_a_teacher_ratio_against_jax():
    kw = _forced_kw(**NO_DROPOUT)
    hp = HParams(**kw)
    batch = _int32(config_batch(hp, np.random.default_rng(12), B, FRAMES, S, shortest=3))
    variables = jax_variables(kw, batch, seed=2)
    ratio = np.array([0.5, 1.25, 2.0], np.float32)[:B]
    jnet = jax_factory(JaxHParams(**kw)).network(is_training=False)
    key = jax.random.PRNGKey(1)
    want = jax.jit(lambda: jnet.apply(
        variables, jnp.asarray(batch["source"]), jnp.asarray(batch["source_lengths"]),
        jnp.asarray(batch["mel"]), jnp.asarray(batch["target_lengths"]),
        teacher_ratio=jnp.asarray(ratio), rngs={"dropout": key, "zoneout": key},
    ))()
    net = port_network(kw, variables, hp).eval()
    with torch.no_grad():
        got = net(t(batch["source"]), t(batch["source_lengths"]), t(batch["mel"]),
                  t(batch["target_lengths"]), teacher_ratio=t(ratio))
    assert_close(got.frames["mel"], np.asarray(want.frames["mel"]), atol=ATOL)
    assert_close(got.stop_logits, np.asarray(want.stop_logits), atol=ATOL)
    for g, w in zip(got.alignments, want.alignments):
        assert_close(g, np.asarray(w), atol=ATOL)
    align = got.alignments[0].numpy()
    for b in range(B):
        steps = FRAMES // kw["outputs_per_step"]
        centre = np.minimum(np.arange(steps, dtype=np.float32) * ratio[b], np.float32(S - 1))
        peak = np.minimum(centre, batch["source_lengths"][b] - 1)
        assert np.all(np.abs(align[b, :steps].argmax(axis=-1) - peak) <= 0.5), b
