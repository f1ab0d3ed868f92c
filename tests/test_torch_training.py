"""The port's ``Trainer.train_step`` against the JAX package's, leaf by leaf.

A narrow flagship (dual-source self-attention Tacotron, r = 2) starts from the
same weights on both sides (flax init, moved by seeded noise, through
``convert``), takes the same seeded batch with ragged source and target lengths,
and makes one and three updates: ``Trainer._train_step_impl`` of the JAX package
(XLA scan path) and ``Trainer.train_step`` of the port on the CPU. Every
stochastic rate is 0, since the frameworks' random streams differ.

Compared: the loss parts and ``grad_norm``, every gradient leaf (through
``convert.torch_to_flax_flat(gradients=True)``), and every updated parameter and
``batch_stats`` leaf, with and without clipping by global norm. Tolerance 1e-4
absolute (gradients: relative to the largest entry of the leaf). ``adam_eps`` is
1e-4 here: with the default 1e-8 Adam's first update is lr * sign(g), and an
entry whose gradient is float32 noise around zero would differ by 2 * lr for a
reason that is not the optimizer's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.training import trainer as jax_trainer
from self_attention_tacotron_tpu.training.schedules import (
    learning_rate_schedule as jax_schedule,
    make_optimizer as jax_make_optimizer,
)

from self_attention_tacotron_torch import convert
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.tools.flagship import training_batch
from self_attention_tacotron_torch.training import schedules
from self_attention_tacotron_torch.training.trainer import Trainer, TrainState, targets_from_batch

from test_torch_helpers import flat_variables

B, S, FRAMES = 3, 9, 10
ATOL = 1e-4

_NARROW = dict(
    tacotron_model="DualSourceSelfAttentionTacotronModel",
    encoder="SelfAttentionCBHGEncoder", decoder="DualSourceSelfAttentionDecoder",
    attention="forward", attention2="additive",
    num_symbols=70, embedding_dim=16,
    encoder_prenet_out_units=(16, 8), encoder_prenet_drop_rate=0.0,
    cbhg_out_units=16, conv_channels=8, max_filter_width=3,
    projection1_out_channels=8, projection2_out_channels=8, num_highway=1,
    self_attention_out_units=16, self_attention_transformer_ffn_units=24,
    self_attention_drop_rate=0.0,
    decoder_prenet_out_units=(16, 8), decoder_prenet_drop_rate=0.0,
    attention_out_units=16, attention1_out_units=12, attention2_out_units=4,
    decoder_out_units=16, decoder_self_attention_out_units=16,
    decoder_self_attention_drop_rate=0.0,
    zoneout_factor_cell=0.0, zoneout_factor_output=0.0,
    num_mels=6, outputs_per_step=2,
    initial_learning_rate=1e-3, adam_eps=1e-4,
)

CASES = {
    "plain": dict(),
    "clipped_l2": dict(
        use_gradient_clipping=True, gradient_clip_norm=0.05, use_l2_regularization=True,
        l2_regularization_weight=1e-4,
    ),
    "transition_agent": dict(use_forward_attention_transition_agent=True),
}


def _batch():
    batch = training_batch(
        np.random.default_rng(11), B, FRAMES, S, num_mels=6, outputs_per_step=2, shortest=2
    )
    return {k: (v.astype(np.int32) if v.dtype == np.int64 else v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request, tmp_path_factory):
    """Three updates on both sides; everything a test reads, as numpy."""
    return three_steps(dict(_NARROW, **CASES[request.param]), tmp_path_factory)


def three_steps(kw, tmp_path_factory):
    """Three updates of the configuration ``kw`` on both sides, from the same weights."""
    batch = _batch()
    assert len(set(batch["target_lengths"].tolist())) > 1 and batch["source_lengths"].min() < S

    jax_model = jax_factory(JaxHParams(**kw))
    jt = jax_trainer.Trainer(jax_model, str(tmp_path_factory.mktemp("ckpt")))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(9)
    # what Trainer.init_state does, jitted and without the device mesh
    variables = jax.jit(lambda: jt.net.init(
        {"params": key, "dropout": jax.random.fold_in(key, 1), "zoneout": jax.random.fold_in(key, 2)},
        jbatch["source"], jbatch["source_lengths"], jbatch["mel"], jbatch["target_lengths"],
    ))()
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)),
        variables["params"],
    )
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, opt_state=jt.tx.init(params),
        batch_stats=variables.get("batch_stats", {}),   # none without a CBHG
    )
    start = flat_variables({"params": state.params, "batch_stats": state.batch_stats})

    def step_and_grads(state):
        # one compilation for both: the update, and the gradients it does not return
        def loss_fn(p):
            out, _ = jt._forward(jt.net, p, state.batch_stats, jbatch, key, mutable=True)
            return jax_model.loss(out, jbatch, params=p)["loss"]

        return jt._train_step_impl(state, jbatch, key), jax.grad(loss_fn)(state.params)

    step = jax.jit(step_and_grads)
    want, jax_grads = [], None
    for _ in range(3):
        (state, metrics), grads = step(state)
        if jax_grads is None:
            jax_grads = flat_variables({"params": grads})
        want.append((
            {k: float(v) for k, v in metrics.items()},
            flat_variables({"params": state.params, "batch_stats": state.batch_stats}),
        ))

    hp = HParams(**kw)
    model = tacotron_model_factory(hp)
    net = _load_flat(model, start, hp)
    trainer = Trainer(model, device="cpu")
    tstate = trainer.init_state(net)
    got, grads = [], None
    for i in range(3):
        tstate, metrics = trainer.train_step(tstate, batch, torch.Generator().manual_seed(i))
        if i == 0:
            grads = convert.torch_to_flax_flat(tstate.net, gradients=True)
        got.append(({k: float(v) for k, v in metrics.items()},
                    convert.torch_to_flax_flat(tstate.net)))
    return dict(kw=kw, start=start, want=want, got=got, jax_grads=jax_grads, grads=grads,
                state=tstate)


def _has_batch_norm(kw):
    # the CBHG's convolutions carry batch norm; ZoneoutEncoderV1 has no CBHG
    return not kw.get("encoder", "").startswith("ZoneoutEncoderV1")


def _load_flat(model, flat, hp):
    net = model.network(device="cpu")
    return convert.load_state(net, convert.flax_to_torch_state(flat, hp, net))


def test_the_inverse_of_convert_gives_back_every_leaf(runs):
    hp = HParams(**runs["kw"])
    net = _load_flat(tacotron_model_factory(hp), runs["start"], hp)
    back = convert.torch_to_flax_flat(net)
    assert set(back) == set(runs["start"])
    assert any(k.startswith("batch_stats/") for k in back) == _has_batch_norm(runs["kw"])
    for key, want in runs["start"].items():
        np.testing.assert_array_equal(back[key], want, err_msg=key)
    zeros = convert.torch_to_flax_flat(net, gradients=True)
    assert set(zeros) == {k for k in back if k.startswith("params/")}
    assert all(float(np.abs(v).max()) == 0.0 for v in zeros.values())


def test_loss_parts_and_grad_norm_of_every_step(runs):
    for (got, _), (want, _) in zip(runs["got"], runs["want"]):
        assert set(got) == set(want)
        assert {"loss", "mel_loss", "done_loss", "grad_norm"} <= set(got)
        for key in want:
            assert np.isfinite(got[key])
            np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=1e-4, err_msg=key)
    if runs["kw"].get("use_l2_regularization"):
        assert runs["got"][0][0]["l2_regularization"] > 0.0


def test_every_gradient_leaf_of_the_first_step(runs):
    kw, norm = runs["kw"], runs["want"][0][0]["grad_norm"]
    scale = 1.0
    if kw.get("use_gradient_clipping"):
        clip = kw["gradient_clip_norm"]
        assert norm > clip, "the case must clip"
        scale = clip / max(norm, clip)       # the port's gradients were clipped in place
    assert set(runs["grads"]) == set(runs["jax_grads"])
    nonzero = 0
    for key, want in runs["jax_grads"].items():
        want = want * scale
        largest = float(np.abs(want).max())
        nonzero += largest > 0.0
        np.testing.assert_allclose(
            runs["grads"][key], want, atol=ATOL * max(largest, 1e-3), rtol=0, err_msg=key
        )
    assert nonzero >= len(runs["jax_grads"]) - 2   # all but an unused leaf or two take gradient


@pytest.mark.parametrize("steps", [1, 3])
def test_every_updated_parameter_and_batch_stats_leaf(runs, steps):
    got, want = runs["got"][steps - 1][1], runs["want"][steps - 1][1]
    assert set(got) == set(want)
    moved = 0
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=0, err_msg=key)
        moved += float(np.abs(want[key] - runs["start"][key]).max()) > 1e-5
    assert moved >= len(want) - 2
    stats = [k for k in want if k.startswith("batch_stats/") and k.endswith("/var")]
    assert bool(stats) == _has_batch_norm(runs["kw"])
    assert all(float(np.abs(want[k] - runs["start"][k]).max()) > 1e-5 for k in stats)


def test_the_state_counts_steps_and_sets_the_scheduled_rate(runs):
    state = runs["state"]
    assert isinstance(state, TrainState) and state.step == 3
    rate = state.optimizer.param_groups[0]["lr"]
    assert rate == pytest.approx(float(jax_schedule(JaxHParams(**runs["kw"]))(2)), rel=1e-6)


@pytest.mark.parametrize("overrides", [
    dict(initial_learning_rate=1e-3, decay_learning_rate=True),
    dict(initial_learning_rate=2e-3, decay_learning_rate=True, learning_rate_step_factor=4),
    dict(initial_learning_rate=1e-3, decay_learning_rate=False),
], ids=["decay", "step_factor", "constant"])
def test_learning_rate_schedule(overrides):
    ours = schedules.learning_rate_schedule(HParams(**overrides))
    theirs = jax_schedule(JaxHParams(**overrides))
    for step in (0, 1, 777, 50_000, 123_456, 10_000_000):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-5)
    if overrides["decay_learning_rate"]:
        assert ours(10_000_000) == pytest.approx(overrides["initial_learning_rate"] / 100.0)


def test_clip_by_global_norm_is_the_optax_rule():
    import optax

    rng = np.random.default_rng(2)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,), (2, 2, 2))]
    for clip in (0.5, 100.0):
        grads = [torch.tensor(x) for x in leaves]
        norm = schedules.global_norm(grads)
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm([jnp.asarray(x) for x in leaves])), rtol=1e-6
        )
        schedules.clip_by_global_norm(grads, norm, clip)
        want, _ = optax.clip_by_global_norm(clip).update([jnp.asarray(x) for x in leaves], None)
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7, rtol=1e-6)
    # a gradient under the limit passes unchanged, bit for bit
    assert all(torch.equal(g, torch.tensor(x)) for g, x in zip(grads, leaves))


def test_adam_is_optax_adam():
    kw = dict(initial_learning_rate=1e-2, decay_learning_rate=False, adam_eps=1e-3)
    rng = np.random.default_rng(6)
    p0 = rng.standard_normal((4, 3)).astype(np.float32)
    tx = jax_make_optimizer(JaxHParams(**kw))
    params, opt_state = jnp.asarray(p0), None
    opt_state = tx.init(params)
    p = torch.nn.Parameter(torch.tensor(p0))
    opt = schedules.make_optimizer(HParams(**kw), [p])
    for _ in range(4):
        g = rng.standard_normal((4, 3)).astype(np.float32) * 1e-3     # near eps: its place shows
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = params + updates
        p.grad = torch.tensor(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), atol=1e-6, rtol=0)


def test_eval_step_and_targets_from_batch(runs):
    hp = HParams(**runs["kw"])
    model = tacotron_model_factory(hp)
    trainer = Trainer(model, device="cpu")
    batch = _batch()
    assert torch.equal(
        targets_from_batch(model, {"mel": torch.tensor(batch["mel"])}), torch.tensor(batch["mel"])
    )
    before = convert.torch_to_flax_flat(runs["state"].net)
    losses, out = trainer.eval_step(runs["state"], batch)
    assert not runs["state"].net.training
    assert out.frames["mel"].shape == (B, FRAMES, 6) and out.stop_logits.shape == (B, FRAMES)
    sources = 2 if "DualSource" in hp.decoder else 1
    assert [a.shape for a in out.alignments] == [(B, FRAMES // 2, S)] * sources
    assert all(np.isfinite(float(v)) for v in losses.values())
    after = convert.torch_to_flax_flat(runs["state"].net)
    assert all(np.array_equal(before[k], after[k]) for k in before)   # eval moves nothing


def test_the_trainer_wants_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is allowed to work")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(tacotron_model_factory(HParams(**_NARROW)))
