"""The WORLD-feature model classes with location-sensitive attention as whole models against the JAX package.

``MgcLf0TacotronModel`` (``ZoneoutEncoderV1``, ``MgcLf0ExtendedDecoder``: the
configuration ``mgclf0-ls``) and ``DualSourceSelfAttentionMgcLf0TacotronModel``
(``flagship-mgclf0-ls``) pin only the decoder, so ``attention="location_sensitive"``
reaches them: the decode's location taps together with the lf0 softmax fed back to
the prenet. Narrow, ``num_mgcs=7`` and ``num_lf0s=13``, 7 taps, 4 filters.

* Synthesis: ``make_predict_fn`` of the port on the CPU against the JAX package's,
  the same flax weights (every leaf moved by seeded noise, so that the location
  bias counts) and source, to the step cap and with an early exit whose threshold
  comes from the JAX run's own stop probabilities. The fused branch (the kernel's
  plain version) against the JAX Pallas kernel in interpret mode, prenet dropout
  off; the step-by-step path against the JAX XLA loop, prenet dropout 0.5 from the
  masks the JAX side draws. float32, 1e-4 on mgc, lf0, stop probabilities and
  alignments; lengths, flags and step counts exact.
* Training: one ``train_step`` and one ``eval_step`` against the JAX trainer from
  the same weights and batch (``test_torch_mgclf0_training.py``'s steps), every
  stochastic rate 0, float32: the loss parts and ``grad_norm``, every gradient
  leaf (the location parameters among them, which must not be zero) to 1e-4 of its
  largest entry, every updated parameter, the evaluation's losses and frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.synthesis import make_predict_fn as jax_make_predict_fn

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.synthesis import make_predict_fn

from test_torch_helpers import assert_close, load_from_flax
from test_torch_mgclf0_model import HEADS, LF0S, MGCS, MODELS
from test_torch_mgclf0_training import _batch, _jax_step, _port_step
from test_torch_synthesis import MAX_ITERS, SRC_LENGTHS, _NARROW as _SYNTH_NARROW
from test_torch_synthesis import _jax_prenet_masks, _source, _threshold_with_early_exit
from test_torch_training import ATOL, _NARROW as _TRAIN_NARROW

LS = dict(attention="location_sensitive", attention_kernel=7, attention_filters=4,
          cumulative_weights=True)
# the stop columns spread, so that a threshold lets the lanes fire at steps of their own
STOP_SPREAD = {"mgclf0": 8.0, "flagship_mgclf0": 8.0}


def _synthesis_kw(model, **overrides):
    return dict(_SYNTH_NARROW, num_mgcs=MGCS, num_lf0s=LF0S, **MODELS[model], **LS,
                attention1_out_units=16, **overrides)


_variables = {}


def _synthesis_variables(model):
    if model not in _variables:
        hp = JaxHParams(**_synthesis_kw(model))
        net = jax_factory(hp).network(is_training=True)
        variables = dict(net.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
             "zoneout": jax.random.PRNGKey(2)},
            jnp.asarray(_source()), jnp.asarray(SRC_LENGTHS),
            jnp.zeros((3, 4, MGCS + LF0S), jnp.float32), jnp.full((3,), 4, jnp.int32),
        ))
        # flax starts the location bias at zero: move every leaf, so that it counts
        rng = np.random.default_rng(4)
        variables = jax.tree.map(
            lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)),
            variables)
        params = dict(variables["params"])
        params["decoder"] = dict(params["decoder"])
        proj = dict(params["decoder"]["output_projection"])
        proj["kernel"] = proj["kernel"].at[:, -hp.outputs_per_step:].multiply(STOP_SPREAD[model])
        params["decoder"]["output_projection"] = proj
        _variables[model] = dict(variables, params=params)
    return _variables[model]


def _synthesize(model, fused, threshold):
    """(port, JAX) outputs of one request: the fused branches without dropout, the
    step-by-step paths with dropout 0.5 from the JAX side's masks."""
    kw = _synthesis_kw(model, stop_token_threshold=threshold,
                       decoder_prenet_drop_rate=0.0 if fused else 0.5)
    rng = jax.random.PRNGKey(11)
    batch = {"source": jnp.asarray(_source()), "source_lengths": jnp.asarray(SRC_LENGTHS)}
    hp = JaxHParams(**kw)
    want = jax_make_predict_fn(jax_factory(hp), max_iters=MAX_ITERS, use_fused=fused)(
        _synthesis_variables(model), batch, rng)
    masks = None if fused else _jax_prenet_masks(rng, hp)
    port_hp = HParams(**kw)
    net = load_from_flax(tacotron_model_factory(port_hp).network(device="cpu"),
                         _synthesis_variables(model), port_hp)
    got = make_predict_fn(net, max_iters=MAX_ITERS, device="cpu", use_fused=fused)(
        {"source": _source(), "source_lengths": SRC_LENGTHS}, prenet_masks=masks)
    return got, jax.tree.map(np.asarray, want)


def _compare_synthesis(got, want):
    assert "mel" not in got and got["mgc"].shape == (3, MAX_ITERS * 2, MGCS)
    assert got["lf0"].shape == (3, MAX_ITERS * 2, LF0S)
    for key in HEADS + ("stop_probs",):
        assert_close(got[key], want[key], atol=1e-4)
    assert len(got["alignments"]) == len(want["alignments"])
    for g, w in zip(got["alignments"], want["alignments"]):
        assert_close(g, w, atol=1e-4)
    for key in ("lengths", "finished"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    assert int(got["num_steps"]) == int(want["num_steps"])


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
def test_synthesis_matches_jax_to_the_step_cap_and_with_early_exit(model, fused):
    got, want = _synthesize(model, fused, 2.0)
    assert int(want["num_steps"]) == MAX_ITERS and not want["finished"].any()
    _compare_synthesis(got, want)
    threshold = _threshold_with_early_exit(want["stop_probs"])
    got, want = _synthesize(model, fused, threshold)
    assert int(want["num_steps"]) < MAX_ITERS and want["finished"].all()
    assert len(set(want["lengths"].tolist())) > 1
    _compare_synthesis(got, want)


@pytest.fixture(scope="module", params=sorted(MODELS))
def runs(request, tmp_path_factory):
    """One update and one evaluation of the model class on both sides, float32."""
    kw = dict(_TRAIN_NARROW, num_mgcs=MGCS, num_lf0s=LF0S, **MODELS[request.param], **LS)
    batch = _batch()
    want = _jax_step(kw, batch, tmp_path_factory.mktemp("ckpt"), "float32")
    return {"jax": want, "port": _port_step(kw, batch, want["start"], "float32")}


def test_train_step_matches_jax_leaf_by_leaf(runs):
    got, want = runs["port"], runs["jax"]
    assert set(got["metrics"]) == set(want["metrics"])
    assert {"mgc_loss", "lf0_loss", "done_loss", "grad_norm"} <= set(got["metrics"])
    for key, value in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][key], value, atol=ATOL, rtol=1e-4, err_msg=key)
    assert set(got["grads"]) == set(want["grads"])
    location = [k for k in want["grads"] if "location_conv" in k or "location_layer" in k
                or k.endswith("attention_b")]
    assert len(location) == 4, location
    for key in location:
        assert float(np.abs(want["grads"][key]).max()) > 0.0, key
    for key, ref in want["grads"].items():
        largest = float(np.abs(ref).max())
        np.testing.assert_allclose(got["grads"][key], ref, atol=ATOL * max(largest, 1e-3),
                                   rtol=0, err_msg=key)
    for key, ref in want["params"].items():
        np.testing.assert_allclose(got["params"][key], ref, atol=ATOL, rtol=0, err_msg=key)


def test_eval_step_matches_jax(runs):
    (got_losses, got_frames, got_stop) = runs["port"]["evaluated"]
    (want_losses, want_frames, want_stop) = runs["jax"]["evaluated"]
    assert set(got_losses) == set(want_losses) >= {"mgc_loss", "lf0_loss", "done_loss"}
    for key, value in want_losses.items():
        np.testing.assert_allclose(got_losses[key], value, atol=ATOL, rtol=1e-4, err_msg=key)
    for head in HEADS:
        np.testing.assert_allclose(got_frames[head], want_frames[head], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_stop, want_stop, atol=ATOL, rtol=0)
