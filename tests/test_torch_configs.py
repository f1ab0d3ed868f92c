"""Each of the five ``configs/*.json`` as a whole model against the JAX package, on the CPU.

Each configuration is its JSON with narrow widths overridden and its structure
kept: the reduction factor (3 for ``ljspeech_griffinlim_streaming.json``), both
postnets (the linear one at its own widths, a BiGRU of 128 units), accent types,
speaker ids. Both sides start from the same weights (flax init, moved by seeded
noise, through ``convert``).

* Synthesis: JAX ``make_predict_fn(use_fused=False)`` against the port's
  ``make_predict_fn`` on the CPU, the same injected decoder prenet masks, at a stop
  threshold taken from the port's own stop probabilities at which the lanes stop at
  steps of their own; ``mel``, ``postnet_mel`` and ``linear`` over every frame,
  stop probabilities and alignments to 1e-4, lengths, flags and step counts exact.
* One training step: the JAX trainer's forward, loss and gradient against
  ``Trainer.train_step``, every stochastic rate 0 (the frameworks' random streams
  differ): every loss part (``postnet_loss`` and ``linear_loss`` among them) and
  ``grad_norm`` to 1e-4, every gradient leaf to 1e-4 of the leaf's largest entry,
  the batch statistics the step moves to 1e-4.
* ``streaming`` at r = 3: the port's fused decode (its plain version on the CPU)
  against the JAX package's Pallas ``fused_decode`` in interpret mode, prenet dropout
  off on both sides (that kernel draws its own masks), postnets included.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.synthesis import make_predict_fn as jax_make_predict_fn
from self_attention_tacotron_tpu.training import trainer as jax_trainer

from self_attention_tacotron_torch import convert
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.synthesis import make_predict_fn
from self_attention_tacotron_torch.tools.flagship import config_batch, config_request
from self_attention_tacotron_torch.training.trainer import Trainer

from test_torch_helpers import assert_close, flat_variables
from test_torch_modules import _perturb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_FILES = ("japanese_pitch_accent", "ljspeech_baseline", "ljspeech_griffinlim_streaming",
                "ljspeech_selfattention", "vctk_multispeaker")
B, S, MAX_ITERS = 3, 9, 8
FRAMES = 12
ATOL = 1e-4

NARROW = dict(
    embedding_dim=16, accent_type_embedding_dim=6, speaker_embedding_dim=5,
    encoder_prenet_out_units=(16, 8), cbhg_out_units=16, conv_channels=8, max_filter_width=3,
    projection1_out_channels=8, projection2_out_channels=8, num_highway=1,
    self_attention_out_units=16, self_attention_transformer_ffn_units=24,
    decoder_prenet_out_units=(16, 8), attention_out_units=16, attention1_out_units=12,
    attention2_out_units=4, decoder_out_units=16, decoder_self_attention_out_units=16,
    num_mels=6, num_freq=9, postnet_v2_num_layers=3, postnet_v2_out_channels=7,
    encoder_prenet_drop_rate=0.0, max_iters=MAX_ITERS, use_gradient_clipping=False,
    initial_learning_rate=1e-3, adam_eps=1e-4,
)
# every stochastic rate of a training step
NO_DROPOUT = dict(decoder_prenet_drop_rate=0.0, self_attention_drop_rate=0.0,
                  decoder_self_attention_drop_rate=0.0, zoneout_factor_cell=0.0,
                  zoneout_factor_output=0.0, postnet_v2_drop_rate=0.0)


def config_kw(name: str, **overrides):
    """The JSON's values, then the narrow widths, then ``overrides``."""
    with open(os.path.join(REPO, "configs", f"{name}.json")) as f:
        kw = json.load(f)
    return {**kw, **NARROW, **overrides}


def _int32(batch):
    return {k: (v.astype(np.int32) if v.dtype == np.int64 else v) for k, v in batch.items()}


def jax_variables(kw, batch, seed=0):
    """Flax-initialised weights of ``kw``'s training network, moved off their init values."""
    hp = JaxHParams(**kw)
    model = jax_factory(hp)
    jbatch = {k: jnp.asarray(v) for k, v in _int32(batch).items()}
    key = jax.random.PRNGKey(seed)
    variables = jax.jit(lambda: model.network(is_training=True).init(
        {"params": key, "dropout": jax.random.fold_in(key, 1),
         "zoneout": jax.random.fold_in(key, 2)},
        jbatch["source"], jbatch["source_lengths"],
        jnp.zeros((B, 6, hp.num_mels), jnp.float32), jnp.full((B,), 6, jnp.int32),
        **jax_trainer._network_kwargs(model, jbatch),
    ))()
    return _perturb(variables, seed=seed + 3, scale=0.05)


def port_network(kw, variables, hp=None):
    hp = hp or HParams(**kw)
    net = tacotron_model_factory(hp).network(device="cpu")
    return convert.load_state(net, convert.flax_to_torch_state(flat_variables(variables), hp, net))


def jax_prenet_masks(rng, hp, steps, batch):
    """The decoder prenet masks the JAX ``predict`` draws from ``rng`` (its own three lines)."""
    _, dec_rng = jax.random.split(rng)
    keep = 1.0 - hp.decoder_prenet_drop_rate
    keys = jax.random.split(dec_rng, len(hp.decoder_prenet_out_units) + 1)
    return tuple(np.asarray(jax.random.bernoulli(k, keep, (steps, batch, units)))
                 for k, units in zip(keys[:-1], hp.decoder_prenet_out_units))


def separating_threshold(stop_probs, steps):
    """A threshold at which the lanes stop at steps of their own (a lane that never
    fires runs to the cap), one of them before the cap, and no probability lies
    within 2e-3 of it."""
    r = stop_probs.shape[1] // steps
    values = np.sort(np.unique(stop_probs))
    for lo, hi in zip(values[:-1], values[1:]):
        if hi - lo < 4e-3:
            continue
        thr = float((lo + hi) / 2)
        fired = stop_probs > thr
        first = np.where(fired.any(axis=1), fired.argmax(axis=1) // r, steps)
        if first.min() < steps - 1 and len(set(first.tolist())) > 1:
            return thr
    raise AssertionError("no threshold separates the lanes; change the seed")


def synthesis_pair(kw, req, use_fused=False, seed=0):
    """Both packages' synthesis of ``req`` from the same weights, at a threshold from the
    port's stop probabilities; returns (port output, JAX output as numpy)."""
    variables = jax_variables(kw, req, seed)
    rng = jax.random.PRNGKey(11)
    jhp = JaxHParams(**{**kw, "stop_token_threshold": 2.0})
    masks = jax_prenet_masks(rng, jhp, MAX_ITERS, B)
    hp = HParams(**{**kw, "stop_token_threshold": 2.0})
    net = port_network(kw, variables, hp)
    port_predict = make_predict_fn(net, max_iters=MAX_ITERS, device="cpu", use_fused=use_fused)
    to_cap = port_predict(req, prenet_masks=masks)
    threshold = separating_threshold(to_cap["stop_probs"].numpy(), MAX_ITERS)
    jhp.stop_token_threshold = hp.stop_token_threshold = threshold
    want = jax_make_predict_fn(jax_factory(jhp), max_iters=MAX_ITERS, use_fused=use_fused)(
        variables, {k: jnp.asarray(v) for k, v in _int32(req).items()}, rng)
    port_predict = make_predict_fn(net, max_iters=MAX_ITERS, device="cpu", use_fused=use_fused)
    got = port_predict(req, prenet_masks=None if use_fused else masks)
    return got, jax.tree.map(np.asarray, want)


def compare_synthesis(got, want, postnets=True):
    keys = ["mel", "stop_probs"] + (["postnet_mel", "linear"] if postnets else [])
    assert set(keys) <= set(got) and set(keys) <= set(want)
    assert ("postnet_mel" in got) == ("postnet_mel" in want)
    assert ("linear" in got) == ("linear" in want)
    for key in keys:
        assert got[key].shape == want[key].shape, key
        assert_close(got[key], want[key], atol=ATOL)
    for g, w in zip(got["alignments"], want["alignments"], strict=True):
        assert_close(g, w, atol=ATOL)
    for g, w in zip(got["encoder_sa_alignments"], want["encoder_sa_alignments"], strict=True):
        assert_close(g, w, atol=ATOL)
    np.testing.assert_array_equal(got["lengths"].numpy(), want["lengths"])
    np.testing.assert_array_equal(got["finished"].numpy(), want["finished"])
    assert int(got["num_steps"]) == int(want["num_steps"])
    assert bool(want["finished"].any()) and len(set(want["lengths"].tolist())) > 1


def request(kw, seed=5):
    return config_request(HParams(**kw), np.random.default_rng(seed), B, S, shortest=3)


def training_pair(kw, tmp_path_factory, seed=0):
    """One step on both sides from the same weights: the JAX trainer's forward, loss and
    gradient, and ``Trainer.train_step``. Returns numpy dictionaries."""
    hp = HParams(**kw)
    batch = _int32(config_batch(hp, np.random.default_rng(11), B, FRAMES, S, shortest=3))
    variables = jax_variables(kw, batch, seed)
    jmodel = jax_factory(JaxHParams(**kw))
    jt = jax_trainer.Trainer(jmodel, str(tmp_path_factory.mktemp("ckpt")))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(9)

    def loss_fn(params):
        out, stats = jt._forward(jt.net, params, variables["batch_stats"], jbatch, key,
                                 mutable=True)
        losses = jmodel.loss(out, jbatch, params=params)
        return losses["loss"], (losses, stats)

    grads, (losses, stats) = jax.jit(jax.grad(loss_fn, has_aux=True))(variables["params"])
    want = {k: float(v) for k, v in losses.items()}
    want["grad_norm"] = float(optax.global_norm(grads))

    model = tacotron_model_factory(hp)
    trainer = Trainer(model, device="cpu")
    state = trainer.init_state(port_network(kw, variables, hp))
    state, metrics = trainer.train_step(state, batch, torch.Generator().manual_seed(0))
    return dict(
        batch=batch, variables=variables,
        got={k: float(v) for k, v in metrics.items()}, want=want,
        grads=convert.torch_to_flax_flat(state.net, gradients=True),
        jax_grads=flat_variables({"params": grads}),
        stats={k: v for k, v in convert.torch_to_flax_flat(state.net).items()
               if k.startswith("batch_stats/")},
        jax_stats=flat_variables({"batch_stats": stats}),
    )


def compare_training(run, parts):
    got, want = run["got"], run["want"]
    assert set(got) == set(want) and set(parts) <= set(got)
    for key in want:
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=1e-4, err_msg=key)
    assert set(run["grads"]) == set(run["jax_grads"])
    nonzero = 0
    for key, w in run["jax_grads"].items():
        largest = float(np.abs(w).max())
        nonzero += largest > 0.0
        np.testing.assert_allclose(run["grads"][key], w, atol=ATOL * max(largest, 1e-3), rtol=0,
                                   err_msg=key)
    assert nonzero >= len(run["jax_grads"]) - 2
    assert set(run["stats"]) == set(run["jax_stats"])
    for key, w in run["jax_stats"].items():
        np.testing.assert_allclose(run["stats"][key], w, atol=ATOL, rtol=0, err_msg=key)


def _parts(kw):
    parts = {"loss", "mel_loss", "done_loss", "grad_norm"}
    if kw.get("use_postnet_v2"):
        parts.add("postnet_loss")
    if kw.get("use_linear_spectrogram_postnet"):
        parts.add("linear_loss")
    return parts


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_synthesis_of_every_config_against_jax(name):
    kw = config_kw(name)
    got, want = synthesis_pair(kw, request(kw))
    compare_synthesis(got, want, postnets=name == "ljspeech_griffinlim_streaming")
    if name == "ljspeech_griffinlim_streaming":
        assert kw["outputs_per_step"] == 3
        assert got["linear"].shape == (B, MAX_ITERS * 3, kw["num_freq"])


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_one_train_step_of_every_config_against_jax(name, tmp_path_factory):
    kw = config_kw(name, **NO_DROPOUT)
    run = training_pair(kw, tmp_path_factory)
    compare_training(run, _parts(kw))
    if name == "ljspeech_griffinlim_streaming":
        assert any(k.startswith("batch_stats/post_cbhg/") for k in run["jax_stats"])
        assert any(k.startswith("batch_stats/postnet_v2/") for k in run["jax_stats"])


def test_streaming_r3_fused_decode_against_the_pallas_kernel():
    kw = config_kw("ljspeech_griffinlim_streaming", decoder_prenet_drop_rate=0.0)
    got, want = synthesis_pair(kw, request(kw, seed=6), use_fused=True, seed=1)
    compare_synthesis(got, want)
