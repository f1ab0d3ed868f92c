"""The port's synthesis slice as a whole against the JAX package, on the CPU.

Same weights (flax init -> convert), same source ids (numpy seed), the same
decoder prenet masks (drawn as the JAX ``predict`` draws them and handed to
the port), encoder prenet dropout off on both sides. JAX runs
``make_predict_fn(model, use_fused=False)``, the ``lax.while_loop`` decode.
Tolerance: atol 1e-4 on floats (float32 sums in another order, fed back
through up to 12 decoder steps); integers and flags exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.synthesis import make_predict_fn as jax_make_predict_fn

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.synthesis import make_predict_fn

from test_torch_helpers import assert_close, load_from_flax

MAX_ITERS = 12
B, S = 3, 11
SRC_LENGTHS = np.array([11, 7, 4], np.int32)

_NARROW = dict(
    tacotron_model="DualSourceSelfAttentionTacotronModel",
    encoder="SelfAttentionCBHGEncoder",
    decoder="DualSourceSelfAttentionDecoder",
    attention="forward",
    attention2="additive",
    num_symbols=30,
    embedding_dim=32,
    encoder_prenet_out_units=(32, 16),
    encoder_prenet_drop_rate=0.0,
    cbhg_out_units=32,
    conv_channels=16,
    max_filter_width=4,
    projection1_out_channels=16,
    projection2_out_channels=16,
    num_highway=2,
    self_attention_out_units=32,
    self_attention_num_heads=2,
    self_attention_transformer_ffn_units=64,
    decoder_prenet_out_units=(32, 16),
    attention_out_units=32,
    attention1_out_units=24,
    attention2_out_units=8,
    decoder_out_units=32,
    decoder_self_attention_out_units=32,
    decoder_self_attention_num_heads=2,
    num_mels=10,
    outputs_per_step=2,
    max_iters=MAX_ITERS,
)


def _source():
    rng = np.random.default_rng(7)
    return rng.integers(1, 30, size=(B, S)).astype(np.int32)


def _jax_prenet_masks(rng, hp):
    # the three lines of the JAX predict that draw the decoder's prenet masks
    _, dec_rng = jax.random.split(rng)
    keep = 1.0 - hp.decoder_prenet_drop_rate
    mask_keys = jax.random.split(dec_rng, len(hp.decoder_prenet_out_units) + 1)
    return tuple(
        np.asarray(jax.random.bernoulli(k, keep, (MAX_ITERS, B, units)))
        for k, units in zip(mask_keys[:-1], hp.decoder_prenet_out_units)
    )


@pytest.fixture(scope="module")
def jax_side():
    hp = JaxHParams(**_NARROW)
    model = jax_factory(hp)
    net = model.network(is_training=True)
    source = jnp.asarray(_source())
    lengths = jnp.asarray(SRC_LENGTHS)
    targets = jnp.zeros((B, 4, hp.num_mels), jnp.float32)
    variables = net.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "zoneout": jax.random.PRNGKey(2)},
        source, lengths, targets, jnp.full((B,), 4, jnp.int32),
    )
    return hp, dict(variables), {"source": source, "source_lengths": lengths}


def _run_jax(jax_side, threshold):
    hp, variables, batch = jax_side
    hp.stop_token_threshold = threshold
    predict = jax_make_predict_fn(jax_factory(hp), max_iters=MAX_ITERS, use_fused=False)
    rng = jax.random.PRNGKey(11)
    out = predict(variables, batch, rng)
    return jax.tree.map(np.asarray, out), _jax_prenet_masks(rng, hp)


def _run_torch(jax_side, threshold, masks, early_exit=True):
    _, variables, _ = jax_side
    hp = HParams(**_NARROW)
    hp.stop_token_threshold = threshold
    net = load_from_flax(tacotron_model_factory(hp).network(device="cpu"), variables, hp)
    predict = make_predict_fn(net, max_iters=MAX_ITERS, device="cpu", early_exit=early_exit)
    return predict(
        {"source": _source(), "source_lengths": SRC_LENGTHS}, prenet_masks=masks
    )


def _compare(got, want):
    for key in ("mel", "stop_probs"):
        assert_close(got[key], want[key], atol=1e-4)
    for g, w in zip(got["alignments"], want["alignments"]):
        assert_close(g, w, atol=1e-4)
    assert len(got["encoder_sa_alignments"]) == len(want["encoder_sa_alignments"]) == 1
    for g, w in zip(got["encoder_sa_alignments"], want["encoder_sa_alignments"]):
        assert_close(g, w, atol=1e-4)
    np.testing.assert_array_equal(got["lengths"].numpy(), want["lengths"])
    np.testing.assert_array_equal(got["finished"].numpy(), want["finished"])
    assert int(got["num_steps"]) == int(want["num_steps"])
    assert got["lengths"].dtype == torch.int32 and got["finished"].dtype == torch.bool


def _threshold_with_early_exit(stop_probs):
    """A threshold, taken from the JAX run's own stop probabilities, at which every
    lane fires before the cap, not all at the same step, and no probability is
    within 1e-3 of it."""
    r = stop_probs.shape[1] // MAX_ITERS
    values = np.sort(np.unique(stop_probs))
    for lo, hi in zip(values[:-1], values[1:]):
        if hi - lo < 4e-3:
            continue
        thr = float((lo + hi) / 2)
        fired = stop_probs > thr
        if not fired.any(axis=1).all():
            continue
        first_step = fired.argmax(axis=1) // r
        if first_step.max() < MAX_ITERS - 2 and len(set(first_step.tolist())) > 1:
            return thr
    raise AssertionError("no threshold separates the lanes; change the seed")


def test_synthesis_matches_jax_to_the_step_cap(jax_side):
    want, masks = _run_jax(jax_side, threshold=2.0)   # a probability never exceeds 2
    got = _run_torch(jax_side, 2.0, masks)
    assert int(want["num_steps"]) == MAX_ITERS and not want["finished"].any()
    assert got["mel"].shape == (B, MAX_ITERS * 2, 10)
    assert got["stop_probs"].shape == (B, MAX_ITERS * 2)
    assert [a.shape for a in got["alignments"]] == [(B, MAX_ITERS, S)] * 2
    assert got["encoder_sa_alignments"][0].shape == (B, 2, S, S)
    _compare(got, want)


def test_synthesis_early_exit_matches_jax(jax_side):
    full, masks = _run_jax(jax_side, threshold=2.0)
    threshold = _threshold_with_early_exit(full["stop_probs"])
    want, masks = _run_jax(jax_side, threshold=threshold)
    got = _run_torch(jax_side, threshold, masks)
    assert int(want["num_steps"]) < MAX_ITERS
    assert want["finished"].all()
    assert len(set(want["lengths"].tolist())) > 1     # lanes finish at different steps
    _compare(got, want)
    # beyond the exit the buffers stay zero on both sides
    steps = int(got["num_steps"])
    assert float(got["mel"][:, steps * 2 :].abs().max()) == 0.0


def test_without_early_exit_the_lanes_come_out_the_same(jax_side):
    full, masks = _run_jax(jax_side, threshold=2.0)
    threshold = _threshold_with_early_exit(full["stop_probs"])
    early = _run_torch(jax_side, threshold, masks)
    late = _run_torch(jax_side, threshold, masks, early_exit=False)
    steps = int(early["num_steps"])
    assert steps < MAX_ITERS and int(late["num_steps"]) == MAX_ITERS
    assert torch.equal(early["lengths"], late["lengths"])
    assert torch.equal(early["finished"], late["finished"])
    assert torch.equal(early["mel"][:, : steps * 2], late["mel"][:, : steps * 2])
    assert float(late["mel"][:, steps * 2 :].abs().max()) > 0.0
