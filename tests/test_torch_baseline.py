"""The baseline Tacotron family of the port against the JAX package, on the CPU.

``ExtendedTacotronV1Model``: a single-stream encoder (``EncoderV1``, prenet ->
CBHG, or ``ZoneoutEncoderV1``, prenet -> bidirectional ZoneoutLSTM), the
single-source ``ExtendedDecoder`` with forward attention, no decoder
self-attention. Same weights (flax init, moved by seeded noise where the init
leaves zeros, through ``convert``), same numpy-seeded inputs.

* the encoders in eval mode, to 1e-5 (float32 sums in another order);
* synthesis: JAX runs ``make_predict_fn(model, use_fused=False)``, the
  ``lax.while_loop`` decode, with its own decoder prenet masks, which the port
  is handed; the port runs its step-by-step loop and the plain version of the
  fused decode kernel (``use_fused=True, device="cpu"``). atol 1e-4 on mel, stop
  probabilities and alignments (fed back through 12 decoder steps); lengths,
  flags and step counts exact; to the step cap and with an early exit. The
  kernel's plain version against the Pallas kernel itself is in
  ``test_torch_fused_decode.py`` (variant ``extended_decoder``), the teacher
  scan with one source in ``test_torch_fused_teacher.py`` and the training step
  in ``test_torch_baseline_training.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models import encoders as jax_encoders
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.synthesis import make_predict_fn as jax_make_predict_fn

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models import encoders
from self_attention_tacotron_torch.models.models import (
    ExtendedTacotronV1Model,
    tacotron_model_factory,
)
from self_attention_tacotron_torch.synthesis import make_predict_fn

from test_torch_helpers import assert_close, load_from_flax, t
from test_torch_modules import KEY, _perturb, _randn
from test_torch_synthesis import (
    B,
    MAX_ITERS,
    S,
    SRC_LENGTHS,
    _jax_prenet_masks,
    _source,
    _threshold_with_early_exit,
)

NARROW = dict(
    tacotron_model="ExtendedTacotronV1Model",
    encoder="EncoderV1",
    decoder="ExtendedDecoder",
    attention="forward",
    num_symbols=30,
    embedding_dim=32,
    encoder_prenet_out_units=(32, 16),
    encoder_prenet_drop_rate=0.0,
    encoder_out_units=32,
    cbhg_out_units=32,
    conv_channels=16,
    max_filter_width=4,
    projection1_out_channels=16,
    projection2_out_channels=16,
    num_highway=2,
    decoder_prenet_out_units=(32, 16),
    attention_out_units=32,
    attention1_out_units=24,
    decoder_out_units=32,
    num_mels=10,
    outputs_per_step=2,
    max_iters=MAX_ITERS,
)
ENCODERS = ("EncoderV1", "ZoneoutEncoderV1")


# --------------------------------------------------------------------------- #
# Encoders
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize(
    "name", ["EncoderV1", "ZoneoutEncoderV1", "ZoneoutEncoderV1WithAccentType"]
)
def test_encoder_matches_jax(name):
    if name == "EncoderV1":
        kw = dict(
            cbhg_out_units=16, conv_channels=6, max_filter_width=4,
            projection1_out_channels=7, projection2_out_channels=8, num_highway=2,
            prenet_out_units=(12, 8), drop_rate=0.0,
        )
    else:
        kw = dict(out_units=16, prenet_out_units=(12, 8), drop_rate=0.0,
                  zoneout_factor_cell=0.1, zoneout_factor_output=0.2)
    x, acc = _randn(0, 3, 10, 12), _randn(1, 3, 10, 4)
    lengths = np.array([10, 1, 7])
    jax_cls, cls = getattr(jax_encoders, name), getattr(encoders, name)
    jenc = jax_cls(is_training=False, use_pallas=True, **kw)
    if name.endswith("WithAccentType"):
        args = (jnp.asarray(x), jnp.asarray(acc), jnp.asarray(lengths))
        port, port_args = cls(16, use_pallas=True, **kw), (t(x), t(acc), t(lengths))
    else:
        args = (jnp.asarray(x), jnp.asarray(lengths))
        port, port_args = cls(12, use_pallas=True, **kw), (t(x), t(lengths))
    variables = _perturb(jenc.init({"params": KEY, "dropout": KEY}, *args))
    want = jenc.apply(variables, *args, rngs={"dropout": KEY})
    load_from_flax(port, variables)
    with torch.no_grad():
        got = port(*port_args)
    assert torch.is_tensor(got) and got.shape == (3, 10, 16)     # one memory, as in JAX
    assert_close(got, np.asarray(want), atol=1e-5)
    assert float(got[1, 1:].abs().max()) == 0.0 and float(got[1, 0].abs().max()) > 0.0


def test_the_baseline_model_pins_its_decoder_and_refuses_a_dual_stream_encoder():
    hp = HParams(tacotron_model="ExtendedTacotronV1Model", decoder="DualSourceDecoder",
                 encoder="ZoneoutEncoderV1")
    model = tacotron_model_factory(hp)
    assert isinstance(model, ExtendedTacotronV1Model) and hp.decoder == "ExtendedDecoder"
    net = model.network(device="cpu")
    assert net.decoder.num_attentions == 1 and net.decoder.self_attention is None
    assert net.decoder.attention_0.memory_layer.in_features == hp.encoder_out_units
    with pytest.raises(ValueError, match="single-stream"):
        tacotron_model_factory(HParams(tacotron_model="ExtendedTacotronV1Model",
                                       encoder="SelfAttentionCBHGEncoder"))


# --------------------------------------------------------------------------- #
# Synthesis
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module", params=ENCODERS)
def jax_side(request):
    hp = JaxHParams(**dict(NARROW, encoder=request.param))
    net = jax_factory(hp).network(is_training=True)
    source, lengths = jnp.asarray(_source()), jnp.asarray(SRC_LENGTHS)
    variables = dict(net.init(
        {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(1),
         "zoneout": jax.random.PRNGKey(2)},
        source, lengths, jnp.zeros((B, 4, hp.num_mels), jnp.float32), jnp.full((B,), 4, jnp.int32),
    ))
    # without a self-attention block the narrow decoder's stop probabilities sit
    # within 0.05 of 0.5; a larger output projection spreads them, so that lanes
    # fire at steps of their own
    params = dict(variables["params"])
    params["decoder"] = dict(params["decoder"])
    proj = dict(params["decoder"]["output_projection"])
    proj["kernel"] = proj["kernel"] * 8.0
    params["decoder"]["output_projection"] = proj
    variables["params"] = params
    return request.param, variables, {"source": source, "source_lengths": lengths}, {}


def _run_jax(jax_side, threshold):
    encoder, variables, batch, cache = jax_side
    if threshold not in cache:
        hp = JaxHParams(**dict(NARROW, encoder=encoder, stop_token_threshold=threshold))
        predict = jax_make_predict_fn(jax_factory(hp), max_iters=MAX_ITERS, use_fused=False)
        rng = jax.random.PRNGKey(11)
        cache[threshold] = (
            jax.tree.map(np.asarray, predict(variables, batch, rng)), _jax_prenet_masks(rng, hp)
        )
    return cache[threshold]


def _run_torch(jax_side, threshold, masks, use_fused, early_exit=True):
    encoder, variables, _, _ = jax_side
    hp = HParams(**dict(NARROW, encoder=encoder, stop_token_threshold=threshold))
    net = load_from_flax(tacotron_model_factory(hp).network(device="cpu"), variables, hp)
    predict = make_predict_fn(net, max_iters=MAX_ITERS, device="cpu", early_exit=early_exit,
                              use_fused=use_fused)
    return predict({"source": _source(), "source_lengths": SRC_LENGTHS}, prenet_masks=masks)


def _compare(got, want):
    for key in ("mel", "stop_probs"):
        assert_close(got[key], want[key], atol=1e-4)
    assert len(got["alignments"]) == len(want["alignments"]) == 1
    assert_close(got["alignments"][0], want["alignments"][0], atol=1e-4)
    assert got["encoder_sa_alignments"] == () and len(want["encoder_sa_alignments"]) == 0
    np.testing.assert_array_equal(got["lengths"].numpy(), want["lengths"])
    np.testing.assert_array_equal(got["finished"].numpy(), want["finished"])
    assert int(got["num_steps"]) == int(want["num_steps"])
    assert got["lengths"].dtype == torch.int32 and got["finished"].dtype == torch.bool


@pytest.mark.parametrize("use_fused", [False, True], ids=["step_by_step", "fused_plain"])
def test_synthesis_matches_jax_to_the_step_cap(jax_side, use_fused):
    want, masks = _run_jax(jax_side, 2.0)     # a probability never exceeds 2
    got = _run_torch(jax_side, 2.0, masks, use_fused)
    assert int(want["num_steps"]) == MAX_ITERS and not want["finished"].any()
    assert got["mel"].shape == (B, MAX_ITERS * 2, 10)
    assert [a.shape for a in got["alignments"]] == [(B, MAX_ITERS, S)]
    assert float(got["mel"].abs().max()) > 0.0
    _compare(got, want)


@pytest.mark.parametrize("use_fused", [False, True], ids=["step_by_step", "fused_plain"])
def test_synthesis_early_exit_matches_jax(jax_side, use_fused):
    threshold = _threshold_with_early_exit(_run_jax(jax_side, 2.0)[0]["stop_probs"])
    want, masks = _run_jax(jax_side, threshold)
    got = _run_torch(jax_side, threshold, masks, use_fused)
    assert int(want["num_steps"]) < MAX_ITERS and want["finished"].all()
    assert len(set(want["lengths"].tolist())) > 1     # lanes finish at different steps
    _compare(got, want)
    steps = int(got["num_steps"])
    assert float(got["mel"][:, steps * 2 :].abs().max()) == 0.0
