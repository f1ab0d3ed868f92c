"""Which decode a request takes: the configurations the kernel serves, and auto mode.

* ``supports_fused_decode`` of the port equals the JAX package's over every decoder
  x attention mechanism x head family that a model class reaches (the decoders each
  class pins or keeps, with the mel head or the WORLD heads), in both compute dtypes,
  and with location-sensitive attention on every decoder. One difference is named
  and held as a difference: the port refuses widths at which the first decoder LSTM
  takes a residual (the JAX kernels drop it, ``ROADMAP.md`` §3).
* ``synthesis.decode_fused``, the decision of ``make_predict_fn``: in auto mode
  (``use_fused=None``) the kernel wherever the configuration is served and the
  device is the card, whatever the request's source length (one block's shared
  memory does not grow with it). Where a block cannot fit an SM at all, the fused
  decode on the card raises: nothing gives way to the step-by-step loop.
"""

import types

import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.ops import fused_decode as jax_fused_decode

from self_attention_tacotron_torch import synthesis
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import TacotronModelBase, tacotron_model_factory
from self_attention_tacotron_torch.ops import fused_decode as fd
from self_attention_tacotron_torch.tools.flagship import config_hparams

from test_torch_synthesis import SRC_LENGTHS, _NARROW, _source

# (model class, decoder, encoder): the decoders each model class pins or keeps. The
# mel model class keeps any decoder named DualSource*, the MgcLf0 ones too, but its
# loss reads a mel head, which they do not have: those pairs are no configuration.
REACHED = (
    ("ExtendedTacotronV1Model", "ExtendedDecoder", "EncoderV1"),
    ("DualSourceSelfAttentionTacotronModel", "DualSourceSelfAttentionDecoder",
     "SelfAttentionCBHGEncoder"),
    ("DualSourceSelfAttentionTacotronModel", "DualSourceDecoder", "SelfAttentionCBHGEncoder"),
    ("MgcLf0TacotronModel", "MgcLf0ExtendedDecoder", "ZoneoutEncoderV1"),
    ("DualSourceSelfAttentionMgcLf0TacotronModel", "MgcLf0DualSourceSelfAttentionDecoder",
     "SelfAttentionCBHGEncoder"),
)
MECHANISMS = ("forward", "forward_transition_agent", "location_sensitive", "additive")
DTYPES = ("float32", "bfloat16")


def _both(**overrides):
    return HParams(**overrides), JaxHParams(**overrides)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("attention", MECHANISMS)
@pytest.mark.parametrize("model,decoder,encoder", REACHED)
def test_the_port_serves_what_the_jax_package_serves(model, decoder, encoder, attention, dtype):
    hp, jax_hp = _both(tacotron_model=model, decoder=decoder, encoder=encoder,
                       attention=attention, compute_dtype=dtype)
    assert tacotron_model_factory(hp).hparams.decoder == decoder
    want = jax_fused_decode.supports_fused_decode(jax_hp)
    assert fd.supports_fused_decode(hp) == want
    assert want == (attention != "additive")


@pytest.mark.parametrize("model,decoder,encoder", REACHED)
def test_the_residual_widths_are_a_named_difference(model, decoder, encoder):
    """Where the first decoder LSTM's input and output widths agree it takes a
    residual, which the JAX kernels drop: the port leaves those widths to the loop."""
    sizes = fd._hp_sizes(HParams(tacotron_model=model, decoder=decoder, encoder=encoder))
    width = sizes["AU"] + sizes["E1"] + sizes["E2"]
    hp, jax_hp = _both(tacotron_model=model, decoder=decoder, encoder=encoder,
                       decoder_out_units=width)
    assert jax_fused_decode.supports_fused_decode(jax_hp)
    assert not fd.supports_fused_decode(hp)


DECODER_NAMES = [prefix + name for prefix in ("", "MgcLf0") for name in
                 ("ExtendedDecoder", "SelfAttentionDecoder", "DualSourceDecoder",
                  "DualSourceSelfAttentionDecoder")]


@pytest.mark.parametrize("decoder", DECODER_NAMES)
def test_location_sensitive_attention_is_served_on_every_decoder(decoder):
    """Every pair of the kernel's flags is compiled with location-sensitive attention,
    with the mel head and with the lf0 feedback, as the JAX kernel serves them, and
    packs (the plain version on the CPU runs them:
    ``test_torch_fused_decode_ls_branches.py``)."""
    overrides = dict(decoder=decoder, attention="location_sensitive", attention_kernel=7,
                     encoder="SelfAttentionCBHGEncoder" if "DualSource" in decoder
                     else "EncoderV1")
    hp, jax_hp = _both(**overrides)
    assert jax_fused_decode.supports_fused_decode(jax_hp)
    assert fd.supports_fused_decode(hp)
    net = TacotronModelBase(hp).network(device="cpu").eval()
    packed = fd.pack_decoder(net.decoder)
    assert packed.ls and packed.lf0 == decoder.startswith("MgcLf0")
    assert (packed.dual, packed.use_sa) == ("DualSource" in decoder,
                                            "SelfAttention" in decoder)


@pytest.mark.parametrize("config", ["flagship-ls", "flagship-mgclf0-ls"])
def test_auto_mode_takes_the_kernel_at_any_source_length(config):
    """The configurations with the largest blocks (the location matrix, the WORLD
    frames): one launch takes every lane whatever the source, and auto mode decodes
    on the card through the kernel."""
    for dtype in DTYPES:
        hp = config_hparams(config, compute_dtype=dtype)
        assert not torch.cuda.is_available()   # the plan of an H100 answers
        assert fd.fused_decode_max_batch(hp) == fd.MAX_LANES
        assert synthesis.decode_fused(hp, None, "cuda")


def test_a_block_that_cannot_fit_raises_on_the_card(monkeypatch):
    """Where one block cannot fit an SM, auto mode still takes the kernel, and the
    fused decode on the card raises: nothing gives way to the step-by-step loop."""
    monkeypatch.setattr(fd, "fused_decode_max_batch", lambda *a: 0)
    hp = config_hparams("flagship")
    assert synthesis.decode_fused(hp, None, "cuda")
    monkeypatch.setattr(fd, "_launch_limit", lambda *a: 0)
    monkeypatch.setattr(fd, "block_shared_memory", lambda *a: (300_000, 232_384))
    card = types.SimpleNamespace(flat=types.SimpleNamespace(device=torch.device("cuda", 0)),
                                 sizes=fd._hp_sizes(hp), io_dtype=torch.float32)
    cond = types.SimpleNamespace(memories=(torch.zeros(2, 4096, 8),))
    with pytest.raises(RuntimeError, match="cannot launch: one block needs 300000 bytes"):
        fd.fused_decode(card, cond, None, 500, 0.5)


def test_auto_mode_off_the_card_and_without_the_kernels():
    hp = config_hparams("flagship")
    assert not synthesis.decode_fused(hp, None, "cpu")
    assert not synthesis.decode_fused(config_hparams("flagship", use_pallas_kernels=False),
                                      None, "cuda")
    assert synthesis.decode_fused(hp, True, "cpu")
    assert not synthesis.decode_fused(hp, False, "cuda")
    unserved = config_hparams("flagship", attention="additive")
    assert not synthesis.decode_fused(unserved, None, "cuda")
    with pytest.raises(ValueError, match="not supported"):
        synthesis.decode_fused(unserved, True, "cpu")


def test_predict_decides_once_when_it_is_built(monkeypatch):
    """``make_predict_fn`` asks when it is built, not per request."""
    calls = []
    original = synthesis.decode_fused

    def spy(hp, use_fused, device_type):
        calls.append((use_fused, device_type))
        return original(hp, use_fused, device_type)

    monkeypatch.setattr(synthesis, "decode_fused", spy)
    hp = HParams(**_NARROW, stop_token_threshold=2.0)
    net = tacotron_model_factory(hp).network(device="cpu")
    predict = synthesis.make_predict_fn(net, max_iters=3, device="cpu", use_fused=True)
    for _ in range(2):
        out = predict({"source": _source(), "source_lengths": SRC_LENGTHS})
    assert calls == [(True, "cpu")]
    assert int(out["num_steps"]) == 3 and np.isfinite(out["mel"].numpy()).all()
