"""A training decoder with one or three decoder LSTMs against the JAX package's XLA scan.

JAX's ``Decoder`` draws one keep-mask pair per LSTM cell (``decoders.py:555-567``)
for any count of decoder LSTMs; the port draws them the same way from the step's
generator where the count is not the kernels' two (``draw_teacher_masks``). Both
networks are built with ``num_decoder_layers`` of 1 and 3 (a field no hparam sets:
the test patches each package's decoder construction), the flax variables loaded
into the port, and the masks that JAX's scan draws (prenet dropout 0.5, zoneout
0.3 / 0.2, rebuilt from the decoder's own ``make_rng`` streams) injected into the
port's scan. Frames, stop logits and alignments to 1e-5 over 5 decoder steps.
About 30 s on one worker.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models import decoders as jax_decoders
from self_attention_tacotron_tpu.models import models as jax_models
from self_attention_tacotron_tpu.models.decoders import DecoderConditioning as JaxConditioning

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models import decoders
from self_attention_tacotron_torch.models import models
from self_attention_tacotron_torch.models.decoders import DecoderConditioning

from test_torch_decoder_teacher import _NARROW, B, LENGTHS, S, T
from test_torch_helpers import assert_close, load_from_flax, t

ATOL = 1e-5
ZC, ZO, DROP = 0.3, 0.2, 0.5
RNGS = {"dropout": jax.random.PRNGKey(3), "zoneout": jax.random.PRNGKey(4)}


@pytest.fixture(scope="module", params=[1, 3], ids=lambda n: f"{n}_lstms")
def pair(request):
    layers = request.param
    kw = dict(_NARROW, zoneout_factor_cell=ZC, zoneout_factor_output=ZO,
              decoder_prenet_drop_rate=DROP)
    # JAX's network builds its decoder lazily, at every apply: the patch stays for the
    # module's tests
    patch = pytest.MonkeyPatch()
    jax_kwargs = jax_decoders._decoder_kwargs
    patch.setattr(jax_decoders, "_decoder_kwargs",
                  lambda *a, **k: dict(jax_kwargs(*a, **k), num_decoder_layers=layers))
    patch.setattr(decoders, "Decoder",
                  functools.partial(decoders.Decoder, num_decoder_layers=layers))
    rng = np.random.default_rng(11)
    source = rng.integers(1, 20, (B, S)).astype(np.int32)
    targets = rng.standard_normal((B, T, 6)).astype(np.float32)
    variables = jax_models.TacotronNetwork(hparams=JaxHParams(**kw), is_training=True).init(
        {"params": jax.random.PRNGKey(0), **RNGS}, jnp.asarray(source),
        jnp.asarray(LENGTHS), jnp.asarray(targets), jnp.full((B,), T, jnp.int32),
    )
    jnet = jax_models.TacotronNetwork(hparams=JaxHParams(**kw), is_training=True)
    hp = HParams(**kw)
    port = load_from_flax(models.TacotronNetwork(hp), variables, hp).train(True)
    assert len(port.decoder.decoder_lstms) == layers
    memories = tuple(rng.standard_normal((B, S, 16)).astype(np.float32) for _ in range(2))
    mask = np.arange(S)[None, :] < LENGTHS[:, None]
    keys_j = jnet.apply(variables, tuple(map(jnp.asarray, memories)),
                        method=lambda m, mems: m.decoder.compute_keys(mems))
    cond_j = JaxConditioning(memories=tuple(map(jnp.asarray, memories)), keys=keys_j,
                             masks=(jnp.asarray(mask), jnp.asarray(mask)), speaker_embed=None)
    with torch.no_grad():
        keys = port.decoder.compute_keys(tuple(map(t, memories)))
    cond = DecoderConditioning(memories=tuple(map(t, memories)), keys=keys,
                               masks=(t(mask), t(mask)), speaker_embed=None)
    yield layers, kw, jnet, variables, cond_j, port, cond, targets
    patch.undo()


def jax_masks(jnet, variables, kw, layers):
    """The prenet and zoneout masks JAX's scan draws (``Decoder.__call__``'s own lines,
    from the first key of each of the decoder's streams)."""
    n = T // kw["outputs_per_step"]
    dkey, zkey = jnet.apply(variables, rngs=RNGS, method=lambda m: (
        m.decoder.make_rng("dropout"), m.decoder.make_rng("zoneout")))
    pkeys = jax.random.split(dkey, len(kw["decoder_prenet_out_units"]))
    prenet = tuple(np.array(jax.random.bernoulli(k, 1.0 - DROP, (B, n, u)))
                   for k, u in zip(pkeys, kw["decoder_prenet_out_units"]))
    units = [kw["attention_out_units"]] + [kw["decoder_out_units"]] * layers
    zkeys = jax.random.split(zkey, 2 * len(units))
    zoneout = tuple(
        (np.array(jax.random.bernoulli(zkeys[2 * i], ZC, (B, n, u))),
         np.array(jax.random.bernoulli(zkeys[2 * i + 1], ZO, (B, n, u))))
        for i, u in enumerate(units))
    return prenet, zoneout


def test_scan_matches_the_jax_xla_scan_with_injected_masks(pair):
    layers, kw, jnet, variables, cond_j, port, cond, targets = pair
    want = jnet.apply(variables, cond_j, jnp.asarray(targets), rngs=RNGS,
                      method=lambda m, c, x: m.decoder(c, x))
    prenet, zoneout = jax_masks(jnet, variables, kw, layers)
    decoder = port.decoder
    with torch.no_grad():
        feeds = decoder.make_teacher_feeds(t(targets))
        features, aligns = decoder._plain_teacher_scan(
            cond, feeds, tuple(torch.as_tensor(m) for m in prenet),
            tuple(tuple(torch.as_tensor(m).transpose(0, 1) for m in pair) for pair in zoneout))
        frames, stop, _ = decoder.post(features)
    frames_j, stop_j, aligns_j, _ = want
    assert_close(frames["mel"], np.asarray(frames_j["mel"]), atol=ATOL)
    assert_close(stop, np.asarray(stop_j), atol=ATOL)
    for g, w in zip(aligns, aligns_j):
        assert_close(g, np.asarray(w), atol=ATOL)
    # the masks matter: the same scan with every mask flipped is another result
    with torch.no_grad():
        other, _ = decoder._plain_teacher_scan(
            cond, feeds, tuple(torch.as_tensor(m) for m in prenet),
            tuple(tuple(~torch.as_tensor(m).transpose(0, 1) for m in pair) for pair in zoneout))
    assert float((other - features).abs().max()) > 1e-3


def test_forward_draws_a_mask_pair_per_cell_from_the_generator(pair):
    layers, kw, _, _, _, port, cond, targets = pair
    decoder = port.decoder
    n = T // kw["outputs_per_step"]
    prenet, zoneout = decoder.draw_teacher_masks(B, n, "cpu", torch.Generator().manual_seed(5))
    assert len(zoneout) == 1 + layers
    widths = [kw["attention_out_units"]] + [kw["decoder_out_units"]] * layers
    for (cell, out), width in zip(zoneout, widths):
        assert cell.shape == out.shape == (n, B, width) and cell.dtype == torch.bool
    rates = [float(torch.cat([p[0].flatten() for p in zoneout]).float().mean()),
             float(torch.cat([p[1].flatten() for p in zoneout]).float().mean())]
    assert abs(rates[0] - ZC) < 0.1 and abs(rates[1] - ZO) < 0.1
    runs = []
    for _ in range(2):
        out = decoder(cond, t(targets), generator=torch.Generator().manual_seed(5))
        runs.append(out[0]["mel"].detach())
        out[0]["mel"].sum().backward()
        assert all(p.grad is not None for p in decoder.decoder_lstms[-1].parameters())
        decoder.zero_grad()
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="decoder LSTMs take the zoneout masks"):
        decoder._plain_teacher_scan(cond, decoder.make_teacher_feeds(t(targets)), prenet, 7)
