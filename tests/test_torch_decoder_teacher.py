"""The port's teacher-forced ``Decoder.forward`` against the JAX package's decoder.

The flax network is initialised through its teacher-forced pass and its
variables are loaded into the port. The same conditioning (memories from a numpy
seed, keys from the flax decoder's own memory layers) and the same targets go
through ``Decoder.__call__`` of the JAX package, once on its XLA scan path and
once on its fused path (Pallas kernels in interpret mode), and through the
port's ``forward``: its plain scan, and the hand-over of the weights to
``ops/fused_teacher.py`` (on CPU tensors that module's plain version). Dropout
is 0 on both sides (the frameworks' streams differ); train zoneout is 0 against
JAX, and eval zoneout, which draws nothing, is 0.1.

Tolerance: 1e-4 absolute, float32 sums in another order over 5 decoder steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.decoders import DecoderConditioning as JaxConditioning
from self_attention_tacotron_tpu.models.models import TacotronNetwork as JaxNetwork
from self_attention_tacotron_tpu.ops import fused_teacher as jax_teacher

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.decoders import DecoderConditioning
from self_attention_tacotron_torch.models.models import TacotronNetwork

from test_torch_helpers import assert_close, load_from_flax, t

B, S, T = 3, 9, 10
LENGTHS = np.array([9, 5, 2], np.int32)
ATOL = 1e-4

_NARROW = dict(
    decoder="DualSourceSelfAttentionDecoder",
    num_symbols=20, embedding_dim=16,
    encoder_prenet_out_units=(16, 8), encoder_prenet_drop_rate=0.0,
    cbhg_out_units=16, conv_channels=8, max_filter_width=3,
    projection1_out_channels=8, projection2_out_channels=8, num_highway=1,
    self_attention_out_units=16, self_attention_transformer_ffn_units=24,
    self_attention_drop_rate=0.0,
    decoder_prenet_out_units=(16, 8), decoder_prenet_drop_rate=0.0,
    attention_out_units=16, attention1_out_units=12, attention2_out_units=4,
    decoder_out_units=16, decoder_self_attention_out_units=16,
    decoder_self_attention_drop_rate=0.0, num_mels=6, outputs_per_step=2,
)

CASES = {
    "forward": dict(train=True, zoneout=0.0),
    "transition_agent": dict(
        train=True, zoneout=0.0, use_forward_attention_transition_agent=True
    ),
    "speaker": dict(
        train=True, zoneout=0.0, use_speaker_embedding=True, num_speakers=3,
        speaker_embedding_dim=4,
    ),
    "eval_zoneout": dict(train=False, zoneout=0.1),
}


def _decode(net, cond, targets):
    return net.decoder(cond, targets)


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    case = dict(CASES[request.param])
    train, zoneout = case.pop("train"), case.pop("zoneout")
    kw = dict(_NARROW, zoneout_factor_cell=zoneout, zoneout_factor_output=zoneout, **case)
    rng = np.random.default_rng(5)
    source = rng.integers(1, 20, (B, S)).astype(np.int32)
    targets = rng.standard_normal((B, T, 6)).astype(np.float32)
    extra = {}
    if kw.get("use_speaker_embedding"):
        extra["speaker_id"] = jnp.asarray([0, 2, 1], jnp.int32)
    init_net = JaxNetwork(hparams=JaxHParams(**kw), is_training=True)
    variables = init_net.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "zoneout": jax.random.PRNGKey(2)},
        jnp.asarray(source), jnp.asarray(LENGTHS), jnp.asarray(targets),
        jnp.full((B,), T, jnp.int32), **extra,
    )
    variables = jax.tree.map(
        lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)),
        dict(variables),
    )
    jnet = JaxNetwork(hparams=JaxHParams(**kw), is_training=train)
    hp = HParams(**kw)
    port = load_from_flax(TacotronNetwork(hp), variables, hp).train(train)

    memories = tuple(rng.standard_normal((B, S, 16)).astype(np.float32) for _ in range(2))
    mask = np.arange(S)[None, :] < LENGTHS[:, None]
    speaker = None
    if kw.get("use_speaker_embedding"):
        speaker = rng.standard_normal((B, 4)).astype(np.float32)
    keys_j = jnet.apply(
        variables, tuple(map(jnp.asarray, memories)),
        method=lambda m, mems: m.decoder.compute_keys(mems),
    )
    cond_j = JaxConditioning(
        memories=tuple(map(jnp.asarray, memories)), keys=keys_j,
        masks=(jnp.asarray(mask), jnp.asarray(mask)),
        speaker_embed=None if speaker is None else jnp.asarray(speaker),
    )
    with torch.no_grad():
        keys = port.decoder.compute_keys(tuple(map(t, memories)))
    for g, w in zip(keys, keys_j):
        assert_close(g, np.asarray(w), atol=1e-5)
    cond = DecoderConditioning(
        memories=tuple(map(t, memories)), keys=keys, masks=(t(mask), t(mask)),
        speaker_embed=None if speaker is None else t(speaker),
    )
    return jnet, variables, cond_j, port, cond, targets


def _jax_forward(pair):
    jnet, variables, cond_j, _, _, targets = pair
    return jnet.apply(
        variables, cond_j, jnp.asarray(targets), method=_decode,
        rngs={"dropout": jax.random.PRNGKey(3), "zoneout": jax.random.PRNGKey(4)},
    )


def _compare(got, want):
    frames, stop, aligns, sa = got
    frames_j, stop_j, aligns_j, sa_j = want
    assert frames["mel"].shape == (B, T, 6) and stop.shape == (B, T)
    assert_close(frames["mel"], np.asarray(frames_j["mel"]), atol=ATOL)
    assert_close(stop, np.asarray(stop_j), atol=ATOL)
    assert len(aligns) == len(aligns_j) == 2
    for g, w in zip(aligns, aligns_j):
        assert g.shape == (B, T // 2, S)
        assert_close(g, np.asarray(w), atol=ATOL)
    assert len(sa) == len(sa_j) == 1
    assert_close(sa[0], np.asarray(sa_j[0]), atol=ATOL)


def test_forward_matches_the_jax_scan_path(pair):
    _, _, _, port, cond, targets = pair
    want = _jax_forward(pair)                      # on the CPU the JAX decoder scans
    with torch.no_grad():
        got = port.decoder(cond, t(targets))
    _compare(got, want)


def test_forward_matches_the_jax_fused_path(pair, monkeypatch):
    _, _, _, port, cond, targets = pair
    monkeypatch.setattr(jax_teacher, "FORCE_INTERPRET", True)
    calls = []
    original = jax_teacher.teacher_decode

    def spy(**kwargs):
        calls.append(1)
        return original(**kwargs)

    monkeypatch.setattr(jax_teacher, "teacher_decode", spy)
    want = _jax_forward(pair)
    assert calls, "the JAX decoder did not take its fused path"
    with torch.no_grad():
        got = port.decoder(cond, t(targets))
    _compare(got, want)


def test_the_hand_over_to_the_teacher_kernels_matches_the_jax_scan_path(pair):
    """``_fused_teacher_call`` (``vblk``, the fused query projection, the mask as
    a bias) followed by ``post``: what ``forward`` does on the card."""
    _, _, _, port, cond, targets = pair
    decoder = port.decoder
    assert decoder.fused_teacher_supported()
    want = _jax_forward(pair)
    with torch.no_grad():
        feeds = decoder.make_teacher_feeds(t(targets))
        features, aligns = decoder._fused_teacher_call(cond, feeds, None, 0)
        frames, stop, sa = decoder.post(features)
    _compare((frames, stop, aligns, sa), want)


def test_train_zoneout_and_prenet_dropout_are_the_same_on_both_of_the_ports_paths(pair):
    """With dropout 0.5 and train zoneout the plain scan and the hand-over draw
    the same masks from one generator seed: the same values to 1e-5."""
    _, _, _, port, cond, targets = pair
    decoder = port.decoder
    was_training = decoder.training
    rate = decoder.prenet.drop_rate
    cells = (decoder.attention_lstm, *decoder.decoder_lstms)
    factors = [(c.zoneout_factor_cell, c.zoneout_factor_output) for c in cells]
    try:
        decoder.train()
        decoder.prenet.drop_rate = 0.5
        for cell in cells:
            cell.zoneout_factor_cell, cell.zoneout_factor_output = 0.3, 0.2
        feeds = decoder.make_teacher_feeds(t(targets))
        masks, seed = decoder.draw_teacher_masks(
            B, T // 2, feeds.device, torch.Generator().manual_seed(7)
        )
        again = decoder.draw_teacher_masks(B, T // 2, feeds.device, torch.Generator().manual_seed(7))
        assert seed == again[1] and seed > 0
        assert all(torch.equal(a, b) for a, b in zip(masks, again[0]))
        assert [m.shape for m in masks] == [(B, T // 2, 16), (B, T // 2, 8)]
        with torch.no_grad():
            plain = decoder._plain_teacher_scan(cond, feeds, masks, seed)
            fused = decoder._fused_teacher_call(cond, feeds, masks, seed)
            other_seed = decoder._plain_teacher_scan(cond, feeds, masks, seed + 1)
        assert_close(fused[0], plain[0].numpy(), atol=1e-5)
        for g, w in zip(fused[1], plain[1]):
            assert_close(g, w.numpy(), atol=1e-5)
        assert float((other_seed[0] - plain[0]).abs().max()) > 1e-3   # the seed matters
    finally:
        decoder.train(was_training)
        decoder.prenet.drop_rate = rate
        for cell, (zc, zo) in zip(cells, factors):
            cell.zoneout_factor_cell, cell.zoneout_factor_output = zc, zo


def test_make_teacher_feeds(pair):
    jnet, variables, _, port, _, targets = pair
    want = jnet.apply(
        variables, jnp.asarray(targets), method=lambda m, x: m.decoder.make_teacher_feeds(x)
    )
    got = port.decoder.make_teacher_feeds(t(targets))
    assert got.shape == (B, T // 2, 6)
    assert float(got[:, 0].abs().max()) == 0.0                       # the go frame
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, 1:].numpy(), targets[:, 1:-1:2])
    with pytest.raises(ValueError, match="multiple of outputs_per_step"):
        port.decoder.make_teacher_feeds(t(targets[:, :-1]))


def test_post(pair):
    jnet, variables, _, port, _, _ = pair
    features = np.random.default_rng(8).standard_normal((B, T // 2, 16)).astype(np.float32)
    frames_j, stop_j, sa_j = jnet.apply(
        variables, jnp.asarray(features), method=lambda m, x: m.decoder.post(x),
        rngs={"dropout": jax.random.PRNGKey(3)},
    )
    with torch.no_grad():
        frames, stop, sa = port.decoder.post(t(features))
    assert_close(frames["mel"], np.asarray(frames_j["mel"]), atol=1e-5)
    assert_close(stop, np.asarray(stop_j), atol=1e-5)
    assert_close(sa[0], np.asarray(sa_j[0]), atol=1e-5)
    # causal: a row of the self-attention looks at no later step
    assert float(sa[0].triu(1).abs().max()) == 0.0
