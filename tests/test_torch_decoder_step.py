"""Three steps of the port's dual-source self-attention decoder against flax.

The flax ``TacotronNetwork`` is initialised through its teacher-forced pass (so
the parameter tree is the one a trained checkpoint has: one fused
``query_projection``, no per-mechanism query layers), then ``encode``,
``decoder_step`` and ``decoder_post_step`` run on both sides with the same
injected prenet masks. States are compared leaf by leaf. Tolerance: float32
atol 1e-5 (sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import TacotronNetwork as JaxNetwork

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.decoders import decoder_factory
from self_attention_tacotron_torch.models.models import TacotronNetwork, tacotron_model_factory

from test_torch_helpers import assert_close, load_from_flax, t

B, S, STEPS, MAX_LEN = 3, 9, 3, 6
LENGTHS = np.array([9, 5, 2], np.int32)

_NARROW = dict(
    decoder="DualSourceSelfAttentionDecoder",
    num_symbols=20, embedding_dim=16,
    encoder_prenet_out_units=(16, 8), encoder_prenet_drop_rate=0.0,
    cbhg_out_units=16, conv_channels=8, max_filter_width=3,
    projection1_out_channels=8, projection2_out_channels=8, num_highway=1,
    self_attention_out_units=16, self_attention_transformer_ffn_units=24,
    decoder_prenet_out_units=(16, 8), attention_out_units=16,
    attention1_out_units=12, attention2_out_units=4, decoder_out_units=16,
    decoder_self_attention_out_units=16, num_mels=6, outputs_per_step=2,
)


@pytest.fixture(scope="module", params=[False, True], ids=["forward", "transition_agent"])
def pair(request):
    kw = dict(_NARROW, use_forward_attention_transition_agent=request.param)
    jnet = JaxNetwork(hparams=JaxHParams(**kw), is_training=False)
    source = np.random.default_rng(0).integers(1, 20, (B, S)).astype(np.int32)
    init_net = JaxNetwork(hparams=JaxHParams(**kw), is_training=True)
    variables = init_net.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "zoneout": jax.random.PRNGKey(2)},
        jnp.asarray(source), jnp.asarray(LENGTHS),
        jnp.zeros((B, 4, 6)), jnp.full((B,), 4, jnp.int32),
    )
    rng = np.random.default_rng(4)
    variables = jax.tree.map(
        lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)),
        dict(variables),
    )
    hp = HParams(**kw)
    port = load_from_flax(TacotronNetwork(hp), variables, hp)
    return jnet, variables, port, source


def _compare_lstm(got, want):
    for g, w in zip(got, want):
        assert_close(g, np.asarray(w), atol=1e-5)


def test_three_decoder_steps_state_by_state(pair):
    jnet, variables, port, source = pair
    cond_j, sa_j = jnet.apply(
        variables, jnp.asarray(source), jnp.asarray(LENGTHS), method=JaxNetwork.encode,
        rngs={"dropout": jax.random.PRNGKey(3)},
    )
    with torch.no_grad():
        cond, sa = port.encode(t(source, torch.long), t(LENGTHS, torch.long))
    for g, w in zip(cond.memories + cond.keys, cond_j.memories + cond_j.keys):
        assert_close(g, np.asarray(w), atol=1e-5)
    for g, w in zip(cond.masks, cond_j.masks):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert_close(sa[0], np.asarray(sa_j[0]), atol=1e-5)

    state_j = jnet.apply(variables, cond_j, method=JaxNetwork.decoder_initial_state)
    caches_j = jnet.apply(variables, B, MAX_LEN, method=JaxNetwork.decoder_init_caches)
    feed_j = jnet.apply(variables, B, method=JaxNetwork.decoder_go_frame)
    state = port.decoder_initial_state(cond)
    caches = port.decoder_init_caches(B, MAX_LEN)
    feed = port.decoder_go_frame(B)
    assert feed.shape == tuple(feed_j.shape) and float(feed.abs().max()) == 0.0
    assert float(state.attention_states[0].alignments[:, 0].min()) == 1.0   # one-hot start
    assert all(float(c.abs().max()) == 0.0 for c in state.contexts)         # zero contexts

    rng = np.random.default_rng(9)
    for i in range(STEPS):
        masks = (rng.random((B, 16)) < 0.5, rng.random((B, 8)) < 0.5)
        state_j, (feat_j, aligns_j) = jnet.apply(
            variables, state_j, feed_j, cond_j, tuple(jnp.asarray(m) for m in masks),
            method=JaxNetwork.decoder_step,
        )
        frames_j, stop_j, caches_j = jnet.apply(
            variables, feat_j, caches_j, jnp.asarray(i, jnp.int32),
            method=JaxNetwork.decoder_post_step,
        )
        with torch.no_grad():
            state, (feat, aligns) = port.decoder_step(
                state, feed, cond, tuple(t(m) for m in masks)
            )
            frames, stop, caches = port.decoder_post_step(feat, caches, i)

        assert_close(feat, np.asarray(feat_j), atol=1e-5)
        _compare_lstm(state.attention_lstm, state_j.attention_lstm)
        for g, w in zip(state.decoder_lstms, state_j.decoder_lstms):
            _compare_lstm(g, w)
        for g, w in zip(state.attention_states, state_j.attention_states):
            assert_close(g.alignments, np.asarray(w.alignments), atol=1e-5)
            assert_close(g.cumulative, np.asarray(w.cumulative), atol=1e-5)
            assert_close(g.transition, np.asarray(w.transition), atol=1e-5)
            assert g.step == int(w.step)
        for g, w in zip(state.contexts, state_j.contexts):
            assert_close(g, np.asarray(w), atol=1e-5)
        for g, w in zip(aligns, aligns_j):
            assert_close(g, np.asarray(w), atol=1e-5)
        assert state.time == int(state_j.time) == i + 1
        assert frames["mel"].shape == (B, 2, 6) and stop.shape == (B, 2)
        assert_close(frames["mel"], np.asarray(frames_j["mel"]), atol=1e-5)
        assert_close(stop, np.asarray(stop_j), atol=1e-5)
        for (k, v), (kj, vj) in zip(caches, caches_j):
            assert_close(k, np.asarray(kj), atol=1e-5)
            assert_close(v, np.asarray(vj), atol=1e-5)

        feed_j = frames_j["mel"][:, -1, :]
        feed = frames["mel"][:, -1, :]


def test_second_decoder_lstm_has_the_residual_and_the_first_has_not(pair):
    _, _, port, _ = pair
    first, second = port.decoder.decoder_lstms
    assert first.gates.in_features - first.num_units != first.num_units    # 48 -> 16: no residual
    assert second.gates.in_features - second.num_units == second.num_units


def test_factories_name_what_is_not_ported():
    # the WORLD-feature family is ported: all four MgcLf0 decoders and both model
    # classes build, with the mgc and lf0 heads fed back side by side
    world = dict(_NARROW, num_mgcs=7, num_lf0s=13)
    for name, encoder in (
        ("MgcLf0ExtendedDecoder", "EncoderV1"),
        ("MgcLf0SelfAttentionDecoder", "EncoderV1"),
        ("MgcLf0DualSourceDecoder", "SelfAttentionCBHGEncoder"),
        ("MgcLf0DualSourceSelfAttentionDecoder", "SelfAttentionCBHGEncoder"),
    ):
        decoder = TacotronNetwork(HParams(**{**world, "decoder": name, "encoder": encoder})).decoder
        assert decoder.output_heads == (("mgc", 7), ("lf0", 13)), name
        assert decoder.out_dim == 20 and decoder.prenet.Dense_0.in_features == 20, name
        assert decoder.output_projection.out_features == 2 * 20 + 2, name
    for name, decoder, encoder in (
        ("MgcLf0TacotronModel", "MgcLf0ExtendedDecoder", "EncoderV1"),
        ("DualSourceSelfAttentionMgcLf0TacotronModel", "MgcLf0DualSourceSelfAttentionDecoder",
         "SelfAttentionCBHGEncoder"),
    ):
        model = tacotron_model_factory(HParams(tacotron_model=name, encoder=encoder))
        assert model.HEADS == ("mgc", "lf0") and model.hparams.decoder == decoder, name
        assert model.head_dims() == {"mgc": 60, "lf0": 256}, name
    with pytest.raises(ValueError):
        tacotron_model_factory(HParams(tacotron_model="DualSourceSelfAttentionMgcLf0TacotronModel",
                                       encoder="EncoderV1"))
    with pytest.raises(ValueError):
        decoder_factory(HParams(decoder="nope"), (), ())
    with pytest.raises(ValueError):
        decoder_factory(HParams(decoder="MgcLf0nope"), (), ())
    with pytest.raises(NotImplementedError):
        TacotronNetwork(HParams(attention="teacher_forcing_forward", decoder="ExtendedDecoder",
                                encoder="EncoderV1"))
    with pytest.raises(NotImplementedError):
        TacotronNetwork(HParams(decoder="DualSourceSelfAttentionDecoder", use_postnet_v2=True))
    # bfloat16 is ported (it builds, tests/test_torch_bf16.py); a dtype the JAX
    # package does not know is refused
    with pytest.raises(ValueError):
        TacotronNetwork(
            HParams(decoder="DualSourceSelfAttentionDecoder", compute_dtype="float16")
        )
