"""Each ported module of ``models/modules.py``, ``self_attention.py`` and
``encoders.py`` against its flax counterpart, on the CPU.

Weights come from ``module.init`` through ``convert.flax_to_torch_state``;
inputs from a numpy seed. Tolerance: float32 atol 1e-5 unless a test says
otherwise (sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.models import encoders as jax_encoders
from self_attention_tacotron_tpu.models import modules as jm
from self_attention_tacotron_tpu.models import self_attention as jsa

from self_attention_tacotron_torch.models import encoders, modules
from self_attention_tacotron_torch.models import self_attention as sa

from test_torch_helpers import assert_close, load_from_flax, t

KEY = jax.random.PRNGKey(0)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _perturb(variables, seed=3, scale=0.1):
    """Move every leaf off its init value (zero biases, unit scales, zero means)."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        noise = scale * rng.standard_normal(a.shape).astype(np.float32)
        if path[-1].key == "var":
            return jnp.asarray(np.abs(1.0 + noise))
        return jnp.asarray(a + noise)

    return jax.tree_util.tree_map_with_path(move, dict(variables))


def test_sequence_mask():
    lengths = np.array([3, 0, 5])
    want = np.asarray(jm.sequence_mask(jnp.asarray(lengths), 5))
    np.testing.assert_array_equal(modules.sequence_mask(t(lengths), 5).numpy(), want)


@pytest.mark.parametrize("offset", [0, 100])
def test_embedding_offset_and_clip(offset):
    ids = np.array([[offset - 3, offset, offset + 4, offset + 99]])
    emb = jm.Embedding(num_symbols=6, embedding_dim=4, index_offset=offset)
    variables = emb.init(KEY, jnp.asarray(ids))
    port = load_from_flax(modules.Embedding(6, 4, index_offset=offset), variables)
    assert_close(port(t(ids)), np.asarray(emb.apply(variables, jnp.asarray(ids))), atol=0)


def test_prenet_with_injected_masks_drops_at_inference():
    x = _randn(0, 5, 12)
    rng = np.random.default_rng(1)
    masks = [rng.random((5, 16)) < 0.5, rng.random((5, 8)) < 0.5]
    prenet = jm.PreNet((16, 8), drop_rate=0.5)
    variables = _perturb(prenet.init({"params": KEY, "dropout": KEY}, jnp.asarray(x)))
    want = prenet.apply(
        variables, jnp.asarray(x), dropout_masks=[jnp.asarray(m) for m in masks]
    )
    port = load_from_flax(modules.PreNet(12, (16, 8), drop_rate=0.5), variables)
    got = port(t(x), dropout_masks=[t(m) for m in masks])
    assert_close(got, np.asarray(want), atol=1e-5)
    # eval mode, no masks: dropout is still on, and follows the generator
    a = port(t(x), generator=torch.Generator().manual_seed(0))
    b = port(t(x), generator=torch.Generator().manual_seed(0))
    c = port(t(x), generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float((a == 0).float().mean()) > 0.3


@pytest.mark.parametrize("kernel_size", [1, 2, 3, 4, 5])
def test_conv1d_bn_same_padding(kernel_size):
    x = _randn(kernel_size, 2, 9, 6)
    conv = jm.Conv1dBN(kernel_size=kernel_size, out_channels=5, is_training=False)
    variables = _perturb(conv.init(KEY, jnp.asarray(x)))
    port = load_from_flax(modules.Conv1dBN(6, kernel_size, 5), variables)
    assert_close(port(t(x)), np.asarray(conv.apply(variables, jnp.asarray(x))), atol=1e-5)


def test_highway():
    x = _randn(0, 3, 7, 8)
    hw = jm.HighwayNet(8)
    variables = hw.init(KEY, jnp.asarray(x))
    port = modules.HighwayNet(8)
    assert float(port.T.bias.detach().mean()) == -1.0          # transform-gate bias starts at -1
    load_from_flax(port, _perturb(variables))
    want = hw.apply(_perturb(variables), jnp.asarray(x))
    assert_close(port(t(x)), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("zoneout", [0.0, 0.1])
def test_zoneout_lstm_cell_eval_interpolation(zoneout):
    x, c, h = _randn(0, 3, 6), _randn(1, 3, 8), _randn(2, 3, 8)
    cell = jm.ZoneoutLSTMCell(8, zoneout, zoneout, is_training=False)
    carry = (jnp.asarray(c), jnp.asarray(h))
    variables = _perturb(cell.init(KEY, carry, jnp.asarray(x)))
    (want_c, want_h), want_y = cell.apply(variables, carry, jnp.asarray(x))
    port = load_from_flax(modules.ZoneoutLSTMCell(6, 8, zoneout, zoneout), variables)
    (got_c, got_h), got_y = port((t(c), t(h)), t(x))
    assert_close(got_c, np.asarray(want_c), atol=1e-5)
    assert_close(got_h, np.asarray(want_h), atol=1e-5)
    assert_close(got_y, np.asarray(want_y), atol=1e-5)


def test_zoneout_lstm_cell_train_masks():
    x, c, h = _randn(0, 3, 6), _randn(1, 3, 8), _randn(2, 3, 8)
    rng = np.random.default_rng(5)
    masks = (rng.random((3, 8)) < 0.3, rng.random((3, 8)) < 0.3)
    cell = jm.ZoneoutLSTMCell(8, 0.3, 0.3, is_training=True)
    carry = (jnp.asarray(c), jnp.asarray(h))
    variables = _perturb(cell.init({"params": KEY, "zoneout": KEY}, carry, jnp.asarray(x)))
    (want_c, want_h), _ = cell.apply(
        variables, carry, jnp.asarray(x), zoneout_masks=tuple(jnp.asarray(m) for m in masks)
    )
    port = load_from_flax(modules.ZoneoutLSTMCell(6, 8, 0.3, 0.3), variables).train()
    (got_c, got_h), _ = port((t(c), t(h)), t(x), zoneout_masks=tuple(t(m) for m in masks))
    assert_close(got_c, np.asarray(want_c), atol=1e-5)
    assert_close(got_h, np.asarray(want_h), atol=1e-5)


def test_gru_cell_candidate_takes_reset_times_hidden():
    x, h = _randn(0, 3, 6), _randn(1, 3, 8)
    cell = jm.GRUCell(8)
    variables = _perturb(cell.init(KEY, jnp.asarray(h), jnp.asarray(x)))
    want, _ = cell.apply(variables, jnp.asarray(h), jnp.asarray(x))
    port = load_from_flax(modules.GRUCell(6, 8), variables)
    got, _ = port(t(h), t(x))
    assert_close(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("max_filter_width,out_units", [(3, 16), (4, 16), (4, 12)])
def test_cbhg_even_and_odd_banks_ragged_lengths(max_filter_width, out_units):
    # out_units=12: the highway width differs from the input's, so highway_in is there
    x = _randn(0, 3, 11, 8)
    lengths = np.array([11, 6, 1])
    cbhg = jm.CBHG(
        out_units=out_units, conv_channels=6, max_filter_width=max_filter_width,
        projection1_out_channels=7, projection2_out_channels=8, num_highway=2,
        is_training=False,
    )
    variables = _perturb(cbhg.init(KEY, jnp.asarray(x), jnp.asarray(lengths)))
    want = cbhg.apply(variables, jnp.asarray(x), jnp.asarray(lengths))
    port = load_from_flax(
        modules.CBHG(8, out_units, 6, max_filter_width, 7, 8, 2, use_pallas=True), variables
    )
    assert (port.highway_in is not None) == (out_units != 16)
    with torch.no_grad():
        got = port(t(x), t(lengths))
    assert got.shape == (3, 11, out_units)
    assert_close(got, np.asarray(want), atol=1e-5)


def test_positional_encoding_table():
    want = np.asarray(jsa.positional_encoding(50, 16))
    np.testing.assert_array_equal(sa.positional_encoding(50, 16).numpy(), want)


def test_layer_norm_epsilon_is_the_flax_one():
    block = sa.SelfAttentionBlock(2, 8, 16)
    assert block.ln1.eps == 1e-6 and block.ln2.eps == 1e-6


def _transformer_pair(in_units=12, num_hop=2):
    jt = jsa.SelfAttentionTransformer(
        num_hop=num_hop, num_heads=2, num_units=16, ffn_units=24, is_training=False
    )
    x = _randn(0, 2, 9, in_units)
    variables = _perturb(jt.init(KEY, jnp.asarray(x)))
    port = load_from_flax(
        sa.SelfAttentionTransformer(in_units, num_hop, 2, 16, 24, use_pallas=True), variables
    )
    return jt, variables, port, x


def test_transformer_full_sequence_with_mask():
    jt, variables, port, x = _transformer_pair()
    mask = np.arange(9)[None, :] < np.array([9, 5])[:, None]
    want, want_probs = jt.apply(variables, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got, probs = port(t(x), t(mask))
    assert_close(got, np.asarray(want), atol=1e-5)
    assert len(probs) == 2
    for g, w in zip(probs, want_probs):
        assert_close(g, np.asarray(w), atol=1e-5)


def test_transformer_incremental_steps_match_flax_and_the_causal_pass():
    jt, variables, port, x = _transformer_pair()
    caches_j = jt.init_cache(2, 9)
    caches = port.init_cache(2, 9)
    with torch.no_grad():
        causal, _ = port(t(x), None, causal=True)
    for i in range(9):
        want, caches_j = jt.apply(
            variables, jnp.asarray(x[:, i]), caches_j, jnp.asarray(i, jnp.int32),
            method=jsa.SelfAttentionTransformer.incremental_step,
        )
        with torch.no_grad():
            got, caches = port.incremental_step(t(x[:, i]), caches, i)
        assert_close(got, np.asarray(want), atol=1e-5)
        assert_close(got, causal[:, i].numpy(), atol=1e-5)
    for (k, v), (kj, vj) in zip(caches, caches_j):
        assert_close(k, np.asarray(kj), atol=1e-5)
        assert_close(v, np.asarray(vj), atol=1e-5)


@pytest.mark.parametrize("with_accent", [False, True])
def test_self_attention_cbhg_encoder(with_accent):
    kw = dict(
        cbhg_out_units=16, conv_channels=6, max_filter_width=4,
        projection1_out_channels=7, projection2_out_channels=8, num_highway=2,
        prenet_out_units=(12, 8), drop_rate=0.0,
        self_attention_out_units=16, self_attention_num_heads=2,
        self_attention_ffn_units=24,
    )
    x, acc = _randn(0, 3, 10, 12), _randn(1, 3, 10, 4)
    lengths = np.array([10, 4, 7])
    if with_accent:
        jenc = jax_encoders.SelfAttentionCBHGEncoderWithAccentType(is_training=False, **kw)
        args = (jnp.asarray(x), jnp.asarray(acc), jnp.asarray(lengths))
        port = encoders.SelfAttentionCBHGEncoderWithAccentType(16, use_pallas=True, **kw)
        port_args = (t(x), t(acc), t(lengths))
    else:
        jenc = jax_encoders.SelfAttentionCBHGEncoder(is_training=False, **kw)
        args = (jnp.asarray(x), jnp.asarray(lengths))
        port = encoders.SelfAttentionCBHGEncoder(12, use_pallas=True, **kw)
        port_args = (t(x), t(lengths))
    rngs = {"params": KEY, "dropout": KEY}
    variables = _perturb(jenc.init(rngs, *args))
    want1, want2, want_sa = jenc.apply(variables, *args, rngs={"dropout": KEY})
    load_from_flax(port, variables)
    with torch.no_grad():
        got1, got2, got_sa = port(*port_args)
    assert_close(got1, np.asarray(want1), atol=1e-5)
    assert_close(got2, np.asarray(want2), atol=1e-5)
    assert_close(got_sa[0], np.asarray(want_sa[0]), atol=1e-5)


def test_encoder_factory_names():
    from self_attention_tacotron_torch.hparams import HParams

    enc = encoders.encoder_factory(HParams(encoder="SelfAttentionCBHGEncoder"))
    assert isinstance(enc, encoders.SelfAttentionCBHGEncoder)
    for name in ("EncoderV1", "ZoneoutEncoderV1", "ZoneoutEncoderV1WithAccentType",
                 "SelfAttentionCBHGEncoderWithAccentType"):
        assert type(encoders.encoder_factory(HParams(encoder=name))).__name__ == name
    with pytest.raises(ValueError):
        encoders.encoder_factory(HParams(encoder="nope"))
