"""The postnets of ``models/postnet.py`` against their flax counterparts, on the CPU.

``PostNetV2`` with and without its speaker conditioning, in eval mode and in train
mode (batch statistics and the running averages they move, dropout at 0, since
the frameworks' random streams differ; with dropout on, the port's mask follows its
generator); ``PostCBHG`` with its conv bank up to width 8 (even widths pad as flax
pads them) on ragged lengths; both converter directions over a whole network with
both postnets. Weights come from ``module.init``, moved off their init values, through
``convert.flax_to_torch_state``; inputs from a numpy seed. Tolerance 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models import postnet as jax_postnet
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory

from self_attention_tacotron_torch import convert
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models import postnet
from self_attention_tacotron_torch.models.models import tacotron_model_factory

from test_torch_helpers import assert_close, flat_variables, load_from_flax, t
from test_torch_modules import _perturb, _randn

KEY = jax.random.PRNGKey(0)
B, T, M = 3, 13, 6
LENGTHS = np.array([13, 7, 2])


def _postnet_v2_pair(cond_units, **kw):
    jnet = jax_postnet.PostNetV2(out_dim=M, num_layers=3, kernel_size=5, out_channels=7,
                                 is_training=False, **kw)
    x = _randn(0, B, T, M)
    cond = _randn(1, B, cond_units) if cond_units else None
    variables = _perturb(jnet.init(KEY, jnp.asarray(x),
                                   None if cond is None else jnp.asarray(cond)))
    port = postnet.PostNetV2(M, num_layers=3, kernel_size=5, out_channels=7,
                             cond_units=cond_units, **kw)
    return jnet, variables, load_from_flax(port, variables), x, cond


@pytest.mark.parametrize("cond_units", [0, 4], ids=["no_cond", "speaker_cond"])
def test_postnet_v2_eval(cond_units):
    jnet, variables, port, x, cond = _postnet_v2_pair(cond_units, drop_rate=0.5)
    want = jnet.apply(variables, jnp.asarray(x), None if cond is None else jnp.asarray(cond))
    with torch.no_grad():
        got = port(t(x), None if cond is None else t(cond))
    assert got.shape == (B, T, M)
    assert_close(got, np.asarray(want), atol=1e-5)
    # no mask: a frame past a lane's length reaches the frames before it
    x2 = x.copy()
    x2[1, LENGTHS[1]:] += 1.0
    with torch.no_grad():
        moved = port(t(x2), None if cond is None else t(cond))
    assert float((moved[1, LENGTHS[1] - 2] - got[1, LENGTHS[1] - 2]).abs().max()) > 1e-3


@pytest.mark.parametrize("cond_units", [0, 4], ids=["no_cond", "speaker_cond"])
def test_postnet_v2_train_batch_statistics(cond_units):
    _, variables, port, x, cond = _postnet_v2_pair(cond_units, drop_rate=0.0)
    jnet = jax_postnet.PostNetV2(out_dim=M, num_layers=3, kernel_size=5, out_channels=7,
                                 drop_rate=0.0, is_training=True)
    want, mutated = jnet.apply(variables, jnp.asarray(x),
                               None if cond is None else jnp.asarray(cond),
                               mutable=["batch_stats"])
    port.train()
    got = port(t(x), None if cond is None else t(cond))
    assert_close(got, np.asarray(want), atol=1e-5)
    stats = convert.torch_to_flax_flat(port)
    moved = flat_variables({"batch_stats": mutated["batch_stats"]})
    assert len(moved) == 2 * 3
    for key, value in moved.items():
        assert_close(stats[key], value, atol=1e-5)


def test_postnet_v2_dropout_follows_the_generator_in_train_mode_only():
    _, _, port, x, _ = _postnet_v2_pair(0, drop_rate=0.5)
    port.train()
    a = port(t(x), generator=torch.Generator().manual_seed(0))
    b = port(t(x), generator=torch.Generator().manual_seed(0))
    c = port(t(x), generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    port.eval()
    with torch.no_grad():
        d = port(t(x), generator=torch.Generator().manual_seed(0))
        e = port(t(x), generator=torch.Generator().manual_seed(1))
    assert torch.equal(d, e)


@pytest.mark.parametrize("max_filter_width", [4, 8])
def test_post_cbhg_even_conv_bank_ragged_lengths(max_filter_width):
    jnet = jax_postnet.PostCBHG(out_dim=9, cbhg_out_units=10, conv_channels=5,
                                max_filter_width=max_filter_width, projection1_out_channels=7,
                                projection2_out_channels=M, num_highway=2, is_training=False)
    x = _randn(2, B, T, M)
    variables = _perturb(jnet.init(KEY, jnp.asarray(x), jnp.asarray(LENGTHS)))
    want = jnet.apply(variables, jnp.asarray(x), jnp.asarray(LENGTHS))
    port = load_from_flax(postnet.PostCBHG(M, 9, cbhg_out_units=10, conv_channels=5,
                                           max_filter_width=max_filter_width,
                                           projection1_out_channels=7, num_highway=2,
                                           use_pallas=True), variables)
    assert port.cbhg.highway_in is not None
    with torch.no_grad():
        got = port(t(x), t(LENGTHS))
    assert got.shape == (B, T, 9)
    # every frame: past a lane's length the BiGRU emits zero, the dense layer its bias
    assert_close(got, np.asarray(want), atol=1e-5)


def test_post_cbhg_defaults_are_the_flax_module_s():
    port = postnet.PostCBHG(80, 1025)
    jnet = jax_postnet.PostCBHG(out_dim=1025, projection2_out_channels=80)
    cbhg = port.cbhg
    assert cbhg.max_filter_width == jnet.max_filter_width == 8
    assert cbhg.proj1.Conv_0.out_channels == jnet.projection1_out_channels == 256
    assert cbhg.birnn.cell_fwd.num_units == jnet.cbhg_out_units // 2 == 128
    assert cbhg.conv_bank_1.Conv_0.out_channels == jnet.conv_channels == 128
    assert cbhg.num_highway == jnet.num_highway == 4
    assert port.linear.in_features == 256 and port.linear.out_features == 1025


_NET = dict(
    tacotron_model="DualSourceSelfAttentionTacotronModel", encoder="SelfAttentionCBHGEncoder",
    decoder="DualSourceSelfAttentionDecoder", attention="forward", attention2="additive",
    num_symbols=20, embedding_dim=8, encoder_prenet_out_units=(8, 8), cbhg_out_units=8,
    conv_channels=4, max_filter_width=2, projection1_out_channels=8,
    projection2_out_channels=8, num_highway=1, self_attention_out_units=8,
    self_attention_transformer_ffn_units=8, decoder_prenet_out_units=(8, 8),
    attention_out_units=8, attention1_out_units=4, attention2_out_units=4,
    decoder_out_units=8, decoder_self_attention_out_units=8, num_mels=M, num_freq=9,
    outputs_per_step=3, use_postnet_v2=True, use_linear_spectrogram_postnet=True,
    postnet_v2_num_layers=3, postnet_v2_out_channels=7, use_speaker_embedding=True,
    num_speakers=3, speaker_embedding_dim=4, channel_id_to_postnet=True,
)


def test_both_converter_directions_over_a_network_with_both_postnets():
    jhp = JaxHParams(**_NET)
    jnet = jax_factory(jhp).network(is_training=True)
    source = jnp.asarray(np.random.default_rng(3).integers(1, 20, (2, 5)), jnp.int32)
    variables = jax.jit(lambda: jnet.init(
        {"params": KEY, "dropout": KEY, "zoneout": KEY}, source, jnp.array([5, 3]),
        jnp.zeros((2, 6, M)), jnp.array([6, 3]), speaker_id=jnp.array([0, 2]),
    ))()
    flat = flat_variables(_perturb(variables))
    postnet_keys = [k for k in flat if "/postnet_v2/" in k or "/post_cbhg/" in k]
    assert any(k.startswith("batch_stats/postnet_v2/conv_2/") for k in postnet_keys)
    assert any(k.startswith("params/post_cbhg/cbhg/gru_fwd/") for k in postnet_keys)
    assert "params/post_cbhg/linear/kernel" in postnet_keys
    # the speaker embedding is concatenated to the postnet's input
    assert flat["params/postnet_v2/conv_0/Conv_0/kernel"].shape == (5, M + 4, 7)
    hp = HParams(**_NET)
    net = tacotron_model_factory(hp).network(device="cpu")
    convert.load_state(net, convert.flax_to_torch_state(flat, hp, net))
    assert_close(net.post_cbhg.linear.weight.t(), flat["params/post_cbhg/linear/kernel"], atol=0)
    assert_close(net.post_cbhg.cbhg.birnn.cell_bwd.candidate.kernel,
                 flat["params/post_cbhg/cbhg/gru_bwd/candidate/kernel"], atol=0)
    back = convert.torch_to_flax_flat(net)
    assert set(back) == set(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key], err_msg=key)
