"""``convert`` carries the three configurations of the last location-sensitive branches.

``mgclf0-ls``, ``flagship-mgclf0-ls`` and ``flagship-dualsource-ls`` at narrow widths:
every flax leaf of the JAX network (location convolution and layer, the WORLD heads'
output projection, no decoder self-attention on ``DualSourceDecoder``) is placed in
the port's network, every entry of the port's network is filled, and
``torch_to_flax_flat`` gives back every leaf exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory

from self_attention_tacotron_torch import convert
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import tacotron_model_factory

from test_torch_helpers import flat_variables
from test_torch_training import _NARROW

LS = dict(attention="location_sensitive", attention_kernel=5, attention_filters=4)
CONFIGS = {
    "mgclf0-ls": dict(tacotron_model="MgcLf0TacotronModel", encoder="ZoneoutEncoderV1",
                      decoder="MgcLf0ExtendedDecoder", encoder_out_units=16, num_mgcs=7,
                      num_lf0s=13),
    "flagship-mgclf0-ls": dict(tacotron_model="DualSourceSelfAttentionMgcLf0TacotronModel",
                               decoder="MgcLf0DualSourceSelfAttentionDecoder", num_mgcs=7,
                               num_lf0s=13),
    "flagship-dualsource-ls": dict(decoder="DualSourceDecoder"),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_every_leaf_is_carried_both_ways(config):
    kw = dict(_NARROW, **CONFIGS[config], **LS)
    hp, jax_hp = HParams(**kw), JaxHParams(**kw)
    width = hp.num_mgcs + hp.num_lf0s if "MgcLf0" in hp.decoder else hp.num_mels
    source = np.random.default_rng(0).integers(1, 20, (2, 7)).astype(np.int32)
    lengths = np.array([7, 4], np.int32)
    variables = jax_factory(jax_hp).network(is_training=True).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "zoneout": jax.random.PRNGKey(2)},
        jnp.asarray(source), jnp.asarray(lengths), jnp.zeros((2, 4, width), jnp.float32),
        jnp.full((2,), 4, jnp.int32),
    )
    flat = flat_variables(dict(variables))
    assert sum("location_conv" in k or "location_layer" in k for k in flat) == 3
    net = tacotron_model_factory(hp).network(device="cpu")
    state = convert.flax_to_torch_state(flat, hp, net)
    assert set(state) == {k for k in net.state_dict() if not k.endswith("num_batches_tracked")}
    convert.load_state(net, state)
    back = convert.torch_to_flax_flat(net)
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    if config == "flagship-dualsource-ls":
        assert net.decoder.self_attention is None
        assert not any("self_attention" in k and "decoder" in k for k in flat)
