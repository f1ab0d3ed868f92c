"""A fresh network of the port against the JAX package's ``net.init``, leaf by leaf.

For the flagship and each of the five ``configs/*.json``, narrowed (the widths of
``test_torch_configs.py``) and at full width: the JAX training network's
``init`` from ``PRNGKey(random_seed)`` (the XLA path, as its trainer initialises
it) and the port's ``model.network(generator=init_generator(random_seed))``
through ``convert.torch_to_flax_flat``. JAX's bitstream (threefry) cannot be
matched; the distributions can:

* the same keys and shapes;
* exact zeros where JAX's leaf is zeros (the biases, ``attention_b``, the batch
  and layer norms' offsets), and every other constant leaf (their scales, the
  highway gates' bias of -1) equal to JAX's;
* for every leaf of at least 1000 entries, the standard deviation within 5 % of
  JAX's;
* no entry past the truncation bound: ``lecun_normal`` kernels within
  ``2 sqrt(1 / fan_in) / 0.8796`` (fan-in in flax's layout), the attention vectors
  within glorot's ``sqrt(6 / (in + out))``;
* the same seed twice gives identical weights, another seed others.

About 60 s on one worker, most of it the JAX inits' traces and compiles (12 networks, in
threads).
"""

import concurrent.futures
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.training import trainer as jax_trainer

from self_attention_tacotron_torch import convert
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import init_generator, tacotron_model_factory
from self_attention_tacotron_torch.models.modules import TRUNCATED_NORMAL_STD

from test_torch_configs import CONFIG_FILES, NARROW, REPO
from test_torch_helpers import flat_variables

FLAGSHIP = dict(tacotron_model="DualSourceSelfAttentionTacotronModel",
                encoder="SelfAttentionCBHGEncoder", decoder="DualSourceSelfAttentionDecoder",
                attention="forward", attention2="additive")
NAMES = ("flagship",) + CONFIG_FILES
SEED = 1234
STD_SHARE = 0.05
MIN_ENTRIES = 1000
B, S, FRAMES = 2, 3, 6
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def config(name: str, narrow: bool) -> dict:
    kw = dict(FLAGSHIP)
    if name != "flagship":
        with open(os.path.join(REPO, "configs", f"{name}.json")) as f:
            kw = json.load(f)
    if narrow:
        kw.update(NARROW)
    return dict(kw, use_pallas_kernels=False, random_seed=SEED)


def jax_init(kw: dict) -> dict:
    """The flat leaves of the JAX trainer's ``net.init`` at ``PRNGKey(random_seed)``."""
    hp = JaxHParams(**kw)
    model = jax_factory(hp)
    batch = {"source": jnp.ones((B, S), jnp.int32), "source_lengths": jnp.full((B,), S, jnp.int32)}
    if hp.use_accent_type:
        batch["accent_type"] = jnp.zeros((B, S), jnp.int32)
    if hp.use_speaker_embedding:
        batch["speaker_id"] = jnp.zeros((B,), jnp.int32)
    dims = sum(model.head_dims().values()) if hasattr(model, "head_dims") else hp.num_mels
    key = jax.random.PRNGKey(hp.random_seed)
    init = jax.jit(lambda: model.network(is_training=True).init(
        {"params": key, "dropout": jax.random.fold_in(key, 1),
         "zoneout": jax.random.fold_in(key, 2)},
        batch["source"], batch["source_lengths"], jnp.zeros((B, FRAMES, dims), jnp.float32),
        jnp.full((B,), FRAMES, jnp.int32), **jax_trainer._network_kwargs(model, batch),
    ))
    # the draws are the same at any optimisation level; the compile is shorter at 0
    return flat_variables(init.lower().compile(compiler_options=FAST_COMPILE)())


def port_init(kw: dict, seed: int = SEED) -> dict:
    hp = HParams(**kw)
    net = tacotron_model_factory(hp).network(is_training=True, device="cpu",
                                             generator=init_generator(seed))
    return convert.torch_to_flax_flat(net)


def bound(key: str, shape) -> float:
    """The largest magnitude the leaf's initialiser can draw; inf where it has none."""
    if key.endswith("/kernel"):
        fan_in = int(np.prod(shape[:-1]))
        return 2.0 * math.sqrt(1.0 / fan_in) / TRUNCATED_NORMAL_STD
    if key.endswith("/attention_v"):
        return math.sqrt(6.0 / (shape[-2] + shape[-1]))
    return math.inf


CASES = [(n, w) for n in NAMES for w in ("narrow", "full")]


@pytest.fixture(scope="module")
def jax_inits():
    """Every case's JAX init, traced and compiled in threads (XLA compiles without the
    interpreter's lock, so the compiles overlap the traces)."""
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futures = {case: pool.submit(jax_init, config(case[0], case[1] == "narrow"))
                   for case in CASES}
        return {case: future.result() for case, future in futures.items()}


@pytest.fixture(scope="module", params=CASES, ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request, jax_inits):
    name, width = request.param
    kw = config(name, width == "narrow")
    return kw, jax_inits[request.param], port_init(kw)


def test_same_leaves(pair):
    _, want, got = pair
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == np.float32, key


def test_zeros_and_constants(pair):
    _, want, got = pair
    constant = [k for k, w in want.items() if w.size and np.all(w == w.flat[0])]
    assert any(np.all(want[k] == 0) for k in constant)
    for key in constant:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_spread_and_truncation(pair):
    _, want, got = pair
    checked = 0
    for key, w in want.items():
        g = got[key]
        if w.size >= MIN_ENTRIES and w.std() > 0:
            assert abs(g.std() / w.std() - 1.0) <= STD_SHARE, (key, g.std(), w.std())
            checked += 1
        limit = bound(key, w.shape) * (1 + 1e-6)
        assert np.abs(w).max() <= limit, ("JAX's own leaf past the bound", key)
        assert np.abs(g).max() <= limit, (key, np.abs(g).max(), limit)
    assert checked > 0


@pytest.mark.parametrize("name", NAMES)
def test_seed_decides_the_weights(name):
    kw = config(name, narrow=True)
    first, again, other = port_init(kw), port_init(kw), port_init(kw, SEED + 1)
    for key, value in first.items():
        np.testing.assert_array_equal(again[key], value, err_msg=key)
    drawn = [k for k, v in first.items() if v.std() > 0]
    assert drawn and all(not np.array_equal(other[k], first[k]) for k in drawn)


def test_global_generator_untouched():
    kw = config("flagship", narrow=True)
    torch.manual_seed(3)
    before = torch.rand(4)
    torch.manual_seed(3)
    port_init(kw)
    np.testing.assert_array_equal(torch.rand(4).numpy(), before.numpy())


def test_trainer_starts_from_random_seed():
    """``Trainer.init_state`` without a network draws it from ``random_seed``."""
    from self_attention_tacotron_torch.training.trainer import Trainer

    kw = config("flagship", narrow=True)
    model = tacotron_model_factory(HParams(**kw))
    state = Trainer(model, device="cpu").init_state()
    got = convert.torch_to_flax_flat(state.net)
    for key, value in port_init(kw).items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
