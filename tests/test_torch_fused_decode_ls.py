"""The location-sensitive branch of the whole-loop decode (``ops/fused_decode.py``) on the CPU.

On the CPU ``fused_decode`` runs its plain version, ``fused_decode_reference``,
which repeats the CUDA kernel's formulation: the location convolution and the
dense layer after it folded into one map of the taps (``location_fold``), the
taps of the rounded alignments, the alignments the softmax itself, starting
uniform. It is held, as ``test_torch_fused_decode.py`` holds the forward-attention
specialisations,

* against the port's step-by-step path (``LocationSensitiveAttention`` as flax
  computes it) with prenet dropout 0.5 from the same injected masks: floats to
  1e-5, integers and flags exact, to the cap and with an early exit;
* against the JAX package's Pallas kernel in interpret mode
  (``make_predict_fn(model, use_fused=True)``), prenet dropout off: atol 1e-4 on
  mel, stop probabilities and alignments, lengths, flags and step counts exact,
  to the cap and with an early exit; in bfloat16 at 3e-2 (both round where the
  Pallas kernel casts to its io dtype, float32 sums in another order).

Two configurations, the two the kernel was first compiled for, as
``tests/test_fused_decode.py`` sets them up for the JAX package: the baseline's
``ExtendedDecoder`` (one source, no self-attention) over the cumulative
alignments, and the flagship's ``DualSourceSelfAttentionDecoder`` over the
previous ones; 7 taps, 4 filters, A1 = 16.
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
from self_attention_tacotron_torch.models.attention import LocationSensitiveAttention
from self_attention_tacotron_torch.models.models import TacotronModelBase, tacotron_model_factory
from self_attention_tacotron_torch.ops import fused_decode as fd
from self_attention_tacotron_torch.synthesis import make_predict_fn

from test_torch_fused_decode import B, MAX_ITERS, R, _as_dict, _compare, _masks, _threshold
from test_torch_helpers import load_from_flax
from test_torch_synthesis import _NARROW

_LS = dict(attention="location_sensitive", attention_kernel=7, attention_filters=4,
           attention1_out_units=16)
VARIANTS = {
    # dual=0, use_sa=0: the reference's LS family's decoder
    "extended_cumulative": dict(_LS, tacotron_model="ExtendedTacotronV1Model",
                                encoder="EncoderV1", decoder="ExtendedDecoder",
                                cumulative_weights=True),
    # dual=1, use_sa=1: the flagship's structure
    "dual_self_attention_previous": dict(_LS, cumulative_weights=False),
}
# the stop columns of the output projection scaled, as test_torch_fused_decode.py
# does for its decoders whose stop probabilities stay near 0.5 (see SPREAD there)
SPREAD = {"extended_cumulative": -8.0, "dual_self_attention_previous": 8.0}
S = 11
SRC_LENGTHS = np.array([11, 7, 4], np.int32)
TOL_BF16 = 3e-2


def _batch(seed=7):
    rng = np.random.default_rng(seed)
    return {"source": rng.integers(1, 30, size=(B, S)).astype(np.int32),
            "source_lengths": SRC_LENGTHS}


_flax_cache = {}


def _flax_variables(variant):
    if variant not in _flax_cache:
        hp = JaxHParams(**{**_NARROW, **VARIANTS[variant]})
        net = jax_factory(hp).network(is_training=True)
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        variables = dict(net.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
             "zoneout": jax.random.PRNGKey(2)},
            batch["source"], batch["source_lengths"],
            jnp.zeros((B, 4, hp.num_mels), jnp.float32), jnp.full((B,), 4, jnp.int32),
        ))
        params = dict(variables["params"])
        params["decoder"] = dict(params["decoder"])
        proj = dict(params["decoder"]["output_projection"])
        proj["kernel"] = proj["kernel"].at[:, -R:].multiply(SPREAD[variant])
        params["decoder"]["output_projection"] = proj
        # flax initialises the location bias at zero: move it, so that it counts
        rng = np.random.default_rng(3)
        mech = dict(params["attention_0"])
        mech["attention_b"] = jnp.asarray(
            0.3 * rng.standard_normal(mech["attention_b"].shape), jnp.float32)
        params["attention_0"] = mech
        variables["params"] = params
        _flax_cache[variant] = variables
    return _flax_cache[variant]


def _torch_net(variant, **overrides):
    hp = HParams(**{**_NARROW, **VARIANTS[variant], **overrides})
    net = tacotron_model_factory(hp).network(device="cpu")
    return load_from_flax(net, _flax_variables(variant), hp)


def _both_paths(variant, threshold):
    net = _torch_net(variant, stop_token_threshold=threshold)
    masks, batch = _masks(), _batch()
    stepwise = make_predict_fn(net, max_iters=MAX_ITERS, device="cpu", use_fused=False)(
        batch, prenet_masks=masks)
    with torch.inference_mode():
        cond, _ = net.encode(torch.as_tensor(batch["source"]).long(),
                             torch.as_tensor(batch["source_lengths"]).long())
        packed = fd.pack_decoder(net.decoder)
        plain = fd.fused_decode_reference(packed, cond, masks, MAX_ITERS, threshold)
    return packed, _as_dict(plain), stepwise


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_version_matches_the_step_by_step_path(variant):
    packed, plain, stepwise = _both_paths(variant, threshold=2.0)
    assert packed.ls and packed.ls_cumulative == VARIANTS[variant]["cumulative_weights"]
    assert isinstance(_torch_net(variant).decoder.attention_0, LocationSensitiveAttention)
    assert int(stepwise["num_steps"]) == MAX_ITERS
    assert float(plain["mel"].abs().max()) > 0.0
    _compare(plain, stepwise, atol=1e-5)
    threshold = _threshold(stepwise["stop_probs"].numpy())
    _, plain, stepwise = _both_paths(variant, threshold)
    assert int(stepwise["num_steps"]) < MAX_ITERS and bool(stepwise["finished"].all())
    assert len(set(stepwise["lengths"].tolist())) > 1
    _compare(plain, stepwise, atol=1e-5)


_jax_runs = {}


def _run_jax_fused(variant, threshold, dtype="float32"):
    key = (variant, threshold, dtype)
    if key not in _jax_runs:
        hp = JaxHParams(**{**_NARROW, **VARIANTS[variant], "decoder_prenet_drop_rate": 0.0,
                           "stop_token_threshold": threshold, "compute_dtype": dtype})
        predict = jax_make_predict_fn(jax_factory(hp), max_iters=MAX_ITERS, use_fused=True)
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        out = predict(_flax_variables(variant), batch, jax.random.PRNGKey(11))
        _jax_runs[key] = jax.tree.map(np.asarray, out)
    return _jax_runs[key]


def _run_torch_fused(variant, threshold, dtype="float32"):
    net = _torch_net(variant, decoder_prenet_drop_rate=0.0, stop_token_threshold=threshold,
                     compute_dtype=dtype)
    return make_predict_fn(net, max_iters=MAX_ITERS, device="cpu", use_fused=True)(_batch())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_matches_the_pallas_kernel_to_the_cap_and_with_early_exit(variant, dtype):
    atol = 1e-4 if dtype == "float32" else TOL_BF16
    want = _run_jax_fused(variant, 2.0, dtype)
    got = _run_torch_fused(variant, 2.0, dtype)
    assert int(want["num_steps"]) == MAX_ITERS and not want["finished"].any()
    _compare(got, want, atol=atol)
    # no probability within gap / 2 of the threshold: "fired" cannot differ at atol
    threshold = _threshold(want["stop_probs"], gap=4e-3 if dtype == "float32" else 1e-2)
    want = _run_jax_fused(variant, threshold, dtype)
    got = _run_torch_fused(variant, threshold, dtype)
    assert int(want["num_steps"]) < MAX_ITERS and want["finished"].all()
    assert len(set(want["lengths"].tolist())) > 1
    _compare(got, want, atol=atol)


def test_which_location_sensitive_configurations_the_kernel_serves():
    for variant in VARIANTS:
        assert fd.supports_fused_decode(HParams(**{**_NARROW, **VARIANTS[variant]})), variant
        assert fd.supports_fused_decode(
            HParams(**{**_NARROW, **VARIANTS[variant], "compute_dtype": "bfloat16"})), variant
    dual, single = VARIANTS["dual_self_attention_previous"], VARIANTS["extended_cumulative"]
    # DualSourceDecoder, which the flagship's model class keeps, and SelfAttentionDecoder
    # are served too (tests/test_torch_dualsource_ls.py and
    # tests/test_torch_fused_decode_ls_branches.py hold them)
    assert fd.supports_fused_decode(HParams(**{**_NARROW, **dual, "decoder": "DualSourceDecoder"}))
    assert fd.supports_fused_decode(HParams(**{**_NARROW, **single,
                                               "decoder": "SelfAttentionDecoder"}))
    for overrides in (
        dict(single, attention_kernel=8),           # an even window is not centred
        dict(single, attention_kernel=33),          # more taps than the kernel holds
    ):
        assert not fd.supports_fused_decode(HParams(**{**_NARROW, **overrides})), overrides
    packed = fd.pack_decoder(_torch_net("extended_cumulative").decoder)
    assert packed.sizes["K"] == 7 and packed.mat("ls_w").shape == (fd.MAX_TAPS, 16)
    assert float(packed.mat("ls_w")[7:].abs().max()) == 0.0
    assert fd.variant_name(False, False, torch.bfloat16, ls=True) == "dual=0,use_sa=0,ls,bf16"
    hp = HParams(**{**_NARROW, **dual, "decoder": "DualSourceDecoder"})
    net = tacotron_model_factory(hp).network(device="cpu").eval()
    packed = fd.pack_decoder(net.decoder)
    assert packed.ls and packed.dual and not packed.use_sa
    hp = HParams(**{**_NARROW, **single, "decoder": "SelfAttentionDecoder"})
    net = TacotronModelBase(hp).network(device="cpu").eval()
    packed = fd.pack_decoder(net.decoder)
    assert packed.ls and packed.use_sa and not packed.dual
