"""The last two location-sensitive branches of the whole-loop decode (``ops/fused_decode.py``) on the CPU.

Location-sensitive attention with the lf0 feedback (``MgcLf0ExtendedDecoder`` of
``MgcLf0TacotronModel`` and ``MgcLf0DualSourceSelfAttentionDecoder`` of
``DualSourceSelfAttentionMgcLf0TacotronModel``, which pin only the decoder), and
location-sensitive attention on ``DualSourceDecoder`` (two sources without the
decoder self-attention, which ``DualSourceSelfAttentionTacotronModel`` keeps). The
CUDA kernel has an instantiation for each in both io types; on the CPU
``fused_decode`` runs their plain version, ``fused_decode_reference``. It is held,
as ``test_torch_fused_decode_ls.py`` holds the location-sensitive mel decoders,

* against the port's step-by-step path with prenet dropout 0.5 from the same
  injected masks: floats to 1e-5, integers and flags exact, to the cap and with an
  early exit;
* against the JAX package's Pallas kernel in interpret mode (``fused_decode`` of
  ``self_attention_tacotron_tpu/ops/fused_decode.py``) on the same conditioning,
  the JAX encoder's, so that only the decode is compared; prenet dropout off:
  atol 1e-4 on every head, stop probabilities and alignments in float32, 1e-3 in
  bfloat16 (both round where the Pallas kernel casts to its io dtype; the two read
  at most 4.8e-7 apart on initialisations 0 to 3, where the bfloat16 runs lie up
  to 2.4e-2 from the float32 ones), lengths, flags and step counts exact, to the
  cap and with an early exit, and to the cap from further initialisations
  (``MORE_SEEDS``) in bfloat16.

Each exit's threshold comes from the run's own stop probabilities (``_threshold``:
every lane fires before the cap, not all at one step). 7 taps, 4 filters, A1 = 16;
``num_mgcs=7`` and ``num_lf0s=13`` (the split and the frame's end off a multiple
of 4). The stop columns of the output projection are scaled (``SPREAD``) and the
flax initialisation seeded (``INIT_SEED``) so that such a threshold exists.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import TacotronNetwork as JaxTacotronNetwork
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.ops import fused_decode as jax_fused_decode

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.ops import fused_decode as fd
from self_attention_tacotron_torch.synthesis import make_predict_fn

from test_torch_fused_decode import B, MAX_ITERS, R, _masks, _threshold
from test_torch_helpers import assert_close, load_from_flax
from test_torch_synthesis import _NARROW

_LS = dict(attention="location_sensitive", attention_kernel=7, attention_filters=4,
           attention1_out_units=16)
_WORLD = dict(num_mgcs=7, num_lf0s=13)
VARIANTS = {
    # dual=0, use_sa=0, the lf0 feedback: MgcLf0TacotronModel's decoder
    "mgclf0_extended_cumulative": dict(
        _LS, **_WORLD, tacotron_model="MgcLf0TacotronModel", encoder="EncoderV1",
        decoder="MgcLf0ExtendedDecoder", cumulative_weights=True),
    # dual=1, use_sa=1, the lf0 feedback: DualSourceSelfAttentionMgcLf0TacotronModel's
    "mgclf0_dual_self_attention_previous": dict(
        _LS, **_WORLD, tacotron_model="DualSourceSelfAttentionMgcLf0TacotronModel",
        decoder="MgcLf0DualSourceSelfAttentionDecoder", cumulative_weights=False),
    # dual=1, use_sa=0, the mel head: DualSourceSelfAttentionTacotronModel keeps it
    "dual_source_cumulative": dict(_LS, decoder="DualSourceDecoder", cumulative_weights=True),
}
# (dual, use_sa, lf0) of each variant's instantiation
FLAGS = {"mgclf0_extended_cumulative": (False, False, True),
         "mgclf0_dual_self_attention_previous": (True, True, True),
         "dual_source_cumulative": (True, False, False)}
SPREAD = {"mgclf0_extended_cumulative": 16.0, "mgclf0_dual_self_attention_previous": 8.0,
          "dual_source_cumulative": 8.0}
INIT_SEED = {"mgclf0_extended_cumulative": 1, "mgclf0_dual_self_attention_previous": 0,
             "dual_source_cumulative": 3}
# Further initialisations, each held to the cap in bfloat16
MORE_SEEDS = (2, 3)
S = 11
SRC_LENGTHS = np.array([11, 7, 4], np.int32)
TOL_BF16 = 1e-3


def _heads(variant):
    return ("mgc", "lf0") if "num_mgcs" in VARIANTS[variant] else ("mel",)


def _batch(seed=7):
    rng = np.random.default_rng(seed)
    return {"source": rng.integers(1, 30, size=(B, S)).astype(np.int32),
            "source_lengths": SRC_LENGTHS}


_flax_cache = {}


def _flax_variables(variant, seed=None):
    seed = INIT_SEED[variant] if seed is None else seed
    if (variant, seed) not in _flax_cache:
        hp = JaxHParams(**{**_NARROW, **VARIANTS[variant]})
        net = jax_factory(hp).network(is_training=True)
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        width = hp.num_mgcs + hp.num_lf0s if "mgc" in _heads(variant) else hp.num_mels
        variables = dict(net.init(
            {"params": jax.random.PRNGKey(seed),
             "dropout": jax.random.PRNGKey(1), "zoneout": jax.random.PRNGKey(2)},
            batch["source"], batch["source_lengths"],
            jnp.zeros((B, 4, width), jnp.float32), jnp.full((B,), 4, jnp.int32),
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
        _flax_cache[(variant, seed)] = variables
    return _flax_cache[(variant, seed)]


def _torch_net(variant, seed=None, **overrides):
    hp = HParams(**{**_NARROW, **VARIANTS[variant], **overrides})
    net = tacotron_model_factory(hp).network(device="cpu")
    return load_from_flax(net, _flax_variables(variant, seed), hp)


def _compare(got, want, heads, atol):
    for key in heads + ("stop_probs",):
        assert_close(got[key], np.asarray(want[key]), atol=atol)
    assert len(got["alignments"]) == len(want["alignments"])
    for g, w in zip(got["alignments"], want["alignments"]):
        assert_close(g, np.asarray(w), atol=atol)
    for key in ("lengths", "finished"):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))
    assert int(got["num_steps"]) == int(want["num_steps"])
    steps = int(got["num_steps"])
    for key in heads + ("stop_probs",):   # nothing is left beyond the exit
        assert float(got[key][:, steps * R :].abs().sum()) == 0.0
    for a in got["alignments"]:
        assert float(a[:, steps:].abs().sum()) == 0.0


def _both_paths(variant, threshold):
    net = _torch_net(variant, stop_token_threshold=threshold)
    masks, batch = _masks(), _batch()
    stepwise = make_predict_fn(net, max_iters=MAX_ITERS, device="cpu", use_fused=False)(
        batch, prenet_masks=masks)
    with torch.inference_mode():
        cond, _ = net.encode(torch.as_tensor(batch["source"]).long(),
                             torch.as_tensor(batch["source_lengths"]).long())
        packed = fd.pack_decoder(net.decoder)
        result = fd.fused_decode_reference(packed, cond, masks, MAX_ITERS, threshold)
    plain = {**result.frames, "stop_probs": result.stop_probs,
             "alignments": result.alignments, "lengths": result.lengths,
             "finished": result.finished, "num_steps": result.num_steps}
    return packed, plain, stepwise


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_version_matches_the_step_by_step_path(variant):
    heads = _heads(variant)
    packed, plain, stepwise = _both_paths(variant, threshold=2.0)
    dual, use_sa, lf0 = FLAGS[variant]
    assert (packed.dual, packed.use_sa, packed.ls, packed.lf0) == (dual, use_sa, True, lf0)
    assert packed.ls_cumulative == VARIANTS[variant]["cumulative_weights"]
    assert int(stepwise["num_steps"]) == MAX_ITERS
    assert float(plain[heads[0]].abs().max()) > 0.0
    _compare(plain, stepwise, heads, atol=1e-5)
    threshold = _threshold(stepwise["stop_probs"].numpy())
    _, plain, stepwise = _both_paths(variant, threshold)
    assert int(stepwise["num_steps"]) < MAX_ITERS and bool(stepwise["finished"].all())
    assert len(set(stepwise["lengths"].tolist())) > 1
    _compare(plain, stepwise, heads, atol=1e-5)


def _as_dict(result):
    return {**result["frames"], "stop_probs": result["stop_probs"],
            "alignments": tuple(result["alignments"]), "lengths": result["lengths"],
            "finished": result["finished"], "num_steps": result["num_steps"]}


_conditioning = {}


def _jax_conditioning(variant, dtype, seed):
    """The JAX encoder's conditioning of ``_batch()``, as numpy float32 arrays."""
    key = (variant, dtype, seed)
    if key not in _conditioning:
        hp = JaxHParams(**{**_NARROW, **VARIANTS[variant], "compute_dtype": dtype})
        batch = _batch()
        cond, _ = jax_factory(hp).network(is_training=False).apply(
            _flax_variables(variant, seed), jnp.asarray(batch["source"]),
            jnp.asarray(batch["source_lengths"]), method=JaxTacotronNetwork.encode,
            rngs={"dropout": jax.random.PRNGKey(5)})
        _conditioning[key] = cond
    return _conditioning[key]


_jax_runs = {}


def _run_jax_decode(variant, threshold, dtype="float32", seed=None):
    """The Pallas kernel in interpret mode on the JAX encoder's conditioning."""
    key = (variant, threshold, dtype, seed)
    if key not in _jax_runs:
        hp = JaxHParams(**{**_NARROW, **VARIANTS[variant], "decoder_prenet_drop_rate": 0.0,
                           "stop_token_threshold": threshold, "compute_dtype": dtype})
        decode = jax.jit(functools.partial(jax_fused_decode.fused_decode, hp=hp, batch=B,
                                           max_iters=MAX_ITERS, interpret=True))
        out = decode(variables=_flax_variables(variant, seed),
                     cond=_jax_conditioning(variant, dtype, seed), seed=jnp.int32(0))
        _jax_runs[key] = _as_dict(jax.tree.map(np.asarray, out))
    return _jax_runs[key]


def _run_torch_decode(variant, threshold, dtype="float32", seed=None):
    """The port's plain version of the kernel on the same conditioning: the JAX
    encoder's memories and keys (the masks are the source lengths')."""
    net = _torch_net(variant, seed, decoder_prenet_drop_rate=0.0,
                     stop_token_threshold=threshold, compute_dtype=dtype).eval()
    batch = _batch()
    jax_cond = _jax_conditioning(variant, dtype, seed)
    as_torch = lambda x: torch.tensor(np.asarray(x, np.float32))  # noqa: E731
    with torch.inference_mode():
        own, _ = net.encode(torch.as_tensor(batch["source"]).long(),
                            torch.as_tensor(batch["source_lengths"]).long())
        cond = dataclasses.replace(own, memories=tuple(map(as_torch, jax_cond.memories)),
                                   keys=tuple(map(as_torch, jax_cond.keys)))
        result = fd.fused_decode_reference(fd.pack_decoder(net.decoder), cond, None,
                                           MAX_ITERS, threshold)
    return _as_dict(dataclasses.asdict(result))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_matches_the_pallas_kernel_to_the_cap_and_with_early_exit(variant, dtype):
    heads = _heads(variant)
    atol = 1e-4 if dtype == "float32" else TOL_BF16
    want = _run_jax_decode(variant, 2.0, dtype)
    got = _run_torch_decode(variant, 2.0, dtype)
    assert int(want["num_steps"]) == MAX_ITERS and not want["finished"].any()
    assert len(got["alignments"]) == (2 if FLAGS[variant][0] else 1)
    _compare(got, want, heads, atol=atol)
    # no probability within gap / 2 of the threshold: "fired" cannot differ at atol
    threshold = _threshold(want["stop_probs"], gap=4e-3 if dtype == "float32" else 1e-2)
    want = _run_jax_decode(variant, threshold, dtype)
    got = _run_torch_decode(variant, threshold, dtype)
    assert int(want["num_steps"]) < MAX_ITERS and want["finished"].all()
    assert len(set(want["lengths"].tolist())) > 1
    _compare(got, want, heads, atol=atol)


@pytest.mark.parametrize("seed", MORE_SEEDS)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_matches_the_pallas_kernel_in_bfloat16_from_further_initialisations(variant, seed):
    want = _run_jax_decode(variant, 2.0, "bfloat16", seed)
    got = _run_torch_decode(variant, 2.0, "bfloat16", seed)
    assert int(want["num_steps"]) == MAX_ITERS
    _compare(got, want, _heads(variant), atol=TOL_BF16)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_the_kernel_serves_them_in_both_io_types(variant):
    dual, use_sa, lf0 = FLAGS[variant]
    for dtype, io in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        assert fd.supports_fused_decode(HParams(**{**_NARROW, **VARIANTS[variant],
                                                   "compute_dtype": dtype}))
        packed = fd.pack_decoder(_torch_net(variant, compute_dtype=dtype).decoder)
        assert packed.io_dtype == io and packed.sizes["K"] == 7
        assert packed.sizes["LF0"] == (7 if lf0 else 0)
        name = fd.variant_name(dual, use_sa, io, ls=True, lf0=lf0)
        assert name == fd.variant_name(packed.dual, packed.use_sa, packed.io_dtype, packed.ls,
                                       packed.lf0)
        assert name.startswith(f"dual={int(dual)},use_sa={int(use_sa)},ls")
