"""The WORLD-feature (MgcLf0) branch of the whole-loop decode (``ops/fused_decode.py``) on the CPU.

The MgcLf0 decoders write a frame of ``num_mgcs + num_lf0s`` values: mgc
regression values, then lf0 class logits. The kernel treats the frame as one row
and softmaxes its lf0 lanes before they feed the next step's prenet (training
feeds one-hot rows there); the frames it returns stay logits. On the CPU
``fused_decode`` runs the kernel's plain version, ``fused_decode_reference``. It
is held here

* against the JAX package's Pallas kernel in interpret mode
  (``make_predict_fn(model, use_fused=True)``, as the JAX package's
  ``tests/test_fused_decode.py`` runs its MgcLf0 cases), prenet dropout off: atol
  1e-4 on mgc, lf0, stop probabilities and alignments in float32 (two float32
  implementations over 12 fed-back steps), 3e-2 in bfloat16 (both round where the
  Pallas kernel casts to its io dtype), lengths, flags and step counts exact, to
  the cap and with an early exit;
* with prenet dropout 0.5, against the JAX package's step-by-step XLA loop, whose
  masks (drawn from its own key) the port is handed: float32, atol 1e-4.

Three decoders: the two that the model classes reach (``MgcLf0ExtendedDecoder``
of ``MgcLf0TacotronModel``, ``MgcLf0DualSourceSelfAttentionDecoder`` of
``DualSourceSelfAttentionMgcLf0TacotronModel``) and one that none reaches
(``MgcLf0DualSourceDecoder``). ``num_mgcs=7`` and ``num_lf0s=13``: the split and
the frame's end both off a multiple of 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import TacotronModelBase as JaxModelBase
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.synthesis import make_predict_fn as jax_make_predict_fn

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import TacotronModelBase, tacotron_model_factory
from self_attention_tacotron_torch.ops import fused_decode as fd
from self_attention_tacotron_torch.synthesis import make_predict_fn

from test_torch_fused_decode import B, MAX_ITERS, R, _threshold
from test_torch_helpers import assert_close, load_from_flax
from test_torch_synthesis import _NARROW

MGCS, LF0S = 7, 13
S = 11
SRC_LENGTHS = np.array([11, 7, 4], np.int32)
TOL_BF16 = 3e-2
HEADS = ("mgc", "lf0")

VARIANTS = {
    # dual=0, use_sa=0: MgcLf0TacotronModel's decoder
    "extended": dict(tacotron_model="MgcLf0TacotronModel", encoder="EncoderV1",
                     decoder="MgcLf0ExtendedDecoder"),
    # dual=1, use_sa=1: DualSourceSelfAttentionMgcLf0TacotronModel's decoder
    "dual_self_attention": dict(tacotron_model="DualSourceSelfAttentionMgcLf0TacotronModel",
                                decoder="MgcLf0DualSourceSelfAttentionDecoder"),
    # dual=1, use_sa=0: no model class reaches it
    "dual_source": dict(decoder="MgcLf0DualSourceDecoder"),
}
# the stop columns of the output projection scaled, as test_torch_fused_decode.py
# does for its decoders whose stop probabilities stay near 0.5 (see SPREAD there)
SPREAD = {"extended": -16.0, "dual_self_attention": 8.0, "dual_source": -8.0}


class _JaxWorldBase(JaxModelBase):
    HEADS = HEADS


class _WorldBase(TacotronModelBase):
    HEADS = HEADS


def _hp(variant, **overrides):
    return {**_NARROW, "num_mgcs": MGCS, "num_lf0s": LF0S, **VARIANTS[variant], **overrides}


def _model(hp, jax_side=False):
    """The model of ``hp``; ``MgcLf0DualSourceDecoder`` is reached by no model class."""
    if hp.decoder == "MgcLf0DualSourceDecoder":
        return (_JaxWorldBase if jax_side else _WorldBase)(hp)
    return (jax_factory if jax_side else tacotron_model_factory)(hp)


def _batch(seed=7):
    rng = np.random.default_rng(seed)
    return {"source": rng.integers(1, 30, size=(B, S)).astype(np.int32),
            "source_lengths": SRC_LENGTHS}


_flax_cache = {}


def _flax_variables(variant):
    if variant not in _flax_cache:
        hp = JaxHParams(**_hp(variant))
        net = _model(hp, jax_side=True).network(is_training=True)
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        variables = dict(net.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
             "zoneout": jax.random.PRNGKey(2)},
            batch["source"], batch["source_lengths"],
            jnp.zeros((B, 4, MGCS + LF0S), jnp.float32), jnp.full((B,), 4, jnp.int32),
        ))
        params = dict(variables["params"])
        params["decoder"] = dict(params["decoder"])
        proj = dict(params["decoder"]["output_projection"])
        proj["kernel"] = proj["kernel"].at[:, -R:].multiply(SPREAD[variant])
        params["decoder"]["output_projection"] = proj
        variables["params"] = params
        _flax_cache[variant] = variables
    return _flax_cache[variant]


def _torch_net(variant, **overrides):
    hp = HParams(**_hp(variant, **overrides))
    net = _model(hp).network(device="cpu")
    return load_from_flax(net, _flax_variables(variant), hp)


def _compare(got, want, atol):
    for key in HEADS + ("stop_probs",):
        assert_close(got[key], np.asarray(want[key]), atol=atol)
    assert len(got["alignments"]) == len(want["alignments"])
    for g, w in zip(got["alignments"], want["alignments"]):
        assert_close(g, np.asarray(w), atol=atol)
    for key in ("lengths", "finished"):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))
    assert int(got["num_steps"]) == int(want["num_steps"])
    steps = int(got["num_steps"])
    for key in HEADS + ("stop_probs",):   # nothing is left beyond the exit
        assert float(got[key][:, steps * R :].abs().sum()) == 0.0
    for a in got["alignments"]:
        assert float(a[:, steps:].abs().sum()) == 0.0


_jax_runs = {}


def _run_jax(variant, threshold, dtype="float32", drop_rate=0.0):
    """The JAX package's predict: its Pallas kernel in interpret mode without
    dropout, its step-by-step XLA loop with it (the kernel draws its own masks)."""
    key = (variant, threshold, dtype, drop_rate)
    if key not in _jax_runs:
        hp = JaxHParams(**_hp(variant, decoder_prenet_drop_rate=drop_rate,
                              stop_token_threshold=threshold, compute_dtype=dtype))
        predict = jax_make_predict_fn(_model(hp, jax_side=True), max_iters=MAX_ITERS,
                                      use_fused=drop_rate == 0.0)
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        out = predict(_flax_variables(variant), batch, jax.random.PRNGKey(11))
        _jax_runs[key] = jax.tree.map(np.asarray, out)
    return _jax_runs[key]


def _jax_loop_masks(keep):
    """The prenet keep masks that the JAX package's step-by-step loop draws from
    ``PRNGKey(11)`` (``synthesis.py::make_predict_fn``)."""
    _, dec_rng = jax.random.split(jax.random.PRNGKey(11))
    keys = jax.random.split(dec_rng, 3)
    units = _NARROW["decoder_prenet_out_units"]
    return tuple(np.array(jax.random.bernoulli(k, keep, (MAX_ITERS, B, u)))
                 for k, u in zip(keys[:2], units))


def _run_torch(variant, threshold, dtype="float32", drop_rate=0.0, masks=None):
    net = _torch_net(variant, decoder_prenet_drop_rate=drop_rate,
                     stop_token_threshold=threshold, compute_dtype=dtype)
    predict = make_predict_fn(net, max_iters=MAX_ITERS, device="cpu", use_fused=True)
    return predict(_batch(), prenet_masks=masks)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_matches_the_pallas_kernel_to_the_cap_and_with_early_exit(variant):
    want = _run_jax(variant, 2.0)
    got = _run_torch(variant, 2.0)
    assert got["mgc"].shape == (B, MAX_ITERS * R, MGCS)
    assert got["lf0"].shape == (B, MAX_ITERS * R, LF0S)
    assert int(want["num_steps"]) == MAX_ITERS and not want["finished"].any()
    assert float(got["lf0"].abs().max()) > 0.0
    _compare(got, want, atol=1e-4)
    threshold = _threshold(want["stop_probs"])
    want = _run_jax(variant, threshold)
    got = _run_torch(variant, threshold)
    assert int(want["num_steps"]) < MAX_ITERS and want["finished"].all()
    assert len(set(want["lengths"].tolist())) > 1
    _compare(got, want, atol=1e-4)


@pytest.mark.parametrize("variant", ["dual_self_attention", "extended"])
def test_bfloat16_matches_the_pallas_kernel_to_the_cap_and_with_early_exit(variant):
    want = _run_jax(variant, 2.0, "bfloat16")
    got = _run_torch(variant, 2.0, "bfloat16")
    assert int(want["num_steps"]) == MAX_ITERS
    _compare(got, want, atol=TOL_BF16)
    # no probability within gap / 2 of the threshold: "fired" cannot differ at atol
    threshold = _threshold(want["stop_probs"], gap=1e-2)
    want = _run_jax(variant, threshold, "bfloat16")
    got = _run_torch(variant, threshold, "bfloat16")
    assert int(want["num_steps"]) < MAX_ITERS and want["finished"].all()
    _compare(got, want, atol=TOL_BF16)


def test_prenet_dropout_from_injected_masks_matches_the_jax_loop():
    """Dropout 0.5: the plain version of the kernel, handed the masks that the JAX
    package's step-by-step loop draws, against that loop."""
    want = _run_jax("dual_self_attention", 2.0, drop_rate=0.5)
    masks = _jax_loop_masks(0.5)
    assert 0.3 < float(np.mean(masks[0])) < 0.7
    got = _run_torch("dual_self_attention", 2.0, drop_rate=0.5, masks=masks)
    _compare(got, want, atol=1e-4)
    undropped = _run_torch("dual_self_attention", 2.0)
    assert float((undropped["mgc"] - got["mgc"]).abs().max()) > 1e-2


def test_the_lf0_feedback_is_compiled_with_forward_attention():
    """The lf0 feedback has instantiations of its own, with forward attention on
    every pair of flags, and with location-sensitive attention on every pair too
    (tests/test_torch_fused_decode_ls_branches.py holds them)."""
    for variant in VARIANTS:
        assert fd.supports_fused_decode(HParams(**_hp(variant)))
        assert fd.supports_fused_decode(HParams(**_hp(variant, compute_dtype="bfloat16")))
    ls = _hp("extended", attention="location_sensitive", attention_kernel=7)
    assert fd.supports_fused_decode(HParams(**ls))
    net = tacotron_model_factory(HParams(**ls)).network(device="cpu").eval()
    packed = fd.pack_decoder(net.decoder)
    assert packed.ls and packed.lf0
    ls = _hp("dual_source", attention="location_sensitive", attention_kernel=7)
    assert fd.supports_fused_decode(HParams(**ls))
    net = _model(HParams(**ls)).network(device="cpu").eval()
    packed = fd.pack_decoder(net.decoder)
    assert packed.ls and packed.lf0 and packed.dual and not packed.use_sa
    packed = fd.pack_decoder(_torch_net("dual_source").decoder)
    assert packed.lf0 and not packed.ls
    assert fd.variant_name(True, False, torch.bfloat16, lf0=packed.lf0) == "dual=1,use_sa=0,lf0,bf16"


def test_the_lf0_lanes_feed_back_as_probabilities():
    """The packed decoder names the lf0 lanes; the fed-back lf0 logits go through
    the softmax (decoding them as plain frames gives other outputs), and the
    frames returned stay logits (not rows summing to 1)."""
    net = _torch_net("extended", decoder_prenet_drop_rate=0.0, stop_token_threshold=2.0)
    packed = fd.pack_decoder(net.decoder)
    assert packed.sizes["M"] == MGCS + LF0S and packed.sizes["LF0"] == MGCS
    assert packed.heads == (("mgc", MGCS), ("lf0", LF0S))
    with torch.inference_mode():
        batch = _batch()
        cond, _ = net.encode(torch.as_tensor(batch["source"]).long(),
                             torch.as_tensor(batch["source_lengths"]).long())
        out = fd.fused_decode_reference(packed, cond, None, MAX_ITERS, 2.0)
        packed.sizes["LF0"] = 0
        plain_feed = fd.fused_decode_reference(packed, cond, None, MAX_ITERS, 2.0)
    sums = out.frames["lf0"].sum(dim=-1)
    assert float((sums - 1.0).abs().min()) > 1e-3
    # the go frame feeds step 0 alike; from step 1 on the feeds differ
    assert torch.equal(out.frames["mgc"][:, :R], plain_feed.frames["mgc"][:, :R])
    assert float((out.frames["mgc"][:, R:] - plain_feed.frames["mgc"][:, R:]).abs().max()) > 1e-3
