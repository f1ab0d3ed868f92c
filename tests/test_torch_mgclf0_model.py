"""The WORLD-feature model classes' synthesis as whole models against the JAX package.

``MgcLf0TacotronModel`` (``ZoneoutEncoderV1``, ``MgcLf0ExtendedDecoder``, forward
attention: the reference's ``mgclf0`` convergence family) and
``DualSourceSelfAttentionMgcLf0TacotronModel`` (the flagship's structure with the
WORLD heads), narrow, ``num_mgcs=7`` and ``num_lf0s=13`` (off a multiple of 4):
``make_predict_fn`` of the port on the CPU against the JAX package's, the same
flax weights and source, to the step cap and with an early exit whose threshold
comes from the JAX run's own stop probabilities. The fused branch (the kernel's
plain version) against the JAX Pallas kernel in interpret mode, prenet dropout
off; the step-by-step path against the JAX XLA loop, prenet dropout 0.5 from the
masks the JAX side draws. float32: 1e-4 on mgc, lf0, stop probabilities and
alignments; bfloat16 (``mgclf0``, the dtype the reference trains it in; each path
against its own JAX counterpart, which rounds where it does): 3e-2. Lengths,
flags and step counts exact. Training: ``test_torch_mgclf0_training.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.synthesis import make_predict_fn as jax_make_predict_fn

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.synthesis import make_predict_fn

from test_torch_helpers import assert_close, load_from_flax
from test_torch_synthesis import MAX_ITERS, SRC_LENGTHS, _NARROW as _SYNTH_NARROW
from test_torch_synthesis import _jax_prenet_masks, _source, _threshold_with_early_exit

MGCS, LF0S = 7, 13
HEADS = ("mgc", "lf0")
MODELS = {
    "mgclf0": dict(tacotron_model="MgcLf0TacotronModel", encoder="ZoneoutEncoderV1",
                   decoder="MgcLf0ExtendedDecoder", encoder_out_units=16),
    "flagship_mgclf0": dict(tacotron_model="DualSourceSelfAttentionMgcLf0TacotronModel",
                            encoder="SelfAttentionCBHGEncoder",
                            decoder="MgcLf0DualSourceSelfAttentionDecoder"),
}
# the stop columns spread, as test_torch_fused_decode.py's SPREAD, so that a
# threshold lets the lanes fire at steps of their own
STOP_SPREAD = {"mgclf0": 16.0, "flagship_mgclf0": 8.0}
TOL_BF16 = 3e-2


def _synthesis_kw(model, **overrides):
    return dict(_SYNTH_NARROW, num_mgcs=MGCS, num_lf0s=LF0S, **MODELS[model], **overrides)


_variables = {}


def _synthesis_variables(model):
    if model not in _variables:
        hp = JaxHParams(**_synthesis_kw(model))
        net = jax_factory(hp).network(is_training=True)
        variables = dict(net.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
             "zoneout": jax.random.PRNGKey(2)},
            jnp.asarray(_source()), jnp.asarray(SRC_LENGTHS),
            jnp.zeros((3, 4, MGCS + LF0S), jnp.float32), jnp.full((3,), 4, jnp.int32),
        ))
        params = dict(variables["params"])
        params["decoder"] = dict(params["decoder"])
        proj = dict(params["decoder"]["output_projection"])
        proj["kernel"] = proj["kernel"].at[:, -hp.outputs_per_step:].multiply(STOP_SPREAD[model])
        params["decoder"]["output_projection"] = proj
        _variables[model] = dict(variables, params=params)
    return _variables[model]


def _synthesize(model, fused, threshold, dtype):
    """(port, JAX) outputs of one request: the fused branches without dropout, the
    step-by-step paths with dropout 0.5 from the JAX side's masks."""
    kw = _synthesis_kw(model, stop_token_threshold=threshold, compute_dtype=dtype,
                       decoder_prenet_drop_rate=0.0 if fused else 0.5)
    rng = jax.random.PRNGKey(11)
    batch = {"source": jnp.asarray(_source()), "source_lengths": jnp.asarray(SRC_LENGTHS)}
    hp = JaxHParams(**kw)
    want = jax_make_predict_fn(jax_factory(hp), max_iters=MAX_ITERS, use_fused=fused)(
        _synthesis_variables(model), batch, rng)
    masks = None if fused else _jax_prenet_masks(rng, hp)
    port_hp = HParams(**kw)
    net = load_from_flax(tacotron_model_factory(port_hp).network(device="cpu"),
                         _synthesis_variables(model), port_hp)
    got = make_predict_fn(net, max_iters=MAX_ITERS, device="cpu", use_fused=fused)(
        {"source": _source(), "source_lengths": SRC_LENGTHS}, prenet_masks=masks)
    return got, jax.tree.map(np.asarray, want)


def _compare_synthesis(got, want, atol):
    assert "mel" not in got and got["mgc"].shape == (3, MAX_ITERS * 2, MGCS)
    assert got["lf0"].shape == (3, MAX_ITERS * 2, LF0S)
    for key in HEADS + ("stop_probs",):
        assert_close(got[key], want[key], atol=atol)
    assert len(got["alignments"]) == len(want["alignments"])
    for g, w in zip(got["alignments"], want["alignments"]):
        assert_close(g, w, atol=atol)
    for key in ("lengths", "finished"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    assert int(got["num_steps"]) == int(want["num_steps"])


@pytest.mark.parametrize("model,fused,dtype", [
    ("mgclf0", True, "float32"), ("mgclf0", False, "float32"),
    ("flagship_mgclf0", True, "float32"), ("flagship_mgclf0", False, "float32"),
    ("mgclf0", True, "bfloat16"), ("mgclf0", False, "bfloat16"),
], ids=["mgclf0-fused", "mgclf0-stepwise", "flagship_mgclf0-fused",
        "flagship_mgclf0-stepwise", "mgclf0-fused-bf16", "mgclf0-stepwise-bf16"])
def test_synthesis_matches_jax_to_the_step_cap_and_with_early_exit(model, fused, dtype):
    atol = 1e-4 if dtype == "float32" else TOL_BF16
    got, want = _synthesize(model, fused, 2.0, dtype)
    assert int(want["num_steps"]) == MAX_ITERS and not want["finished"].any()
    _compare_synthesis(got, want, atol)
    threshold = _threshold_with_early_exit(want["stop_probs"])
    got, want = _synthesize(model, fused, threshold, dtype)
    assert int(want["num_steps"]) < MAX_ITERS and want["finished"].all()
    _compare_synthesis(got, want, atol)
