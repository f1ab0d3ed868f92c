"""``DualSourceDecoder`` with location-sensitive attention (``flagship-dualsource-ls``) against the JAX package.

``DualSourceSelfAttentionTacotronModel`` keeps any ``DualSource*`` decoder, and
``DualSourceDecoder`` is the hparams' own default: two sources, no decoder
self-attention. The decode kernel has an instantiation of its own for it
(``tests/test_torch_fused_decode_ls_branches.py`` holds its plain version against
the Pallas kernel); the teacher kernels take it as they take the flagship's
decoder, whose self-attention sits outside the scan. Held here:

* the decoder's hand-over to ``ops/fused_teacher.py`` (``location_fold`` under
  autograd, then the plain version of the teacher kernels) against the JAX network
  on its fused path (Pallas kernels in interpret mode): in float32 the loss and
  every parameter's gradient to 1e-4 of the leaf's largest entry
  (``test_torch_fused_teacher_ls.py``'s check with this decoder); in bfloat16 every
  leaf within a quarter of the JAX function's own bfloat16-against-float32 gap
  (``test_torch_fused_teacher_bf16.py``'s check with this decoder);
* synthesis: ``make_predict_fn`` of the port on the CPU (the step-by-step path)
  against the JAX package's XLA loop, the same flax weights and source, prenet
  dropout 0.5 from the masks the JAX side draws, to the step cap and with an early
  exit from the JAX run's own stop probabilities: 1e-4 on mel, stop probabilities
  and both alignments, lengths, flags and step counts exact;
* training: the checks of ``test_torch_training.py`` (imported, so they run once
  here for this configuration): one and three ``train_step``s against the JAX
  ``Trainer`` from the same weights and batch, every stochastic rate 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.synthesis import make_predict_fn as jax_make_predict_fn

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import TacotronNetwork, tacotron_model_factory
from self_attention_tacotron_torch.synthesis import make_predict_fn

import test_torch_fused_teacher_bf16 as teacher_bf16
import test_torch_fused_teacher_ls as teacher_ls
from test_torch_helpers import assert_close, load_from_flax
from test_torch_synthesis import MAX_ITERS, SRC_LENGTHS, _NARROW as _SYNTH_NARROW
from test_torch_synthesis import _jax_prenet_masks, _source, _threshold_with_early_exit
from test_torch_training import (  # noqa: F401  (the imported tests run here too)
    _NARROW,
    test_eval_step_and_targets_from_batch,
    test_every_gradient_leaf_of_the_first_step,
    test_every_updated_parameter_and_batch_stats_leaf,
    test_loss_parts_and_grad_norm_of_every_step,
    test_the_inverse_of_convert_gives_back_every_leaf,
    test_the_state_counts_steps_and_sets_the_scheduled_rate,
    three_steps,
)

DUALSOURCE_LS = dict(decoder="DualSourceDecoder", attention="location_sensitive",
                     attention_kernel=5, attention_filters=4, cumulative_weights=True)
SYNTHESIS = dict(_SYNTH_NARROW, **DUALSOURCE_LS, attention1_out_units=16)
STOP_SPREAD = 8.0


def test_the_decoder_is_served_by_the_kernels():
    hp = HParams(**dict(_NARROW, **DUALSOURCE_LS))
    decoder = TacotronNetwork(hp).decoder
    assert decoder.num_attentions == 2 and decoder.self_attention is None
    assert decoder.fused_teacher_supported()
    assert tacotron_model_factory(hp).hparams.decoder == "DualSourceDecoder"


def test_float32_hand_over_matches_the_jax_kernels(monkeypatch):
    """Every gradient of the loss through the teacher kernels' plain version."""
    monkeypatch.setattr(teacher_ls, "_NET", dict(teacher_ls._NET, decoder="DualSourceDecoder"))
    teacher_ls.test_the_decoder_hands_the_folded_taps_over_and_every_gradient_reaches_its_parameter(
        monkeypatch)


def test_bfloat16_hand_over_sits_within_a_quarter_of_the_gap(monkeypatch):
    monkeypatch.setitem(teacher_bf16.DECODER_CASES, "dual_location_sensitive",
                        dict(DUALSOURCE_LS, attention_kernel=7))
    teacher_bf16.test_bf16_decoder_hand_over_sits_within_a_quarter_of_the_gap(
        "dual_location_sensitive", monkeypatch)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three updates of the narrow ``flagship-dualsource-ls`` on both sides."""
    return three_steps(dict(_NARROW, **DUALSOURCE_LS), tmp_path_factory)


def test_the_location_parameters_receive_gradients(runs):
    keys = [k for k in runs["jax_grads"] if "location_conv" in k or "location_layer" in k
            or k.endswith("attention_b")]
    assert len(keys) == 4, keys
    assert not any("self_attention" in k and "decoder" in k for k in runs["jax_grads"])
    for key in keys:
        assert float(np.abs(runs["jax_grads"][key]).max()) > 0.0, key
        assert float(np.abs(runs["grads"][key]).max()) > 0.0, key


@pytest.fixture(scope="module")
def jax_side():
    hp = JaxHParams(**SYNTHESIS)
    net = jax_factory(hp).network(is_training=True)
    variables = dict(net.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "zoneout": jax.random.PRNGKey(2)},
        jnp.asarray(_source()), jnp.asarray(SRC_LENGTHS),
        jnp.zeros((3, 4, hp.num_mels), jnp.float32), jnp.full((3,), 4, jnp.int32),
    ))
    # flax starts the location bias at zero: move every leaf, so that it counts
    rng = np.random.default_rng(4)
    variables = jax.tree.map(
        lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)),
        variables)
    params = dict(variables["params"])
    params["decoder"] = dict(params["decoder"])
    proj = dict(params["decoder"]["output_projection"])
    proj["kernel"] = proj["kernel"].at[:, -hp.outputs_per_step:].multiply(STOP_SPREAD)
    params["decoder"]["output_projection"] = proj
    return dict(variables, params=params)


def _run(variables, threshold):
    hp = JaxHParams(**SYNTHESIS, stop_token_threshold=threshold)
    rng = jax.random.PRNGKey(11)
    batch = {"source": jnp.asarray(_source()), "source_lengths": jnp.asarray(SRC_LENGTHS)}
    want = jax_make_predict_fn(jax_factory(hp), max_iters=MAX_ITERS, use_fused=False)(
        variables, batch, rng)
    masks = _jax_prenet_masks(rng, hp)
    port_hp = HParams(**SYNTHESIS, stop_token_threshold=threshold)
    net = load_from_flax(tacotron_model_factory(port_hp).network(device="cpu"), variables,
                         port_hp)
    got = make_predict_fn(net, max_iters=MAX_ITERS, device="cpu")(
        {"source": _source(), "source_lengths": SRC_LENGTHS}, prenet_masks=masks)
    return got, jax.tree.map(np.asarray, want)


def _compare(got, want):
    for key in ("mel", "stop_probs"):
        assert_close(got[key], want[key], atol=1e-4)
    assert len(got["alignments"]) == len(want["alignments"]) == 2
    for g, w in zip(got["alignments"], want["alignments"]):
        assert_close(g, w, atol=1e-4)
    for key in ("lengths", "finished"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    assert int(got["num_steps"]) == int(want["num_steps"])


def test_synthesis_matches_jax_to_the_step_cap_and_with_early_exit(jax_side):
    got, want = _run(jax_side, 2.0)
    assert int(want["num_steps"]) == MAX_ITERS and not want["finished"].any()
    _compare(got, want)
    threshold = _threshold_with_early_exit(want["stop_probs"])
    got, want = _run(jax_side, threshold)
    assert int(want["num_steps"]) < MAX_ITERS and want["finished"].all()
    assert len(set(want["lengths"].tolist())) > 1
    _compare(got, want)
