"""The reference's location-sensitive family (``ls``) as a whole model against the JAX package.

``ExtendedTacotronV1Model`` with ``ZoneoutEncoderV1``, ``ExtendedDecoder`` and
``attention="location_sensitive"`` (the ICASSP'19 comparison family), narrow: 7
taps, 4 filters, cumulative weights.

* Synthesis: ``make_predict_fn`` of the port on the CPU (the step-by-step path,
  ``LocationSensitiveAttention`` as flax computes it) against the JAX package's
  (its XLA loop), the same flax weights and source, prenet dropout 0.5 from the
  masks the JAX side draws: to the step cap and with an early exit whose
  threshold comes from the JAX run's own stop probabilities; 1e-4 on mel, stop
  probabilities and alignments, lengths, flags and step counts exact.
* Training: the checks of ``test_torch_training.py`` (imported here, so they run
  once for this configuration): one and three ``train_step``s against the JAX
  ``Trainer`` from the same weights and batch, every stochastic rate 0; loss
  parts, ``grad_norm``, every gradient leaf (``location_conv``,
  ``location_layer`` and ``attention_b`` among them), every updated parameter.
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

LS_FAMILY = dict(
    tacotron_model="ExtendedTacotronV1Model", encoder="ZoneoutEncoderV1",
    decoder="ExtendedDecoder", attention="location_sensitive", attention_kernel=7,
    attention_filters=4, cumulative_weights=True,
)
SYNTHESIS = dict(_SYNTH_NARROW, **LS_FAMILY, encoder_out_units=32, attention1_out_units=16)
STOP_SPREAD = 8.0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three updates of the narrow ``ls`` family on both sides."""
    return three_steps(dict(_NARROW, **LS_FAMILY, encoder_out_units=16), tmp_path_factory)


def test_the_location_parameters_receive_gradients(runs):
    keys = [k for k in runs["jax_grads"] if "location_conv" in k or "location_layer" in k
            or k.endswith("attention_b")]
    assert len(keys) == 4, keys
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
    # the stop columns spread, as test_torch_fused_decode.py's SPREAD, so that a
    # threshold lets the lanes fire at steps of their own
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
    assert len(got["alignments"]) == len(want["alignments"]) == 1
    assert_close(got["alignments"][0], want["alignments"][0], atol=1e-4)
    # a single-stream encoder has no encoder self-attention
    assert got["encoder_sa_alignments"] == () and len(want["encoder_sa_alignments"]) == 0
    for key in ("lengths", "finished"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    assert int(got["num_steps"]) == int(want["num_steps"])


def test_ls_synthesis_matches_jax_to_the_step_cap_and_with_early_exit(jax_side):
    got, want = _run(jax_side, 2.0)
    assert int(want["num_steps"]) == MAX_ITERS and not want["finished"].any()
    assert [a.shape for a in got["alignments"]] == [(3, MAX_ITERS, SRC_LENGTHS.max())]
    _compare(got, want)
    threshold = _threshold_with_early_exit(want["stop_probs"])
    got, want = _run(jax_side, threshold)
    assert int(want["num_steps"]) < MAX_ITERS and want["finished"].all()
    _compare(got, want)
