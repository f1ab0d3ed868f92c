"""The baseline's ``Trainer.train_step`` against the JAX package's, leaf by leaf.

``ExtendedTacotronV1Model`` (single-source ``ExtendedDecoder``, forward
attention) with each of its encoders, ``EncoderV1`` and ``ZoneoutEncoderV1``,
narrow: one and three updates on both sides from the same weights and the same
seeded batch, every stochastic rate 0. The setup and the checks are those of
``test_torch_training.py`` (imported here, so they run once for each baseline
configuration): loss parts and ``grad_norm``, every gradient leaf of the first
step (1e-4 relative to the leaf's largest entry), every updated parameter and
``batch_stats`` leaf after one and three steps (1e-4), the scheduled rate, and
an ``eval_step``.
"""

import pytest

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

BASELINES = {
    "EncoderV1": dict(tacotron_model="ExtendedTacotronV1Model", encoder="EncoderV1",
                      decoder="ExtendedDecoder"),
    "ZoneoutEncoderV1": dict(tacotron_model="ExtendedTacotronV1Model",
                             encoder="ZoneoutEncoderV1", decoder="ExtendedDecoder",
                             encoder_out_units=16),
}


@pytest.fixture(scope="module", params=sorted(BASELINES))
def runs(request, tmp_path_factory):
    """Three updates of a baseline configuration on both sides."""
    return three_steps(dict(_NARROW, **BASELINES[request.param]), tmp_path_factory)
