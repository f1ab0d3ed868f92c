"""The port's five loss functions against the JAX package's, value and gradient.

Same numpy inputs on both sides, ragged lengths (one lane full, one empty).
Tolerance 1e-6 absolute on the values, 1e-6 on the gradients of the prediction:
float32 reductions over a few hundred terms in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.models import losses as jax_losses

from self_attention_tacotron_torch.models import losses

B, T, D = 4, 12, 6
LENGTHS = np.array([12, 7, 1, 0], np.int32)
ATOL = 1e-6


def _rng():
    return np.random.default_rng(3)


def _both(jax_fn, torch_fn, prediction, *rest, **kwargs):
    """(value, gradient of the first argument) from each framework."""
    want, want_grad = jax.value_and_grad(lambda p: jax_fn(p, *map(jnp.asarray, rest), **kwargs))(
        jnp.asarray(prediction)
    )
    p = torch.tensor(prediction, requires_grad=True)
    got = torch_fn(p, *map(torch.as_tensor, rest), **kwargs)
    got.backward()
    return float(got.detach()), p.grad.numpy(), float(want), np.asarray(want_grad)


def _assert_both(result):
    got, got_grad, want, want_grad = result
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(got_grad, want_grad, atol=ATOL, rtol=0)
    return got_grad


@pytest.mark.parametrize("loss_type", ["l1", "mse"])
def test_spec_loss(loss_type):
    rng = _rng()
    pred = rng.standard_normal((B, T, D)).astype(np.float32)
    target = rng.standard_normal((B, T, D)).astype(np.float32)
    grad = _assert_both(_both(
        jax_losses.spec_loss, losses.spec_loss, pred, target, LENGTHS, loss_type=loss_type
    ))
    pad = np.arange(T)[None, :] >= LENGTHS[:, None]
    assert float(np.abs(grad[pad]).max()) == 0.0           # padded frames take no gradient


def test_spec_loss_of_an_unknown_type_raises():
    x = torch.zeros(1, 2, 3)
    with pytest.raises(ValueError, match="spec_loss_type"):
        losses.spec_loss(x, x, torch.tensor([2]), "huber")


def test_stop_token_loss():
    rng = _rng()
    logits = (4.0 * rng.standard_normal((B, T))).astype(np.float32)
    done = (np.arange(T)[None, :] >= LENGTHS[:, None] - 1).astype(np.float32)
    _assert_both(_both(jax_losses.stop_token_loss, losses.stop_token_loss, logits, done, LENGTHS))


@pytest.mark.parametrize("one_hot", [False, True], ids=["integer_labels", "one_hot_labels"])
def test_classification_loss(one_hot):
    rng = _rng()
    classes = 9
    logits = rng.standard_normal((B, T, classes)).astype(np.float32)
    labels = rng.integers(0, classes, (B, T)).astype(np.int32)
    if one_hot:
        labels = np.eye(classes, dtype=np.float32)[labels]
    _assert_both(_both(
        jax_losses.classification_loss, losses.classification_loss, logits, labels, LENGTHS
    ))


def test_binary_divergence():
    rng = _rng()
    pred = rng.uniform(-0.1, 1.1, (B, T, D)).astype(np.float32)      # clipped on both sides
    target = rng.uniform(0.0, 1.0, (B, T, D)).astype(np.float32)
    target[0, 0, :2] = (0.0, 1.0)
    _assert_both(_both(jax_losses.binary_divergence, losses.binary_divergence, pred, target, LENGTHS))


def test_l2_regularization_reads_kernels_only():
    rng = _rng()
    leaves = {"kernel": rng.standard_normal((5, 4)).astype(np.float32),
              "conv": rng.standard_normal((3, 2, 4)).astype(np.float32),
              "bias": rng.standard_normal((4,)).astype(np.float32)}
    want = float(jax_losses.l2_regularization(jax.tree.map(jnp.asarray, leaves), 1e-3))
    params = [torch.tensor(v, requires_grad=True) for v in leaves.values()]
    got = losses.l2_regularization(params, 1e-3)
    got.backward()
    np.testing.assert_allclose(float(got), want, atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(params[0].grad.numpy(), 2e-3 * leaves["kernel"], atol=ATOL)
    assert params[2].grad is None


def test_a_batch_of_empty_lanes_gives_zero_and_not_nan():
    zeros = torch.zeros(2, dtype=torch.long)
    x = torch.ones(2, 3, 4)
    assert float(losses.spec_loss(x, 0 * x, zeros)) == 0.0
    assert float(losses.stop_token_loss(x[..., 0], x[..., 0], zeros)) == 0.0
