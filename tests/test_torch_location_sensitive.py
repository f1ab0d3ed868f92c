"""The port's ``LocationSensitiveAttention`` against flax's, its fold, and its leaves in ``convert``.

* Three consecutive steps of the mechanism from the initial (uniform) state,
  so that the cumulative sums feed back, over the cumulative and over the
  previous alignments, with an odd and an even number of taps (SAME padding
  as XLA pads it, one more on the right for an even window), with the
  mechanism's own query layer and with a query projected by the caller:
  float32 atol 1e-5 (sums in another order); bfloat16 (flax's ``dtype``
  semantics on both sides) within two bfloat16 ulps of the reference's largest
  magnitude, 8e-3 * max|ref|, as ``test_torch_bf16.py`` holds every module.
* The fold the kernels take (``location_fold``: the convolution's taps times
  the dense layer, and the bias) against the convolution and the dense layer
  themselves, values and the gradients of the convolution, the layer and the
  bias through autograd, 1e-5.
* ``convert``: the flax leaves ``location_conv/kernel`` (K, 1, F),
  ``location_conv/bias``, ``location_layer/kernel`` and ``attention_b`` placed
  in the port's layout and given back, values and gradients, under flax names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.models import attention as ja

from self_attention_tacotron_torch import convert
from self_attention_tacotron_torch.models import attention, modules
from self_attention_tacotron_torch.ops.fused_teacher import location_taps

from test_torch_helpers import assert_close, flat_variables, load_from_flax, t

B, S, E, Q, U, F = 3, 9, 10, 12, 8, 3
MASK = np.arange(S)[None, :] < np.array([9, 5, 2])[:, None]
TOL_BF16 = 8e-3


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(kernel, cumulative, projected, dtype=jnp.float32):
    """(flax mechanism, its variables with every leaf moved from its init, port twin)."""
    memory = _randn(0, B, S, E)
    jmech = ja.LocationSensitiveAttention(num_units=U, attention_kernel=kernel,
                                          attention_filters=F, cumulative_weights=cumulative,
                                          dtype=dtype)
    state = ja.initial_attention_state(B, S, initial_alignment=jmech.initial_alignment)
    variables = jmech.init(
        jax.random.PRNGKey(0), jnp.asarray(_randn(10, B, Q)), jnp.zeros((B, S, U)),
        jnp.asarray(memory), jnp.asarray(MASK), state,
        projected_query=jnp.asarray(_randn(20, B, U)) if projected else None,
    )
    key_vars = jmech.init(jax.random.PRNGKey(1), jnp.asarray(memory),
                          method=type(jmech).compute_keys)
    params = dict(variables["params"], memory_layer=key_vars["params"]["memory_layer"])
    rng = np.random.default_rng(3)
    # flax starts the bias at zero: move every leaf, so that each one counts
    params = jax.tree.map(
        lambda a: jnp.asarray(a + 0.3 * rng.standard_normal(a.shape).astype(np.float32)), params)
    port = attention.LocationSensitiveAttention(
        Q, E, U, attention_kernel=kernel, attention_filters=F, cumulative_weights=cumulative,
        own_query_layer=not projected)
    load_from_flax(port, {"params": params})
    return jmech, {"params": params}, port, memory


def _three_steps(kernel, cumulative, projected, dtype):
    jmech, variables, port, memory = _pair(kernel, cumulative, projected, dtype)
    if dtype == jnp.bfloat16:
        modules.set_compute_dtype(port, torch.bfloat16)
    state_j = ja.initial_attention_state(B, S, initial_alignment=jmech.initial_alignment)
    state = attention.initial_attention_state(B, S, initial_alignment=port.initial_alignment)
    keys_j = jmech.apply(variables, jnp.asarray(memory), method=type(jmech).compute_keys)
    keys = port.compute_keys(t(memory))
    mem = t(memory).to(port.compute_dtype)
    rows = []
    with torch.no_grad():
        for i in range(3):
            q, pq = _randn(10 + i, B, Q), _randn(20 + i, B, U)
            want = jmech.apply(variables, jnp.asarray(q), keys_j, jnp.asarray(memory, dtype),
                               jnp.asarray(MASK), state_j,
                               projected_query=jnp.asarray(pq, dtype) if projected else None)
            got = port(t(q), keys, mem, t(MASK), state,
                       projected_query=t(pq).to(port.compute_dtype) if projected else None)
            state_j, state = want[2], got[2]
            rows.append((got, want))
    return keys, keys_j, rows


@pytest.mark.parametrize("projected", [False, True], ids=["own_query_layer", "projected"])
@pytest.mark.parametrize("kernel", [5, 4], ids=["odd", "even"])
@pytest.mark.parametrize("cumulative", [True, False], ids=["cumulative", "previous"])
def test_three_steps_float32(cumulative, kernel, projected):
    keys, keys_j, rows = _three_steps(kernel, cumulative, projected, jnp.float32)
    assert_close(keys, np.asarray(keys_j), atol=1e-5)
    for (ctx, probs, state), (ctx_j, probs_j, state_j) in rows:
        assert_close(ctx, np.asarray(ctx_j), atol=1e-5)
        assert_close(probs, np.asarray(probs_j), atol=1e-5)
        assert_close(state.cumulative, np.asarray(state_j.cumulative), atol=1e-5)
        assert_close(state.alignments, np.asarray(state_j.alignments), atol=1e-5)
        assert state.step == int(state_j.step)
    assert float(probs[2, 2:].abs().max()) < 1e-6        # no mass on padded keys
    # the previous alignments move from step to step: the features are not constant
    assert float((rows[0][0][1] - rows[1][0][1]).abs().max()) > 1e-3


@pytest.mark.parametrize("kernel", [5, 4], ids=["odd", "even"])
@pytest.mark.parametrize("cumulative", [True, False], ids=["cumulative", "previous"])
def test_three_steps_bfloat16(cumulative, kernel):
    keys, keys_j, rows = _three_steps(kernel, cumulative, True, jnp.bfloat16)
    assert keys.dtype == torch.bfloat16

    def check(name, got, want):
        got = got.detach().float().numpy()
        want = np.asarray(jnp.asarray(want, jnp.float32))
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        print(f"bf16 location-sensitive {name}: max abs err {err} of max |ref| {scale}")
        assert err <= TOL_BF16 * scale, (name, err, scale)

    check("keys", keys, keys_j)
    for i, ((ctx, probs, state), (ctx_j, probs_j, state_j)) in enumerate(rows):
        assert ctx.dtype == torch.bfloat16 and probs.dtype == torch.float32
        check(f"context {i}", ctx, ctx_j)
        check(f"alignments {i}", probs, probs_j)
        check(f"cumulative {i}", state.cumulative, state_j.cumulative)


@pytest.mark.parametrize("kernel", [31, 7])
def test_the_fold_is_the_convolution_and_the_dense_layer(kernel):
    _, _, port, _ = _pair(kernel, True, False)
    prev = t(np.abs(_randn(5, B, S)))
    cot = t(_randn(6, B, S, U))
    leaves = (port.location_conv.weight, port.location_conv.bias,
              port.location_layer.weight, port.attention_b)

    direct = port.location_features(prev) + port.attention_b
    grads_direct = torch.autograd.grad((direct * cot).sum(), leaves)
    w, bias = attention.location_fold(port)
    assert tuple(w.shape) == (kernel, U) and tuple(bias.shape) == (U,)
    folded = location_taps(prev, kernel) @ w + bias
    grads_folded = torch.autograd.grad((folded * cot).sum(), leaves)
    assert_close(folded, direct.detach().numpy(), atol=1e-5)
    for got, want in zip(grads_folded, grads_direct):
        scale = float(want.abs().max())
        assert scale > 0.0
        assert_close(got, want.numpy(), atol=1e-5 * scale)


def test_the_converter_places_the_location_leaves_both_ways():
    _, variables, port, _ = _pair(5, True, False)
    flat = flat_variables(variables)
    state = port.state_dict()
    np.testing.assert_array_equal(state["location_conv.weight"].numpy(),
                                  flat["params/location_conv/kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(state["location_conv.bias"].numpy(),
                                  flat["params/location_conv/bias"])
    np.testing.assert_array_equal(state["location_layer.weight"].numpy(),
                                  flat["params/location_layer/kernel"].T)
    np.testing.assert_array_equal(state["attention_b"].numpy(), flat["params/attention_b"])
    back = convert.torch_to_flax_flat(port)
    assert set(back) == set(flat)
    for key, want in flat.items():
        np.testing.assert_array_equal(back[key], want, err_msg=key)
    # the gradients come back under flax names, in flax's layout
    state_j = attention.initial_attention_state(B, S)
    memory = t(_randn(0, B, S, E))
    _, probs, _ = port(t(_randn(10, B, Q)), port.compute_keys(memory), memory, t(MASK),
                       state_j.replace(cumulative=t(np.abs(_randn(7, B, S)))))
    (probs * t(_randn(8, B, S))).sum().backward()
    grads = convert.torch_to_flax_flat(port, gradients=True)
    for key in ("location_conv/kernel", "location_conv/bias", "location_layer/kernel",
                "attention_b"):
        g = grads[f"params/{key}"]
        assert g.shape == flat[f"params/{key}"].shape and float(np.abs(g).max()) > 0.0, key
    np.testing.assert_allclose(grads["params/location_conv/kernel"],
                               port.location_conv.weight.grad.numpy().transpose(2, 1, 0))
