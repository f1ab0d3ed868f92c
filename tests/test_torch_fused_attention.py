"""The port's full-sequence MHA (plain version and module) against the JAX package.

The JAX side is ``mha_full_pallas(..., interpret=True)`` and the flax
``MultiHeadAttention``. On the CPU the port's wrapper takes its plain version.
Tolerance: float32 atol 2e-5 on context and probabilities (sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.models.self_attention import (
    MultiHeadAttention as JaxMultiHeadAttention,
)
from self_attention_tacotron_tpu.ops.fused_attention import mha_full_pallas

from self_attention_tacotron_torch.models.self_attention import MultiHeadAttention
from self_attention_tacotron_torch.ops import fused_attention

from test_torch_helpers import assert_close, load_from_flax, t

B, T, D, NH = 3, 16, 32, 2
MASK = np.arange(T)[None, :] < np.array([16, 9, 3])[:, None]


@pytest.fixture(scope="module")
def case():
    x = np.random.default_rng(0).standard_normal((B, T, D)).astype(np.float32)
    qkv = np.random.default_rng(1).standard_normal((B, T, 3 * D)).astype(np.float32)
    mha = JaxMultiHeadAttention(num_heads=NH, num_units=D, is_training=False)
    variables = mha.init(jax.random.PRNGKey(2), jnp.asarray(x))
    port = load_from_flax(MultiHeadAttention(D, NH, D, use_pallas=True), variables)
    return x, qkv, mha, variables, port


@pytest.mark.parametrize("masked", [True, False])
def test_reference_matches_pallas_interpret(case, masked):
    _, qkv, _, _, _ = case
    mask = MASK if masked else None
    want_ctx, want_probs = mha_full_pallas(
        jnp.asarray(qkv), None if mask is None else jnp.asarray(mask),
        num_heads=NH, interpret=True,
    )
    ctx, probs = fused_attention.mha_full_reference(
        t(qkv), None if mask is None else t(mask), NH
    )
    assert ctx.shape == (B, T, D) and probs.shape == (B, NH, T, T)
    assert probs.dtype == torch.float32
    assert_close(ctx, np.asarray(want_ctx), atol=2e-5)
    assert_close(probs, np.asarray(want_probs), atol=2e-5)
    if masked:
        assert float(probs[1, :, :, 9:].max()) == 0.0


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_module_matches_flax(case, masked, use_pallas):
    x, _, mha, variables, port = case
    mask = MASK if masked else None
    want_out, want_probs = mha.apply(
        variables, jnp.asarray(x), None if mask is None else jnp.asarray(mask)
    )
    port.use_pallas = use_pallas
    with torch.no_grad():
        out, probs = port(t(x), None if mask is None else t(mask))
    assert_close(out, np.asarray(want_out), atol=2e-5)
    assert_close(probs, np.asarray(want_probs), atol=2e-5)


def test_causal_path_matches_flax(case):
    x, _, mha, variables, port = case
    want_out, want_probs = mha.apply(variables, jnp.asarray(x), None, True)
    with torch.no_grad():
        out, probs = port(t(x), None, causal=True)
    assert_close(out, np.asarray(want_out), atol=2e-5)
    assert_close(probs, np.asarray(want_probs), atol=2e-5)


def test_wrapper_on_cpu_is_the_reference_and_counts_no_launch(case):
    _, qkv, _, _, _ = case
    before = fused_attention.launch_count
    ctx, probs = fused_attention.mha_full(t(qkv), t(MASK), NH)
    want_ctx, want_probs = fused_attention.mha_full_reference(t(qkv), t(MASK), NH)
    assert fused_attention.launch_count == before
    assert torch.equal(ctx, want_ctx) and torch.equal(probs, want_probs)


def test_reference_bf16_matches_pallas_interpret(case):
    _, qkv, _, _, _ = case
    want_ctx, want_probs = mha_full_pallas(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(MASK), num_heads=NH, interpret=True
    )
    ctx, probs = fused_attention.mha_full_reference(t(qkv).to(torch.bfloat16), t(MASK), NH)
    assert ctx.dtype == torch.bfloat16 and probs.dtype == torch.float32
    # bfloat16 keeps 8 bits: the two frameworks round the products at other places
    assert_close(ctx, np.asarray(want_ctx.astype(jnp.float32)), atol=2e-2)
    assert_close(probs, np.asarray(want_probs), atol=2e-2)


def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    _, qkv, _, _, _ = case
    with pytest.raises(ValueError):
        fused_attention.mha_full(t(qkv)[..., :-1], None, NH)
    with pytest.raises(ValueError):
        fused_attention.mha_full(t(qkv), t(MASK).float(), NH)
    with pytest.raises(TypeError):
        fused_attention.mha_full(t(qkv).double(), None, NH)


def test_train_mode_attention_dropout_is_named_as_not_ported():
    mha = MultiHeadAttention(D, NH, D, drop_rate=0.05).train()
    with pytest.raises(NotImplementedError):
        mha(torch.zeros(1, 4, D))
    out, _ = MultiHeadAttention(D, NH, D, drop_rate=0.0).train()(torch.zeros(1, 4, D))
    assert out.shape == (1, 4, D)
