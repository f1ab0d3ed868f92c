"""The port's trainable BiGRU in bfloat16 against the JAX package's ``bigru_train``.

The same numpy inputs, ``xs`` in bfloat16 and float32 weights, go through
``fused_rnn.bigru_train`` of the port (on the CPU: the autograd function with the
plain versions of its two kernels) and through ``bigru_train(..., interpret=True)``
of the JAX package: outputs, and the gradients of the input and of all eight
weight leaves, with ragged lengths.

Tolerance: the JAX function in bfloat16 against itself in float32 on the same
inputs is the yardstick (``gap``); the port against the JAX function in
bfloat16 must sit within a quarter of it, per gradient leaf in ||delta|| / ||ref||
and in max abs for the outputs. A rounding point that differs from the
reference's shows as an error near the gap. ``-s`` prints both per leaf.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_torch.ops import fused_rnn

from test_torch_bigru_train import KEYS, SHAPES, _inputs, _jax_side, _torch_side

SHARE_OF_GAP = 0.25


def _relative(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _leaves(side):
    """{name: array} of one side's (y, d_xs, forward-direction and backward-direction grads)."""
    y, g_x, g_f, g_b = side
    out = {"y": y, "d_xs": g_x}
    out.update({f"fwd_{k}": g_f[k] for k in KEYS})
    out.update({f"bwd_{k}": g_b[k] for k in KEYS})
    return {k: np.asarray(torch.as_tensor(v).float() if torch.is_tensor(v) else
                          np.asarray(v, np.float32)) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _sides(name):
    shape = SHAPES[name]
    xs, lengths, params, cot = _inputs(shape)
    xs16 = jnp.asarray(xs, jnp.bfloat16)
    jax16 = _leaves(_jax_side(xs16, lengths, params, cot, shape[3]))
    jax32 = _leaves(_jax_side(xs, lengths, params, cot, shape[3]))

    def bf16_side(fn):
        x = torch.tensor(np.asarray(xs16, np.float32)).bfloat16().requires_grad_(True)
        ps = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()} for p in params]
        y = fn(x, torch.tensor(lengths), ps[0], ps[1], shape[3])
        (y * torch.tensor(cot)).sum().backward()
        return y.detach(), x.grad, {k: v.grad for k, v in ps[0].items()}, {
            k: v.grad for k, v in ps[1].items()}

    got = bf16_side(fused_rnn.bigru_train)
    return shape, got, _leaves(got), jax16, jax32


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_bf16_outputs_and_gradients_sit_within_a_quarter_of_the_gap(name):
    shape, raw, got, want, f32 = _sides(name)
    assert raw[0].dtype == torch.bfloat16 and raw[1].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for side in raw[2:] for g in side.values())
    rows = []
    for leaf in got:
        if leaf == "y":
            err = float(np.abs(got[leaf] - want[leaf]).max())
            gap = float(np.abs(want[leaf] - f32[leaf]).max())
        else:
            err, gap = _relative(got[leaf], want[leaf]), _relative(want[leaf], f32[leaf])
        rows.append((leaf, err, gap))
    print(f"\nbigru_train bf16, {name}: leaf, port against JAX bf16, JAX bf16 against f32")
    for leaf, err, gap in rows:
        print(f"  {leaf:24s} {err:.3e}  {gap:.3e}")
    for leaf, err, gap in rows:
        assert gap > 0.0, f"{name}: {leaf} shows no bfloat16 gap"
        assert err <= SHARE_OF_GAP * gap, f"{name}: {leaf}: {err:.3e} against a gap of {gap:.3e}"
    # padded positions emit zero and take no gradient
    B, S = shape[0], shape[1]
    pad = np.arange(S)[None, :] >= np.asarray(shape[4])[:, None]
    assert float(np.abs(got["y"][pad]).max(initial=0.0)) == 0.0
    assert float(np.abs(got["d_xs"][pad]).max(initial=0.0)) == 0.0


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_bf16_function_equals_autograd_through_its_plain_version_where_it_rounds(name):
    """The carry kernel's plain version in bfloat16 against the float32 one on the
    same operands: the only difference is the rounding of the two cotangents that
    enter its products, so they agree to a few bfloat16 ulps of the largest entry."""
    shape = SHAPES[name]
    xs, lengths, params, cot = _inputs(shape, seed=2)
    H = shape[3]
    x = torch.tensor(xs).bfloat16()
    weights = [torch.tensor(p[k]) for p in params for k in fused_rnn._PARAM_KEYS]
    y = fused_rnn.bigru_reference(
        x, torch.tensor(lengths), dict(zip(KEYS, weights[:4])), dict(zip(KEYS, weights[4:])), H)
    rz, n, hp, _, _, wgh_t, wch_t = fused_rnn.bwd_operands(x, y, weights, H)
    assert wgh_t.dtype == wch_t.dtype == torch.bfloat16 and rz.dtype == torch.float32
    args = (torch.tensor(cot), rz, n, hp, torch.tensor(lengths))
    got = fused_rnn.bigru_bwd_carry(*args, wgh_t, wch_t)
    wide = fused_rnn.bigru_bwd_carry(*args, wgh_t.float(), wch_t.float())
    for a, b in zip(got, wide):
        assert a.dtype == torch.float32
        scale = float(b.abs().max())
        assert 0.0 < float((a - b).abs().max()) <= 0.05 * scale
