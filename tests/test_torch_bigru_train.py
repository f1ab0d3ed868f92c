"""The port's trainable BiGRU against the JAX package's ``bigru_train``.

The same numpy inputs go through ``fused_rnn.bigru_train`` of the port (on the
CPU: the autograd function with the plain versions of its two kernels) and
through ``bigru_train(..., interpret=True)`` of the JAX package: outputs, and
the gradients of the input and of all eight weight leaves, with ragged lengths.
Tolerance 2e-5 absolute: float32 on both sides, sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.ops import fused_rnn as jax_rnn

from self_attention_tacotron_torch.ops import fused_rnn

ATOL = 2e-5
KEYS = ("gates_kernel", "gates_bias", "candidate_kernel", "candidate_bias")

# (B, S, C, H, lengths): H a multiple of 128, and widths off every tile
SHAPES = {
    "H128": (3, 6, 16, 128, [6, 3, 1]),
    "H20": (4, 9, 7, 20, [9, 1, 4, 9]),
    "H8_all_full": (2, 5, 10, 8, [5, 5]),
}


def _inputs(shape, seed=0):
    B, S, C, H, lengths = shape
    rng = np.random.RandomState(seed)
    r = lambda *s: (rng.randn(*s) * 0.4).astype(np.float32)  # noqa: E731
    params = [
        {"gates_kernel": r(C + H, 2 * H), "gates_bias": r(2 * H),
         "candidate_kernel": r(C + H, H), "candidate_bias": r(H)}
        for _ in range(2)
    ]
    return r(B, S, C), np.asarray(lengths, np.int32), params, r(B, S, 2 * H)


def _jax_side(xs, lengths, params, cot, hidden):
    def tree(p):
        return {"gates": {"kernel": p["gates_kernel"], "bias": p["gates_bias"]},
                "candidate": {"kernel": p["candidate_kernel"], "bias": p["candidate_bias"]}}

    def loss(x, pf, pb):
        y = jax_rnn.bigru_train(x, jnp.asarray(lengths), pf, pb, hidden=hidden, interpret=True)
        return jnp.sum(y * cot), y

    (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(xs), jax.tree.map(jnp.asarray, tree(params[0])),
        jax.tree.map(jnp.asarray, tree(params[1])),
    )
    flat = lambda g: {f"{a}_{b}": g[a][b] for a in ("gates", "candidate")  # noqa: E731
                      for b in ("kernel", "bias")}
    return y, grads[0], flat(grads[1]), flat(grads[2])


def _torch_side(fn, xs, lengths, params, cot, hidden):
    x = torch.tensor(xs, requires_grad=True)
    ps = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()} for p in params]
    y = fn(x, torch.tensor(lengths), ps[0], ps[1], hidden)
    (y * torch.tensor(cot)).sum().backward()
    return y.detach(), x.grad, {k: v.grad for k, v in ps[0].items()}, {
        k: v.grad for k, v in ps[1].items()
    }


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_outputs_and_gradients_match_the_jax_kernel(name):
    shape = SHAPES[name]
    xs, lengths, params, cot = _inputs(shape)
    want = _jax_side(xs, lengths, params, cot, shape[3])
    got = _torch_side(fused_rnn.bigru_train, xs, lengths, params, cot, shape[3])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=ATOL, rtol=0)
    for direction in (2, 3):
        for key in KEYS:
            np.testing.assert_allclose(
                got[direction][key].numpy(), np.asarray(want[direction][key]), atol=ATOL, rtol=0,
                err_msg=f"{name}: direction {direction - 2}, {key}",
            )
    # padded positions emit zero and take no gradient
    B, S = xs.shape[:2]
    pad = np.arange(S)[None, :] >= lengths[:, None]
    assert float(np.abs(got[0].numpy()[pad]).max(initial=0.0)) == 0.0
    assert float(np.abs(got[1].numpy()[pad]).max(initial=0.0)) == 0.0


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_the_function_equals_autograd_through_the_plain_version(name):
    shape = SHAPES[name]
    xs, lengths, params, cot = _inputs(shape, seed=1)
    want = _torch_side(fused_rnn.bigru_reference, xs, lengths, params, cot, shape[3])
    got = _torch_side(fused_rnn.bigru_train, xs, lengths, params, cot, shape[3])
    assert torch.equal(got[0], want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), atol=ATOL, rtol=0)
    for direction in (2, 3):
        for key in KEYS:
            np.testing.assert_allclose(
                got[direction][key].numpy(), want[direction][key].numpy(), atol=ATOL, rtol=0
            )


def test_bfloat16_and_unknown_devices_raise():
    xs, lengths, params, _ = _inputs(SHAPES["H8_all_full"])
    ps = [{k: torch.tensor(v) for k, v in p.items()} for p in params]
    with pytest.raises(TypeError, match="float32"):
        fused_rnn.bigru_train(torch.tensor(xs).bfloat16(), torch.tensor(lengths), ps[0], ps[1], 8)
    meta = torch.zeros(2, 2, 5, 8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fused_rnn.bigru_bwd_carry(
            torch.zeros(2, 5, 16, device="meta"), torch.zeros(2, 2, 5, 16, device="meta"), meta,
            meta, torch.tensor(lengths), None, None,
        )
