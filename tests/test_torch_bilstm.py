"""The port's bidirectional ZoneoutLSTM (plain version and ``BiRNN``) against the JAX package.

The JAX side is ``bilstm_pallas(..., interpret=True)`` and the flax ``BiRNN``
scan over ``ZoneoutLSTMCell``s. On the CPU the port's wrapper takes its plain
version, ``bilstm_reference``, which the CUDA kernel is held against on the
card. Lengths are ragged and include 1 and S. Tolerances: float32 atol 2e-5
(sums in another order over 12 recurrent steps); bfloat16 compared in float32
with atol 2e-2 (the two frameworks round at other places); gradients 1e-5
relative to the largest entry of the leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.models import modules as jax_modules
from self_attention_tacotron_tpu.ops.fused_rnn import bilstm_pallas

from self_attention_tacotron_torch.models import modules
from self_attention_tacotron_torch.ops import fused_rnn

from test_torch_helpers import assert_close, load_from_flax, t

B, S, C, H = 4, 12, 10, 8
LENGTHS = np.array([12, 1, 7, 12], np.int32)


def _cells(zoneout, is_training, jax_side):
    if jax_side:
        return tuple(
            jax_modules.ZoneoutLSTMCell(H, zoneout, zoneout, is_training, name=name)
            for name in ("lstm_fwd", "lstm_bwd")
        )
    return tuple(modules.ZoneoutLSTMCell(C, H, zoneout, zoneout) for _ in range(2))


def _flax_rnn(zoneout, is_training):
    cell_fwd, cell_bwd = _cells(zoneout, is_training, jax_side=True)
    return jax_modules.BiRNN(cell_fwd=cell_fwd, cell_bwd=cell_bwd, rng_names=())


@pytest.fixture(scope="module", params=[0.0, 0.1], ids=["zoneout_0", "zoneout_0.1"])
def case(request):
    """Inputs, flax variables (biases moved off zero), the flax scan's eval output and
    the port's ``BiRNN`` holding the same weights."""
    zoneout = request.param
    xs = np.random.default_rng(0).standard_normal((B, S, C)).astype(np.float32)
    rnn = _flax_rnn(zoneout, is_training=False)
    init = (jnp.zeros((B, H)), jnp.zeros((B, H)))
    variables = rnn.init(jax.random.PRNGKey(1), jnp.asarray(xs), jnp.asarray(LENGTHS), init, init)
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: jnp.asarray(a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)),
        variables["params"],
    )
    variables = {"params": params}
    scan = rnn.apply(variables, jnp.asarray(xs), jnp.asarray(LENGTHS), init, init)
    port = load_from_flax(
        modules.BiRNN(*_cells(zoneout, False, jax_side=False), use_pallas=True), variables
    )
    return dict(xs=xs, variables=variables, scan=np.asarray(scan), port=port, zoneout=zoneout)


def _pallas(case, dtype=jnp.float32):
    p = case["variables"]["params"]
    return bilstm_pallas(
        jnp.asarray(case["xs"], dtype), jnp.asarray(LENGTHS), p["cell_fwd"], p["cell_bwd"],
        hidden=H, zoneout_cell=case["zoneout"], zoneout_output=case["zoneout"], interpret=True,
    )


def _reference(case, xs=None):
    port = case["port"]
    return fused_rnn.bilstm_reference(
        t(case["xs"]) if xs is None else xs, t(LENGTHS), port.cell_fwd.kernel_params(),
        port.cell_bwd.kernel_params(), H, case["zoneout"], case["zoneout"],
    )


def test_reference_matches_pallas_interpret_and_flax_scan(case):
    with torch.no_grad():
        got = _reference(case)
    assert got.shape == (B, S, 2 * H) and got.dtype == torch.float32
    assert_close(got, np.asarray(_pallas(case)), atol=2e-5)
    assert_close(got, case["scan"], atol=2e-5)


def test_wrapper_on_cpu_is_the_reference_and_counts_no_launch(case):
    port = case["port"]
    before = fused_rnn.lstm_launch_count
    with torch.no_grad():
        got = fused_rnn.bilstm(
            t(case["xs"]), t(LENGTHS), port.cell_fwd.kernel_params(),
            port.cell_bwd.kernel_params(), H, case["zoneout"], case["zoneout"],
        )
    assert fused_rnn.lstm_launch_count == before
    assert_close(got, case["scan"], atol=2e-5)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_birnn_module_in_eval_mode_matches_flax_scan(case, use_pallas):
    port = case["port"]
    port.use_pallas = use_pallas
    with torch.no_grad():
        got = port(t(case["xs"]), t(LENGTHS))
    assert_close(got, case["scan"], atol=2e-5)


def test_padded_steps_emit_zero_and_keep_the_carry(case):
    with torch.no_grad():
        got = _reference(case).numpy()
    for b, n in enumerate(LENGTHS):
        assert np.all(got[b, n:] == 0.0)
        assert np.all(got[b, :n] != 0.0)
    # the backward direction starts at a lane's last valid step from zero, whatever
    # lies in the padding, and a lane of length 1 sees its one step only
    noisy = case["xs"].copy()
    noisy[1, 1:] = 1e3
    noisy[2, 7:] = -1e3
    with torch.no_grad():
        again = _reference(case, t(noisy)).numpy()
    np.testing.assert_array_equal(again[1:3], got[1:3])
    np.testing.assert_array_equal(again[[0, 3]], got[[0, 3]])


def test_reference_bf16_matches_pallas_interpret(case):
    want = np.asarray(_pallas(case, jnp.bfloat16).astype(jnp.float32))
    with torch.no_grad():
        got = _reference(case, t(case["xs"]).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert_close(got, want, atol=2e-2)


def test_birnn_module_in_train_mode_matches_flax_with_gradients():
    """Train mode, zoneout 0: the cells step by step under autograd on the port's
    side, the flax scan on the other; outputs and every gradient."""
    xs = np.random.default_rng(2).standard_normal((B, S, C)).astype(np.float32)
    cot = np.random.default_rng(3).standard_normal((B, S, 2 * H)).astype(np.float32)
    rnn = _flax_rnn(0.0, is_training=True)
    init = (jnp.zeros((B, H)), jnp.zeros((B, H)))
    variables = rnn.init(jax.random.PRNGKey(4), jnp.asarray(xs), jnp.asarray(LENGTHS), init, init)

    def loss(params, x):
        y = rnn.apply({"params": params}, x, jnp.asarray(LENGTHS), init, init)
        return jnp.sum(y * cot), y

    (_, want), (g_params, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(xs)
    )
    port = load_from_flax(
        modules.BiRNN(*_cells(0.0, True, jax_side=False), use_pallas=True), variables
    ).train()
    x_t = t(xs).requires_grad_(True)
    got = port(x_t, t(LENGTHS))
    (got * t(cot)).sum().backward()
    assert_close(got, np.asarray(want), atol=2e-5)
    grads = {"x": (x_t.grad, g_x)}
    for name, cell in (("cell_fwd", port.cell_fwd), ("cell_bwd", port.cell_bwd)):
        want = g_params[name]["gates"]
        grads[f"{name} kernel"] = (cell.gates.weight.grad.t(), want["kernel"])
        grads[f"{name} bias"] = (cell.gates.bias.grad, want["bias"])
    for label, (g, w) in grads.items():
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * scale, rtol=0, err_msg=label)


def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    port = case["port"]
    pf, pb = port.cell_fwd.kernel_params(), port.cell_bwd.kernel_params()
    with pytest.raises(TypeError):
        fused_rnn.bilstm(t(case["xs"]).double(), t(LENGTHS), pf, pb, H)
    with pytest.raises(ValueError):
        fused_rnn.bilstm(t(case["xs"])[0], t(LENGTHS), pf, pb, H)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fused_rnn.bilstm(torch.zeros(B, S, C, device="meta"), t(LENGTHS), pf, pb, H)
