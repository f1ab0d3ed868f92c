"""The port's BiGRU (plain version and ``BiRNN``) against the JAX package.

The JAX side is ``bigru_pallas(..., interpret=True)`` and the flax ``BiRNN``
scan. On the CPU the port's wrapper takes its plain version. Tolerances:
float32 atol 2e-5 (sums in another order over 12 recurrent steps); bfloat16
compared in float32 with atol 2e-2 (the two frameworks round at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.models import modules as jax_modules
from self_attention_tacotron_tpu.ops.fused_rnn import bigru_pallas

from self_attention_tacotron_torch.models import modules
from self_attention_tacotron_torch.ops import fused_rnn

from test_torch_helpers import assert_close, load_from_flax, t

B, S, C, H = 4, 12, 10, 8
LENGTHS = np.array([12, 7, 1, 12], np.int32)


@pytest.fixture(scope="module")
def case():
    xs = np.random.default_rng(0).standard_normal((B, S, C)).astype(np.float32)
    rnn = jax_modules.BiRNN(
        cell_fwd=jax_modules.GRUCell(H, name="gru_fwd"),
        cell_bwd=jax_modules.GRUCell(H, name="gru_bwd"),
        rng_names=(),
    )
    init = jnp.zeros((B, H))
    variables = rnn.init(jax.random.PRNGKey(1), jnp.asarray(xs), jnp.asarray(LENGTHS), init, init)
    # give the biases values: flax starts them at zero
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: jnp.asarray(a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)),
        variables["params"],
    )
    variables = {"params": params}
    scan = rnn.apply(variables, jnp.asarray(xs), jnp.asarray(LENGTHS), init, init)
    port = load_from_flax(
        modules.BiRNN(modules.GRUCell(C, H), modules.GRUCell(C, H), use_pallas=True), variables
    )
    return xs, variables, np.asarray(scan), port


def _pallas(xs, variables, dtype=jnp.float32):
    return bigru_pallas(
        jnp.asarray(xs, dtype),
        jnp.asarray(LENGTHS),
        variables["params"]["cell_fwd"],
        variables["params"]["cell_bwd"],
        hidden=H,
        interpret=True,
    )


def test_reference_matches_pallas_interpret_and_flax_scan(case):
    xs, variables, scan, port = case
    got = fused_rnn.bigru_reference(
        t(xs), t(LENGTHS), port.cell_fwd.kernel_params(), port.cell_bwd.kernel_params(), H
    )
    assert got.shape == (B, S, 2 * H)
    assert_close(got, np.asarray(_pallas(xs, variables)), atol=2e-5)
    assert_close(got, scan, atol=2e-5)


def test_wrapper_on_cpu_is_the_reference_and_counts_no_launch(case):
    xs, _, scan, port = case
    before = fused_rnn.launch_count
    got = fused_rnn.bigru(
        t(xs), t(LENGTHS), port.cell_fwd.kernel_params(), port.cell_bwd.kernel_params(), H
    )
    assert fused_rnn.launch_count == before
    assert_close(got, scan, atol=2e-5)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_birnn_module_matches_flax_scan(case, use_pallas):
    xs, _, scan, port = case
    port.use_pallas = use_pallas
    with torch.no_grad():
        got = port(t(xs), t(LENGTHS))
    assert_close(got, scan, atol=2e-5)


def test_padded_steps_emit_zero_and_keep_the_carry(case):
    xs, _, _, port = case
    with torch.no_grad():
        got = port(t(xs), t(LENGTHS)).numpy()
    for b, n in enumerate(LENGTHS):
        assert np.all(got[b, n:] == 0.0)
        assert np.any(got[b, :n] != 0.0)
    # a lane's valid steps do not depend on what lies in its padding
    noisy = xs.copy()
    noisy[1, 7:] = 1e3
    with torch.no_grad():
        again = port(t(noisy), t(LENGTHS)).numpy()
    np.testing.assert_array_equal(again[1], got[1])


def test_reference_bf16_matches_pallas_interpret(case):
    xs, variables, _, port = case
    want = np.asarray(_pallas(xs, variables, jnp.bfloat16).astype(jnp.float32))
    got = fused_rnn.bigru_reference(
        t(xs).to(torch.bfloat16), t(LENGTHS),
        port.cell_fwd.kernel_params(), port.cell_bwd.kernel_params(), H,
    )
    assert got.dtype == torch.bfloat16
    assert_close(got, want, atol=2e-2)


def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    xs, _, _, port = case
    pf, pb = port.cell_fwd.kernel_params(), port.cell_bwd.kernel_params()
    with pytest.raises(TypeError):
        fused_rnn.bigru(t(xs).double(), t(LENGTHS), pf, pb, H)
    with pytest.raises(ValueError):
        fused_rnn.bigru(t(xs)[0], t(LENGTHS), pf, pb, H)
