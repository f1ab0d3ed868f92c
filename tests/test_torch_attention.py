"""The port's attention mechanisms against their flax counterparts, on the CPU.

Three consecutive steps from the initial state, so that the forward
recursion, the cumulative sums and the transition agent all feed back.
Tolerance: float32 atol 1e-5 (sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models import attention as ja

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models import attention

from test_torch_helpers import assert_close, load_from_flax, t

B, S, E, Q, U = 3, 9, 10, 12, 8
MASK = np.arange(S)[None, :] < np.array([9, 5, 2])[:, None]


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _compare_states(got, want):
    assert_close(got.alignments, np.asarray(want.alignments), atol=1e-5)
    assert_close(got.cumulative, np.asarray(want.cumulative), atol=1e-5)
    assert_close(got.transition, np.asarray(want.transition), atol=1e-5)
    assert got.step == int(want.step)


@pytest.mark.parametrize("initial_alignment", ["uniform", "one_hot"])
def test_initial_attention_state(initial_alignment):
    want = ja.initial_attention_state(B, S, initial_alignment=initial_alignment)
    got = attention.initial_attention_state(B, S, initial_alignment=initial_alignment)
    _compare_states(got, want)


@pytest.mark.parametrize(
    "name,agent",
    [("additive", False), ("forward", False), ("forward", True),
     ("forward_transition_agent", False)],
)
@pytest.mark.parametrize("projected", [False, True])
def test_mechanism_three_steps(name, agent, projected):
    memory = _randn(0, B, S, E)
    queries = [_randn(10 + i, B, Q) for i in range(3)]
    pqs = [_randn(20 + i, B, U) for i in range(3)]
    jhp = JaxHParams(use_forward_attention_transition_agent=agent)
    hp = HParams(use_forward_attention_transition_agent=agent)
    jmech = ja.attention_factory(name, U, jhp)
    port = attention.attention_factory(
        name, U, hp, query_units=Q, memory_units=E, own_query_layer=not projected
    )

    def apply_j(variables, q, keys, state, pq):
        return jmech.apply(
            variables, q, keys, jnp.asarray(memory), jnp.asarray(MASK), state,
            projected_query=pq,
        )

    state_j = ja.initial_attention_state(B, S, initial_alignment=jmech.initial_alignment)
    state = attention.initial_attention_state(B, S, initial_alignment=port.initial_alignment)
    keys0 = jnp.zeros((B, S, U))
    variables = jmech.init(
        jax.random.PRNGKey(0), jnp.asarray(queries[0]), keys0, jnp.asarray(memory),
        jnp.asarray(MASK), state_j,
        projected_query=jnp.asarray(pqs[0]) if projected else None,
    )
    # memory_layer is only touched by compute_keys: initialise it too
    key_vars = jmech.init(
        jax.random.PRNGKey(1), jnp.asarray(memory), method=type(jmech).compute_keys
    )
    params = dict(variables["params"])
    params["memory_layer"] = key_vars["params"]["memory_layer"]
    variables = {"params": params}
    load_from_flax(port, variables)

    keys_j = jmech.apply(variables, jnp.asarray(memory), method=type(jmech).compute_keys)
    keys = port.compute_keys(t(memory))
    assert_close(keys, np.asarray(keys_j), atol=1e-5)
    with torch.no_grad():
        for q, pq in zip(queries, pqs):
            want_ctx, want_probs, state_j = apply_j(
                variables, jnp.asarray(q), keys_j, state_j,
                jnp.asarray(pq) if projected else None,
            )
            ctx, probs, state = port(
                t(q), keys, t(memory), t(MASK), state,
                projected_query=t(pq) if projected else None,
            )
            assert_close(ctx, np.asarray(want_ctx), atol=1e-5)
            assert_close(probs, np.asarray(want_probs), atol=1e-5)
            _compare_states(state, state_j)
    assert float(probs[2, 2:].abs().max()) < 1e-6       # no mass on padded keys


def test_forward_attention_starts_at_the_first_key_and_moves_one_step_at_most():
    memory = _randn(0, 1, S, E)
    port = attention.ForwardAttention(Q, E, U)
    state = attention.initial_attention_state(1, S, initial_alignment="one_hot")
    with torch.no_grad():
        keys = port.compute_keys(t(memory))
        _, probs, state = port(t(_randn(1, 1, Q)), keys, t(memory), None, state)
    # after one step only positions 0 and 1 can hold more than the epsilon floor
    assert float(probs[0, :2].sum()) > 0.999


def test_factory_names():
    hp = HParams()
    mech = attention.attention_factory("location_sensitive", 8, hp, query_units=4, memory_units=4)
    assert isinstance(mech, attention.LocationSensitiveAttention)
    assert mech.attention_kernel == hp.attention_kernel and mech.cumulative_weights
    assert tuple(mech.location_conv.weight.shape) == (hp.attention_filters, 1, hp.attention_kernel)
    # forced-alignment mode: the mechanism it stands for in training, the window in eval
    mech = attention.attention_factory("teacher_forcing_forward", 8, hp, query_units=4,
                                       memory_units=4)
    assert isinstance(mech, attention.TeacherForcingAttention)
    assert isinstance(mech, attention.ForwardAttention)
    mech = attention.attention_factory("teacher_forcing_additive", 8, hp, query_units=4,
                                       memory_units=4)
    assert isinstance(mech, attention.TeacherForcingAttention)
    assert isinstance(mech, attention.AdditiveAttention)
    with pytest.raises(ValueError):
        attention.attention_factory("nope", 8, hp, query_units=4, memory_units=4)
