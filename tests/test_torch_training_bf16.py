"""The port's bfloat16 ``Trainer.train_step`` against the JAX package's, leaf by leaf.

The narrow flagship of ``test_torch_training.py`` (dual-source self-attention
Tacotron, r = 2) at ``compute_dtype="bfloat16"`` starts from the same weights on
both sides and takes one update on the same seeded batch: ``Trainer._train_step_impl``
of the JAX package (its XLA path, run operation by operation under
``jax.disable_jit``, as the port's bfloat16 modules round: jitted XLA keeps float32
between fused bfloat16 operations) and ``Trainer.train_step`` of the port on the
CPU (its plain path). Every stochastic rate is 0.

The yardstick is the JAX step in bfloat16 against the JAX step in float32 from
the same weights (``gap``), printed beside the port's error (``-s``). Tolerances:
the loss parts within a quarter of their gap (they agree to about 1e-7),
``grad_norm`` within half of its gap, every gradient leaf (||delta|| / ||ref||)
within its gap and the median leaf within a quarter of it. A leaf may come
nearer its gap than the kernels' plain versions alone do (a quarter,
``test_torch_fused_teacher_bf16.py``): XLA on the CPU sums a bfloat16 bias
gradient over the rows one row at a time in bfloat16, where the port sums in
float32 and rounds once (the output projection's bias reads 0.83 of its gap),
and the modules' bfloat16 backward casts float32 cotangents after sums in
another order than JAX's autodiff, which reaches the leaves upstream of them
(the query projection 0.69). A rounding point that differed along the whole
path would move the median leaf to about the gap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.training import trainer as jax_trainer

from self_attention_tacotron_torch import convert
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.training.trainer import Trainer

from test_torch_helpers import flat_variables
from test_torch_training import _NARROW, _batch, _load_flat

SHARE_LOSS = 0.25
SHARE_NORM = 0.5
SHARE_LEAF = 1.0
SHARE_MEDIAN = 0.25


def _relative(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The first update's metrics and gradients: JAX in bfloat16 and float32, the port in bfloat16."""
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(9)
    start, out = None, {}
    for dtype in ("bfloat16", "float32"):
        kw = dict(_NARROW, compute_dtype=dtype)
        jax_model = jax_factory(JaxHParams(**kw))
        jt = jax_trainer.Trainer(jax_model, str(tmp_path_factory.mktemp(f"ckpt_{dtype}")))
        variables = jax.jit(lambda: jt.net.init(
            {"params": key, "dropout": jax.random.fold_in(key, 1),
             "zoneout": jax.random.fold_in(key, 2)},
            jbatch["source"], jbatch["source_lengths"], jbatch["mel"], jbatch["target_lengths"],
        ))()
        rng = np.random.default_rng(4)
        params = jax.tree.map(
            lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)),
            variables["params"],
        )
        state = jax_trainer.TrainState(
            step=jnp.zeros((), jnp.int32), params=params, opt_state=jt.tx.init(params),
            batch_stats=variables.get("batch_stats", {}),
        )
        flat = flat_variables({"params": state.params, "batch_stats": state.batch_stats})
        if start is None:
            start = flat
        assert all(np.array_equal(flat[k], start[k]) for k in start)   # the same weights

        def step_and_grads(state):
            def loss_fn(p):
                o, _ = jt._forward(jt.net, p, state.batch_stats, jbatch, key, mutable=True)
                return jax_model.loss(o, jbatch, params=p)["loss"]

            return jt._train_step_impl(state, jbatch, key), jax.grad(loss_fn)(state.params)

        if dtype == "bfloat16":
            # operation by operation, as the port's bfloat16 modules round (jitted XLA
            # keeps float32 between fused bfloat16 operations)
            with jax.disable_jit():
                (_, metrics), grads = step_and_grads(state)
        else:
            (_, metrics), grads = jax.jit(step_and_grads)(state)
        out[dtype] = ({k: float(v) for k, v in metrics.items()}, flat_variables({"params": grads}))

    hp = HParams(**dict(_NARROW, compute_dtype="bfloat16"))
    model = tacotron_model_factory(hp)
    trainer = Trainer(model, device="cpu")
    tstate = trainer.init_state(_load_flat(model, start, hp))
    tstate, metrics = trainer.train_step(tstate, batch, torch.Generator().manual_seed(0))
    out["port"] = ({k: float(v) for k, v in metrics.items()},
                   convert.torch_to_flax_flat(tstate.net, gradients=True))
    return out


def test_bf16_loss_parts_and_grad_norm_sit_within_the_gap(steps):
    got, want, wide = steps["port"][0], steps["bfloat16"][0], steps["float32"][0]
    assert set(got) == set(want) and {"loss", "mel_loss", "done_loss", "grad_norm"} <= set(got)
    print("\nbf16 train_step: metric, port against JAX bf16, JAX bf16 against f32")
    for key in want:
        err, gap = abs(got[key] - want[key]), abs(want[key] - wide[key])
        if key == "grad_norm":
            err, gap = err / want[key], gap / wide[key]
        print(f"  {key:20s} {err:.3e}  {gap:.3e}")
        assert np.isfinite(got[key])
        share = SHARE_NORM if key == "grad_norm" else SHARE_LOSS
        assert err <= share * gap, f"{key}: {err:.3e} against a gap of {gap:.3e}"


def test_bf16_every_gradient_leaf_sits_within_its_gap_and_the_median_leaf_a_quarter(steps):
    got, want, wide = steps["port"][1], steps["bfloat16"][1], steps["float32"][1]
    assert set(got) == set(want)
    rows = []
    for key, ref in want.items():
        if float(np.abs(ref).max()) == 0.0:
            assert float(np.abs(got[key]).max()) == 0.0, key     # an unused leaf
            continue
        rows.append((key, _relative(got[key], ref), _relative(ref, wide[key])))
    assert len(rows) >= len(want) - 2
    print("\nbf16 train_step: gradient leaf, port against JAX bf16, JAX bf16 against f32")
    for key, err, gap in sorted(rows, key=lambda r: -r[1] / r[2]):
        print(f"  {key:70s} {err:.3e}  {gap:.3e}")
    median = float(np.median([err / gap for _, err, gap in rows]))
    print(f"  median share of the gap: {median:.3f}")
    for key, err, gap in rows:
        assert err <= SHARE_LEAF * gap, f"{key}: {err:.3e} against a gap of {gap:.3e}"
    assert median <= SHARE_MEDIAN


def test_bf16_sigmoid_is_jaxs_logistic_forward_and_backward():
    """``modules.sigmoid`` in bfloat16 rounds as XLA does operation by operation, and
    its gradient is JAX's rule for ``logistic``, ``g * (s * (1 - s))``: bit for bit
    against ``jax.vjp(jax.nn.sigmoid)`` run operation by operation, and finite where
    ``exp(-x)`` overflows (autograd through the composed forward gives 0 * inf)."""
    from self_attention_tacotron_torch.models.modules import sigmoid

    rng = np.random.default_rng(0)
    # |x| up to about 35, and three beyond exp's range; between about -88 and -87
    # the result is subnormal, which XLA on the CPU flushes to zero and torch keeps
    xs = (rng.standard_normal(4096) * 8).astype(np.float32)
    xs[:3] = [-100.0, -95.0, 100.0]
    g = rng.standard_normal(4096).astype(np.float32)
    x = torch.tensor(xs).bfloat16().requires_grad_(True)
    y = sigmoid(x)
    y.backward(torch.tensor(g).bfloat16())
    with jax.disable_jit():
        want, vjp = jax.vjp(jax.nn.sigmoid, jnp.asarray(xs, jnp.bfloat16))
        (want_grad,) = vjp(jnp.asarray(g, jnp.bfloat16))
    np.testing.assert_array_equal(y.detach().float().numpy(), np.asarray(want, np.float32))
    np.testing.assert_array_equal(x.grad.float().numpy(), np.asarray(want_grad, np.float32))
    assert bool(torch.isfinite(x.grad).all()) and float(x.grad[0]) == 0.0
