"""The WORLD-feature model classes' ``Trainer`` steps against the JAX package's.

``MgcLf0TacotronModel`` (``ZoneoutEncoderV1``, ``MgcLf0ExtendedDecoder``, forward
attention) and ``DualSourceSelfAttentionMgcLf0TacotronModel``, narrow,
``num_mgcs=7`` and ``num_lf0s=13``, one ``train_step`` from the same weights and
batch (mgc frames and lf0 class ids, ``tools/flagship.py::training_batch``), every
stochastic rate 0, and one ``eval_step``. float32: the loss parts ``mgc_loss``,
``lf0_loss``, ``done_loss`` and ``grad_norm`` to 1e-4, every gradient leaf to
1e-4 of its largest entry, every updated parameter and the eval step's losses and
frames to 1e-4, as ``test_torch_training.py`` holds the mel models. bfloat16:
against JAX run operation by operation, within shares of the JAX step's own
bfloat16-against-float32 gap: those that ``test_torch_training_bf16.py`` states
for the flagship's structure, wider ones for the one-source model, whose reason
``SHARES`` gives (``-s`` prints them).
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
from self_attention_tacotron_torch.tools.flagship import training_batch
from self_attention_tacotron_torch.training.trainer import Trainer, targets_from_batch

from test_torch_helpers import flat_variables
from test_torch_mgclf0_model import HEADS, LF0S, MGCS, MODELS
from test_torch_training import ATOL, _NARROW as _TRAIN_NARROW, _load_flat
from test_torch_training_bf16 import SHARE_LEAF, SHARE_LOSS, SHARE_MEDIAN, SHARE_NORM, _relative

B, S, FRAMES = 3, 9, 10


def _batch():
    batch = training_batch(np.random.default_rng(11), B, FRAMES, S, outputs_per_step=2,
                           shortest=2, num_mgcs=MGCS, num_lf0s=LF0S)
    return {k: (v.astype(np.int32) if v.dtype == np.int64 else v) for k, v in batch.items()}


def _jax_step(kw, batch, tmp, dtype):
    """JAX's first update from the moved flax init: (start weights, metrics,
    gradients, updated weights, eval losses, eval frames), all numpy; bfloat16 runs
    operation by operation, as the port's bfloat16 modules round."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(9)
    jax_model = jax_factory(JaxHParams(**dict(kw, compute_dtype=dtype)))
    jt = jax_trainer.Trainer(jax_model, str(tmp))
    targets = jax_trainer.targets_from_batch(jax_model, jbatch)
    variables = jax.jit(lambda: jt.net.init(
        {"params": key, "dropout": jax.random.fold_in(key, 1), "zoneout": jax.random.fold_in(key, 2)},
        jbatch["source"], jbatch["source_lengths"], targets, jbatch["target_lengths"],
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
    start = flat_variables({"params": state.params, "batch_stats": state.batch_stats})

    def step_and_grads(state):
        def loss_fn(p):
            out, _ = jt._forward(jt.net, p, state.batch_stats, jbatch, key, mutable=True)
            return jax_model.loss(out, jbatch, params=p)["loss"]

        return jt._train_step_impl(state, jbatch, key), jax.grad(loss_fn)(state.params)

    if dtype == "bfloat16":
        with jax.disable_jit():
            (new_state, metrics), grads = step_and_grads(state)
        evaluated = None
    else:
        (new_state, metrics), grads = jax.jit(step_and_grads)(state)
        losses, out = jt._eval_step(state, jbatch, key)
        evaluated = ({k: float(v) for k, v in losses.items()},
                     {h: np.asarray(out.frames[h]) for h in HEADS}, np.asarray(out.stop_logits))
    return dict(
        start=start, metrics={k: float(v) for k, v in metrics.items()},
        grads=flat_variables({"params": grads}),
        params=flat_variables({"params": new_state.params, "batch_stats": new_state.batch_stats}),
        targets=np.asarray(targets), evaluated=evaluated,
    )


def _port_step(kw, batch, start, dtype):
    hp = HParams(**dict(kw, compute_dtype=dtype))
    model = tacotron_model_factory(hp)
    trainer = Trainer(model, device="cpu")
    state = trainer.init_state(_load_flat(model, start, hp))
    losses, out = trainer.eval_step(state, batch)
    evaluated = ({k: float(v) for k, v in losses.items()},
                 {h: out.frames[h].float().numpy() for h in HEADS}, out.stop_logits.float().numpy())
    state, metrics = trainer.train_step(state, batch, torch.Generator().manual_seed(0))
    targets = targets_from_batch(model, {k: torch.as_tensor(v) for k, v in batch.items()})
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads=convert.torch_to_flax_flat(state.net, gradients=True),
        params=convert.torch_to_flax_flat(state.net), targets=targets, evaluated=evaluated,
    )


@pytest.fixture(scope="module", params=sorted(MODELS))
def runs(request, tmp_path_factory):
    """One update of the model class on both sides, float32 and bfloat16."""
    kw = dict(_TRAIN_NARROW, num_mgcs=MGCS, num_lf0s=LF0S, **MODELS[request.param])
    batch = _batch()
    out = {"model": request.param}
    for dtype in ("float32", "bfloat16"):
        out[f"jax_{dtype}"] = _jax_step(kw, batch, tmp_path_factory.mktemp(dtype), dtype)
        assert all(np.array_equal(out[f"jax_{dtype}"]["start"][k], out["jax_float32"]["start"][k])
                   for k in out["jax_float32"]["start"])       # the same weights
        out[dtype] = _port_step(kw, batch, out["jax_float32"]["start"], dtype)
    return out


def test_the_batch_and_the_targets_are_the_world_heads(runs):
    batch = _batch()
    assert set(batch) >= {"mgc", "lf0", "done", "target_lengths"} and "mel" not in batch
    assert batch["mgc"].shape == (B, FRAMES, MGCS) and batch["lf0"].shape == (B, FRAMES)
    assert 0 <= batch["lf0"].min() and batch["lf0"].max() < LF0S
    beyond = np.arange(FRAMES)[None, :] >= batch["target_lengths"][:, None]
    assert not batch["lf0"][beyond].any() and not batch["mgc"][beyond].any()
    for dtype in ("float32", "bfloat16"):
        got, want = runs[dtype]["targets"], runs[f"jax_{dtype}"]["targets"]
        assert got.dtype == torch.float32 and want.dtype == np.float32   # in both dtypes
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.shape == (B, FRAMES, MGCS + LF0S)


def test_loss_parts_grad_norm_and_every_gradient_leaf(runs):
    got, want = runs["float32"], runs["jax_float32"]
    assert set(got["metrics"]) == set(want["metrics"])
    assert {"loss", "mgc_loss", "lf0_loss", "done_loss", "grad_norm"} <= set(got["metrics"])
    for key, value in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][key], value, atol=ATOL, rtol=1e-4, err_msg=key)
    assert set(got["grads"]) == set(want["grads"])
    nonzero = 0
    for key, ref in want["grads"].items():
        largest = float(np.abs(ref).max())
        nonzero += largest > 0.0
        np.testing.assert_allclose(got["grads"][key], ref, atol=ATOL * max(largest, 1e-3),
                                   rtol=0, err_msg=key)
    assert nonzero >= len(want["grads"]) - 2
    for key, ref in want["params"].items():
        np.testing.assert_allclose(got["params"][key], ref, atol=ATOL, rtol=0, err_msg=key)


def test_the_eval_step_matches_jax(runs):
    (got_losses, got_frames, got_stop) = runs["float32"]["evaluated"]
    (want_losses, want_frames, want_stop) = runs["jax_float32"]["evaluated"]
    assert set(got_losses) == set(want_losses) >= {"mgc_loss", "lf0_loss", "done_loss"}
    for key, value in want_losses.items():
        np.testing.assert_allclose(got_losses[key], value, atol=ATOL, rtol=1e-4, err_msg=key)
    for head in HEADS:
        assert got_frames[head].shape == (B, FRAMES, MGCS if head == "mgc" else LF0S)
        np.testing.assert_allclose(got_frames[head], want_frames[head], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_stop, want_stop, atol=ATOL, rtol=0)


# Shares of the JAX step's bfloat16-against-float32 gap (loss parts, grad_norm, every
# leaf, the median leaf) within which the port's bfloat16 step must sit. The
# flagship's structure: those of test_torch_training_bf16.py, where the forward's
# rounding (the same on both sides) makes most of the gap. One source: the
# forward's gap is about 80 times smaller (loss 5e-5 against the flagship's 4e-3),
# and the gap is made by the backward's rounding, which JAX's autodiff and XLA's
# row-by-row bfloat16 sums take in another order than the port (ROADMAP.md §3): two
# independent bfloat16 errors of the gap's size, whose distance is about sqrt(2)
# of it (the mel baseline's one-source step reads the same, medians 0.44-0.68), so
# every leaf within twice the gap and the median leaf within it.
SHARES = {
    "flagship_mgclf0": dict(loss=SHARE_LOSS, norm=SHARE_NORM, leaf=SHARE_LEAF, median=SHARE_MEDIAN),
    "mgclf0": dict(loss=SHARE_LOSS, norm=2.0, leaf=2.0, median=1.0),
}


def test_bf16_step_sits_within_the_gap(runs):
    got, want, wide = runs["bfloat16"], runs["jax_bfloat16"], runs["jax_float32"]
    shares = SHARES[runs["model"]]
    print(f"\n{runs['model']} bf16 train_step: metric or leaf, port against JAX bf16, "
          "JAX bf16 against f32 (the gap), port against JAX f32")
    metrics = []
    for key, value in want["metrics"].items():
        err, gap = abs(got["metrics"][key] - value), abs(value - wide["metrics"][key])
        if key == "grad_norm":
            err, gap = err / value, gap / wide["metrics"][key]
        print(f"  {key:20s} {err:.3e}  {gap:.3e}")
        metrics.append((key, err, gap))
    rows = []
    for key, ref in want["grads"].items():
        if float(np.abs(ref).max()) == 0.0:
            assert float(np.abs(got["grads"][key]).max()) == 0.0, key
            continue
        rows.append((key, _relative(got["grads"][key], ref), _relative(ref, wide["grads"][key]),
                     _relative(got["grads"][key], wide["grads"][key])))
    for key, err, gap, wide_err in sorted(rows, key=lambda r: -r[1] / r[2]):
        print(f"  {key:70s} {err:.3e}  {gap:.3e}  {wide_err:.3e}")
    median = float(np.median([r[1] / r[2] for r in rows]))
    print(f"  median share of the gap: {median:.3f}")
    for key, err, gap in metrics:
        share = shares["norm"] if key == "grad_norm" else shares["loss"]
        assert err <= share * gap, f"{key}: {err:.3e} against a gap of {gap:.3e}"
    assert len(rows) >= len(want["grads"]) - 2
    for key, err, gap, _ in rows:
        assert err <= shares["leaf"] * gap, f"{key}: {err:.3e} against a gap of {gap:.3e}"
    assert median <= shares["median"]
