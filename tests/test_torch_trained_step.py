"""The flagship's trained step on corpus data: the port's update against JAX's.

Both packages load ``artifacts/convergence_r3/trained_params.npz`` at full width (the
JAX run's starting point of the long fine-tune, through ``convert.load_npz`` and JAX's
``_variables_from_npz``) and take one update on a batch of the long corpus (the
convergence run's ``--long`` corpus: symbols 94-152, seed 1234), made from the same
files by each package's own data layer, with every stochastic rate 0 and
``use_gradient_clipping`` on, as in the protocol. The port's ``Trainer.train_step``
(CPU, the plain path) is held against JAX's ``Trainer._train_step_impl`` (the XLA
scan, jitted; in a process of its own, ``torch_trained_step_jax.py``):

* float32: the loss parts and ``grad_norm`` (1e-4), every gradient leaf (1e-4 of the
  leaf's largest entry) and every updated leaf (1e-4; ``adam_eps`` 1e-4, as
  ``test_torch_training.py`` says why);
* bfloat16: against the JAX step's own gap between bfloat16 and float32, by the rule
  ``chip_smoke.py``'s ``phase_training_bf16`` holds a trained bfloat16 step to: each
  loss part within the larger of its gap and 1e-4, ``grad_norm`` within half of its
  gap (``test_torch_training_bf16.py``'s share), the median gradient leaf
  (||delta|| / ||ref||) within its gap. ``test_torch_training_bf16.py``'s shares for a
  narrow network from seeded weights (every leaf within its gap, the median within a
  quarter) do not hold here, and bfloat16 does not determine the step to them: the
  port against JAX puts the median leaf at 0.59 of its gap and the largest at 1.51
  (``attention_1/attention_v``), the port against itself with the embedding table
  moved by one part in 1e5 (a handful of bfloat16 roundings of the embedded symbols
  flipped; printed as the yardstick) at 0.72 and 1.15. JAX's bfloat16 step is jitted
  with ``--xla_allow_excess_precision=false``, which rounds where the step run
  operation by operation does (``torch_trained_step_jax.py``; operation by operation
  it took 169 s at these sizes, jitted so 21 s, the same loss parts);
* first, in the port alone, float32 against float64 (every leaf within 1e-4): on
  random symbol ids from the trained weights float32 did not determine the gradients
  (``ROADMAP.md``); on corpus data it does (largest leaf about 3e-6 apart).

What was cut to fit the time limit, the widths kept: the lanes, 2 (the two shortest of
the corpus's first four utterances, 104 and 115 symbols, 668 and 738 frames); and the
frames, each lane's first ``FRAMES`` (its target length clipped to them, so no lane's
stop frame is in the batch). The protocol's batch of 32 lanes over whole utterances
is ``chip_smoke.py``'s ``phase_trained_step``, kernels against the plain path.
About 60 s on one worker, imports included (the JAX processes, one a dtype, beside the port's side).
"""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.data.synthetic import generate_corpus as jax_generate_corpus
from self_attention_tacotron_tpu.hparams import HParams as JaxHParams

from self_attention_tacotron_torch import convert
from self_attention_tacotron_torch.data.dataset import TacotronDataset
from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.tools import convergence_run as run
from self_attention_tacotron_torch.tools.flagship import CONVERGENCE_CORPUS
from self_attention_tacotron_torch.training.trainer import Trainer

from test_torch_training_bf16 import SHARE_NORM, _relative
from torch_trained_step_jax import cut_batch

HERE = os.path.dirname(os.path.abspath(__file__))
NPZ = os.path.join(os.path.dirname(HERE), "artifacts", "convergence_r3", "trained_params.npz")
LANES, FIRST_UTTERANCES, FRAMES = 2, 4, 48
TOL = 1e-4
# phase_training_bf16's rule for a trained bfloat16 step: loss parts within the larger
# of their gap and this, the median leaf within its gap
BF16_LOSS_FLOOR = 1e-4
BF16_MEDIAN_SHARE = 1.0
# the yardstick's move of the embedding table (1e-7 flips no bfloat16 rounding here)
YARDSTICK_MOVE = 1e-5
# every stochastic rate 0; adam_eps as test_torch_training.py
ZERO = dict(encoder_prenet_drop_rate=0.0, decoder_prenet_drop_rate=0.0,
            self_attention_drop_rate=0.0, decoder_self_attention_drop_rate=0.0,
            zoneout_factor_cell=0.0, zoneout_factor_output=0.0, adam_eps=1e-4)


def overrides(dtype: str) -> str:
    return run.hp_string({**ZERO, "compute_dtype": dtype, "use_gradient_clipping": "true"})


@contextlib.contextmanager
def float64(net):
    """The port's plain path in float64 for the block. The port computes in float32 by
    name (``torch.float32``, ``.float()``, float32 compute dtypes) at many points, so
    for this measurement alone those names point at float64 and every module's
    compute dtype is set to it; the test checks that the outputs and gradients are
    float64."""
    names = torch.float32, torch.Tensor.float, torch.get_default_dtype()
    net.double()
    for m in net.modules():
        m.compute_dtype = torch.float64
    torch.float32 = torch.float64
    torch.Tensor.float = lambda self, *args, **kwargs: self.double()
    torch.set_default_dtype(torch.float64)
    try:
        yield net
    finally:
        torch.float32, torch.Tensor.float = names[:2]
        torch.set_default_dtype(names[2])


def port_step(dtype: str, batch, move: float = 0.0):
    """One ``train_step`` of the port on the CPU: metrics, gradients, updated leaves;
    ``move``: the embedding table moved by that part first."""
    hp = run.flagship_run_hparams({**ZERO, "compute_dtype": dtype, "use_gradient_clipping": True})
    trainer = Trainer(tacotron_model_factory(hp), device="cpu")
    net = convert.load_npz(NPZ, hp, device="cpu")
    with torch.no_grad():
        for p in net.embedding.parameters():
            p.mul_(1.0 + move)
    state = trainer.init_state(net)
    state, metrics = trainer.train_step(state, batch, torch.Generator().manual_seed(0))
    return ({k: float(v) for k, v in metrics.items()},
            convert.torch_to_flax_flat(state.net, gradients=True),
            convert.torch_to_flax_flat(state.net))


def port_float64_grads(batch):
    """The gradients of the same loss in float64 (nothing updated)."""
    hp = run.flagship_run_hparams({**ZERO, "compute_dtype": "float32"})
    model = tacotron_model_factory(hp)
    trainer = Trainer(model, device="cpu")
    net = convert.load_npz(NPZ, hp, device="cpu")
    tensors = trainer._batch(batch)
    net.train()
    with float64(net):
        out = trainer._forward(net, tensors, torch.Generator().manual_seed(0))
        loss = model.loss(out, tensors, params=net.parameters())["loss"]
        loss.backward()
    loss = loss.detach()
    dtypes = {out.frames["mel"].dtype, out.stop_logits.dtype, loss.dtype}
    dtypes |= {p.grad.dtype for p in net.parameters() if p.grad is not None}
    return float(loss), convert.torch_to_flax_flat(net, gradients=True), dtypes


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    root = tmp_path_factory.mktemp("trained_step")
    corpus = str(root / "corpus")
    jhp = JaxHParams()
    jhp.parse(overrides("float32"))
    ids = jax_generate_corpus(corpus, jhp, num_utterances=FIRST_UTTERANCES,
                              min_symbols=CONVERGENCE_CORPUS["min_symbols"],
                              max_symbols=CONVERGENCE_CORPUS["max_symbols"],
                              seed=CONVERGENCE_CORPUS["seed"])
    hp = run.flagship_run_hparams({**ZERO, "compute_dtype": "float32"})
    data = TacotronDataset(corpus, corpus, hp, utterance_ids=ids)
    pairs = sorted((data.load_utterance(i) for i in ids), key=lambda p: p[1].target_length)
    lanes = [p[0].id for p in pairs[:LANES]]
    batch = cut_batch(data.make_batch(pairs[:LANES]), FRAMES)
    # one process a dtype, one thread each: the JAX side is mostly compilation, and runs
    # beside the port's side and beside other test workers
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false --xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               PYTHONPATH=os.pathsep.join([os.path.dirname(HERE), HERE,
                                           os.environ.get("PYTHONPATH", "")]))
    outs = {dtype: str(root / f"jax_{dtype}.npz") for dtype in ("float32", "bfloat16")}
    jax_sides = {dtype: subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_trained_step_jax.py"), corpus, ",".join(lanes),
         str(FRAMES), NPZ, overrides(dtype), out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for dtype, out in outs.items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        port = {dtype: port_step(dtype, batch) for dtype in ("float32", "bfloat16")}
        port["yardstick"] = port_step("bfloat16", batch, YARDSTICK_MOVE)
        f64 = port_float64_grads(batch)
    finally:
        torch.set_num_threads(threads)
        logs = {dtype: side.communicate(timeout=600)[0] for dtype, side in jax_sides.items()}
    theirs = {}
    for dtype, side in jax_sides.items():
        assert side.returncode == 0, logs[dtype][-4000:]
        with np.load(outs[dtype]) as archive:
            theirs[dtype] = {k: archive[k] for k in archive.files}

    def part(dtype, prefix):
        return {k[len(prefix):]: v for k, v in theirs[dtype].items() if k.startswith(prefix)}

    jax = {dtype: ({k: float(v) for k, v in part(dtype, "metrics/").items()},
                   part(dtype, "grads/")) for dtype in theirs}
    return dict(batch=batch, jax_batch=part("float32", "batch/"), port=port, f64=f64, jax=jax,
                jax_updated=part("float32", "updated/"), lanes=lanes)


def test_both_data_layers_make_the_same_batch_of_the_long_corpus(steps):
    batch, theirs = steps["batch"], steps["jax_batch"]
    assert set(batch) == set(theirs)
    for key, value in batch.items():
        np.testing.assert_array_equal(value, theirs[key], err_msg=key)
    assert batch["mel"].shape == (LANES, FRAMES, 80) and batch["source_lengths"].min() >= 94
    assert (batch["target_lengths"] == FRAMES).all()


def test_float32_determines_the_trained_step_on_corpus_data(steps):
    _, grads, _ = steps["port"]["float32"]
    loss64, grads64, dtypes = steps["f64"]
    assert dtypes == {torch.float64}
    assert set(grads) == set(grads64)
    errs = {k: float(np.abs(grads[k] - w).max()) / max(float(np.abs(w).max()), 1e-12)
            for k, w in grads64.items()}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    print(f"\nfloat32 against float64: the largest leaf {worst}, "
          f"the median {np.median(list(errs.values())):.3e}")
    assert np.isfinite(loss64)
    assert max(errs.values()) <= TOL, worst


def test_float32_loss_parts_and_grad_norm(steps):
    got, want = steps["port"]["float32"][0], steps["jax"]["float32"][0]
    assert set(got) == set(want) and {"loss", "mel_loss", "done_loss", "grad_norm"} <= set(got)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=1e-4, err_msg=key)
    assert want["grad_norm"] < 1.0          # no clipping: the leaves below are raw


def test_float32_every_gradient_leaf(steps):
    got, want = steps["port"]["float32"][1], steps["jax"]["float32"][1]
    assert set(got) == set(want)
    nonzero = 0
    for key, ref in want.items():
        largest = float(np.abs(ref).max())
        nonzero += largest > 0.0
        np.testing.assert_allclose(got[key], ref, atol=TOL * max(largest, 1e-3), rtol=0,
                                   err_msg=key)
    assert nonzero >= len(want) - 2


def test_float32_every_updated_leaf(steps):
    got, want = steps["port"]["float32"][2], steps["jax_updated"]
    assert set(got) == set(want)
    for key, ref in want.items():
        np.testing.assert_allclose(got[key], ref, atol=TOL, rtol=0, err_msg=key)


def test_bf16_loss_parts_and_grad_norm_sit_within_the_gap(steps):
    got, want, wide = (steps["port"]["bfloat16"][0], steps["jax"]["bfloat16"][0],
                       steps["jax"]["float32"][0])
    moved = steps["port"]["yardstick"][0]
    assert set(got) == set(want)
    print("\nbf16 trained step: metric, port against JAX bf16, JAX bf16 against f32, "
          "port against itself moved")
    for key in want:
        err, gap = abs(got[key] - want[key]), abs(want[key] - wide[key])
        yard = abs(moved[key] - got[key])
        if key == "grad_norm":
            err, gap, yard = err / want[key], gap / wide[key], yard / got[key]
        print(f"  {key:20s} {err:.3e}  {gap:.3e}  {yard:.3e}")
        bound = SHARE_NORM * gap if key == "grad_norm" else max(gap, BF16_LOSS_FLOOR)
        assert err <= bound, f"{key}: {err:.3e} against a gap of {gap:.3e}"


def test_bf16_the_median_gradient_leaf_sits_within_its_gap(steps):
    got, want, wide = (steps["port"]["bfloat16"][1], steps["jax"]["bfloat16"][1],
                       steps["jax"]["float32"][1])
    moved = steps["port"]["yardstick"][1]
    assert set(got) == set(want)
    rows = []
    for key, ref in want.items():
        if float(np.abs(ref).max()) == 0.0:
            assert float(np.abs(got[key]).max()) == 0.0, key
            continue
        rows.append((key, _relative(got[key], ref), _relative(ref, wide[key]),
                     _relative(moved[key], got[key])))
    assert len(rows) >= len(want) - 2
    print("\nbf16 trained step: gradient leaf, port against JAX bf16, JAX bf16 against f32, "
          "port against itself moved")
    for key, err, gap, yard in sorted(rows, key=lambda r: -r[1] / r[2])[:12]:
        print(f"  {key:70s} {err:.3e}  {gap:.3e}  {yard:.3e}")
    median = float(np.median([err / gap for _, err, gap, _ in rows]))
    yardstick = float(np.median([yard / gap for _, _, gap, yard in rows]))
    print(f"  median share of the gap: {median:.3f} (the yardstick's: {yardstick:.3f}); the "
          f"largest {max(err / gap for _, err, gap, _ in rows):.3f} "
          f"({max(yard / gap for _, _, gap, yard in rows):.3f})")
    assert median <= BF16_MEDIAN_SHARE
