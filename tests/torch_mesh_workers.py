"""Rank functions of the mesh tests, run by ``parallel.spawn`` in spawned processes.

Helpers only, no tests. It imports the port and no JAX: a spawned rank imports
this module by name, and the test files import JAX with ``conftest.py``'s eight
virtual devices.
"""

from __future__ import annotations

import os
import time
import types
import warnings

import numpy as np
import torch

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.parallel import mesh as mesh_lib
from self_attention_tacotron_torch.synthesis import make_sharded_predict_fn
from self_attention_tacotron_torch.tools.flagship import training_batch
from self_attention_tacotron_torch.training import trainer as trainer_lib
from self_attention_tacotron_torch.training.metrics import MetricsWriter
from self_attention_tacotron_torch.training.trainer import Trainer

# A narrow flagship (dual-source self-attention Tacotron, r = 2) with every
# stochastic rate on: prenet dropout, self-attention dropout, zoneout.
NARROW = dict(
    tacotron_model="DualSourceSelfAttentionTacotronModel",
    encoder="SelfAttentionCBHGEncoder", decoder="DualSourceSelfAttentionDecoder",
    attention="forward", attention2="additive",
    num_symbols=70, embedding_dim=16,
    encoder_prenet_out_units=(16, 8), encoder_prenet_drop_rate=0.5,
    cbhg_out_units=16, conv_channels=8, max_filter_width=3,
    projection1_out_channels=8, projection2_out_channels=8, num_highway=1,
    self_attention_out_units=16, self_attention_transformer_ffn_units=24,
    self_attention_drop_rate=0.1,
    decoder_prenet_out_units=(16, 8), decoder_prenet_drop_rate=0.5,
    attention_out_units=16, attention1_out_units=12, attention2_out_units=4,
    decoder_out_units=16, decoder_self_attention_out_units=16,
    decoder_self_attention_drop_rate=0.1,
    zoneout_factor_cell=0.1, zoneout_factor_output=0.1,
    num_mels=6, outputs_per_step=2,
    initial_learning_rate=1e-3, adam_eps=1e-4,
)
S, FRAMES = 9, 10


def batch(b: int, seed: int = 11):
    """A seeded batch of ``b`` lanes, ragged source and target lengths."""
    out = training_batch(np.random.default_rng(seed), b, FRAMES, S, num_mels=6,
                         outputs_per_step=2, shortest=2)
    return {k: (v.astype(np.int32) if v.dtype == np.int64 else v) for k, v in out.items()}


def _one_thread_a_rank():
    # spawned ranks share the machine's cores; the test process keeps its own setting
    if torch.distributed.is_initialized():
        torch.set_num_threads(1)


def network(kw, seed: int = 5):
    """The network of ``kw`` with seeded weights, on the CPU."""
    model = tacotron_model_factory(HParams(**kw))
    torch.manual_seed(seed)
    return model, model.network(is_training=True, device="cpu")


def snapshot(trainer: Trainer, state, metrics=None) -> dict:
    """What the tests compare, whole, on the CPU: the metrics, the gradients, the
    network's state and Adam's."""
    mesh = trainer.mesh
    return dict(
        metrics=None if metrics is None else {k: float(v) for k, v in metrics.items()},
        grads={k: v.cpu() for k, v in mesh_lib.whole_gradients(state.net, mesh).items()},
        state={k: v.detach().cpu().clone()
               for k, v in mesh_lib.whole_state_dict(state.net, mesh).items()},
        optimizer=mesh_lib.whole_optimizer_state(state.net, state.optimizer, mesh),
    )


def train_steps(kw, global_batch, mesh_shape, steps: int = 1, seed: int = 0,
                checkpoint_dir=None, restore: bool = False, start=None):
    """``steps`` updates of the seeded network (or of the ``start`` state dict) on
    ``mesh_shape`` (None: one device); the snapshot after them. ``checkpoint_dir``:
    save at the end, or, with ``restore``, start from its latest checkpoint (and take
    no step)."""
    _one_thread_a_rank()
    model, net = network(kw)
    if start is not None:
        net.load_state_dict(start)
    mesh = None if mesh_shape is None else mesh_lib.make_mesh(mesh_shape)
    trainer = Trainer(model, checkpoint_dir, device="cpu", mesh=mesh)
    if restore:
        state = trainer.restore_or_init()
        return dict(snapshot(trainer, state), step=state.step)
    state = trainer.init_state(net)
    metrics = None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(steps):
            state, metrics = trainer.train_step(state, global_batch,
                                                torch.Generator().manual_seed(seed + i))
    if checkpoint_dir is not None:
        trainer.save(state)
    return dict(snapshot(trainer, state, metrics), warnings=[str(w.message) for w in caught],
                placed=sorted(mesh_lib.placement(state.net).dims.items())
                if mesh_lib.placement(state.net) else [])


def train_with_eval(kw, batches, eval_batches, checkpoint_dir, fast_clock_rank: int = 1):
    """``Trainer.train`` over ``batches`` at mesh (2, 1) with evaluation after every
    checkpoint, where rank ``fast_clock_rank``'s monotonic clock runs 1e5 s ahead at
    every reading, so that on its own clock every throttle has passed. The steps at
    which this rank evaluated, and rank 0's ``eval_*`` lines of ``metrics.jsonl``."""
    _one_thread_a_rank()
    model, net = network(kw)
    trainer = Trainer(model, checkpoint_dir, device="cpu", mesh=mesh_lib.make_mesh((2, 1)))
    if trainer.is_chief:    # the JSONL alone: TensorBoard's import takes seconds
        trainer.metrics = MetricsWriter(trainer.log_dir, use_tensorboard=False)
    if trainer.mesh.rank == fast_clock_rank:
        readings = iter(range(1, 1 << 30))
        trainer_lib.time = types.SimpleNamespace(
            monotonic=lambda: time.monotonic() + 1e5 * next(readings), time=time.time)
    evaluated = []
    evaluate = trainer.evaluate

    def counted(state, eval_iter):
        evaluated.append(int(state.step))
        return evaluate(state, eval_iter)

    trainer.evaluate = counted
    trainer.train(iter(batches), len(batches), state=trainer.init_state(net),
                  eval_batches_fn=lambda: iter(eval_batches))
    lines = []
    if trainer.is_chief:
        with open(os.path.join(trainer.log_dir, "metrics.jsonl")) as f:
            lines = [line for line in f if "eval_" in line]
    return dict(evaluated=evaluated, eval_lines=lines)


def sharded_predict(kw, flat_state, global_batch, max_iters: int, masks=None, seed: int = 3,
                    mesh_shape=(2, 1)):
    """The sharded predict of the network with ``flat_state`` on every rank; rank 0's
    dictionary on the CPU, and the error a batch of one lane fewer raises."""
    _one_thread_a_rank()
    model = tacotron_model_factory(HParams(**kw))
    net = model.network(device="cpu")
    net.load_state_dict(flat_state)
    mesh = mesh_lib.make_mesh(mesh_shape)
    predict = make_sharded_predict_fn(net, mesh, max_iters=max_iters, device="cpu",
                                      use_fused=False)
    out = predict(global_batch, torch.Generator().manual_seed(seed), masks)
    try:
        predict({k: v[:-1] for k, v in global_batch.items()})
        error = None
    except ValueError as e:
        error = str(e)
    return dict(out={k: (tuple(t.cpu() for t in v) if isinstance(v, tuple) else v.cpu())
                     for k, v in out.items()}, error=error)


def predict_mel_main(argv):
    """``predict_mel.main(argv)`` on the CPU under a process group."""
    _one_thread_a_rank()
    os.environ["SATT_PLATFORM"] = "cpu"
    from self_attention_tacotron_torch import predict_mel

    return predict_mel.main(argv)["frames"]

