"""Trainer: the training step, the loop, checkpoints, evaluation and artifacts.

Counterpart of ``self_attention_tacotron_tpu/training/trainer.py``:

* ``train_step`` / ``eval_step``: teacher-forced forward, loss, backward,
  optional clipping by global norm, Adam at the scheduled rate (JAX
  ``_train_step_impl`` / ``_eval_step_impl`` / ``_forward``);
* checkpoints in a torch format (``ckpt-<step>.pt`` under ``checkpoint_dir``):
  the step, the network's ``state_dict`` (with the batch-norm buffers) and
  Adam's ``state_dict``, written to a temporary file and moved into place with
  ``os.replace``, read with ``weights_only=True``. ``keep_checkpoint_max``
  keeps the latest; checkpoints on the ``keep_checkpoint_every_n_hours`` grid
  survive eviction, as orbax's ``keep_time_interval`` keeps them;
* ``restore_or_init``: auto-resume from the latest checkpoint, else a warm start
  from a flat npz of the JAX layout (through ``convert.flax_to_torch_state``)
  or from another run's checkpoint directory (parameters and statistics from
  the donor; the step and Adam start fresh); ``restore_inference``: parameters
  and statistics only;
* ``train``: every cadence of the JAX loop (``log_step_count_steps`` /
  ``save_summary_steps``, ``save_training_time_metrics``,
  ``save_checkpoints_steps``, ``alignment_save_steps``, evaluation after
  ``eval_start_delay_secs`` / ``eval_throttle_secs``, a final save);
  ``evaluate`` and the alignment and mel PNGs.

The random draws of an update come from a ``torch.Generator`` derived from
``random_seed`` and the step count (``step_generator``), as JAX folds the step
into its key, so that feeding the same batches after a resume gives the same
run as going straight through.

The mesh (``parallel/mesh.py``; default ``make_mesh(hparams.mesh_shape)`` over the
ranks of the default process group, which ``parallel.init_from_env`` makes under
torchrun): every rank reads the same global batch, as JAX's single controller does;
``shard_batch`` gives each rank its rows, and the step computes the global batch's
loss as GSPMD computes it in the JAX package: every loss normaliser and batch-norm
statistic over the whole batch and every random mask drawn for the whole batch
(``parallel/shard.py``), each rank's loss its share, the gradients summed over the
data axis, the clipping norm taken after that sum. The parameters that the model
axis's rules place keep their slice on each rank (``shard_params``). The metrics
are the global batch's; checkpoints hold whole tensors (any mesh's checkpoint
restores at any mesh, one device included) and are written by rank 0 alone, with
the others at a barrier; ``metrics.jsonl`` and the PNGs are rank 0's too. A mesh of
one rank is the single-device path: no process group, no collective.

With the postnets configured, the losses add ``postnet_loss`` (PostNetV2's mel
against ``mel``) and ``linear_loss`` (PostCBHG's linear spectrogram against the
batch's ``spec``, where the batch has it); the postnets' batch-norm running
statistics move in a training step as the encoder's do.

The network and the optimizer carry their state themselves, so ``train_step``
updates them in place and hands back a :class:`TrainState` around the same
objects with the step count advanced.

``compute_dtype="bfloat16"`` trains through the kernels' bfloat16 branches on the
card (``bigru_train``, the teacher-forced decoder's forward and backward), as the
JAX package's fused path does, and on the plain path (``use_pallas_kernels=False``,
or on the CPU) as its XLA path does; the parameters and Adam's state stay float32.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from self_attention_tacotron_torch import convert

from self_attention_tacotron_torch.models.models import (
    NetworkOutput,
    TacotronModelBase,
    TacotronNetwork,
    init_generator,
)
from self_attention_tacotron_torch.parallel import mesh as mesh_lib
from self_attention_tacotron_torch.parallel import shard as shard_lib
from self_attention_tacotron_torch.training.metrics import (
    MetricsWriter,
    save_alignment_png,
    save_mel_comparison_png,
)
from self_attention_tacotron_torch.training.schedules import (
    clip_by_global_norm,
    global_norm,
    learning_rate_schedule,
    make_optimizer,
)
from self_attention_tacotron_torch.utils.platform import resolve_device, use_full_float32


@dataclasses.dataclass
class TrainState:
    step: int
    net: TacotronNetwork               # parameters and batch-norm statistics
    optimizer: torch.optim.Optimizer   # Adam's moments


def targets_from_batch(model: TacotronModelBase, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-head targets side by side in the decoder's head order (the fed-back order)."""
    hp = model.hparams
    parts = []
    for head in model.HEADS:
        if head == "lf0":
            parts.append(torch.nn.functional.one_hot(batch["lf0"].long(), hp.num_lf0s).float())
        else:
            parts.append(batch[head])
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def _network_kwargs(model: TacotronModelBase, batch) -> Dict[str, torch.Tensor]:
    kwargs = {}
    if model.hparams.use_accent_type:
        kwargs["accent_type"] = batch["accent_type"]
    if model.hparams.use_speaker_embedding:
        kwargs["speaker_id"] = batch["speaker_id"]
    return kwargs


def step_generator(seed: int, *path: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` and ``path`` (for
    instance the step count), as ``jax.random.fold_in`` derives a key."""
    state = np.random.SeedSequence([int(seed), *(int(p) for p in path)]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) & (2**63 - 1))


class CheckpointManager:
    """The checkpoints of one directory: ``ckpt-<step>.pt`` files, and their save
    times in ``checkpoints.json``.

    ``max_to_keep`` (0 or less: all) keeps the latest checkpoints; with
    ``keep_every_seconds`` a checkpoint survives eviction where it was saved at
    least that long after the last one so kept, the first always (orbax's
    ``LatestN`` and ``EveryNSeconds`` preservation policies).
    """

    PATTERN = re.compile(r"^ckpt-(\d+)\.pt$")
    INDEX = "checkpoints.json"

    def __init__(self, directory: str, max_to_keep: int = 0, keep_every_seconds: float = 0.0):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        self.keep_every_seconds = float(keep_every_seconds)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{int(step):08d}.pt")

    def steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        found = (self.PATTERN.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _times(self) -> Dict[int, float]:
        path = os.path.join(self.directory, self.INDEX)
        recorded = {}
        if os.path.exists(path):
            with open(path) as f:
                recorded = {int(k): float(v) for k, v in json.load(f).items()}
        return {s: recorded.get(s, os.path.getmtime(self.path(s))) for s in self.steps()}

    def _write_index(self, times: Dict[int, float]) -> None:
        _atomic_write(os.path.join(self.directory, self.INDEX),
                      lambda f: f.write(json.dumps({str(k): v for k, v in times.items()}).encode()))

    def save(self, step: int, payload: dict) -> bool:
        """Write ``payload`` as the checkpoint of ``step``, then evict. A step at or
        below the latest saved one is not written again (returns False)."""
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        os.makedirs(self.directory, exist_ok=True)
        _atomic_write(self.path(step), lambda f: torch.save(payload, f))
        times = self._times()
        times[step] = time.time()
        for old in self._evicted(times):
            os.remove(self.path(old))
            del times[old]
        self._write_index(times)
        return True

    def _evicted(self, times: Dict[int, float]) -> List[int]:
        steps = sorted(times)
        if self.max_to_keep <= 0:
            return []
        keep = set(steps[-self.max_to_keep:])
        if self.keep_every_seconds > 0 and steps:
            last = steps[0]
            keep.add(last)
            for step in steps[1:]:
                if times[step] - times[last] >= self.keep_every_seconds:
                    keep.add(step)
                    last = step
        return [s for s in steps if s not in keep]

    def load(self, step: int, device=None) -> dict:
        return torch.load(self.path(step), map_location=device, weights_only=True)


def _atomic_write(path: str, write: Callable) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


class Trainer:
    """``device`` is the card unless the caller says ``"cpu"``; without a card
    the default raises. ``checkpoint_dir`` is where ``save``, ``restore_or_init``,
    ``restore_inference`` and ``train`` keep the checkpoints; ``log_dir`` (default
    ``<checkpoint_dir>/log``) takes ``metrics.jsonl`` and the PNGs. A trainer
    without a directory serves ``train_step`` and ``eval_step`` alone. ``mesh``
    (default ``make_mesh(hparams.mesh_shape)``): the ranks the steps run on."""

    #: utterances rendered to PNGs per evaluation
    EVAL_PLOT_UTTERANCES = 3

    def __init__(self, model: TacotronModelBase, checkpoint_dir: Optional[str] = None,
                 log_dir: Optional[str] = None, device="cuda",
                 mesh: Optional[mesh_lib.Mesh] = None):
        self.model = model
        self.hparams = model.hparams
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else mesh_lib.make_mesh(self.hparams.mesh_shape)
        self.is_chief = self.mesh.rank == 0
        use_full_float32()
        self.schedule = learning_rate_schedule(self.hparams)
        self.checkpoint_dir = self.log_dir = self.checkpoints = None
        if checkpoint_dir is not None:
            hp = self.hparams
            self.checkpoint_dir = os.path.abspath(checkpoint_dir)
            self.log_dir = os.path.abspath(log_dir or os.path.join(checkpoint_dir, "log"))
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            os.makedirs(self.log_dir, exist_ok=True)
            self.checkpoints = CheckpointManager(
                self.checkpoint_dir, hp.keep_checkpoint_max,
                3600.0 * max(hp.keep_checkpoint_every_n_hours, 0),
            )

    @functools.cached_property
    def metrics(self) -> MetricsWriter:
        """The scalar writer of ``log_dir``, opened at its first use."""
        if self.log_dir is None:
            raise ValueError("this trainer has no checkpoint_dir, so no log_dir")
        return MetricsWriter(self.log_dir)

    def generator(self, *path: int) -> torch.Generator:
        """``step_generator(hparams.random_seed, *path)`` on the trainer's device."""
        return step_generator(self.hparams.random_seed, *path, device=self.device)

    def init_state(self, net: Optional[TacotronNetwork] = None) -> TrainState:
        """A state at step 0 around ``net`` (for instance from ``convert.load_npz``),
        moved to the trainer's device; without one a fresh network, drawn with flax's
        initialisers from ``init_generator(hparams.random_seed)``, as JAX's trainer
        draws it from ``PRNGKey(random_seed)``: the same seed, the same weights.
        On a mesh of more than one rank, rank 0's weights go to every rank, and the
        model axis's parameters are placed (``shard_params``)."""
        return self._placed_state(self._network(net))

    def _network(self, net: Optional[TacotronNetwork]) -> TacotronNetwork:
        if net is None:
            net = self.model.network(is_training=True, device=self.device,
                                     generator=init_generator(self.hparams.random_seed))
        return net.to(self.device)

    def _placed_state(self, net: TacotronNetwork, step: int = 0) -> TrainState:
        if self.mesh.size > 1 and mesh_lib.placement(net) is None:
            for tensor in list(net.parameters()) + list(net.buffers()):
                torch.distributed.broadcast(tensor.data, src=0)
        mesh_lib.shard_params(net, self.mesh)
        return TrainState(step=step, net=net,
                          optimizer=make_optimizer(self.hparams, net.parameters()))

    def _shard(self, batch) -> mesh_lib.ShardedBatch:
        """This rank's rows of a global batch (the whole batch on a data axis of one)."""
        if self.mesh.shape["data"] == 1:
            return mesh_lib.ShardedBatch(batch)
        return mesh_lib.shard_batch(batch, self.mesh)

    def _global(self, losses: Dict[str, torch.Tensor], sharded) -> Dict[str, torch.Tensor]:
        """The global batch's loss parts from this rank's shares."""
        values = {k: v.detach() for k, v in losses.items()}
        if not sharded.data_parallel:
            return values
        stacked = shard_lib.all_reduce(torch.stack(list(values.values())).float(),
                                       self.mesh.group("data"))
        return dict(zip(values, stacked.unbind(0)))

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        return {
            key: torch.as_tensor(value).to(self.device)
            for key, value in batch.items()
            if not (isinstance(value, np.ndarray) and value.dtype.kind in "US")
        }

    def _forward(self, net: TacotronNetwork, batch, generator) -> NetworkOutput:
        return net(
            batch["source"], batch["source_lengths"], targets_from_batch(self.model, batch),
            batch["target_lengths"], generator=generator, **_network_kwargs(self.model, batch),
        )

    def train_step(
        self, state: TrainState, batch, generator: Optional[torch.Generator] = None,
        mark: Optional[Callable[[str], None]] = None,
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One update. Returns the state and the metrics: the loss parts (with
        ``postnet_loss`` and ``linear_loss`` where the postnets are configured) and
        ``grad_norm`` (before clipping), 0-dim tensors on the device. ``batch`` takes
        the data layer's field names: ``source``, ``source_lengths``, the heads'
        targets, ``done``, ``target_lengths``, and where the configuration reads them
        ``spec``, ``accent_type``, ``speaker_id``.

        ``mark``, where given, is called with ``"forward"``, ``"backward"`` and
        ``"optimizer"`` as each of these parts has been queued (a profiler's hook).
        """
        hp = self.hparams
        mark = mark or (lambda name: None)
        net, optimizer = state.net, state.optimizer
        sharded = self._shard(batch)
        batch = self._batch(sharded)
        net.train()
        optimizer.zero_grad(set_to_none=True)
        with mesh_lib.data_shard(sharded, self.mesh):
            out = self._forward(net, batch, generator)
            losses = self.model.loss(out, batch, params=mesh_lib.logical_parameters(net))
            mark("forward")
            losses["loss"].backward()
        if sharded.data_parallel:
            mesh_lib.sum_gradients(list(net.parameters()), self.mesh)
        mark("backward")
        grads = [p.grad for p in net.parameters() if p.grad is not None]
        norm = mesh_lib.gradient_norm(net, grads, self.mesh, global_norm)
        if hp.use_gradient_clipping and hp.gradient_clip_norm > 0:
            clip_by_global_norm(grads, norm, float(hp.gradient_clip_norm))
        for group in optimizer.param_groups:
            group["lr"] = self.schedule(state.step)
        optimizer.step()
        mark("optimizer")
        metrics = self._global(losses, sharded)
        metrics["grad_norm"] = norm.detach()
        return TrainState(step=state.step + 1, net=net, optimizer=optimizer), metrics

    def eval_step(
        self, state: TrainState, batch, generator: Optional[torch.Generator] = None
    ) -> Tuple[Dict[str, torch.Tensor], NetworkOutput]:
        """Teacher-forced losses and outputs in eval mode (running batch-norm
        averages, zoneout as interpolation; the prenet's dropout stays on). The
        losses are the global batch's; the outputs are this rank's rows."""
        losses, out, _ = self._eval(state, batch, generator)
        return losses, out

    def _eval(self, state: TrainState, batch, generator):
        sharded = self._shard(batch)
        tensors = self._batch(sharded)
        state.net.eval()
        with torch.no_grad(), mesh_lib.data_shard(sharded, self.mesh):
            out = self._forward(state.net, tensors, generator)
            losses = self.model.loss(out, tensors)
        return self._global(losses, sharded), out, sharded

    # ----------------------------- checkpoints ----------------------------- #

    def _checkpoints(self) -> CheckpointManager:
        if self.checkpoints is None:
            raise ValueError("this trainer has no checkpoint_dir")
        return self.checkpoints

    def save(self, state: TrainState) -> bool:
        """Checkpoint ``state``: the step, the network's ``state_dict`` and Adam's, whole
        (placed parameters and their moments gathered). Every rank calls it; rank 0
        writes while the others wait at a barrier."""
        checkpoints = self._checkpoints()
        payload = {
            "step": int(state.step),
            "net": mesh_lib.whole_state_dict(state.net, self.mesh),
            "optimizer": mesh_lib.whole_optimizer_state(state.net, state.optimizer, self.mesh),
        }
        if self.mesh.size == 1:
            return checkpoints.save(state.step, payload)
        written = [checkpoints.save(state.step, payload) if self.is_chief else None]
        torch.distributed.broadcast_object_list(written, src=0)
        return bool(written[0])

    def restore_or_init(
        self, warm_start_from: Optional[str] = None, net: Optional[TacotronNetwork] = None
    ) -> TrainState:
        """Auto-resume from the latest checkpoint of ``checkpoint_dir``: step,
        weights, batch-norm buffers and Adam's moments.

        Without one, ``warm_start_from`` initialises the parameters and the
        batch-norm statistics from a flat ``.npz`` of the JAX layout
        (``scripts/convergence_run.py::export_params_npz``; statistics the npz
        lacks keep their initial values) or from the latest checkpoint of another
        run's directory; the step and Adam start fresh. The architecture must be
        the donor's: a leaf that finds no place, or no leaf, raises. Otherwise
        ``net`` or a fresh network drawn from ``random_seed`` (``init_state``).
        """
        net = self._network(net)
        latest = self._checkpoints().latest_step()
        if latest is not None:
            payload = self.checkpoints.load(latest, self.device)
            net.load_state_dict(payload["net"])
            state = self._placed_state(net, step=int(payload["step"]))
            mesh_lib.load_whole_optimizer_state(state.net, state.optimizer, payload["optimizer"],
                                                self.mesh)
            return state
        if warm_start_from and warm_start_from.endswith(".npz"):
            with np.load(warm_start_from) as archive:
                flat = {k: archive[k] for k in archive.files}
            if not any(k.startswith("batch_stats/") for k in flat):
                flat.update((k, v) for k, v in convert.torch_to_flax_flat(net).items()
                            if k.startswith("batch_stats/"))
            convert.load_state(net, convert.flax_to_torch_state(flat, self.hparams, net))
        elif warm_start_from:
            donor = CheckpointManager(warm_start_from)
            step = donor.latest_step()
            if step is None:
                raise FileNotFoundError(f"warm-start dir {warm_start_from!r} has no checkpoints")
            net.load_state_dict(donor.load(step, self.device)["net"])
        return self._placed_state(net)

    def restore_inference(self, net: Optional[TacotronNetwork] = None) -> TrainState:
        """The parameters and batch-norm statistics of the latest checkpoint, at its
        step, and a fresh Adam that is never consulted: a change of the optimizer's
        hparams (``use_gradient_clipping``, the rates) does not break synthesis.
        Raises ``FileNotFoundError`` where the directory has no checkpoint."""
        net = self._network(net)
        latest = self._checkpoints().latest_step()
        if latest is None:
            raise FileNotFoundError(f"no checkpoint found under {self.checkpoint_dir!r}")
        net.load_state_dict(self.checkpoints.load(latest, self.device)["net"])
        return self._placed_state(net, step=latest)

    # -------------------------------- loops -------------------------------- #

    def train(
        self,
        train_batches: Iterable[Dict[str, np.ndarray]],
        num_steps: int,
        *,
        eval_batches_fn: Optional[Callable[[], Iterable[Dict[str, np.ndarray]]]] = None,
        state: Optional[TrainState] = None,
        warm_start_from: Optional[str] = None,
    ) -> TrainState:
        """``num_steps`` updates from ``state`` (default: ``restore_or_init``), then a
        final save. The update from step s draws from ``generator(s)``."""
        hp = self.hparams
        # an iterator up front: a re-iterable (a list) would replay the first batch
        train_batches = iter(train_batches)
        first = next(train_batches)
        if state is None:
            state = self.restore_or_init(warm_start_from)
        start = state.step
        train_start = window_t0 = time.monotonic()
        last_eval_time: Optional[float] = None
        window_steps = 0
        for batch in _chain_first(first, train_batches):
            if state.step - start >= num_steps:
                break
            state, metrics = self.train_step(state, batch, self.generator(state.step))
            step = state.step
            window_steps += 1
            # log_step_count_steps and save_summary_steps feed the same writer
            if (step % hp.log_step_count_steps == 0 or step % hp.save_summary_steps == 0
                    or step == start + 1):
                scalars = {k: float(v) for k, v in metrics.items()}
                if hp.save_training_time_metrics:
                    dt = max(time.monotonic() - window_t0, 1e-9)
                    scalars["steps_per_sec"] = window_steps / dt
                    scalars["frames_per_sec"] = (
                        window_steps * float(np.sum(np.asarray(batch["target_lengths"]))) / dt
                    )
                if self.is_chief:
                    self.metrics.write(step, scalars)
                window_t0 = time.monotonic()
                window_steps = 0
            if step % hp.save_checkpoints_steps == 0:
                self.save(state)
            # alignment and mel PNGs on a training cadence, from an eval-mode forward
            # on the current batch
            if step % hp.alignment_save_steps == 0:
                _, out, sharded = self._eval(state, batch, self.generator(step))
                self._save_artifacts(step, out, sharded, batch, tag="train_")
            # evaluation follows new checkpoints, after the delay and throttle
            if eval_batches_fn is not None and step % hp.save_checkpoints_steps == 0:
                now = time.monotonic()
                due = [now - train_start >= hp.eval_start_delay_secs and (
                    last_eval_time is None or now - last_eval_time >= hp.eval_throttle_secs
                )]
                if self.mesh.size > 1:
                    # rank 0's clock decides for every rank: evaluate runs collectives
                    torch.distributed.broadcast_object_list(due, src=0)
                if due[0]:
                    self.evaluate(state, eval_batches_fn())
                    last_eval_time = time.monotonic()
        self.save(state)
        return state

    def evaluate(self, state: TrainState, eval_batches: Iterable[Dict[str, np.ndarray]]
                 ) -> Dict[str, float]:
        """Means of the losses over up to ``num_evaluation_steps`` batches, written as
        ``eval_*`` scalars at the state's step, and the first batch's PNGs. Batch i
        draws from ``generator(7919, i)``, apart from training's stream."""
        hp = self.hparams
        totals: Dict[str, float] = {}
        count = 0
        first = None
        for i, batch in enumerate(eval_batches):
            if i >= hp.num_evaluation_steps:
                break
            losses, out, sharded = self._eval(state, batch, self.generator(7919, i))
            if first is None:
                first = (out, sharded, batch)
            for k, v in losses.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            count += 1
        if count == 0:
            return {}
        means = {f"eval_{k}": v / count for k, v in totals.items()}
        if self.is_chief:
            self.metrics.write(state.step, means)
        self._save_artifacts(state.step, *first, max_utts=self.EVAL_PLOT_UTTERANCES)
        return means

    def _save_artifacts(self, step: int, out: NetworkOutput, sharded, batch, *, tag="",
                        max_utts=1):
        """Alignment and mel comparison PNGs of the first ``max_utts`` lanes of the
        global batch, written by rank 0 (every rank calls it: where rank 0 holds fewer
        of those lanes, the data axis gathers them first)."""
        r = self.hparams.outputs_per_step
        n = min(max_utts, int(np.asarray(batch["source_lengths"]).shape[0]))
        aligns = list(out.alignments)
        mel = out.frames.get("mel")
        if sharded.data_parallel and sharded.rows < n:
            group = self.mesh.group("data")
            aligns = [shard_lib.all_gather(a[:n], group) for a in aligns]
            mel = None if mel is None else shard_lib.all_gather(mel[:n], group)
        if not self.is_chief:
            return
        for u in range(n):
            suffix = f"_utt{u}" if n > 1 else ""
            target_length = int(np.asarray(batch["target_lengths"])[u])
            save_alignment_png(
                [a[u].float().cpu().numpy() for a in aligns],
                os.path.join(self.log_dir, f"{tag}alignment_step{step:08d}{suffix}.png"),
                info=f"step {step}",
                source_length=int(np.asarray(batch["source_lengths"])[u]),
                decoder_steps=target_length // r,
            )
            if mel is not None:
                save_mel_comparison_png(
                    mel[u].float().cpu().numpy(),
                    np.asarray(batch["mel"][u]),
                    os.path.join(self.log_dir, f"{tag}mel_step{step:08d}{suffix}.png"),
                    info=f"step {step}",
                    length=target_length,
                )


def _chain_first(first, iterator: Iterator):
    yield first
    yield from iterator
