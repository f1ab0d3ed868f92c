"""Trainer: one training step and one evaluation step of a model.

Counterpart of ``Trainer._train_step_impl`` / ``_eval_step_impl`` / ``_forward``
of ``self_attention_tacotron_tpu/training/trainer.py``: teacher-forced forward,
loss, backward, optional clipping by global norm, Adam at the scheduled rate.
Checkpoints, the training loop, evaluation artifacts and the command line are
not ported yet.

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
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from self_attention_tacotron_torch.models.models import (
    NetworkOutput,
    TacotronModelBase,
    TacotronNetwork,
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


class Trainer:
    """``device`` is the card unless the caller says ``"cpu"``; without a card
    the default raises."""

    def __init__(self, model: TacotronModelBase, device="cuda"):
        self.model = model
        self.hparams = model.hparams
        self.device = resolve_device(device)
        use_full_float32()
        self.schedule = learning_rate_schedule(self.hparams)

    def init_state(self, net: Optional[TacotronNetwork] = None) -> TrainState:
        """A state at step 0 around ``net`` (for instance from ``convert.load_npz``),
        moved to the trainer's device; a freshly initialised network without one."""
        if net is None:
            net = self.model.network(is_training=True, device=self.device)
        net = net.to(self.device)
        return TrainState(step=0, net=net, optimizer=make_optimizer(self.hparams, net.parameters()))

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
        batch = self._batch(batch)
        net.train()
        optimizer.zero_grad(set_to_none=True)
        out = self._forward(net, batch, generator)
        losses = self.model.loss(out, batch, params=net.parameters())
        mark("forward")
        losses["loss"].backward()
        mark("backward")
        grads = [p.grad for p in net.parameters() if p.grad is not None]
        norm = global_norm(grads)
        if hp.use_gradient_clipping and hp.gradient_clip_norm > 0:
            clip_by_global_norm(grads, norm, float(hp.gradient_clip_norm))
        for group in optimizer.param_groups:
            group["lr"] = self.schedule(state.step)
        optimizer.step()
        mark("optimizer")
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = norm.detach()
        return TrainState(step=state.step + 1, net=net, optimizer=optimizer), metrics

    def eval_step(
        self, state: TrainState, batch, generator: Optional[torch.Generator] = None
    ) -> Tuple[Dict[str, torch.Tensor], NetworkOutput]:
        """Teacher-forced losses and outputs in eval mode (running batch-norm
        averages, zoneout as interpolation; the prenet's dropout stays on)."""
        batch = self._batch(batch)
        state.net.eval()
        with torch.no_grad():
            out = self._forward(state.net, batch, generator)
            return self.model.loss(out, batch), out
