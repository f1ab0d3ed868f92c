"""Learning-rate schedule and optimizer (Adam, optional clipping by global norm).

Counterpart of ``self_attention_tacotron_tpu/training/schedules.py``. The decay is
an exponential half-life schedule, floored at 1 % of the initial rate; it honours
``initial_learning_rate`` and ``learning_rate_step_factor``.
"""

from __future__ import annotations

from typing import Callable, Iterable, List

import torch


def learning_rate_schedule(hparams) -> Callable[[int], float]:
    """Step count (updates made so far) -> learning rate of the next update."""
    init = float(hparams.initial_learning_rate)
    factor = max(hparams.learning_rate_step_factor, 1)
    if not hparams.decay_learning_rate:
        return lambda step: init

    def fn(step: int) -> float:
        lr = init * 0.5 ** (float(step) * factor / 50_000.0)
        return max(lr, init / 100.0)

    return fn


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """The 2-norm of all gradients taken as one vector."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def clip_by_global_norm(grads: List[torch.Tensor], norm: torch.Tensor, clip: float) -> None:
    """Scale ``grads`` in place by ``clip / max(norm, clip)``: nothing is added to
    the norm, so gradients at or under ``clip`` pass unchanged."""
    scale = clip / torch.clamp(norm, min=clip)
    for g in grads:
        g.mul_(scale)


def make_optimizer(hparams, params: Iterable[torch.nn.Parameter]) -> torch.optim.Adam:
    """Adam with both bias corrections and ``eps`` outside the root. The trainer
    sets the rate from ``learning_rate_schedule`` before every update and clips
    the gradients first where ``use_gradient_clipping`` says so."""
    return torch.optim.Adam(
        list(params),
        lr=float(hparams.initial_learning_rate),
        betas=(hparams.adam_beta1, hparams.adam_beta2),
        eps=hparams.adam_eps,
    )
