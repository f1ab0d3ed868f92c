"""Where a training step's time goes on the card.

    python3 -m self_attention_tacotron_torch.tools.profile_training [--config ls]

One configuration of ``tools/flagship.py`` at full width (``--config``: the
flagship from the committed trained weights, the default; ``baseline``,
``zoneout``, ``ls``, ``flagship-ls``, ``mgclf0`` or ``flagship-mgclf0`` from weights
made from a seed), the seeded batch of ``tools/flagship.py::config_batch`` (32 lanes
x 800 frames, sources 24..128, the configuration's heads),
``Trainer.train_step`` through the kernels and with ``use_pallas_kernels=False``
(eager encoder, the decoder's Python loop under autograd). It prints JSON lines:

* ``step``, per path and step: device time of forward (with the loss), backward
  and optimizer (clipping included) by CUDA events, the step's wall time on the
  host clock, target frames per second, and for the kernel path the device time
  of the two teacher kernels alone (the events around their launches);
* ``device``, per path: from ``torch.profiler`` over one step, kernels launched,
  device-busy time and its share of the median untraced step's wall time, and the kernels
  that take most device time (the hand-written ones appear under their names);
* ``memory``, per path: ``torch.cuda.max_memory_allocated`` over the steps.

With ``--conditioning`` it prints instead how well the first step's gradients are
determined at all: ``grad_norm`` and every gradient leaf (relative to the leaf's
largest entry; median and largest over the leaves) of the kernel path and of the
plain path in float32, and of the plain path in float64 with the embedding moved
by one part in 1e7, each against the plain path in float64.

Needs one CUDA device; it fails without one.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.ops import fused_teacher
from self_attention_tacotron_torch.tools.flagship import (
    CONFIGS,
    StepTimer,
    config_batch,
    config_hparams,
    device_busy,
    gpu_line,
    load_network,
)
from self_attention_tacotron_torch.training.trainer import Trainer
from self_attention_tacotron_torch.utils.platform import resolve_device


def timed_step(trainer, state, batch, generator):
    """``(state, metrics, row)`` of one ``train_step``: device ms of its parts,
    wall ms, and the teacher kernels' own device ms where they were launched."""
    launches = (fused_teacher.launch_count, fused_teacher.bwd_launch_count)
    torch.cuda.synchronize()
    start = time.perf_counter()
    timer = StepTimer()
    state, metrics = trainer.train_step(state, batch, generator, mark=timer)
    row = {f"{name}_ms": ms for name, ms in timer.ms().items()}
    torch.cuda.synchronize()
    row["wall_ms"] = 1e3 * (time.perf_counter() - start)
    if fused_teacher.launch_count > launches[0]:
        row["fused_teacher_fwd_ms"] = fused_teacher.last_launch_ms("fwd")
    if fused_teacher.bwd_launch_count > launches[1]:
        row["fused_teacher_bwd_ms"] = fused_teacher.last_launch_ms("bwd")
    return state, metrics, row


def first_gradients(config, overrides, batch, dev, double: bool = False, moved: float = 1.0):
    """``(gradients by parameter name in float64, loss, grad_norm)`` of the first
    step from the configuration's weights, generator seed 0, nothing updated."""
    trainer = Trainer(tacotron_model_factory(config_hparams(config, **overrides)))
    net = load_network(config, **overrides)
    batch = dict(batch)
    if double:
        net = net.double()
        for head in ("mel", "mgc"):
            if head in batch:
                batch[head] = batch[head].astype(np.float64)
    with torch.no_grad():
        for p in net.embedding.parameters():
            p.mul_(moved)
    tensors = trainer._batch(batch)
    net.train()
    out = trainer._forward(net, tensors, torch.Generator(device=dev).manual_seed(0))
    loss = trainer.model.loss(out, tensors, params=net.parameters())["loss"]
    loss.backward()
    grads = {k: p.grad.detach().double() for k, p in net.named_parameters()}
    norm = float(torch.sqrt(sum(g.square().sum() for g in grads.values())))
    return grads, float(loss.detach()), norm


def conditioning(config, dev, frames: int) -> None:
    hp = config_hparams(config)
    batch = config_batch(hp, np.random.default_rng(1234), 32, frames)
    plain = {"use_pallas_kernels": False}
    ref, loss, norm = first_gradients(config, plain, batch, dev, double=True)
    print(json.dumps({"conditioning": {
        "path": "plain, float64", "loss": loss, "grad_norm": norm}}), flush=True)
    for path, overrides, kwargs in (
        ("kernels, float32", {}, {}),
        ("plain, float32", plain, {}),
        ("plain, float32, embedding moved by 1e-7", plain, {"moved": 1.0 + 1e-7}),
        ("plain, float64, embedding moved by 1e-7", plain, {"double": True, "moved": 1.0 + 1e-7}),
    ):
        grads, loss, norm = first_gradients(config, overrides, batch, dev, **kwargs)
        errs = sorted(
            float((grads[k] - g).abs().max()) / max(float(g.abs().max()), 1e-12)
            for k, g in ref.items()
        )
        print(json.dumps({"conditioning": {
            "path": path, "loss": loss, "grad_norm": norm,
            "leaves_rel_err_against_float64": {"median": errs[len(errs) // 2], "max": errs[-1]},
        }}), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=3, help="timed steps per path")
    parser.add_argument("--frames", type=int, default=800, help="target frames per lane")
    parser.add_argument("--conditioning", action="store_true",
                        help="how well float32 determines the first step's gradients")
    parser.add_argument("--config", choices=CONFIGS, default="flagship")
    args = parser.parse_args()
    dev = resolve_device("cuda")
    print(json.dumps({"card": gpu_line(), "config": args.config, "steps": args.steps,
                      "frames": args.frames}), flush=True)
    if args.conditioning:
        conditioning(args.config, dev, args.frames)
        return

    for path, overrides in (("kernels", {}), ("plain", {"use_pallas_kernels": False})):
        hp = config_hparams(args.config, **overrides)
        trainer = Trainer(tacotron_model_factory(hp))
        state = trainer.init_state(load_network(args.config, **overrides))
        batch = config_batch(hp, np.random.default_rng(1234), 32, args.frames)
        frames = int(batch["target_lengths"].sum())
        gen = torch.Generator(device=dev).manual_seed(0)
        state, _, _ = timed_step(trainer, state, batch, gen)          # warm-up
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for i in range(args.steps):
            state, metrics, row = timed_step(trainer, state, batch, gen)
            walls.append(row["wall_ms"])
            print(json.dumps({"step": {
                "path": path, "index": i, **row, "frames_per_s": 1e3 * frames / row["wall_ms"],
                "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            }}), flush=True)
        print(json.dumps({"memory": {
            "path": path, "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        }}), flush=True)
        row = device_busy(
            lambda: trainer.train_step(state, batch, gen), sorted(walls)[len(walls) // 2]
        )
        print(json.dumps({"device": {"path": path, **row}}), flush=True)
        del trainer, state
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
