"""Closed-loop training through ``Trainer.train_step`` on a pool of batches: the
driver of the mixes whose generator is ``traffic/training.py``."""

from __future__ import annotations

from typing import Dict, List

import torch

from port_bench import check
from port_bench.harness import Cell, Span, program_network, seeded_weights, sync
from port_bench.traffic import text

CHECKED_STEPS = 3


class Driver:
    def __init__(self, cell: Cell, seed: int, device):
        from self_attention_tacotron_torch.models.models import tacotron_model_factory
        from self_attention_tacotron_torch.training.trainer import Trainer

        self.cell, self.device, self.seed = cell, device, seed
        self.flat = seeded_weights(cell, seed, device)
        self.hp, net = program_network(cell, self.flat, device)
        self.trainer = Trainer(tacotron_model_factory(self.hp), device=device)
        self.state = self.trainer.init_state(net)
        self.r = self.hp.outputs_per_step
        self.batches = cell.generator.batches(cell.traffic, seed, self.hp.num_mels, self.r, device)
        self.program = self._first_steps()

    def step_seed(self, k: int) -> int:
        return text.seed_of(self.seed, 4, k)

    def _first_steps(self) -> Dict:
        """The first steps, through the window's own call: what the check holds
        against the reference (losses, the first gradient as Adam got it, the
        change after three steps)."""
        net, opt = self.state.net, self.state.optimizer
        start = {k: p.detach().clone() for k, p in net.named_parameters()}
        beta1 = opt.param_groups[0]["betas"][0]
        losses, grad, first = [], None, None
        for k in range(CHECKED_STEPS):
            item = self.serve(k)
            losses.append(float(item["metrics"]["loss"]))
            if k == 0:
                # a leaf Adam holds no state of has not reached it: 0
                grad = {name: float((opt.state[p]["exp_avg"] / (1.0 - beta1)).norm())
                        if "exp_avg" in opt.state.get(p, {}) else 0.0
                        for name, p in net.named_parameters()}
                first = {name: float(v) for name, v in item["metrics"].items()}
        update = {k: float((p.detach() - start[k]).norm()) for k, p in net.named_parameters()}
        return {"losses": losses, "grad": grad, "update": update, "first": first}

    def serve(self, k: int, mark=None) -> Dict:
        batch = self.batches[k % len(self.batches)]
        gen = torch.Generator(device=self.device).manual_seed(self.step_seed(k))
        self.state, metrics = self.trainer.train_step(self.state, batch, gen, mark=mark)
        sync(self.device)
        lengths = batch["target_lengths"]
        steps = (lengths // self.r).tolist()
        return {"metrics": metrics, "frames": int(lengths.sum()),
                "lanes": list(zip(batch["source_lengths"].tolist(), steps))}

    def keep(self, item: Dict) -> None:
        pass

    def warm_up(self) -> int:
        """Every batch of the pool once (the first steps served already); the
        window starts at the pool's second round."""
        for k in range(CHECKED_STEPS, len(self.batches)):
            self.serve(k)
        return len(self.batches)

    def samples(self, after: int, count: int) -> Dict[str, List[Dict[str, float]]]:
        """``Trainer.train_step``'s marks (CUDA events) over steps after the trace."""
        out = []
        for k in range(after, after + count):
            timer = Span(self.device)
            self.serve(k, mark=timer)
            out.append(timer.ms())
        return {"marks": out}

    def release(self) -> None:
        del self.state, self.trainer

    def readings(self, control: bool) -> Dict:
        first = [self.batches[k % len(self.batches)] for k in range(CHECKED_STEPS)]
        seeds = [self.step_seed(k) for k in range(CHECKED_STEPS)]
        return check.training_readings(self.cell.reference, self.cell.hp, self.flat, first,
                                       seeds, self.program, self.device, control=control)
