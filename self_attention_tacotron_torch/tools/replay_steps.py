"""Replay a run's updates through the kernels and through the plain paths.

``python -m self_attention_tacotron_torch.tools.replay_steps --run-dir RUN --from-step K
--count N``: restores the checkpoint of step K of a run of ``tools/convergence_run.py``
(``RUN/checkpoints/ckpt-K.pt``) through the ``Trainer``, rebuilds the batches of
updates K+1 .. K+N as the run's loop drew them (``RUN/data``, ``RUN/lists/train.lst``,
shuffled from ``random_seed``, the run's loop begun at step 0: from scratch or from a warm
start, not resumed, since a resumed loop draws its stream afresh), and runs each update from
the run's own state before it through four paths, each with ``step_generator(random_seed, step)``
on the device, so that every path draws the same prenet masks and zoneout seed:

* ``a``: the kernel path, as the run trained (its hparams: ``--hparams-extra`` over
  ``tools/flagship.py::FLAGSHIP_OVERRIDES``, as the convergence tool takes them);
* ``b``: the plain path (``use_pallas_kernels=False``) in the run's compute dtype;
* ``c``: the plain path in float32 compute, which shows what bfloat16 rounding does;
* ``d``: path ``b`` with the state moved by one part in 1e7, the yardstick of how far
  rounding alone moves the update: the decoder's memories where they are float32;
  in bfloat16, whose memories cannot hold such a move, the embedding table (float32)
  moved by that part instead.

The run goes on along path ``a``. Before anything is written, path ``a`` must give the
run's own logged loss parts and ``grad_norm`` of that step (``checkpoints/log/
metrics.jsonl``; log every step, ``log_step_count_steps=1``) bit for bit: the tool
fails where it does not, or where the step was not logged. On the card it fails where
path ``a`` launches no training kernel or another path launches one.

It writes one JSON line per update and path (``--out``, default
``RUN/replay_<K+1>-<K+N>.jsonl``, after a first line that names the run, the card and
the command): the loss parts and ``grad_norm``; the training kernels' launches;
per gradient leaf, the largest |delta g| over the leaf's largest entry against path
``b`` (every leaf, and the worst by name); Adam's update per leaf, the largest
|delta theta| over the rate and the leaf's smallest second moment (a rarely moved
direction), the largest leaves by name; each lane's ``done_loss`` and its share of
the batch's ``done_loss`` and ``mel_loss``; and the loss parts of the same batch after
the path's update (a train-mode forward with the same generator, batch-norm buffers
left as the update left them).

``--digest REPLAY_JSONL --out FILE`` writes the brief of a replay's lines (``digest``):
the first line, then one line per update with each path's losses, its distance from
path ``b`` and Adam's update in their largest leaves, and the lanes of the largest
``done_loss``.

Usage:
  python -m self_attention_tacotron_torch.tools.replay_steps --run-dir runs/long_1235 \\
      --from-step 1764 --count 16 [--hparams-extra random_seed=1235,...] \\
      [--out FILE] [--device cpu]
  python -m self_attention_tacotron_torch.tools.replay_steps --digest FILE --out BRIEF
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import itertools
import json
import os
import sys
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models import losses as losses_lib
from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.tools import convergence_run as run
from self_attention_tacotron_torch.training.trainer import Trainer, TrainState, step_generator

# path -> (label, hparams overrides)
PATHS = {
    "a": ("kernels", {}),
    "b": ("plain", {"use_pallas_kernels": False}),
    "c": ("plain, float32", {"use_pallas_kernels": False, "compute_dtype": "float32"}),
    "d": ("plain, moved by 1e-7", {"use_pallas_kernels": False}),
}
MOVE = 1.0 + 1e-7
# the training kernels that one update of the flagship launches on the kernel path
TRAINING_KERNELS = ("bigru", "bigru_bwd", "fused_teacher_fwd", "fused_teacher_bwd")
# leaves named in each ranking
WORST = 8


def significant(x: float, digits: int = 4) -> float:
    return float(f"{x:.{digits}g}")


def leaf_distances(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
                   ) -> Dict[str, float]:
    """Per leaf, the largest |got - want| over the largest |want|."""
    return {
        k: float((got[k].double() - w.double()).abs().max())
        / max(float(w.double().abs().max()), 1e-30)
        for k, w in want.items()
    }


def ranked(values: Dict[str, float], n: int = WORST) -> List[list]:
    return [[k, significant(v)] for k, v in sorted(values.items(), key=lambda kv: -kv[1])[:n]]


def summary_of(values: Dict[str, float]) -> dict:
    v = list(values.values())
    return {"max": max(v), "median": float(np.median(v)), "worst": ranked(values),
            "leaves": {k: significant(x, 3) for k, x in values.items()}}


def path_hparams(hp: HParams, path: str) -> HParams:
    return dataclasses.replace(hp, **PATHS[path][1])


@contextmanager
def moved_memories(net, hp: HParams):
    """Path ``d``'s move in float32: the decoder's memories by one part in 1e7, for
    the block (in bfloat16 ``move_embedding`` moves the state instead)."""
    if hp.compute_dtype != "float32":
        yield
        return

    def hook(module, args, kwargs):
        cond = args[0]
        moved = dataclasses.replace(cond, memories=tuple(m * MOVE for m in cond.memories))
        return (moved, *args[1:]), kwargs

    handle = net.decoder.register_forward_pre_hook(hook, with_kwargs=True)
    try:
        yield
    finally:
        handle.remove()


def move_embedding(net) -> None:
    """Path ``d``'s move in bfloat16, whose memories cannot hold one part in 1e7: the
    embedding table (float32) moved by that part."""
    with torch.no_grad():
        for p in net.embedding.parameters():
            p.mul_(MOVE)


class _Captured:
    """Wraps a model's ``loss`` to keep the last output and batch it was given."""

    def __init__(self, model):
        self.model, self.loss = model, model.loss
        self.out = self.batch = None
        model.loss = self

    def __call__(self, out, batch, params=None):
        self.out, self.batch = out, batch
        return self.loss(out, batch, params=params)


def lane_losses(hp: HParams, out, batch) -> dict:
    """Each lane's ``done_loss`` (over its own frames), and its share of the batch's
    ``done_loss`` and ``mel_loss`` (the lane's term of the batch's sum over the total)."""
    lengths = batch["target_lengths"]
    stop, mels = out.stop_logits.detach(), out.frames["mel"].detach()
    frames = lengths.double()
    total = float(frames.sum())
    done, mel = [], []
    for i in range(int(lengths.shape[0])):
        sl = slice(i, i + 1)
        done.append(float(losses_lib.stop_token_loss(stop[sl], batch["done"][sl], lengths[sl])))
        mel.append(float(losses_lib.spec_loss(mels[sl], batch["mel"][sl], lengths[sl],
                                              hp.spec_loss_type)))
    done_terms = np.asarray(done) * frames.cpu().numpy()
    mel_terms = np.asarray(mel) * frames.cpu().numpy()
    return {
        "done_loss": [significant(x) for x in done],
        "done_share": [significant(x) for x in done_terms / max(done_terms.sum(), 1e-30)],
        "mel_share": [significant(x) for x in mel_terms / max(mel_terms.sum(), 1e-30)],
        "frames": [int(x) for x in lengths.tolist()],
        "of_frames": total,
    }


class Path:
    """One path's trainer, network and optimizer, loaded from a state before each
    update."""

    def __init__(self, name: str, hp: HParams, device, checkpoint_dir: Optional[str] = None):
        self.name, self.label = name, PATHS[name][0]
        self.hp = path_hparams(hp, name)
        self.trainer = Trainer(tacotron_model_factory(self.hp), checkpoint_dir, device=device)
        self.captured = _Captured(self.trainer.model)
        self.device = device
        self.state: Optional[TrainState] = None
        if checkpoint_dir is None:
            self.state = self.trainer.init_state(self.trainer.model.network(device=device))

    def state_from(self, snapshot: dict, step: int) -> TrainState:
        """This path's network and optimizer loaded from ``snapshot`` at ``step``."""
        net, optimizer = self.state.net, self.state.optimizer
        net.load_state_dict(snapshot["net"])
        optimizer.load_state_dict(copy.deepcopy(snapshot["optimizer"]))
        if self.name == "d" and self.hp.compute_dtype != "float32":
            move_embedding(net)
        return TrainState(step=step, net=net, optimizer=optimizer)

    def update(self, state: TrainState, batch, seed: int) -> dict:
        """One update of ``state`` in place; what the replay reads of it."""
        hp = self.hp
        before = {k: p.detach().clone() for k, p in state.net.named_parameters()}
        rate = self.trainer.schedule(state.step)
        run.reset_launch_counts()
        with moved_memories(state.net, hp) if self.name == "d" else nullcontext():
            after, metrics = self.trainer.train_step(
                state, batch, step_generator(seed, state.step, device=self.device))
        launches = {k: v for k, v in run.launch_counts().items() if not k.endswith("_variants")}
        grads = {k: p.grad.detach().clone() for k, p in after.net.named_parameters()
                 if p.grad is not None}
        lanes = lane_losses(hp, self.captured.out, self.captured.batch)
        self.captured.out = self.captured.batch = None
        moves, moments = {}, {}
        opt_state = after.optimizer.state
        for k, p in after.net.named_parameters():
            moves[k] = float((p.detach() - before[k]).abs().max()) / rate
            if p in opt_state and "exp_avg_sq" in opt_state[p]:
                moments[k] = float(opt_state[p]["exp_avg_sq"].min())
        with moved_memories(after.net, hp) if self.name == "d" else nullcontext():
            later = self.loss_parts(after, batch, seed, state.step)
        self.state = after
        return {
            "state": after, "grads": grads,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "launches": launches, "rate": rate, "lanes": lanes,
            "moves": moves, "moments": moments, "after": later,
        }

    def loss_parts(self, state: TrainState, batch, seed: int, step: int) -> Dict[str, float]:
        """The loss parts of ``batch`` at ``state`` (train mode, the update's
        generator), the batch-norm buffers left as they were."""
        net = state.net
        buffers = {k: b.detach().clone() for k, b in net.named_buffers()}
        tensors = self.trainer._batch(batch)
        net.train()
        with torch.no_grad():
            out = self.trainer._forward(net, tensors, step_generator(seed, step,
                                                                     device=self.device))
            parts = self.captured.loss(out, tensors)
        self.captured.out = self.captured.batch = None
        with torch.no_grad():
            for k, b in net.named_buffers():
                b.copy_(buffers[k])
        return {k: float(v) for k, v in parts.items()}


def snapshot(state: TrainState) -> dict:
    return {"net": {k: v.detach().clone() for k, v in state.net.state_dict().items()},
            "optimizer": copy.deepcopy(state.optimizer.state_dict())}


def logged_records(log_dir: str) -> Dict[int, dict]:
    return {r["step"]: r for r in run.read_metrics(log_dir) if "loss" in r}


def check_logged(step: int, metrics: Dict[str, float], records: Dict[int, dict]) -> None:
    """Path ``a`` against the run's own record of ``step``, bit for bit."""
    if step not in records:
        raise SystemExit(f"[replay] the run logged no training scalars at step {step}: "
                         "train with log_step_count_steps=1")
    rec = records[step]
    differ = {k: (v, rec.get(k)) for k, v in metrics.items() if rec.get(k) != v}
    if differ:
        raise SystemExit(f"[replay] path a does not reproduce the run's step {step} bit for "
                         f"bit: {differ} (replayed, logged)")


def check_launches(device: str, name: str, launches: Dict[str, int]) -> None:
    if name == "a" and device.startswith("cuda"):
        missing = [k for k in TRAINING_KERNELS if launches[k] < 1]
        if missing:
            raise SystemExit(f"[replay] the kernel path launched no {missing}: {launches}")
    if name != "a" and any(launches.values()):
        raise SystemExit(f"[replay] the {PATHS[name][0]} path launched a kernel: {launches}")


def path_record(step: int, name: str, got: dict, plain: Optional[dict]) -> dict:
    moves, moments = got["moves"], got["moments"]
    rec = {
        "step": step, "path": name, "label": PATHS[name][0],
        "loss_parts": {k: v for k, v in got["metrics"].items() if k != "grad_norm"},
        "grad_norm": got["metrics"]["grad_norm"], "rate": got["rate"],
        "launches": got["launches"], "lanes": got["lanes"], "after_update": got["after"],
        "adam": {
            # [leaf, largest |delta theta| / rate, smallest second moment]
            "update_over_rate": {
                "max": max(moves.values()), "median": float(np.median(list(moves.values()))),
                "largest": [[k, v, significant(moments.get(k, float("nan")))]
                            for k, v in ranked(moves)]},
            "smallest_second_moment": [[k, significant(v)] for k, v in
                                       sorted(moments.items(), key=lambda kv: kv[1])[:WORST]],
        },
    }
    if plain is not None:
        rec["grads_against_b"] = summary_of(leaf_distances(got["grads"], plain["grads"]))
        theirs = dict(plain["state"].net.named_parameters())
        rec["update_against_b_over_rate"] = ranked({
            k: float((p.detach() - theirs[k].detach()).abs().max()) / got["rate"]
            for k, p in got["state"].net.named_parameters()})
    return rec


def digest(records: List[dict], n: int = 3) -> List[dict]:
    """The replay's lines in brief: the first line, then one line per update with each
    path's loss parts, ``grad_norm``, the loss parts after its update, Adam's update
    over the rate (largest and median leaf, the ``n`` largest), the distance of its
    gradients from path ``b`` (largest and median leaf, the ``n`` worst) and the ``n``
    lanes of the largest ``done_loss``."""
    out = [records[0]]
    by_step: Dict[int, dict] = {}
    for rec in records[1:]:
        lanes = rec["lanes"]
        top = sorted(range(len(lanes["done_loss"])), key=lambda i: -lanes["done_loss"][i])[:n]
        row = {
            **rec["loss_parts"], "grad_norm": rec["grad_norm"],
            "after_update": {k: rec["after_update"][k] for k in ("loss", "done_loss")},
            "update_over_rate": {"max": significant(rec["adam"]["update_over_rate"]["max"]),
                                 "median": significant(rec["adam"]["update_over_rate"]["median"]),
                                 "largest": rec["adam"]["update_over_rate"]["largest"][:n]},
            # [lane, its done_loss, its share of the batch's, its frames]
            "lanes_of_largest_done_loss": [[i, lanes["done_loss"][i], lanes["done_share"][i],
                                            lanes["frames"][i]] for i in top],
        }
        if "grads_against_b" in rec:
            g = rec["grads_against_b"]
            row["grads_against_b"] = {"max": significant(g["max"]),
                                      "median": significant(g["median"]), "worst": g["worst"][:n]}
        line = by_step.setdefault(rec["step"], {"step": rec["step"], "paths": {}})
        line["paths"][rec["path"]] = row
    return out + [by_step[k] for k in sorted(by_step)]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run-dir")
    p.add_argument("--from-step", type=int,
                   help="the checkpoint's step K: updates K+1 .. K+count are replayed")
    p.add_argument("--count", type=int, default=16)
    p.add_argument("--hparams-extra", default="",
                   help="the run's overrides, as convergence_run took them")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--digest", default=None, metavar="REPLAY_JSONL",
                   help="write the brief of a replay's lines (``digest``) to --out instead")
    args = p.parse_args(argv)
    if args.digest is None and (args.run_dir is None or args.from_step is None):
        p.error("--run-dir and --from-step are required")
    if args.digest is not None and args.out is None:
        p.error("--digest takes --out")
    return args


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Run the command line ``argv``; returns the records written."""
    from self_attention_tacotron_torch.data.dataset import TacotronDataset, read_selected_list

    args = parse_args(argv)
    if args.digest is not None:
        with open(args.digest) as f:
            brief = digest([json.loads(line) for line in f if line.strip()])
        with open(args.out, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in brief)
        return brief
    device = run.device_of(args.device)
    run_dir = os.path.abspath(args.run_dir)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    data_dir, list_dir = os.path.join(run_dir, "data"), os.path.join(run_dir, "lists")
    run.EXTRA.clear()
    run.EXTRA.update(run.parse_extra(args.hparams_extra))
    hp = run.flagship_run_hparams()
    first, last = args.from_step + 1, args.from_step + args.count
    out_path = args.out or os.path.join(run_dir, f"replay_{first}-{last}.jsonl")
    names = list(PATHS)
    records_logged = logged_records(os.path.join(ckpt_dir, "log"))

    dataset = TacotronDataset(data_dir, data_dir, hp,
                              utterance_ids=read_selected_list(list_dir, "train"))
    stream = dataset.batches(hp.batch_size, shuffle=True, repeat=True, seed=hp.random_seed,
                             prefetch=0)
    batches = itertools.islice(stream, args.from_step, None)

    if not os.path.exists(os.path.join(ckpt_dir, f"ckpt-{args.from_step:08d}.pt")):
        raise SystemExit(f"[replay] no checkpoint of step {args.from_step} in {ckpt_dir}")
    # every path's network is made before the first update (nothing draws in between)
    paths = {n: Path(n, hp, device, ckpt_dir if n == "a" else None) for n in names}
    kernel = paths["a"]
    state = kernel.trainer.restore(args.from_step)
    if state.step != args.from_step:
        raise SystemExit(f"[replay] checkpoint {args.from_step} holds step {state.step}")

    written: List[dict] = []
    out = None
    try:
        for step in range(first, last + 1):
            batch = next(batches)
            snap = snapshot(state)
            got = {"a": kernel.update(state, batch, hp.random_seed)}
            check_launches(device, "a", got["a"]["launches"])
            check_logged(step, got["a"]["metrics"], records_logged)
            state = got["a"]["state"]
            for n in names[1:]:
                got[n] = paths[n].update(paths[n].state_from(snap, step - 1), batch,
                                         hp.random_seed)
                check_launches(device, n, got[n]["launches"])
            if out is None:
                out = open(out_path, "w")
                meta = {"run_dir": run.repo_path(run_dir), "checkpoint_step": args.from_step,
                        "updates": [first, last], "hparams_extra": args.hparams_extra,
                        "random_seed": hp.random_seed, "compute_dtype": hp.compute_dtype,
                        "paths": {n: PATHS[n][0] for n in names}, "device": device,
                        "card": run.gpu_line(), "torch": torch.__version__,
                        "command": "python -m self_attention_tacotron_torch.tools.replay_steps "
                                   + " ".join(sys.argv[1:] if argv is None else argv),
                        "logged_bit_for_bit": True}
                out.write(json.dumps(meta) + "\n")
                written.append(meta)
            plain = got.get("b")
            for n in names:
                rec = path_record(step, n, got[n], plain if n != "b" else None)
                if n == "a":
                    rec["logged"] = {k: records_logged[step][k] for k in got["a"]["metrics"]}
                out.write(json.dumps(rec) + "\n")
                written.append(rec)
            out.flush()
            print(json.dumps(step_line(step, got)), flush=True)
    finally:
        if out is not None:
            out.close()
    return written


def step_line(step: int, got: Dict[str, dict]) -> dict:
    """A short line per update for the console."""
    line = {"step": step}
    for n, g in got.items():
        line[n] = {"loss": g["metrics"]["loss"], "done_loss": g["metrics"]["done_loss"],
                   "grad_norm": g["metrics"]["grad_norm"],
                   "after_loss": g["after"]["loss"], "after_done_loss": g["after"]["done_loss"]}
    if "b" in got:
        for n in ("a", "c", "d"):
            if n in got:
                line[f"{n}_against_b_max_leaf"] = max(
                    leaf_distances(got[n]["grads"], got["b"]["grads"]).values())
    return line


if __name__ == "__main__":
    main()
