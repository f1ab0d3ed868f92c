"""Whether what the timed path produced is correct: the plain reference against
the program's outputs, and the readings each limit was set from.

Synthesis: the requests kept from the window (a sample drawn from the run's
seed, and the request with the most frames) are run once through the reference,
teacher-forced on the frames the program served, with the dropout masks the
program used: the encoder's prenet masks drawn again from each request's
generator seed in the program's order (layer 0, then layer 1), the decoder's
prenet masks the benchmark handed in. A ``*_gap`` is the widest gap over the
lanes' valid frames, steps and positions, a ``*_rms_gap`` the root-mean-square
gap over every checked lane, a ``*_lane_p75_gap`` the 75th percentile over the
checked lanes of each lane's own root-mean-square gap (a fault in a quarter of
the lanes moves it; one lane whose bfloat16 forward attention parts from the
reference's does not), ``mel_worst_lane_gap`` the largest of those in mel.

Training: the reference follows the program's first three steps from the same
weights, batches and generator seeds (its random draws in the program's order),
in float32; the numbers are the losses' gap and, by the worst leaf, the gaps of
the first step's gradient norms and of the norms of the parameters' change after
three steps.

A control computes the reference one precision below the configuration's
(``LOWER``): operands of every product rounded to fp8 (e4m3) for bfloat16, TF32
products for float32. Its readings, from the same comparisons, set each
limit's upper reading.
"""

from __future__ import annotations

import contextlib
import importlib
import math
import types
from typing import Dict, List, Optional

import numpy as np
import torch

LOWER = {"bfloat16": "fp8", "float32": "tf32"}
# sums over every checked lane, from which the root-mean-square gaps are taken
SUMS = ("mel_diff", "mel_ref", "stop_diff", "frames", "align_diff", "align_rows")
# each checked lane's own root-mean-square gaps, of which ``*_lane_p75_gap`` is the 75th percentile
LANES = ("mel", "stop", "align")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    y = x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(x.dtype)
    return x + (y - x).detach()


def reference(config: Dict) -> types.ModuleType:
    """The configuration's reference, ``reference/<config["reference"]>.py``
    (``reference/tacotron.py`` says what such a module gives)."""
    return importlib.import_module(f"port_bench.reference.{config['reference']}")


@contextlib.contextmanager
def precision(kind: Optional[str], net: torch.nn.Module, ref: types.ModuleType):
    """The reference in float32 (``None``) or one precision lower."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = kind == "tf32"
    ref.set_operand_rounding(net, _fp8 if kind == "fp8" else None)
    try:
        yield net
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
        ref.set_operand_rounding(net, None)


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each number compared beside its limit; a number that is not finite fails."""
    return {name: {"value": readings.get(name, float("nan")), "limit": limit}
            for name, limit in limits.items()}


def passed(checks: Dict[str, Dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


# --------------------------------------------------------------------------- #
# synthesis
# --------------------------------------------------------------------------- #


def encoder_masks(hp: Dict, seed: int, batch: int, src_len: int, device) -> List[torch.Tensor]:
    """The encoder prenet's keep masks as the program draws them from a generator
    seeded with ``seed``: one ``torch.rand`` per layer of (B, S, units)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    keep = 1.0 - hp["encoder_prenet_drop_rate"]
    return [torch.rand((batch, src_len, u), device=device, generator=gen) < keep
            for u in hp["encoder_prenet_out_units"]]


def decoder_masks(hp: Dict, seed: int, batch: int, device) -> List[torch.Tensor]:
    """The decoder prenet's keep masks the benchmark hands the program: one
    (max_iters, B, units) draw per layer from a generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    keep = 1.0 - hp["decoder_prenet_drop_rate"]
    return [torch.rand((hp["max_iters"], batch, u), device=device, generator=gen) < keep
            for u in hp["decoder_prenet_out_units"]]


def _served_lengths(stop: torch.Tensor, steps: int, r: int, threshold: float) -> torch.Tensor:
    """Each lane's length by the decode's rule over the served stop probabilities:
    the first frame above the threshold, else every frame of the steps run."""
    fired = stop[:, : steps * r] > threshold
    first = torch.where(fired.any(dim=1), fired.int().argmax(dim=1) + 1,
                        torch.full_like(fired[:, 0], steps * r, dtype=torch.long))
    return first


def synthesis_readings(ref: types.ModuleType, hp: Dict, flat, kept: List[Dict], device,
                       control: bool = False) -> Dict[str, Dict[str, float]]:
    """``kept``: per request ``{"inputs", "out", "encoder_seed", "decoder_seed"}``
    (the program's output dictionary). Returns ``{"program": readings}`` and, with
    ``control``, ``"control"``: the reference one precision lower against the
    reference, on the same frames. Requests of one padded source length run as
    one reference batch: the padding is part of what the encoder computes (the
    max-pool's window at a lane's last symbol reaches into it), so each lane
    keeps its request's."""
    groups: Dict[int, List[Dict]] = {}
    for k in kept:
        groups.setdefault(k["inputs"]["source"].shape[1], []).append(k)
    result: Dict[str, Dict[str, float]] = {}
    for group in groups.values():
        for side, gaps in _group_readings(ref, hp, flat, group, device, control).items():
            merged = result.setdefault(side, {})
            for name, value in gaps.items():
                if name in SUMS or name in LANES or name == "length_mismatch":
                    merged[name] = merged.get(name, 0.0 if name not in LANES else []) + value
                else:
                    merged[name] = max(value, merged.get(name, value))
    for merged in result.values():
        merged["mel_rms_gap"] = math.sqrt(merged["mel_diff"] / max(merged["mel_ref"], 1e-30))
        merged["stop_rms_gap"] = math.sqrt(merged["stop_diff"] / max(merged["frames"], 1.0))
        merged["align_rms_gap"] = math.sqrt(merged["align_diff"] / max(merged["align_rows"], 1.0))
        merged["mel_worst_lane_gap"] = max(merged["mel"])
        for name in LANES:
            merged[f"{name}_lane_p75_gap"] = float(np.percentile(merged.pop(name), 75))
        for name in SUMS:
            del merged[name]
    return result


def _group_readings(ref, hp, flat, kept, device, control):
    r = hp["outputs_per_step"]
    n_max = max(int(k["out"]["num_steps"]) for k in kept)
    src, src_len, enc_masks, dec_masks, targets = [], [], [], [], []
    for k in kept:
        batch, s = k["inputs"]["source"].shape
        src.append(torch.as_tensor(k["inputs"]["source"], device=device))
        src_len.append(torch.as_tensor(k["inputs"]["source_lengths"], device=device))
        enc_masks.append(encoder_masks(hp, k["encoder_seed"], batch, s, device))
        dec_masks.append([m[:n_max].transpose(0, 1)
                          for m in decoder_masks(hp, k["decoder_seed"], batch, device)])
        targets.append(k["out"]["mel"][:, : n_max * r].float())
    source, lengths = torch.cat(src), torch.cat(src_len)
    enc = [torch.cat(ms) for ms in zip(*enc_masks)]
    dec = [torch.cat(ms) for ms in zip(*dec_masks)]
    mel_in = torch.cat(targets)
    full_mel = torch.cat([k["out"]["mel"].float() for k in kept])
    served_len = torch.cat([k["out"]["lengths"].long() for k in kept])

    def run(kind):
        net = ref.network(hp, flat, device).eval()
        with precision(kind, net, ref), torch.no_grad():
            out = net(source, lengths, mel_in, served_len, encoder_masks=enc, decoder_masks=dec)
            out["postnet_mel"], out["linear"] = net.postnets(full_mel, served_len)
        return out

    want = run(None)
    result = {"program": _synthesis_gaps(hp, kept, want, None)}
    if control:
        result["control"] = _synthesis_gaps(hp, kept, want, run(LOWER[hp["compute_dtype"]]))
    return result


def _synthesis_gaps(hp, kept, want, got_ref) -> Dict[str, float]:
    """Widest gaps of the program's outputs (``got_ref`` None) or of the lower
    precision reference's against the reference, request by request."""
    r, thr = hp["outputs_per_step"], hp["stop_token_threshold"]
    gaps = {"mel_gap": 0.0, "stop_gap": 0.0, "align_gap": 0.0, "encoder_sa_gap": 0.0,
            "length_mismatch": 0.0}
    sums = dict.fromkeys(SUMS, 0.0)
    lanes: Dict[str, List[float]] = {name: [] for name in LANES}
    post = want["postnet_mel"] is not None
    lin = want["linear"] is not None
    if post:
        gaps["postnet_gap"] = 0.0
    if lin:
        gaps["linear_gap"] = 0.0
    row = 0
    for k in kept:
        out, inputs = k["out"], k["inputs"]
        batch = inputs["source"].shape[0]
        sl = slice(row, row + batch)
        row += batch
        L = out["lengths"].long()
        steps = int(out["num_steps"])
        s_len = torch.as_tensor(inputs["source_lengths"], device=L.device)
        frames = L.max().item()
        t_idx = torch.arange(frames, device=L.device)
        fmask = (t_idx[None, :] < L[:, None]).float()
        n_lane = (L + r - 1) // r
        want_mel = want["mel"][sl, :frames]
        want_stop = torch.sigmoid(want["stop_logits"][sl, :frames])
        if got_ref is None:
            got_mel = out["mel"][:, :frames].float()
            got_stop = out["stop_probs"][:, :frames].float()
            got_align = [a.float() for a in out["alignments"]]
            got_sa = out["encoder_sa_alignments"][0].float() if out["encoder_sa_alignments"] else None
            got_post, got_lin = out.get("postnet_mel"), out.get("linear")
            gaps["length_mismatch"] += float(
                (_served_lengths(out["stop_probs"].float(), steps, r, thr) != L).sum())
        else:
            got_mel = got_ref["mel"][sl, :frames]
            got_stop = torch.sigmoid(got_ref["stop_logits"][sl, :frames])
            got_align = [a[sl] for a in got_ref["alignments"]]
            got_sa = got_ref["encoder_sa"][0][sl]
            got_post, got_lin = got_ref["postnet_mel"], got_ref["linear"]
            got_post = None if got_post is None else got_post[sl]
            got_lin = None if got_lin is None else got_lin[sl]
        scale = (want_mel.abs() * fmask[..., None]).max().clamp_min(1e-12)
        diff = (got_mel - want_mel) * fmask[..., None]
        gaps["mel_gap"] = max(gaps["mel_gap"], float(diff.abs().max() / scale))
        sums["mel_diff"] += float(diff.square().sum())
        sums["mel_ref"] += float((want_mel * fmask[..., None]).square().sum())
        lane_ref = (want_mel * fmask[..., None]).square().sum(dim=(1, 2)).clamp_min(1e-30)
        lanes["mel"] += (diff.square().sum(dim=(1, 2)) / lane_ref).sqrt().tolist()
        stop_diff = (got_stop - want_stop) * fmask
        gaps["stop_gap"] = max(gaps["stop_gap"], float(stop_diff.abs().max()))
        sums["stop_diff"] += float(stop_diff.square().sum())
        sums["frames"] += float(fmask.sum())
        lane_frames = fmask.sum(dim=1).clamp_min(1.0)
        lanes["stop"] += (stop_diff.square().sum(dim=1) / lane_frames).sqrt().tolist()
        lane_align, lane_rows = torch.zeros_like(fmask[:, 0]), torch.zeros_like(fmask[:, 0])
        for got_a, want_a in zip(got_align, want["alignments"]):
            n, s = min(got_a.shape[1], want_a.shape[1]), got_a.shape[2]
            amask = ((torch.arange(n, device=L.device)[None, :, None] < n_lane[:, None, None])
                     & (torch.arange(s, device=L.device)[None, None, :] < s_len[:, None, None]))
            diff = (got_a[:, :n] - want_a[sl, :n, :s]).abs() * amask
            gaps["align_gap"] = max(gaps["align_gap"], float(diff.max()))
            sums["align_diff"] += float(diff.square().sum())
            sums["align_rows"] += float(amask.any(dim=2).float().sum())
            lane_align += diff.square().sum(dim=(1, 2))
            lane_rows += amask.any(dim=2).float().sum(dim=1)
        lanes["align"] += (lane_align / lane_rows.clamp_min(1.0)).sqrt().tolist()
        if got_sa is not None:
            s = got_sa.shape[-1]
            valid = torch.arange(s, device=L.device)[None, :] < s_len[:, None]
            smask = (valid[:, None, :, None] & valid[:, None, None, :]).float()
            diff = (got_sa - want["encoder_sa"][0][sl, :, :s, :s]).abs() * smask
            gaps["encoder_sa_gap"] = max(gaps["encoder_sa_gap"], float(diff.max()))
        for name, got_x, want_x in (("postnet_gap", got_post, want["postnet_mel"]),
                                    ("linear_gap", got_lin, want["linear"])):
            if want_x is None:
                continue
            w = want_x[sl, :frames]
            g = got_x[:, :frames].float()
            sc = (w.abs() * fmask[..., None]).max().clamp_min(1e-12)
            gaps[name] = max(gaps[name], float(((g - w).abs() * fmask[..., None]).max() / sc))
    gaps.update(sums, **lanes)
    return gaps


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.float().norm()) for k, v in tensors.items()}


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float], leaves) -> List[float]:
    """Per leaf the gap of the norms over the reference's norm of that leaf or of
    the median leaf, whichever is larger."""
    median = float(np.median([want[k] for k in leaves]))
    return [abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in leaves]


def training_readings(ref: types.ModuleType, hp: Dict, flat, batches: List[Dict],
                      step_seeds: List[int], program: Dict, device,
                      control: bool = False) -> Dict[str, Dict]:
    """``program``: ``losses`` (the first three steps' ``loss``), ``grad`` (the
    first step's gradient norm per leaf, as Adam got it) and ``update`` (the norm
    of each leaf's change after three steps). Leaves whose reference gradient is
    under a thousandth of the median leaf's are left out of the change."""

    def follow(kind):
        net = ref.network(hp, flat, device)
        adam = ref.make_adam(hp, net.parameters())
        start = {k: p.detach().clone() for k, p in net.named_parameters()}
        losses, grad, first = [], None, None
        with precision(kind, net, ref):
            for step, (batch, seed) in enumerate(zip(batches, step_seeds)):
                gen = torch.Generator(device=device).manual_seed(seed)
                floats, grads = ref.train_step(net, adam, hp, step, batch, gen)
                losses.append(floats["loss"])
                if step == 0:
                    grad, first = leaf_norms(grads), floats
        update = leaf_norms({k: p.detach() - start[k] for k, p in net.named_parameters()})
        return {"losses": losses, "grad": grad, "update": update, "first": first}

    want = follow(None)
    median = float(np.median(list(want["grad"].values())))
    moved = [k for k, v in want["grad"].items() if v >= 1e-3 * median]

    def gaps(got):
        losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
        grad = _leaf_gaps(got["grad"], want["grad"], list(want["grad"]))
        update = _leaf_gaps(got["update"], want["update"], moved)
        parts = {f"first_{k}_gap": abs(got["first"][k] - want["first"][k]) / abs(want["first"][k])
                 for k in ("mel_loss", "done_loss", "grad_norm") if k in got.get("first", {})}
        return {**parts, "loss_gap": max(losses), "first_loss_gap": losses[0],
                "grad_leaf_gap": max(grad), "grad_median_gap": float(np.median(grad)),
                "update_leaf_gap": max(update), "update_median_gap": float(np.median(update))}

    result = {"program": gaps(program), "left_out": sorted(set(want["grad"]) - set(moved))}
    if control:
        result["control"] = gaps(follow(LOWER[hp["compute_dtype"]]))
    return result
