"""The configurations and request shapes that the GPU scripts drive.

Seven configurations at full width, float32 unless ``compute_dtype`` is
overridden (``DTYPES``; the scripts' ``--dtype``): ``flagship`` (the dual-source
Self-Attention Tacotron, with the committed trained weights), ``baseline``
(``configs/ljspeech_baseline.json``: ``ExtendedTacotronV1Model`` with
``EncoderV1``), ``zoneout`` (the same model with ``ZoneoutEncoderV1``), ``ls``
(the reference's location-sensitive family: that model with
``attention="location_sensitive"``, 31 taps, 32 filters, cumulative weights,
trained by the reference in bfloat16), ``flagship-ls`` (the flagship's
structure with location-sensitive attention on its first source), ``mgclf0``
(the reference's WORLD-feature family: ``MgcLf0TacotronModel`` with
``ZoneoutEncoderV1`` and forward attention, heads mgc 60 and lf0 256, trained by
the reference in bfloat16) and ``flagship-mgclf0``
(``DualSourceSelfAttentionMgcLf0TacotronModel``: the flagship's structure with
those heads). No trained weights of the baseline family, of location-sensitive
attention or of the WORLD heads are committed: those networks are made from a
seed.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from self_attention_tacotron_torch import convert
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import TacotronNetwork, tacotron_model_factory

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# trained flagship weights (float32 leaves, num_symbols=256), committed in the repo
TRAINED_NPZ = os.path.join(_REPO, "artifacts", "convergence_long_r5", "trained_params.npz")
# the baseline Tacotron's configuration, as the training command line reads it
BASELINE_JSON = os.path.join(_REPO, "configs", "ljspeech_baseline.json")
CONFIGS = ("flagship", "baseline", "zoneout", "ls", "flagship-ls", "mgclf0", "flagship-mgclf0")
# the compute dtypes a script may ask for (hparams.compute_dtype)
DTYPES = ("float32", "bfloat16")


def flagship_hparams(**overrides) -> HParams:
    """Full-width flagship: dual-source self-attention Tacotron, float32, r=2."""
    hp = HParams(
        tacotron_model="DualSourceSelfAttentionTacotronModel",
        encoder="SelfAttentionCBHGEncoder",
        decoder="DualSourceSelfAttentionDecoder",
        attention="forward",
        attention2="additive",
        num_symbols=256,
        compute_dtype="float32",
        max_iters=500,
    )
    return hp.override_from_dict(overrides)


def baseline_hparams(**overrides) -> HParams:
    """Full-width baseline Tacotron: ``configs/ljspeech_baseline.json`` over the
    defaults (``ExtendedTacotronV1Model``, ``EncoderV1``, ``ExtendedDecoder``,
    forward attention, r=2, 70 symbols), float32."""
    hp = HParams(compute_dtype="float32", max_iters=500).override_from_json_file(BASELINE_JSON)
    return hp.override_from_dict(overrides)


def config_hparams(config: str, **overrides) -> HParams:
    """The hyper-parameters of one of ``CONFIGS``; ``zoneout`` is the baseline with
    ``ZoneoutEncoderV1``, ``ls`` that with location-sensitive attention (the
    hparams' own ``attention_kernel=31``, ``attention_filters=32``,
    ``cumulative_weights=True``), ``flagship-ls`` the flagship with it; ``mgclf0``
    the zoneout baseline's structure as ``MgcLf0TacotronModel``, ``flagship-mgclf0``
    the flagship's as ``DualSourceSelfAttentionMgcLf0TacotronModel`` (the hparams'
    own ``num_mgcs=60``, ``num_lf0s=256``)."""
    if config == "flagship":
        return flagship_hparams(**overrides)
    if config == "baseline":
        return baseline_hparams(**overrides)
    if config == "zoneout":
        return baseline_hparams(**{"encoder": "ZoneoutEncoderV1", **overrides})
    if config == "ls":
        return baseline_hparams(**{"encoder": "ZoneoutEncoderV1",
                                   "attention": "location_sensitive", **overrides})
    if config == "flagship-ls":
        return flagship_hparams(**{"attention": "location_sensitive", **overrides})
    if config == "mgclf0":
        return baseline_hparams(**{"encoder": "ZoneoutEncoderV1",
                                   "tacotron_model": "MgcLf0TacotronModel",
                                   "decoder": "MgcLf0ExtendedDecoder", **overrides})
    if config == "flagship-mgclf0":
        return flagship_hparams(**{
            "tacotron_model": "DualSourceSelfAttentionMgcLf0TacotronModel",
            "decoder": "MgcLf0DualSourceSelfAttentionDecoder", **overrides})
    raise ValueError(f"unknown configuration {config!r}; known: {CONFIGS}")


def load_network(config: str, seed: int = 0, device="cuda", **overrides) -> TacotronNetwork:
    """The network of ``config`` on ``device`` in eval mode: the flagship with its
    trained weights, the others with weights made from ``seed`` (on the CPU's
    generator, so that every path of one seed holds the same weights)."""
    hp = config_hparams(config, **overrides)
    if config == "flagship":
        return convert.load_npz(TRAINED_NPZ, hp, device=device)
    torch.manual_seed(seed)
    return tacotron_model_factory(hp).network(device=device).eval()


def ragged_lengths(rng: np.random.Generator, batch: int, longest: int, shortest: int = 24):
    """``batch`` lengths in [shortest, longest]; the first lane has the longest."""
    lengths = rng.integers(shortest, longest + 1, size=batch).astype(np.int64)
    lengths[0] = longest
    return lengths


def ragged_request(
    rng: np.random.Generator, batch: int, longest: int, shortest: int = 24
) -> Dict[str, np.ndarray]:
    """Source ids from ``rng``, zero beyond each lane's length."""
    lengths = ragged_lengths(rng, batch, longest, shortest)
    source = rng.integers(1, 70, size=(batch, longest)).astype(np.int64)
    source *= np.arange(longest)[None, :] < lengths[:, None]
    return {"source": source, "source_lengths": lengths}


def training_batch(
    rng: np.random.Generator, batch: int = 32, frames: int = 800, longest: int = 128,
    num_mels: int = 80, outputs_per_step: int = 2, shortest: int = 24,
    num_mgcs: int = 0, num_lf0s: int = 0,
) -> Dict[str, np.ndarray]:
    """A training batch in the data layer's field names, all from ``rng``.

    Sources as ``ragged_request``; a lane's target length is in proportion to its
    source length (``frames`` for the longest source, a multiple of
    ``outputs_per_step``), as an utterance's frames are to its symbols; ``mel``
    uniform in [0, 1) and zero beyond a lane's length; ``done`` 1 from a lane's
    last frame on. With ``num_lf0s`` (the WORLD heads) ``mgc`` (B, T, num_mgcs)
    uniform in [0, 1) and ``lf0`` (B, T) class ids in [0, num_lf0s) instead of
    ``mel``, both zero beyond a lane's length.
    """
    out = ragged_request(rng, batch, longest, shortest)
    r = outputs_per_step
    frames = frames // r * r
    steps = np.ceil(out["source_lengths"] * (frames // r) / longest).astype(np.int64)
    target_lengths = np.clip(steps, 1, frames // r) * r
    valid = np.arange(frames)[None, :] < target_lengths[:, None]
    if num_lf0s:
        out["mgc"] = rng.random((batch, frames, num_mgcs), dtype=np.float32) * valid[..., None]
        out["lf0"] = rng.integers(0, num_lf0s, size=(batch, frames)) * valid
    else:
        out["mel"] = rng.random((batch, frames, num_mels), dtype=np.float32) * valid[..., None]
    done = (np.arange(frames)[None, :] >= target_lengths[:, None] - 1).astype(np.float32)
    out.update(done=done, target_lengths=target_lengths)
    return out


def config_batch(hp: HParams, rng: np.random.Generator, batch: int = 32, frames: int = 800,
                 longest: int = 128) -> Dict[str, np.ndarray]:
    """``training_batch`` with the targets of ``hp``'s heads: ``mel``, or for the
    ``MgcLf0`` decoders ``mgc`` and ``lf0``."""
    world = hp.decoder.startswith("MgcLf0")
    return training_batch(
        rng, batch, frames, longest, hp.num_mels, hp.outputs_per_step,
        num_mgcs=hp.num_mgcs if world else 0, num_lf0s=hp.num_lf0s if world else 0,
    )


def gpu_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class StepTimer:
    """CUDA events at the marks of ``Trainer.train_step``: device time of a step's
    parts. Use one per step: ``timer = StepTimer(); train_step(..., mark=timer)``."""

    def __init__(self):
        self.names: List[str] = []
        self.events = [torch.cuda.Event(enable_timing=True)]
        self.events[0].record()

    def __call__(self, name: str) -> None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.names.append(name)
        self.events.append(event)

    def ms(self) -> Dict[str, float]:
        """``{part: ms}`` and their sum under ``"step"``; waits for the last mark."""
        self.events[-1].synchronize()
        parts = {
            name: a.elapsed_time(b)
            for name, a, b in zip(self.names, self.events[:-1], self.events[1:])
        }
        parts["step"] = self.events[0].elapsed_time(self.events[-1])
        return parts


def device_busy(fn: Callable[[], object], untraced_ms: float, top: int = 8) -> Dict:
    """One call of ``fn`` under ``torch.profiler``: kernels launched, the device's
    busy time and its share of ``untraced_ms`` (the tracer slows the host down, so
    the share is taken against the same call's untraced wall time)."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    start = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - start)
    rows = [
        (e.key, e.count, e.device_time_total / 1e3)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    if not rows:
        return {"error": "no device time in the trace"}
    busy_ms = sum(r[2] for r in rows)
    return {
        "traced_wall_ms": wall_ms, "untraced_wall_ms": untraced_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share_of_untraced_wall": busy_ms / untraced_ms,
        "kernel_launches": sum(r[1] for r in rows),
        "top_kernels": [
            {"name": k[:80], "count": c, "device_ms": t}
            for k, c, t in sorted(rows, key=lambda r: -r[2])[:top]
        ],
    }
