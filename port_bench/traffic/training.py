"""Training traffic: a pool of batches, made on the card at set-up and cycled.

Parameters: ``batch`` (utterances a step), ``symbols`` (the length
distribution, see ``text.length_pool``), ``batches`` (the pool's size; its
``batches * batch`` lengths are the distribution's quantiles, shuffled by the
seed), ``frames_per_symbol`` (an utterance's target frames per symbol, rounded
up to a multiple of r). Targets are padded to the batch's longest; ``mel``
uniform in [0, 1) and zero beyond a lane's length, ``done`` 1 from the lane's
last frame on. Every batch's rows differ from every other's.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from port_bench.traffic import text

KIND = "training"


def batches(params: Dict, seed: int, num_mels: int, r: int, device) -> List[Dict]:
    size, count = int(params["batch"]), int(params["batches"])
    pool = np.asarray(text.length_pool(params["symbols"], size * count), np.int64)
    lengths = pool[np.random.default_rng(text.seed_of(seed, 0)).permutation(len(pool))]
    out = []
    for k in range(count):
        lanes = lengths[k * size: (k + 1) * size]
        rng = np.random.default_rng(text.seed_of(seed, 1, k))
        batch = text.sources(rng, lanes)
        frames = np.asarray([math.ceil(float(params["frames_per_symbol"]) * n / r) * r
                             for n in lanes], np.int64)
        longest = int(frames.max())
        gen = torch.Generator(device=device).manual_seed(text.seed_of(seed, 2, k))
        valid = torch.arange(longest, device=device)[None, :] < torch.as_tensor(
            frames, device=device)[:, None]
        mel = torch.rand(size, longest, num_mels, device=device, generator=gen) * valid[..., None]
        done = (torch.arange(longest, device=device)[None, :]
                >= torch.as_tensor(frames - 1, device=device)[:, None]).float()
        out.append({
            "source": torch.as_tensor(batch["source"], device=device),
            "source_lengths": torch.as_tensor(batch["source_lengths"], device=device),
            "mel": mel, "done": done,
            "target_lengths": torch.as_tensor(frames, device=device),
        })
    return out
