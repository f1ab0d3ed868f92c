"""The flagship configuration and request shapes that the GPU scripts drive."""

from __future__ import annotations

import os
import subprocess
from typing import Dict

import numpy as np

from self_attention_tacotron_torch.hparams import HParams

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# trained flagship weights (float32 leaves, num_symbols=256), committed in the repo
TRAINED_NPZ = os.path.join(_REPO, "artifacts", "convergence_long_r5", "trained_params.npz")


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


def ragged_lengths(rng: np.random.Generator, batch: int, longest: int, shortest: int = 24):
    """``batch`` lengths in [shortest, longest]; the first lane has the longest."""
    lengths = rng.integers(shortest, longest + 1, size=batch).astype(np.int64)
    lengths[0] = longest
    return lengths


def ragged_request(rng: np.random.Generator, batch: int, longest: int) -> Dict[str, np.ndarray]:
    """Source ids from ``rng``, zero beyond each lane's length."""
    lengths = ragged_lengths(rng, batch, longest)
    source = rng.integers(1, 70, size=(batch, longest)).astype(np.int64)
    source *= np.arange(longest)[None, :] < lengths[:, None]
    return {"source": source, "source_lengths": lengths}


def gpu_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]
