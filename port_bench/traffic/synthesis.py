"""Closed-loop synthesis traffic: request ``i`` is a batch of ``batch`` utterances.

Parameters: ``batch``, ``symbols`` (the length distribution, see
``text.length_pool``), ``pool`` (how many lengths the pool holds). Lanes take
the shuffled pool in arrival order, unsorted, cycling through it. Each request
also has two seeds of its own: one for the generator the program's encoder
draws its prenet dropout from, one for the decoder's prenet masks, which the
benchmark draws and hands in.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from port_bench.traffic import text

KIND = "synthesis"


class Requests:
    def __init__(self, params: Dict, seed: int):
        self.batch = int(params["batch"])
        self.seed = int(seed)
        pool = np.asarray(text.length_pool(params["symbols"], int(params["pool"])), np.int64)
        order = np.random.default_rng(text.seed_of(seed, 0)).permutation(len(pool))
        self.lengths = pool[order]

    def lane_lengths(self, i: int) -> np.ndarray:
        at = (i * self.batch + np.arange(self.batch)) % len(self.lengths)
        return self.lengths[at]

    def request(self, i: int) -> Dict[str, np.ndarray]:
        """The source ids and lengths of request ``i``, the same for every call."""
        rng = np.random.default_rng(text.seed_of(self.seed, 1, i))
        return text.sources(rng, self.lane_lengths(i))

    def encoder_seed(self, i: int) -> int:
        return text.seed_of(self.seed, 2, i)

    def decoder_seed(self, i: int) -> int:
        return text.seed_of(self.seed, 3, i)

    def cycle(self) -> int:
        """Requests after which the lanes' lengths repeat."""
        return len(self.lengths) // math.gcd(len(self.lengths), self.batch)


def requests(params: Dict, seed: int) -> Requests:
    return Requests(params, seed)
