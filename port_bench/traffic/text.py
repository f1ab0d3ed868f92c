"""The text and the lengths that every generator draws from.

A frozen copy of the program's synthetic text draw (``data/synthetic.py``: 26
letters and a space) and of its symbol mapping (``text/symbols.py``,
``text/english.py``: lower case, runs of spaces collapsed, stripped, an end
symbol appended), so that the benchmark's inputs do not move with the program.

Lengths come from a fixed pool per mix: the quantiles of the mix's
distribution, the same set for every seed; a seed shuffles the pool and draws
the letters. So two seeds do the same amount of work in another order.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np

SYMBOLS = ["_", "~"] + list("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!'\"(),-.:;? ")
SYMBOL_ID = {s: i for i, s in enumerate(SYMBOLS)}
EOS_ID = SYMBOL_ID["~"]
ALPHABET = "abcdefghijklmnopqrstuvwxyz "
LETTERS = ALPHABET[:26]


def seed_of(*path: int) -> int:
    """A 63-bit seed derived from ``path`` (the run's seed, then indices)."""
    state = np.random.SeedSequence([int(p) for p in path]).generate_state(1, np.uint64)
    return int(state[0]) & (2**63 - 1)


def length_pool(spec: Dict, size: int) -> List[int]:
    """``size`` symbol counts at the quantiles (i + 0.5) / size of ``spec``'s
    distribution: ``{"dist": "lognormal", "median", "sigma", "min", "max"}`` or
    ``{"dist": "uniform", "min", "max"}``, clipped to [min, max]."""
    lo, hi = int(spec["min"]), int(spec["max"])
    out = []
    for i in range(size):
        q = (i + 0.5) / size
        if spec["dist"] == "lognormal":
            value = math.exp(math.log(spec["median"]) + spec["sigma"] * NormalDist().inv_cdf(q))
            out.append(int(round(value)))
        elif spec["dist"] == "uniform":
            out.append(lo + int(q * (hi - lo + 1)))
        else:
            raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [min(max(n, lo), hi) for n in out]


def encode(text: str) -> List[int]:
    """The program's English frontend on this alphabet: collapse, strip, map, end symbol."""
    cleaned = " ".join(text.lower().split())
    return [SYMBOL_ID[c] for c in cleaned if c in SYMBOL_ID] + [EOS_ID]


def utterance(rng: np.random.Generator, symbols: int) -> np.ndarray:
    """Ids of ``symbols`` symbols, the end symbol last: letters and spaces drawn
    from ``rng``; where collapsing spaces shortens the text, letters drawn after
    it make up the count."""
    chars = rng.integers(0, len(ALPHABET), size=symbols - 1)
    ids = encode("".join(ALPHABET[c] for c in chars))[:-1]
    while len(ids) < symbols - 1:
        ids.append(SYMBOL_ID[LETTERS[int(rng.integers(0, 26))]])
    return np.asarray(ids + [EOS_ID], np.int64)


def sources(rng: np.random.Generator, lengths) -> Dict[str, np.ndarray]:
    """A batch of utterances of ``lengths`` symbols, zero beyond each lane's."""
    lengths = np.asarray(lengths, np.int64)
    out = np.zeros((len(lengths), int(lengths.max())), np.int64)
    for lane, n in enumerate(lengths):
        out[lane, :n] = utterance(rng, int(n))
    return {"source": out, "source_lengths": lengths}
