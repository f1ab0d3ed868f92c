"""The traffic generators: a seed gives the same traffic twice, another seed other
traffic over the same set of lengths, and the lengths keep the stated ranges."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT
from port_bench.traffic import synthesis, text, training

MIXES = os.path.join(ROOT, "port_bench", "traffic")


def mix(name):
    with open(os.path.join(MIXES, name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,lo,hi", [("synth-batch32", 17, 152), ("request-b1", 17, 152),
                                        ("synth-batch64", 300, 400)])
def test_synthesis_requests_repeat_and_keep_their_range(name, lo, hi):
    params = mix(name)
    a, b = synthesis.requests(params, 2**31 + 5), synthesis.requests(params, 2**31 + 5)
    other = synthesis.requests(params, 7)
    for i in (0, 1, 37):
        x, y, z = a.request(i), b.request(i), other.request(i)
        assert np.array_equal(x["source"], y["source"])
        assert x["source"].shape[0] == params["batch"]
        lengths = x["source_lengths"]
        assert lengths.min() >= lo and lengths.max() <= hi
        for lane, n in enumerate(lengths):
            ids = x["source"][lane]
            assert ids[n - 1] == text.EOS_ID and (ids[: n - 1] >= 28).all() and (ids[n:] == 0).all()
            assert (ids[: n - 1] < 70).all()
    assert any(not np.array_equal(a.request(i)["source"], other.request(i)["source"])
               for i in range(3))
    assert a.encoder_seed(3) == b.encoder_seed(3) != other.encoder_seed(3)
    assert sorted(a.lengths.tolist()) == sorted(other.lengths.tolist())


def test_length_pools_follow_the_stated_distributions():
    pool = text.length_pool({"dist": "lognormal", "median": 90, "sigma": 0.35, "min": 17,
                             "max": 152}, 1024)
    assert min(pool) >= 17 and max(pool) == 152 and abs(np.median(pool) - 90) <= 1
    flat = text.length_pool({"dist": "uniform", "min": 300, "max": 400}, 1024)
    assert min(flat) == 300 and max(flat) == 400 and abs(np.mean(flat) - 350) < 1


def test_training_batches_repeat_and_frame_their_targets():
    params = mix("train-batch32")
    one = training.batches(params, 11, 80, 2, "cpu")
    two = training.batches(params, 11, 80, 2, "cpu")
    other = training.batches(params, 12, 80, 2, "cpu")
    assert len(one) == params["batches"]
    for x, y in zip(one, two):
        for key in x:
            assert torch.equal(x[key], y[key])
    assert not torch.equal(one[0]["mel"][:, :4], other[0]["mel"][:, :4])
    rows = [tuple(b["source"][i, : int(b["source_lengths"][i])].tolist())
            for b in one for i in range(b["source"].shape[0])]
    assert len(set(rows)) == len(rows)
    for b in one:
        frames, symbols = b["target_lengths"], b["source_lengths"]
        assert (frames % 2 == 0).all() and (frames >= 6.4 * symbols).all()
        assert (frames < 6.4 * symbols + 2).all()
        assert b["mel"].shape[1] == int(frames.max())
        t = torch.arange(b["mel"].shape[1])
        assert (b["mel"][t[None, :] >= frames[:, None]] == 0).all()
        assert torch.equal(b["done"], (t[None, :] >= frames[:, None] - 1).float())
        assert int(symbols.min()) >= 17 and int(symbols.max()) <= 152
