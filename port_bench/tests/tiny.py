"""Narrow versions of the benchmark's configurations and mixes, for CPU tests.

The structure is each configuration's; the widths are a few units, the cap a few
steps, so that the harness, the program's plain paths and the reference run on
the CPU in seconds."""

from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

NARROW = {
    "num_symbols": 70, "embedding_dim": 16, "encoder_prenet_out_units": [16, 8],
    "cbhg_out_units": 16, "conv_channels": 8, "max_filter_width": 4,
    "projection1_out_channels": 8, "projection2_out_channels": 8,
    "self_attention_out_units": 16, "self_attention_transformer_ffn_units": 32,
    "decoder_prenet_out_units": [16, 8], "attention_out_units": 16,
    "attention1_out_units": 12, "attention2_out_units": 4, "decoder_out_units": 16,
    "decoder_self_attention_out_units": 16, "num_mels": 8, "num_freq": 9,
    "postnet_v2_out_channels": 16, "max_iters": 12,
}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def config(name: str, **overrides):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["hparams"].update(NARROW)
    cfg["hparams"].update(overrides)
    cfg["weights"] = {"seeded": True}
    return cfg


def traffic(name: str, **overrides):
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        mix = json.load(f)
    mix["batch"] = min(mix["batch"], 3)
    mix["symbols"] = dict(mix["symbols"], min=5, max=9, **({"median": 7} if "median" in mix["symbols"] else {}))
    if "pool" in mix:
        mix["pool"] = 12
    if "frames_per_symbol" in mix:
        mix["frames_per_symbol"] = 1.0
        mix["batches"] = 4
    mix.update(overrides)
    return mix
