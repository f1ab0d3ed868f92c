"""The port's TF-checkpoint converter against the JAX package's ``tools/convert_tf_checkpoint.py``.

A dict of fake TF variables (every name of the table, one of them missing) goes
through both converters: the same JAX paths, arrays and unresolved paths. The
port writes the flat npz layout and ``merge_into_state`` overlays it onto a
network as ``merge_into_params`` overlays the msgpack onto a params tree: the
mapped leaf loaded, a leaf of another shape and one absent from the model skipped
and reported (the mirror of ``tests/test_models.py::test_convert_checkpoint_merge_helper``).
A few seconds on one worker.
"""

import os
import sys

import numpy as np
import torch

from self_attention_tacotron_torch import convert
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import init_generator, tacotron_model_factory
from self_attention_tacotron_torch.tools import convert_tf_checkpoint as port_tool

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools import convert_tf_checkpoint as jax_tool  # noqa: E402

from test_torch_configs import NARROW  # noqa: E402


def fake_tf_variables(rng, drop=()):
    """One array per TF name of the table (its first candidate), shapes of the JAX leaf
    a flagship of narrow widths would hold; 1-d score vectors as TF keeps them."""
    tf_vars = {}
    for jax_path, candidates, transform in jax_tool.NAME_MAP:
        if jax_path in drop:
            continue
        shape = (7,) if transform == "expand_last" else (5, 3)
        tf_vars[candidates[-1]] = rng.standard_normal(shape).astype(np.float32)
    return tf_vars


def test_the_same_table():
    assert port_tool.NAME_MAP == jax_tool.NAME_MAP


def test_both_converters_give_the_same_arrays():
    rng = np.random.default_rng(0)
    tf_vars = fake_tf_variables(rng, drop=("decoder/prenet/Dense_1/bias",))
    tf_vars["unrelated/variable"] = np.ones((2,), np.float32)
    got, got_missing = port_tool.convert(tf_vars)
    want, want_missing = jax_tool.convert(tf_vars)
    assert got_missing == want_missing == ["decoder/prenet/Dense_1/bias"]
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert got["attention_0/attention_v"].shape == (7, 1)


def test_npz_layout(tmp_path):
    flat, _ = port_tool.convert(fake_tf_variables(np.random.default_rng(1)))
    path = str(tmp_path / "converted.npz")
    port_tool.save_npz(flat, path)
    with np.load(path) as archive:
        assert sorted(archive.files) == sorted(f"params/{k}" for k in flat)
        for key in flat:
            assert archive[f"params/{key}"].dtype == np.float32
            np.testing.assert_array_equal(archive[f"params/{key}"], flat[key])


def test_merge_into_state_reports_loaded_and_skipped(tmp_path):
    hp = HParams(**dict(NARROW, tacotron_model="DualSourceSelfAttentionTacotronModel",
                        encoder="SelfAttentionCBHGEncoder",
                        decoder="DualSourceSelfAttentionDecoder", attention="forward",
                        attention2="additive"))
    net = tacotron_model_factory(hp).network(device="cpu", generator=init_generator(1))
    before = convert.torch_to_flax_flat(net)
    table = before["params/embedding/embedding"]
    path = str(tmp_path / "donor.npz")
    np.savez(path, **{
        "params/embedding/embedding": np.ones_like(table),
        "params/decoder/prenet/Dense_0/kernel": np.ones((5, 5), np.float32),  # wrong shape
        "params/mystery/w": np.ones((1,), np.float32),                       # not in model
    })
    merged, loaded, skipped = port_tool.merge_into_state(net, path)
    after = convert.torch_to_flax_flat(merged)
    np.testing.assert_array_equal(after["params/embedding/embedding"], 1.0)
    np.testing.assert_array_equal(after["params/decoder/prenet/Dense_0/kernel"],
                                  before["params/decoder/prenet/Dense_0/kernel"])
    assert loaded == ["embedding/embedding"]
    assert any("shape" in s for s in skipped) and any("not in model" in s for s in skipped)
    assert all(torch.equal(torch.as_tensor(after[k]), torch.as_tensor(v))
               for k, v in before.items() if k != "params/embedding/embedding")
