"""The port's mesh (``parallel/mesh.py``) against the JAX package's, on the CPU.

* ``make_mesh``'s shapes and errors against JAX ``make_mesh`` on ``conftest.py``'s
  eight virtual devices (the port's layout for a world of eight ranks), and the
  mesh of one rank without a process group;
* ``shard_batch`` against JAX ``shard_batch`` on the same arrays: every rank's rows,
  the padding and its masked lengths, both warnings, replication, strings left on
  the host;
* ``param_sharding_rules`` against JAX's for every parameter of every
  ``configs/*.json`` network on meshes (4, 2) and (2, 2): the torch dimension the
  port splits (through ``convert.flax_layout``'s permutation; a flax kernel is
  (in, out), ``nn.Linear.weight`` (out, in)) is the one JAX's ``PartitionSpec``
  splits, and a leaf JAX replicates stays whole.

A few seconds on one worker.
"""

import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.parallel import mesh as jax_mesh

from self_attention_tacotron_torch import convert
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.ops.fused_teacher import hash_keep_masks, keep_threshold
from self_attention_tacotron_torch.parallel import mesh as mesh_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f[:-5] for f in os.listdir(os.path.join(REPO, "configs")) if f.endswith(".json"))


@pytest.mark.parametrize("shape", [(), (8,), (8, 1), (4, 2), (2, 4), (1, 8), (3, 2), (4, 4),
                                   (16,), (2, 2, 2)])
def test_make_mesh_shapes_and_errors_are_jax_s(shape):
    try:
        want = tuple(jax_mesh.make_mesh(shape).devices.shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_lib.mesh_layout(shape, 8)
        if len(shape) <= 2:
            assert str(got.value) == str(e)
        else:   # jax.sharding.Mesh refuses three axes with two names; the port says so
            assert "two axes" in str(got.value)
        return
    assert tuple(mesh_lib.mesh_layout(shape, 8)) == want


def test_a_mesh_of_one_rank_needs_no_process_group():
    assert not torch.distributed.is_initialized()
    mesh = mesh_lib.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device_mesh is None
    assert mesh.group("data") is None and mesh.group("model") is None
    with pytest.raises(ValueError) as got:
        mesh_lib.make_mesh((2, 1))
    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh((2, 1), devices=jax.devices()[:1])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("names", [("batch", "model"), ("data",), ("model", "data")])
def test_make_mesh_refuses_other_axis_names(names):
    with pytest.raises(ValueError, match="axes are"):
        mesh_lib.make_mesh((), axis_names=names)
    assert mesh_lib.make_mesh((), axis_names=("data", "model")).shape == {"data": 1, "model": 1}


def _batch(b, with_lengths=True, seed=0):
    rng = np.random.default_rng(seed)
    out = {
        "source": rng.integers(1, 30, (b, 7)).astype(np.int32),
        "source_lengths": rng.integers(2, 8, (b,)).astype(np.int32),
        "mel": rng.standard_normal((b, 6, 4)).astype(np.float32),
        "id": np.array([f"utt{i}" for i in range(b)]),
    }
    if with_lengths:
        out["target_lengths"] = rng.integers(1, 7, (b,)).astype(np.int32)
    return out


def _jax_shard(batch, mesh_shape, **kw):
    mesh = jax_mesh.make_mesh(mesh_shape, devices=jax.devices()[: int(np.prod(mesh_shape))])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = jax_mesh.shard_batch(batch, mesh, **kw)
    return out, [str(w.message) for w in caught]


def _port_shard(batch, mesh_shape, rank, **kw):
    mesh = mesh_lib.Mesh(tuple(mesh_shape), rank=rank)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = mesh_lib.shard_batch(batch, mesh, **kw)
    return out, [str(w.message) for w in caught]


@pytest.mark.parametrize("case", [
    dict(b=8, mesh=(4, 2)),                                   # divides
    dict(b=5, mesh=(2, 1)),                                   # padded
    dict(b=6, mesh=(4, 2)),                                   # padded by 2
    dict(b=5, mesh=(2, 1), with_lengths=False),               # replicated: no lengths
    dict(b=5, mesh=(2, 1), pad_to_data_axis=False),           # replicated: asked
    dict(b=3, mesh=(1, 2)),                                   # a model axis only
], ids=["divides", "pads", "pads_two", "no_lengths", "no_padding", "model_only"])
def test_shard_batch_is_jax_s(case):
    kw = {k: case[k] for k in ("pad_to_data_axis",) if k in case}
    batch = _batch(case["b"], case.get("with_lengths", True))
    want, want_warnings = _jax_shard(batch, case["mesh"], **kw)
    data, model = case["mesh"]
    for rank in range(data * model):
        got, got_warnings = _port_shard(batch, case["mesh"], rank, **kw)
        assert got_warnings == want_warnings
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["id"], batch["id"])   # strings stay on the host
        assert got["id"] is batch["id"]
        d = rank // model
        for key, value in want.items():
            if key == "id":
                continue
            whole = np.asarray(value)
            spec = tuple(value.sharding.spec)
            if spec and spec[0] == "data":
                n = whole.shape[0] // data
                np.testing.assert_array_equal(got[key], whole[d * n : (d + 1) * n], err_msg=key)
                assert key not in got.replicated
            else:
                np.testing.assert_array_equal(got[key], whole, err_msg=key)
                assert data == 1 or key in got.replicated
        assert got.data_parallel == (data > 1 and not got.replicated)
        if got.data_parallel:
            assert (got.row0, got.rows, got.global_rows) == (
                d * got.rows, np.asarray(want["source"]).shape[0] // data,
                np.asarray(want["source"]).shape[0])
    if case["b"] % data and "target_lengths" in batch and kw.get("pad_to_data_axis", True):
        padded = np.asarray(want["target_lengths"])
        assert (padded[case["b"]:] == 0).all()
        assert (np.asarray(want["source_lengths"])[case["b"]:] == 1).all()


def test_placements_are_jax_s():
    mesh = mesh_lib.Mesh((4, 2))
    jmesh = jax_mesh.make_mesh((4, 2))
    assert mesh_lib.replicated(mesh).spec == tuple(jax_mesh.replicated(jmesh).spec)
    for ndim in (1, 2, 3):
        assert mesh_lib.batch_sharding(mesh, ndim).spec == tuple(
            jax_mesh.batch_sharding(jmesh, ndim).spec)


def _config(name):
    with open(os.path.join(REPO, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CONFIGS)
def test_param_sharding_rules_of_every_config_are_jax_s(name):
    kw = _config(name)
    jax_model = jax_factory(JaxHParams(**kw))
    b, s, t = 2, 5, 6     # t: a multiple of every config's r (2 and 3)
    shapes = jax.eval_shape(lambda: jax_model.network(is_training=True).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "zoneout": jax.random.PRNGKey(2)},
        np.ones((b, s), np.int32), np.full((b,), s, np.int32),
        np.zeros((b, t, jax_model.hparams.num_mels), np.float32), np.full((b,), t, np.int32),
        **({"accent_type": np.ones((b, s), np.int32)} if kw.get("use_accent_type") else {}),
        **({"speaker_id": np.zeros((b,), np.int32)} if kw.get("use_speaker_embedding") else {}),
    ))["params"]
    jax_leaves = {
        "params/" + "/".join(str(getattr(k, "key", k)) for k in path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]
    }
    net = tacotron_model_factory(HParams(**kw)).network(device="cpu")
    for mesh_shape in ((4, 2), (2, 2)):
        jmesh = jax_mesh.make_mesh(mesh_shape, devices=jax.devices()[: int(np.prod(mesh_shape))])
        mesh = mesh_lib.Mesh(mesh_shape)
        dims = mesh_lib.model_split_dims(net, mesh)
        seen, split = set(), 0
        for pname, p in net.named_parameters():
            key, axes = convert.flax_layout(net, pname)
            leaf = jax_leaves[key]
            assert tuple(leaf.shape) == tuple(p.shape[a] for a in axes), key
            spec = tuple(jax_mesh.param_sharding_rules(key[len("params/"):], leaf, jmesh).spec)
            assert mesh_lib.param_sharding_rules(key, leaf, mesh).spec == spec, key
            if "model" in spec:
                assert dims[pname] == axes[spec.index("model")], key
                split += 1
            else:
                assert pname not in dims, key
            seen.add(key)
        assert seen == set(jax_leaves)
        assert split == len(dims) and split >= 2    # the embedding and the output projection


@pytest.mark.parametrize("lane0", [0, 1, 3, 5])
def test_hash_masks_with_lane0_are_rows_of_the_global_draw(lane0):
    whole = hash_keep_masks(12345, 7, 8, 6, 2, keep_threshold(0.3), "cpu")
    part = hash_keep_masks(12345, 7, 8 - lane0, 6, 2, keep_threshold(0.3), "cpu", lane0=lane0)
    assert torch.equal(part, whole[:, lane0:])
    if lane0 == 0:
        assert torch.equal(part, hash_keep_masks(12345, 7, 8, 6, 2, keep_threshold(0.3), "cpu"))
