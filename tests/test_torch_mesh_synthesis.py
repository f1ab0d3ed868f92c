"""Data-parallel synthesis (``make_sharded_predict_fn``) against the JAX package's, on the CPU.

Two gloo ranks, spawned through ``parallel.spawn`` (``tests/torch_mesh_workers.py``,
no JAX), against JAX ``make_sharded_predict_fn`` on a mesh of two of
``conftest.py``'s virtual devices, both with the step-by-step loop
(``use_fused=False``), the same weights (flax init through ``convert``) and a stop
threshold at which the lanes stop at different steps:

* prenet rate 0; then rate 0.5 with the decoder prenet masks drawn as JAX's
  shards draw them (each shard (max_iters, B/2, units) from the same key) and
  handed to the port's ranks: floats within ``tests/test_torch_synthesis.py``'s
  1e-4, lengths, flags and ``num_steps`` exact;
* the ``ValueError`` JAX raises for a batch that does not divide the data axis;
* ``predict_mel.main`` at world 2 writes the files it writes at world 1
  (``SATT_PLATFORM=cpu``, ``tests/test_torch_cli.py``'s ``TINY`` hparams with every
  dropout rate 0: with dropout on, each shard draws its own masks, as in JAX).

About 90 s on one worker (two JAX compilations a case, three spawns of two ranks).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.parallel import mesh as jax_mesh
from self_attention_tacotron_tpu.synthesis import make_sharded_predict_fn as jax_sharded

from self_attention_tacotron_torch import convert, preprocess
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.parallel import spawn
from self_attention_tacotron_torch.training.trainer import Trainer

import torch_mesh_workers as workers
from test_torch_cli import _hp_string, _hparams
from test_torch_helpers import flat_variables
from test_torch_synthesis import MAX_ITERS, _threshold_with_early_exit

B, S = 4, 9
ATOL = 1e-4


def _kw(rate):
    return dict(workers.NARROW, encoder_prenet_drop_rate=0.0, decoder_prenet_drop_rate=rate)


def _batch():
    rng = np.random.default_rng(7)
    return {"source": rng.integers(1, 30, size=(B, S)).astype(np.int32),
            "source_lengths": np.array([9, 4, 7, 6], np.int32)}


def _jax_masks(rng, hp):
    # what each of JAX's shards draws: (max_iters, B / 2, units) from the replicated key
    _, dec_rng = jax.random.split(rng)
    keep = 1.0 - hp.decoder_prenet_drop_rate
    keys = jax.random.split(dec_rng, len(hp.decoder_prenet_out_units) + 1)
    return tuple(np.asarray(jax.random.bernoulli(k, keep, (MAX_ITERS, B // 2, units)))
                 for k, units in zip(keys[:-1], hp.decoder_prenet_out_units))


@pytest.fixture(scope="module", params=[0.0, 0.5], ids=["rate0", "masks"])
def runs(request):
    rate = request.param
    hp = JaxHParams(**_kw(rate))
    model = jax_factory(hp)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = dict(model.network(is_training=True).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "zoneout": jax.random.PRNGKey(2)},
        jbatch["source"], jbatch["source_lengths"], jnp.zeros((B, 4, hp.num_mels), jnp.float32),
        jnp.full((B,), 4, jnp.int32)))
    mesh = jax_mesh.make_mesh((2, 1), devices=jax.devices()[:2])
    hp.stop_token_threshold = 2.0
    probe = jax_sharded(jax_factory(hp), mesh, max_iters=MAX_ITERS, use_fused=False)
    for seed in range(11, 30):      # the first key whose lanes a threshold separates
        rng = jax.random.PRNGKey(seed)
        try:
            threshold = _threshold_with_early_exit(
                np.asarray(probe(variables, jbatch, rng)["stop_probs"]))
            break
        except AssertionError:
            continue
    hp.stop_token_threshold = threshold
    predict = jax_sharded(jax_factory(hp), mesh, max_iters=MAX_ITERS, use_fused=False)
    want = jax.tree.map(np.asarray, predict(variables, jbatch, rng))
    with pytest.raises(ValueError) as error:
        predict(variables, {k: v[:-1] for k, v in jbatch.items()}, rng)

    kw = dict(_kw(rate), stop_token_threshold=hp.stop_token_threshold)
    net = tacotron_model_factory(HParams(**kw)).network(device="cpu")
    state = convert.flax_to_torch_state(flat_variables(variables), HParams(**kw), net)
    masks = _jax_masks(rng, hp) if rate > 0 else None
    got = spawn(workers.sharded_predict, 2, (kw, state, batch, MAX_ITERS, masks))
    return dict(want=want, got=got, error=str(error.value))


def test_sharded_predict_is_jax_s(runs):
    want = runs["want"]
    assert len(set(want["lengths"].tolist())) > 1 and int(want["num_steps"]) < MAX_ITERS
    for rank in runs["got"]:      # every rank returns the global batch's dictionary
        got = rank["out"]
        for key in ("mel", "stop_probs"):
            np.testing.assert_allclose(got[key].numpy(), want[key], atol=ATOL, rtol=0,
                                       err_msg=key)
        for name in ("alignments", "encoder_sa_alignments"):
            assert len(got[name]) == len(want[name])
            for g, w in zip(got[name], want[name]):
                np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_array_equal(got["lengths"].numpy(), want["lengths"])
        np.testing.assert_array_equal(got["finished"].numpy(), want["finished"])
        assert int(got["num_steps"]) == int(want["num_steps"])


def test_a_batch_that_does_not_divide_raises_jax_s_error(runs):
    assert runs["error"] == "batch 3 must divide the data axis (2)"
    for rank in runs["got"]:
        assert rank["error"] == runs["error"]


NO_DROPOUT = dict(decoder_prenet_drop_rate=0.0, encoder_prenet_drop_rate=0.0)


def test_predict_mel_at_world_2_writes_what_world_1_writes(tmp_path, monkeypatch):
    monkeypatch.setenv("SATT_PLATFORM", "cpu")
    hp_string = _hp_string(**NO_DROPOUT)
    data, lists, ckpt = (str(tmp_path / d) for d in ("data", "lists", "ckpt"))
    preprocess.main(["synthetic", str(tmp_path / "unused"), data, "--num-workers=1",
                     f"--hparams={hp_string}", f"--write-selected-lists={lists}"])
    model = tacotron_model_factory(_hparams(**NO_DROPOUT))
    trainer = Trainer(model, ckpt, device="cpu")
    trainer.save(trainer.init_state())
    outs = {}
    for world in (1, 2):
        out = str(tmp_path / f"pred{world}")
        argv = [f"--source-data-root={data}", f"--checkpoint-dir={ckpt}", f"--output-dir={out}",
                f"--selected-list-dir={lists}", "--test-list-filename=validation",
                "--batch-size=2", f"--hparams={hp_string}"]
        if world == 1:
            frames = [workers.predict_mel_main(argv)]
        else:
            frames = spawn(workers.predict_mel_main, 2, (argv,))
        assert all(f == frames[0] for f in frames) and frames[0]
        outs[world] = out
    names = sorted(os.listdir(outs[1]))
    assert names == sorted(os.listdir(outs[2]))
    mels = [n for n in names if n.endswith(".mfbsp")]
    assert mels
    for name in mels:
        one = np.fromfile(os.path.join(outs[1], name), np.float32)
        two = np.fromfile(os.path.join(outs[2], name), np.float32)
        assert one.shape == two.shape, name
        np.testing.assert_allclose(two, one, atol=ATOL, rtol=0, err_msg=name)
