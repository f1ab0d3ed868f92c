"""The port's convergence tools against the JAX package's ``scripts/convergence_*.py``.

* ``score_predictions`` (``tools/convergence_run.py``), ``mel_centroid`` and
  ``diagonality`` (``tools/convergence_matrix.py``) equal to the scripts' on the
  same files and arrays;
* ``export_params_npz``: a torch checkpoint of the weights of a flax init, exported,
  equal key for key and bit for bit to the JAX script's export of an orbax
  checkpoint of those weights, and read back by its ``load_variables_npz``;
* every family's ``ok`` predicate gives the recorded ``ok`` of
  ``artifacts/convergence_r5/matrix.json`` on its recorded numbers, and turns false
  where one of its conditions fails;
* each family's corpus variant (four speakers, accents, the ls family's lengths; a
  few utterances) as the JAX package writes it: the sources and lists byte for
  byte, the spectrograms as ``test_torch_text_data.py`` holds them;
* both tools end to end at tiny hparams on the CPU (3 training steps; 2 a family),
  giving every key of the JAX run's ``summary.json`` and of the r5 ``matrix.json``
  entries.

About 50 s on one worker, most of it the two tools end to end.
"""

import functools
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest

from self_attention_tacotron_tpu.data import dataset as jds
from self_attention_tacotron_tpu.data.synthetic import generate_corpus as jax_generate
from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.models.models import tacotron_model_factory as jax_factory

from self_attention_tacotron_torch import convert
from self_attention_tacotron_torch.data import dataset as ds
from self_attention_tacotron_torch.data.synthetic import generate_corpus
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.tools import convergence_matrix as matrix
from self_attention_tacotron_torch.tools import convergence_run as run
from self_attention_tacotron_torch.training import trainer as trainer_lib
from self_attention_tacotron_torch.training.metrics import MetricsWriter
from self_attention_tacotron_torch.training.trainer import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from scripts import convergence_matrix as jax_matrix  # noqa: E402
from scripts import convergence_run as jax_run  # noqa: E402

from test_torch_configs import NARROW  # noqa: E402
from test_torch_helpers import flat_variables  # noqa: E402
from test_torch_init import FAST_COMPILE  # noqa: E402
from test_torch_text_data import TOL_SPEC  # noqa: E402

R3_SUMMARY = os.path.join(REPO, "artifacts", "convergence_r3", "summary.json")
R5_MATRIX = os.path.join(REPO, "artifacts", "convergence_r5", "matrix.json")
# the tiny widths of the end-to-end runs (tests/test_torch_cli.py's, and small heads)
TINY = ("embedding_dim=16,encoder_prenet_out_units=16+8,cbhg_out_units=16,conv_channels=8,"
        "max_filter_width=3,projection1_out_channels=8,projection2_out_channels=8,num_highway=1,"
        "self_attention_out_units=16,self_attention_transformer_ffn_units=24,"
        "decoder_prenet_out_units=16+8,attention_out_units=16,attention1_out_units=12,"
        "attention2_out_units=4,decoder_out_units=16,decoder_self_attention_out_units=16,"
        "num_mels=8,sample_rate=8000,num_freq=129,frame_length_ms=32,frame_shift_ms=16,"
        "batch_size=4,batch_bucket_width=16,max_iters=20,num_mgcs=4,num_lf0s=16,"
        "save_checkpoints_steps=2,eval_start_delay_secs=0,eval_throttle_secs=0,"
        "num_evaluation_steps=1")


def _equal(a, b):
    """Dicts, lists and numbers equal, NaN equal to NaN."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return a == b and type(a) is type(b)


# ------------------------------- scoring ------------------------------- #


@pytest.fixture(scope="module")
def scored_corpus(tmp_path_factory):
    """A corpus at the flagship run's hparams, and predictions of other lengths for
    its validation utterances, one of them missing."""
    root = tmp_path_factory.mktemp("scored")
    data, lists, pred = str(root / "data"), str(root / "lists"), str(root / "pred")
    hp = run.flagship_run_hparams()
    generate_corpus(data, hp, num_utterances=40, min_symbols=4, max_symbols=8,
                    selected_list_dir=lists, device="cpu")
    os.makedirs(pred)
    rng = np.random.default_rng(4)
    ids = ds.read_selected_list(lists, "validation")
    assert len(ids) >= 2
    for i, utt in enumerate(ids[1:]):
        frames = ds.parse_target_tfrecord(os.path.join(data, f"{utt}.target.tfrecord")).target_length
        n = max(frames + (-3, 0, 5)[i % 3], 1)
        rng.standard_normal((n, hp.num_mels)).astype(np.float32).tofile(
            os.path.join(pred, f"{utt}.{hp.predicted_mel_extension}"))
    return data, lists, pred


def test_score_predictions_equals_the_scripts(scored_corpus):
    got = run.score_predictions(*scored_corpus)
    want = jax_run.score_predictions(*scored_corpus)
    assert got["n_scored"] == len(got["utterances"]) > 0
    assert _equal(got, want), (got, want)


def test_mel_centroid_and_diagonality_equal_the_scripts():
    rng = np.random.default_rng(5)
    for shape in ((40, 80), (7, 8), (1, 3)):
        mel = rng.standard_normal(shape).astype(np.float32)
        assert matrix.mel_centroid(mel) == jax_matrix.mel_centroid(mel)
    for src, dec in ((30, 50), (5, 3), (2, 9)):
        align = rng.random((dec + 4, src + 3)).astype(np.float32)
        assert matrix.diagonality(align, src, dec) == jax_matrix.diagonality(align, src, dec)


# ------------------------------- export ------------------------------- #


def test_export_equals_the_scripts(tmp_path):
    kw = dict(NARROW, tacotron_model="DualSourceSelfAttentionTacotronModel",
              encoder="SelfAttentionCBHGEncoder", decoder="DualSourceSelfAttentionDecoder",
              attention="forward", attention2="additive", use_pallas_kernels=False)
    jhp = JaxHParams(**kw)
    key = jax.random.PRNGKey(3)
    init = jax.jit(lambda: jax_factory(jhp).network(is_training=True).init(
        {"params": key, "dropout": key, "zoneout": key}, jnp.ones((2, 4), jnp.int32),
        jnp.full((2,), 4, jnp.int32), jnp.zeros((2, 4, jhp.num_mels)), jnp.full((2,), 4, jnp.int32)))
    variables = init.lower().compile(compiler_options=FAST_COMPILE)()
    # the batch statistics moved off their init values
    variables = dict(variables, batch_stats=jax.tree.map(lambda a: a + 0.25, variables["batch_stats"]))
    orbax_dir = str(tmp_path / "orbax")
    manager = ocp.CheckpointManager(orbax_dir)
    manager.save(7, args=ocp.args.StandardSave(dict(variables, step=7)))
    manager.wait_until_finished()
    want_npz = str(tmp_path / "jax.npz")
    assert jax_run.export_params_npz(orbax_dir, want_npz) == 7

    hp = HParams(**kw)
    net = tacotron_model_factory(hp).network(device="cpu")
    convert.load_state(net, convert.flax_to_torch_state(flat_variables(variables), hp, net))
    ckpt = str(tmp_path / "torch")
    CheckpointManager(ckpt).save(7, {"step": 7, "net": net.state_dict(), "optimizer": {}})
    got_npz = str(tmp_path / "port.npz")
    assert run.export_params_npz(ckpt, got_npz, hp) == 7
    with np.load(got_npz) as got, np.load(want_npz) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype == np.float32, k
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = jax_run.load_variables_npz(got_npz)
    assert jax.tree.structure(back) == jax.tree.structure(
        {c: variables[c] for c in ("params", "batch_stats")})
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree.leaves({c: variables[c] for c in ("params", "batch_stats")})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    digest = run.file_digest(got_npz)
    assert digest["bytes"] == os.path.getsize(got_npz) and len(digest["sha256"]) == 64


# ------------------------------ predicates ------------------------------ #

# one condition of each family's predicate, broken in the recorded numbers
BREAK = {
    "speaker": [("register_order_monotonic", False), ("centroid_correlation", 0.8),
                ("centroid_range_ratio", 0.5), ("final_loss", 9.0)],
    "accent": [("centroid_all_high", 19.5), ("final_loss", 9.0)],
    "mgclf0": [("heldout_lf0_frame_accuracy", 0.15), ("final_mgc_loss", 9.0),
               ("final_lf0_loss", 9.0)],
    "ls": [("median_diagonality", 0.9)],
    "postnet": [("final_linear_loss", 9.0), ("heldout_spec_mse", 0.003),
                ("griffin_lim_wav_finite", False)],
}


def test_predicates_give_r5s_ok():
    with open(R5_MATRIX) as f:
        recorded = json.load(f)
    assert sorted(recorded) == sorted(matrix.OK) == sorted(BREAK)
    for family, entry in recorded.items():
        assert matrix.OK[family](entry) == entry["ok"], family
        for key, value in BREAK[family]:
            changed = dict(entry, **{key: value})
            assert matrix.OK[family](changed) != entry["ok"], (family, key)


# ------------------------------- corpora ------------------------------- #


@pytest.mark.parametrize("family", ["speaker", "accent", "ls"])
def test_family_corpus_equals_jax(family, tmp_path):
    assert matrix.CORPUS == dict(num_utterances=192, min_symbols=17, max_symbols=24)
    assert matrix.FAMILY_CORPUS["ls"] == dict(num_utterances=1024, min_symbols=48, max_symbols=64)
    overrides = dict(matrix.COMMON, **matrix.FLAGSHIP)
    if family == "accent":
        overrides.update(encoder="SelfAttentionCBHGEncoderWithAccentType", use_accent_type="true",
                         num_accent_type="4", accent_type_offset="0")
    if family == "ls":
        overrides.update(tacotron_model="ExtendedTacotronV1Model", encoder="ZoneoutEncoderV1",
                         decoder="ExtendedDecoder", attention="location_sensitive")
    hp = matrix.hp_obj(overrides)
    jhp = JaxHParams()
    jhp.parse(",".join(f"{k}={v}" for k, v in overrides.items()))
    kw = {**matrix.CORPUS, **matrix.FAMILY_CORPUS[family], "num_utterances": 5}
    ids = generate_corpus(str(tmp_path / "port"), hp, **kw,
                          selected_list_dir=str(tmp_path / "port_lists"), device="cpu")
    jids = jax_generate(str(tmp_path / "jax"), jhp, **kw, selected_list_dir=str(tmp_path / "jax_lists"))
    assert ids == jids
    for name in ("train", "validation", "test"):
        assert (tmp_path / "port_lists" / f"{name}.lst").read_bytes() == \
            (tmp_path / "jax_lists" / f"{name}.lst").read_bytes()
    for utt in ids:
        src = f"{utt}.{hp.source_file_extension}"
        assert (tmp_path / "port" / src).read_bytes() == (tmp_path / "jax" / src).read_bytes()
        source = ds.parse_source_tfrecord(str(tmp_path / "port" / src))
        assert kw["min_symbols"] <= len(source.source) <= kw["max_symbols"] + 1
        got = ds.parse_target_tfrecord(str(tmp_path / "port" / f"{utt}.{hp.target_file_extension}"))
        want = jds.parse_target_tfrecord(str(tmp_path / "jax" / f"{utt}.{hp.target_file_extension}"))
        assert got.target_length == want.target_length
        np.testing.assert_allclose(got.mel, want.mel, atol=TOL_SPEC, rtol=0, err_msg=utt)
    if family == "speaker":
        speakers = [ds.parse_source_tfrecord(
            str(tmp_path / "port" / f"{u}.{hp.source_file_extension}")).speaker_id for u in ids]
        assert speakers == [i % 4 for i in range(len(ids))]


# ----------------------------- end to end ----------------------------- #


def _keys_cover(got, want, where=""):
    """Every key of ``want`` in ``got``, recursively through dicts (and the first row
    of the per-utterance lists)."""
    for k, v in want.items():
        assert k in got, f"{where}{k}"
        if isinstance(v, dict) and isinstance(got[k], dict) and not k.endswith("_by_speaker"):
            _keys_cover(got[k], v, f"{where}{k}.")
        if isinstance(v, list) and v and isinstance(v[0], dict):
            assert got[k], f"{where}{k}"
            _keys_cover(got[k][0], v[0], f"{where}{k}[0].")


@pytest.fixture
def quiet_metrics(monkeypatch):
    # the scalars go to metrics.jsonl alone: importing the TensorBoard writer takes seconds
    monkeypatch.setattr(trainer_lib, "MetricsWriter",
                        functools.partial(MetricsWriter, use_tensorboard=False))


def test_convergence_run_end_to_end(tmp_path, quiet_metrics):
    run_dir = str(tmp_path / "short")
    summary = run.main(["--run-dir", run_dir, "--steps", "3", "--num-utterances", "24",
                        "--hparams-extra", TINY + ",compute_dtype=float32", "--device", "cpu"])
    with open(R3_SUMMARY) as f:
        _keys_cover(summary, json.load(f))
    with open(os.path.join(run_dir, "summary.json")) as f:
        assert json.load(f)["checkpoint_step"] == summary["checkpoint_step"] == 3
    assert summary["npz"] == dict(path=summary["npz"]["path"],
                                  **run.file_digest(os.path.join(run_dir, "trained_params.npz")))
    prov = summary["provenance"]
    assert prov["platform"] == "cpu" and prov["gpu"] is None
    assert prov["train_path"] == "plain scan under autograd"
    assert prov["decode_path"] == "step-by-step loop"
    assert os.path.getsize(os.path.join(run_dir, "loss_curve.png")) > 0
    # a corpus of other arguments is refused
    with pytest.raises(SystemExit, match="was generated with"):
        run.main(["--run-dir", run_dir, "--long", "--num-utterances", "24", "--skip-train",
                  "--hparams-extra", TINY, "--device", "cpu"])
    # the long run from the short run's checkpoint, and the npz loads back
    long_dir = str(tmp_path / "long")
    summary = run.main(["--run-dir", long_dir, "--long", "--restore-from",
                        os.path.join(run_dir, "checkpoints"), "--steps", "2", "--min-symbols",
                        "20", "--max-symbols", "24", "--num-utterances", "24", "--score-draws",
                        "1", "--hparams-extra", TINY + ",compute_dtype=float32", "--device", "cpu"])
    assert summary["checkpoint_step"] == 2 and summary["corpus"]["min_symbols"] == 20
    assert [d["random_seed"] for d in summary["synthesis_draws"]] == [1235]
    hp = run.flagship_run_hparams()
    net = convert.load_npz(os.path.join(long_dir, "trained_params.npz"), hp, device="cpu")
    assert net.embedding.embedding.shape[1] == 16


def test_convergence_matrix_end_to_end(tmp_path, quiet_metrics, monkeypatch):
    monkeypatch.setattr(matrix, "CORPUS", dict(matrix.CORPUS, num_utterances=24))
    monkeypatch.setitem(matrix.FAMILY_CORPUS, "ls",
                        dict(num_utterances=24, min_symbols=20, max_symbols=24))
    out = str(tmp_path / "out")
    common = ["--steps", "2", "--hparams-extra", TINY + ",compute_dtype=float32",
              "--run-root", str(tmp_path / "runs"), "--out-dir", out, "--device", "cpu"]
    matrix.main(["--families", "speaker,accent"] + common)
    matrix.main(["--families", "mgclf0,ls,postnet"] + common)     # merged into the same file
    with open(os.path.join(out, "matrix.json")) as f:
        got = json.load(f)
    with open(R5_MATRIX) as f:
        want = json.load(f)
    assert sorted(got) == sorted(want)
    for family, entry in want.items():
        _keys_cover(got[family], entry, f"{family}.")
        assert got[family]["ok"] == matrix.OK[family](got[family])
        assert got[family]["checkpoint_step"] == 2
        assert got[family]["provenance"]["train_path"] == "plain scan under autograd"
    for png in ("speaker_swap", "accent_swap", "mgclf0_losses", "ls_alignments", "postnet_linear"):
        assert os.path.getsize(os.path.join(out, f"{png}.png")) > 0
    # a finished run is scored again without training
    matrix.main(["--families", "accent"] + common)
    with open(os.path.join(out, "matrix.json")) as f:
        again = json.load(f)["accent"]
    assert again["provenance"]["launches"]["training"] is None
    assert again["checkpoint_step"] == 2 and again["first_loss"] == got["accent"]["first_loss"]
