"""The port's three command lines, on the CPU (``SATT_PLATFORM=cpu``), at tiny hparams.

``python -m self_attention_tacotron_torch.preprocess synthetic`` writes a corpus and
its lists, ``train`` takes 2 steps (checkpoints, metrics, PNGs), ``predict_mel``
synthesizes the validation list. Each ``.mfbsp`` equals ``make_predict_fn`` on the
network that ``restore_inference`` gives, with the same generator, exactly; the
preprocessed corpus equals the JAX package's ``preprocess.py`` on the same hparams
(sources exact, mels to 1e-4). Forced alignment writes its warning and note,
``--write-wav`` writes wavs through Griffin-Lim and is refused without the linear
postnet, the CLI's main path is ``python -m``, and without the variable and without a
card the CLIs fail naming CUDA.

About 45 s on one worker.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.data import dataset as jds
from self_attention_tacotron_tpu.data.synthetic import generate_corpus as jax_generate
from self_attention_tacotron_tpu.hparams import default_hparams as jax_default_hparams

from self_attention_tacotron_torch import predict_mel, preprocess, train
from self_attention_tacotron_torch.data import dataset as ds
from self_attention_tacotron_torch.data.dataset import TacotronDataset, read_selected_list
from self_attention_tacotron_torch.hparams import default_hparams
from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.synthesis import make_predict_fn
from self_attention_tacotron_torch.training.trainer import Trainer, step_generator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(
    tacotron_model="DualSourceSelfAttentionTacotronModel", encoder="SelfAttentionCBHGEncoder",
    decoder="DualSourceSelfAttentionDecoder", attention="forward", attention2="additive",
    num_symbols=70, embedding_dim=16, encoder_prenet_out_units="16+8", cbhg_out_units=16,
    conv_channels=8, max_filter_width=3, projection1_out_channels=8, projection2_out_channels=8,
    num_highway=1, self_attention_out_units=16, self_attention_transformer_ffn_units=24,
    decoder_prenet_out_units="16+8", attention_out_units=16, attention1_out_units=12,
    attention2_out_units=4, decoder_out_units=16, decoder_self_attention_out_units=16,
    num_mels=8, sample_rate=8000, num_freq=129, frame_length_ms=32, frame_shift_ms=16,
    batch_size=4, batch_bucket_width=16, max_iters=20, save_checkpoints_steps=1,
    alignment_save_steps=2, eval_start_delay_secs=0, eval_throttle_secs=0,
    num_evaluation_steps=1,
)


def _hp_string(**extra):
    return ",".join(f"{k}={v}" for k, v in dict(TINY, **extra).items())


def _hparams(**extra):
    hp = default_hparams()
    hp.parse(_hp_string(**extra))
    return hp


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """preprocess -> train (2 steps) -> predict_mel, in this process, on the CPU."""
    root = tmp_path_factory.mktemp("cli")
    env = pytest.MonkeyPatch()
    env.setenv("SATT_PLATFORM", "cpu")
    try:
        data, lists, ckpt, pred = (str(root / d) for d in ("data", "lists", "ckpt", "pred"))
        warnings = preprocess.main(["synthetic", str(root / "unused"), data, "--num-workers=1",
                                    f"--hparams={_hp_string()}", f"--write-selected-lists={lists}"])
        state = train.main([f"--source-data-root={data}", f"--checkpoint-dir={ckpt}",
                            f"--selected-list-dir={lists}", "--steps=2",
                            f"--hparams={_hp_string()}"])
        written = predict_mel.main([f"--source-data-root={data}", f"--checkpoint-dir={ckpt}",
                                    f"--output-dir={pred}", f"--selected-list-dir={lists}",
                                    "--test-list-filename=validation", "--batch-size=2",
                                    f"--hparams={_hp_string()}"])["frames"]
    finally:
        env.undo()
    return dict(root=root, data=data, lists=lists, ckpt=ckpt, pred=pred, state=state,
                written=written, warnings=warnings)


def test_preprocess_writes_jax_s_corpus(chain, tmp_path):
    assert chain["warnings"] == []
    jhp = jax_default_hparams()
    jhp.parse(_hp_string())
    jax_generate(str(tmp_path / "jax"), jhp)            # what JAX's SyntheticCorpus runs
    names = sorted(os.listdir(chain["data"]))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 64
    for name in names:
        if name.endswith(".source.tfrecord"):
            assert open(os.path.join(chain["data"], name), "rb").read() == \
                (tmp_path / "jax" / name).read_bytes()
        else:
            got = ds.parse_target_tfrecord(os.path.join(chain["data"], name)).mel
            want = jds.parse_target_tfrecord(str(tmp_path / "jax" / name)).mel
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for name in ("train", "validation", "test"):
        assert read_selected_list(chain["lists"], name)


def test_train_leaves_checkpoints_metrics_and_pngs(chain):
    assert chain["state"].step == 2
    names = sorted(os.listdir(chain["ckpt"]))
    assert {"ckpt-00000001.pt", "ckpt-00000002.pt", "checkpoints.json", "log.txt"} <= set(names)
    log = os.listdir(os.path.join(chain["ckpt"], "log"))
    assert "metrics.jsonl" in log and "train_alignment_step00000002.png" in log
    assert any(n.startswith("alignment_step00000002") for n in log)   # the evaluation's


def test_mfbsp_files_equal_make_predict_fn_on_the_restored_network(chain):
    hp = _hparams()
    ids = read_selected_list(chain["lists"], "validation")
    assert sorted(chain["written"]) == sorted(ids)
    state = Trainer(tacotron_model_factory(hp), chain["ckpt"], device="cpu").restore_inference()
    assert state.step == 2
    predict = make_predict_fn(state.net, device="cpu")
    data = TacotronDataset(chain["data"], chain["data"], hp, utterance_ids=ids)
    seen = set()
    for index, batch in enumerate(data.batches(2, shuffle=False, repeat=False,
                                               drop_incomplete=False, prefetch=0)):
        out = predict({"source": batch["source"], "source_lengths": batch["source_lengths"]},
                      step_generator(hp.random_seed, index, device="cpu"))
        for i, utt in enumerate(batch["id"]):
            if utt in seen:
                continue
            seen.add(utt)
            n = int(out["lengths"][i])
            assert chain["written"][utt] == n
            got = np.fromfile(os.path.join(chain["pred"], f"{utt}.mfbsp"), np.float32)
            np.testing.assert_array_equal(got.reshape(n, hp.num_mels), out["mel"][i, :n].numpy())
            for suffix in ("_alignment.png", "_mel.png"):
                assert os.path.getsize(os.path.join(chain["pred"], utt + suffix)) > 0
    assert seen == set(ids)


def test_forced_alignment_and_wavs(chain, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SATT_PLATFORM", "cpu")
    common = [f"--source-data-root={chain['data']}", f"--checkpoint-dir={chain['ckpt']}",
              f"--selected-list-dir={chain['lists']}", "--test-list-filename=test"]
    forced = predict_mel.main(common + [f"--output-dir={tmp_path / 'forced'}",
                                        f"--hparams={_hp_string(use_forced_alignment_mode='true')}"])
    forced = forced["frames"]
    assert "use_forced_alignment_mode uses RECONSTRUCTED" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "forced" / "FORCED_ALIGNMENT_NOTE.txt")
    assert sorted(forced) == sorted(read_selected_list(chain["lists"], "test"))
    for utt in forced:
        assert os.path.exists(tmp_path / "forced" / f"{utt}.mfbsp")
    with pytest.raises(SystemExit, match="requires --hparams=use_linear_spectrogram_postnet"):
        predict_mel.main(common + [f"--output-dir={tmp_path / 'x'}", "--write-wav",
                                   f"--hparams={_hp_string()}"])
    # the linear postnet: its own short run, then wavs through Griffin-Lim
    linear = _hp_string(use_linear_spectrogram_postnet="true", griffin_lim_iters=2)
    ckpt = str(tmp_path / "linear_ckpt")
    train.main([f"--source-data-root={chain['data']}", f"--checkpoint-dir={ckpt}", "--steps=1",
                f"--selected-list-dir={chain['lists']}", f"--hparams={linear}"])
    written = predict_mel.main([f"--source-data-root={chain['data']}", f"--checkpoint-dir={ckpt}",
                                f"--output-dir={tmp_path / 'wav'}", "--write-wav",
                                f"--selected-list-dir={chain['lists']}",
                                "--test-list-filename=test", f"--hparams={linear}"])["frames"]
    for utt, n in written.items():
        size = os.path.getsize(tmp_path / "wav" / f"{utt}.wav")
        assert size == 44 + 2 * n * _hparams().hop_length


def test_without_a_card_and_without_the_variable_the_clis_name_cuda(chain, tmp_path,
                                                                    monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is allowed to work")
    monkeypatch.delenv("SATT_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        preprocess.main(["synthetic", "in", str(tmp_path / "out"), f"--hparams={_hp_string()}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main([f"--source-data-root={chain['data']}", f"--checkpoint-dir={tmp_path / 'c'}",
                    f"--hparams={_hp_string()}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        predict_mel.main([f"--source-data-root={chain['data']}", f"--checkpoint-dir={chain['ckpt']}",
                          f"--output-dir={tmp_path / 'p'}", f"--hparams={_hp_string()}"])
    monkeypatch.setenv("SATT_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="SATT_PLATFORM"):
        train.main([f"--source-data-root={chain['data']}", f"--checkpoint-dir={tmp_path / 'c'}"])
    # and as `python -m`: the command line names CUDA and exits with an error
    env = {k: v for k, v in os.environ.items() if k not in ("SATT_PLATFORM", "PYTHONPATH")}
    out = subprocess.run([sys.executable, "-m", "self_attention_tacotron_torch.preprocess",
                          "synthetic", "in", str(tmp_path / "out")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "CUDA" in out.stderr
