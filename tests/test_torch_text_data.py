"""Text, records, corpora and batches of the port against the JAX package, on the CPU.

* The English cleaners and the Japanese phoneme and accent encoding on seeded
  strings: exact.
* TFRecord and ``tf.train.Example`` bytes: the port writes the JAX package's bytes,
  and each decodes the other's.
* ``generate_corpus`` (tiny hparams, 8 utterances; with accents, two speakers, the
  WORLD heads and the linear spectrogram in the second case): ids, texts, sources,
  speakers, accents, lf0 and lists exact, mel and mgc within 1e-4, the linear
  spectrogram within 1e-4 where a bin is at least 1e-3 of its frame's peak and in
  amplitude to 1e-5 of that peak everywhere (``assert_spectrogram_close``).
* ``TacotronDataset`` of the port on a corpus that the JAX package wrote gives the
  same batches as JAX's, exactly: shuffled with repeat, eval padding, a selected
  list, and the cache file (each side's, and JAX's read by the port).
* The three recipes (LJSpeech, VCTK, Japanese) on tiny corpora fabricated here: the
  port's records against the JAX package's preprocessor on the same wavs.

About 25 s on one worker.
"""

import os

import numpy as np
import pytest
from scipy.io import wavfile

from self_attention_tacotron_tpu.data import dataset as jds
from self_attention_tacotron_tpu.data.corpus import write_selected_lists as jax_lists
from self_attention_tacotron_tpu.data.dataset_factory import dataset_factory as jax_factory
from self_attention_tacotron_tpu.data.synthetic import generate_corpus as jax_generate
from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.text import english as jeng
from self_attention_tacotron_tpu.text import japanese as jja
from self_attention_tacotron_tpu.utils import tfrecord as jtfr

from self_attention_tacotron_torch.data import dataset as ds
from self_attention_tacotron_torch.data.corpus import write_selected_lists
from self_attention_tacotron_torch.data.dataset_factory import dataset_factory
from self_attention_tacotron_torch.data.synthetic import generate_corpus
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.text import english, japanese
from self_attention_tacotron_torch.text import sequence_to_text, text_to_sequence
from self_attention_tacotron_torch.utils import tfrecord as tfr

TOL_SPEC = 1e-4
# A linear spectrogram's bins far below their frame's peak are float32 FFT rounding
# (the two packages' FFTs sum in other orders), which dB magnifies without bound as
# the magnitude falls: such bins are held in amplitude, to TOL_AMP of the frame's peak
# (a float32 normalized value carries the amplitude to about 1e-6 of itself).
TOL_AMP = 1e-5
QUIET = 1e-3

TINY = dict(sample_rate=8000, num_freq=129, frame_length_ms=32, frame_shift_ms=16, num_mels=10,
            num_mgcs=6, num_lf0s=8, batch_bucket_width=16, prefetch_buffer_size=2)
CORPORA = {
    "mel": (dict(), dict(num_speakers=1)),
    "world_accent_linear": (
        dict(tacotron_model="MgcLf0TacotronModel", decoder="MgcLf0Decoder",
             use_accent_type=True, num_accent_type=5, accent_type_offset=0,
             use_linear_spectrogram_postnet=True),
        dict(num_speakers=2, with_accent=True),
    ),
}


def _hparams(**kw):
    return HParams(**TINY, **kw), JaxHParams(**TINY, **kw)


def _strings(seed, n=40):
    rng = np.random.default_rng(seed)
    pieces = ["Dr.", "Mr.", "mrs.", "St.", "Capt.", "co.", "Ltd.", "12", "0", "1999", "1000001",
              "hello", "World", "  ", "\t", ",", "!", "?", "'", '"', "(x)", "a-b", ";:", "é", "#"]
    return ["".join(str(rng.choice(pieces)) + (" " if rng.random() < 0.6 else "")
                    for _ in range(rng.integers(1, 12))) for _ in range(n)]


# ------------------------------ text ------------------------------ #


def test_english_cleaners_and_ids_against_jax():
    for text in _strings(0):
        assert english.english_cleaners(text) == jeng.english_cleaners(text), text
        seq = text_to_sequence(text)
        assert seq == jeng.text_to_sequence(text), text
        assert text_to_sequence(text, append_eos=False) == jeng.text_to_sequence(text, False)
        assert sequence_to_text(seq) == jeng.sequence_to_text(seq)
    for n in (0, 7, 19, 20, 99, 100, 101, 999, 1000, 12345, 10**6 + 7, 10**9 + 1):
        assert english.spell_number(n) == jeng.spell_number(n)


def test_japanese_phonemes_and_accents_against_jax(tmp_path):
    rng = np.random.default_rng(1)
    phones = list(rng.choice(japanese.phonemes + ["?", "xx"], size=30))
    accents = [int(a) for a in rng.integers(0, 6, size=30)]
    assert japanese.phoneme_to_sequence(phones) == jja.phoneme_to_sequence(phones)
    for eos in (True, False):
        assert (japanese.encode_accent_types(accents, 0x3100, 0x3200, eos)
                == jja.encode_accent_types(accents, 0x3100, 0x3200, eos))
    path = tmp_path / "utt.lab"
    path.write_text("# header\n" + "\n".join(f"{p} {a}" for p, a in zip(phones, accents))
                    + "\npau\n\n")
    assert japanese.parse_label_file(str(path)) == jja.parse_label_file(str(path))


# ----------------------------- records ----------------------------- #


def _examples():
    rng = np.random.default_rng(2)
    return [
        {"id": b"utt-1", "text": "héllo", "source": rng.integers(0, 70, 17),
         "neg": np.array([-1, -(2**40), 2**62], np.int64)},
        {"mel": rng.standard_normal(60).astype(np.float32), "mel_width": np.array([6]),
         "empty": np.zeros(0, np.float32)},
    ]


def test_tfrecord_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    # the byte loop below 8 chunks of 512 bytes, the chunked numpy path from there on
    for n in (0, 1, 1000, 4095, 4096, 4097, 70001):
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        assert tfr.crc32c(data) == jtfr.crc32c(data), n
    assert tfr.crc32c(b"123456789") == 0xE3069283       # the CRC-32C check value
    for n in (0, 1, 127, 128, 300, 2**35, 2**64 - 1):
        assert tfr._varint(n) == jtfr._varint(n)
    records = [tfr.encode_example(e) for e in _examples()]
    assert records == [jtfr.encode_example(e) for e in _examples()]
    tfr.write_records(str(tmp_path / "port.tfrecord"), records + [b"", b"x" * 300])
    jtfr.write_records(str(tmp_path / "jax.tfrecord"), records + [b"", b"x" * 300])
    assert (tmp_path / "port.tfrecord").read_bytes() == (tmp_path / "jax.tfrecord").read_bytes()
    for mine, theirs in ((tfr, jtfr), (jtfr, tfr)):
        back = [mine.decode_example(r) for r in theirs.read_records(str(tmp_path / "jax.tfrecord"))
                if r and r[:1] != b"x"]
        for got, want in zip(back, _examples()):
            assert set(got) == set(want)
            for key, value in want.items():
                value = value.encode() if isinstance(value, str) else value
                if isinstance(value, bytes):
                    assert got[key] == value
                else:
                    np.testing.assert_array_equal(got[key], value)


def test_a_corrupt_record_raises_as_in_jax(tmp_path):
    path = str(tmp_path / "r.tfrecord")
    tfr.write_records(path, [b"payload"])
    raw = bytearray(open(path, "rb").read())
    raw[-6] ^= 1
    open(path, "wb").write(bytes(raw))
    for codec in (tfr, jtfr):
        with pytest.raises(IOError, match="corrupt data crc"):
            list(codec.read_records(path))


# ----------------------------- corpora ----------------------------- #


@pytest.fixture(scope="module", params=sorted(CORPORA))
def corpora(request, tmp_path_factory):
    """The same synthetic corpus written by both packages."""
    kw, gen = CORPORA[request.param]
    hp, jhp = _hparams(**kw)
    root = tmp_path_factory.mktemp(f"corpus_{request.param}")
    ids = generate_corpus(str(root / "port"), hp, num_utterances=8, min_symbols=4,
                          max_symbols=9, selected_list_dir=str(root / "port_lists"),
                          seed=77, device="cpu", **gen)
    jids = jax_generate(str(root / "jax"), jhp, num_utterances=8, min_symbols=4, max_symbols=9,
                        selected_list_dir=str(root / "jax_lists"), seed=77, **gen)
    return dict(name=request.param, root=root, hp=hp, jhp=jhp, ids=ids, jids=jids)


def test_generate_corpus_against_jax(corpora):
    root, hp = corpora["root"], corpora["hp"]
    assert corpora["ids"] == corpora["jids"] and len(corpora["ids"]) == 8
    assert sorted(os.listdir(root / "port")) == sorted(os.listdir(root / "jax"))
    for name in ("train", "validation", "test"):
        assert (root / "port_lists" / f"{name}.lst").read_text() == \
            (root / "jax_lists" / f"{name}.lst").read_text()
    checked = set()
    for utt in corpora["ids"]:
        src = f"{utt}.{hp.source_file_extension}"
        assert (root / "port" / src).read_bytes() == (root / "jax" / src).read_bytes(), utt
        got = ds.parse_target_tfrecord(str(root / "port" / f"{utt}.{hp.target_file_extension}"))
        want = jds.parse_target_tfrecord(str(root / "jax" / f"{utt}.{hp.target_file_extension}"))
        assert got.id == want.id and got.target_length == want.target_length
        for head in ("mel", "spec", "mgc"):
            if getattr(want, head) is None:
                assert getattr(got, head) is None
                continue
            checked.add(head)
            if head == "spec":
                assert_spectrogram_close(got.spec, want.spec, hp, f"{utt} spec")
            else:
                np.testing.assert_allclose(getattr(got, head), getattr(want, head),
                                           atol=TOL_SPEC, rtol=0, err_msg=f"{utt} {head}")
        if want.lf0 is not None:
            checked.add("lf0")
            np.testing.assert_array_equal(got.lf0, want.lf0)
    expected = {"mel"} if corpora["name"] == "mel" else {"mel", "spec", "mgc", "lf0"}
    assert checked == expected
    src = ds.parse_source_tfrecord(str(root / "port" / f"{corpora['ids'][1]}.source.tfrecord"))
    assert src.speaker_id == (1 if corpora["name"] != "mel" else 0)
    assert (src.accent_type is not None) == (corpora["name"] != "mel")


def assert_spectrogram_close(got, want, hp, err_msg=""):
    """Normalized spectrograms within TOL_SPEC wherever the amplitude is at least QUIET
    of its frame's peak; the amplitudes of every bin within TOL_AMP of that peak."""
    def amplitude(x):
        return 10.0 ** ((np.clip(x, 0, 1) * -hp.min_level_db + hp.min_level_db
                         + hp.ref_level_db) / 20.0)

    amp_got, amp_want = amplitude(got), amplitude(want)
    peak = amp_want.max(axis=-1, keepdims=True)
    excess = np.abs(amp_got - amp_want) / peak
    assert excess.max() <= TOL_AMP, (err_msg, float(excess.max()))
    loud = amp_want >= QUIET * peak
    assert loud.mean() > 0.05, err_msg   # a tone per segment: a few loud bins a frame
    np.testing.assert_allclose(got[loud], want[loud], atol=TOL_SPEC, rtol=0, err_msg=err_msg)


def _assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


BATCH_CASES = {
    "shuffle_repeat": dict(kw=dict(shuffle=True, repeat=True, seed=5), take=7),
    "eval_padding": dict(kw=dict(shuffle=False, repeat=False), take=None),
    "no_prefetch_keep_incomplete": dict(kw=dict(shuffle=True, repeat=False, seed=3, prefetch=0,
                                                drop_incomplete=False), take=None),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batches_of_a_jax_corpus_equal_jax(corpora, case):
    root, hp, jhp = corpora["root"], corpora["hp"], corpora["jhp"]
    spec = BATCH_CASES[case]
    mine = ds.TacotronDataset(str(root / "jax"), str(root / "jax"), hp)
    theirs = jds.TacotronDataset(str(root / "jax"), str(root / "jax"), jhp)
    got, want = mine.batches(3, **spec["kw"]), theirs.batches(3, **spec["kw"])
    if spec["take"]:
        got = [next(got) for _ in range(spec["take"])]
        want = [next(want) for _ in range(spec["take"])]
    _assert_same_batches(got, want)


def test_a_selected_list_gives_jax_batches(corpora):
    root, hp, jhp = corpora["root"], corpora["hp"], corpora["jhp"]
    ids = ds.read_selected_list(str(root / "jax_lists"), "train")
    assert ids == jds.read_selected_list(str(root / "jax_lists"), "train")
    mine = ds.TacotronDataset(str(root / "jax"), str(root / "jax"), hp, utterance_ids=ids)
    theirs = jds.TacotronDataset(str(root / "jax"), str(root / "jax"), jhp, utterance_ids=ids)
    assert mine.ids == theirs.ids == sorted(ids)
    _assert_same_batches(mine.batches(2, shuffle=True, seed=1), theirs.batches(2, shuffle=True,
                                                                               seed=1))
    with pytest.raises(FileNotFoundError, match="missing from corpus"):
        ds.TacotronDataset(str(root / "jax"), str(root / "jax"), hp, utterance_ids=["nope"])
    with pytest.raises(FileNotFoundError, match="no selected list"):
        ds.read_selected_list(str(root / "jax_lists"), "absent")


def test_the_cache_file_gives_jax_batches(corpora, tmp_path):
    root = corpora["root"]
    for who, mod, make in (("port", ds, HParams), ("jax", jds, JaxHParams)):
        hp = make(**TINY, use_cache=True, cache_file_name=str(tmp_path / f"{who}.cache"))
        mod.TacotronDataset(str(root / "jax"), str(root / "jax"), hp).save_file_cache()
    results = {}
    for who in ("port", "jax"):
        hp = HParams(**TINY, use_cache=True, cache_file_name=str(tmp_path / f"{who}.cache"))
        data = ds.TacotronDataset(str(root / "jax"), str(root / "jax"), hp)
        assert set(data._cache) == set(data.ids)
        assert all(type(p[0]) is ds.SourceData and type(p[1]) is ds.TargetData
                   for p in data._cache.values())
        results[who] = list(data.batches(3, shuffle=True, seed=2))
    jhp = JaxHParams(**TINY, use_cache=True, cache_file_name=str(tmp_path / "jax.cache"))
    want = list(jds.TacotronDataset(str(root / "jax"), str(root / "jax"), jhp).batches(
        3, shuffle=True, seed=2))
    _assert_same_batches(results["port"], want)
    _assert_same_batches(results["jax"], want)


def test_batch_helpers_and_lists_against_jax(tmp_path):
    for length, padded in ((5, 8), (1, 4), (0, 3), (8, 8)):
        np.testing.assert_array_equal(ds.make_done_targets(length, padded),
                                      jds.make_done_targets(length, padded))
    for t in (4, 5, 7):
        x = np.arange(t * 3, dtype=np.float32).reshape(t, 3)
        np.testing.assert_array_equal(ds.pad_to_multiple(x, 4), jds.pad_to_multiple(x, 4))
    ids = [f"u{i:03d}" for i in range(57)]
    write_selected_lists(str(tmp_path / "port"), ids, seed=9)
    jax_lists(str(tmp_path / "jax"), ids, seed=9)
    for name in ("train", "validation", "test"):
        assert (tmp_path / "port" / f"{name}.lst").read_text() == \
            (tmp_path / "jax" / f"{name}.lst").read_text()


# ----------------------------- recipes ----------------------------- #


def _wav(path, rng, sr, seconds=0.4, silence=0.1):
    n, pad = int(sr * seconds), int(sr * silence)
    tone = np.sin(2 * np.pi * rng.uniform(150, 900) * np.arange(n) / sr) * rng.uniform(0.2, 0.8)
    data = np.concatenate([np.zeros(pad), tone, np.zeros(pad)])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    wavfile.write(path, sr, (data * 32767).astype(np.int16))


def _fabricate(kind, root, sr):
    rng = np.random.default_rng({"ljspeech": 1, "vctk": 2, "japanese": 3}[kind])
    if kind == "ljspeech":
        rows = []
        for i in range(4):
            _wav(str(root / "wavs" / f"LJ{i:03d}.wav"), rng, sr)
            rows.append(f"LJ{i:03d}|Dr. Who, {i + 2} times|" + ("" if i % 2 else f"Doctor {i}"))
        rows.append("broken-line")
        (root / "metadata.csv").write_text("\n".join(rows) + "\n")
    elif kind == "vctk":
        for spk in ("p226", "p225"):
            for i in range(2):
                _wav(str(root / "wav48" / spk / f"{spk}_{i:03d}.wav"), rng, sr)
                os.makedirs(root / "txt" / spk, exist_ok=True)
                if i or spk == "p225":
                    (root / "txt" / spk / f"{spk}_{i:03d}.txt").write_text(f"Call {i} Mr. X.\n")
        _wav(str(root / "wav48" / "p225" / "short.wav"), rng, sr, seconds=0.01, silence=0.0)
        (root / "txt" / "p225" / "short.txt").write_text("x")
    else:
        os.makedirs(root / "labels")
        for i in range(3):
            _wav(str(root / "wav" / f"ja{i}.wav"), rng, sr)
            phones = rng.choice(japanese.phonemes[2:], size=5)
            (root / "labels" / f"ja{i}.lab").write_text(
                "\n".join(f"{p} {rng.integers(0, 4)}" for p in phones))
        (root / "transcript.txt").write_text("ja0|konnichiwa\nja2|sayounara\n")
        wavfile.write(str(root / "wav" / "other_rate.wav"), sr * 2, np.zeros(100, np.int16))
        (root / "labels" / "other_rate.lab").write_text("a 0\n")


@pytest.mark.parametrize("kind", ["ljspeech", "vctk", "japanese"])
def test_recipes_against_jax(kind, tmp_path):
    kw = dict(use_accent_type=True, num_accent_type=5) if kind == "japanese" else {}
    hp, jhp = _hparams(**kw)
    src = tmp_path / "in"
    _fabricate(kind, src, hp.sample_rate)
    pre = dataset_factory(kind)(str(src), str(tmp_path / "port"), hp, device="cpu")
    assert type(pre).__name__ == jax_factory(kind).__name__
    warnings = pre.preprocess(num_workers=2 if kind == "ljspeech" else 1)
    jwarnings = jax_factory(kind)(str(src), str(tmp_path / "jax"), jhp).preprocess(num_workers=1)
    assert warnings == jwarnings
    if kind != "ljspeech":
        assert warnings, "the fabricated corpus holds an utterance to skip"
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and names
    for name in names:
        if name.endswith(hp.source_file_extension):
            assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
        else:
            got = ds.parse_target_tfrecord(str(tmp_path / "port" / name))
            want = jds.parse_target_tfrecord(str(tmp_path / "jax" / name))
            assert got.target_length == want.target_length
            np.testing.assert_allclose(got.mel, want.mel, atol=TOL_SPEC, rtol=0)
    with pytest.raises(ValueError, match="unknown dataset"):
        dataset_factory("timit")
