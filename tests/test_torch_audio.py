"""The port's audio frontend (torch DSP and ``Audio``) against the JAX package's, on the CPU.

Seeded wavs (noise, and tones with silence) through every function of ``dsp``; the
tolerances, absolute unless said:

* window and filterbank: exact (both are numpy); framing: exact (an index gather);
  the trim: exact;
* the complex STFT and the inverse STFT, pre-emphasis and its inverse: 1e-5 of the
  largest magnitude (float32 sums of up to n_fft terms in another order);
* the normalized spectrograms (linear and mel, min/ref-level and standardized) and
  the dB maps: 1e-4 of their [0, 1] or dB range, on noise, whose bins all stand far
  above float32 rounding (``test_torch_text_data.py`` holds tones' spectrograms);
* Griffin-Lim with JAX's start phases (``jax.random.uniform`` of its key 0), the
  function and ``Audio.inv_spectrogram``: 1e-4 of the peak; on a flat spectrogram
  (clamped at the dB floor, as a seeded decoder's is), where float32 rounding moves the
  waveform far more than on a tone (JAX's complex64 result printed), the port's float64
  iterations against a numpy float64 Griffin-Lim: 1e-6 of the peak;
* wav I/O: the bytes JAX writes, and the samples each reads;
* the mel statistics: the same validation errors, the standardized path invertible.

About 10 s on one worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from self_attention_tacotron_tpu.audio import Audio as JaxAudio
from self_attention_tacotron_tpu.audio import dsp as jdsp
from self_attention_tacotron_tpu.hparams import HParams as JaxHParams

from self_attention_tacotron_torch.audio import Audio, dsp
from self_attention_tacotron_torch.hparams import HParams

TOL_FRAMING = 1e-5
TOL_SPEC = 1e-4
TOL_GL = 1e-4
SMALL = dict(sample_rate=8000, num_freq=129, frame_length_ms=32, frame_shift_ms=16, num_mels=12,
             griffin_lim_iters=8)


def _noise(seed, n=4000, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _tone(seed, sr=8000, seconds=0.5, silence=(900, 1300)):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    wav = np.sin(2 * np.pi * rng.uniform(200, 1000) * t) * 0.5
    return np.concatenate([np.zeros(silence[0]), wav, np.zeros(silence[1])]).astype(np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return np.asarray(x)


def test_windows_and_filterbank_are_jax_s():
    for win, n_fft in ((400, 512), (512, 512), (1200, 2048), (7, 16)):
        np.testing.assert_array_equal(dsp.hann_window(win, n_fft), jdsp.hann_window(win, n_fft))
    for args in ((8000, 256, 12, 0.0, 0.0), (22050, 2048, 80, 125.0, 7600.0), (16000, 512, 40)):
        np.testing.assert_array_equal(dsp.mel_filterbank(*args), jdsp.mel_filterbank(*args))


@pytest.mark.parametrize("n", [4000, 700, 3])
def test_framing_against_jax(n):
    """Reflect padding as numpy's, also where the pad outgrows the signal."""
    wav = _noise(n, n)
    for n_fft, hop in ((512, 128), (2048, 300)):
        got = dsp.frame_signal(_t(wav), n_fft, hop).numpy()
        want = _np(jdsp.frame_signal(jnp.asarray(wav), n_fft, hop))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=TOL_FRAMING, rtol=0)


def test_stft_istft_and_preemphasis_against_jax():
    wav = _noise(1)
    spec = _np(jdsp.stft(jnp.asarray(wav), 512, 128, 400))
    got = dsp.stft(_t(wav), 512, 128, 400).numpy()
    peak = float(np.abs(spec).max())
    np.testing.assert_allclose(got, spec, atol=TOL_FRAMING * peak, rtol=0)
    back = dsp.istft(_t(spec), 512, 128, 400, len(wav)).numpy()
    want = _np(jdsp.istft(jnp.asarray(spec), 512, 128, 400, len(wav)))
    np.testing.assert_allclose(back, want, atol=TOL_FRAMING * float(np.abs(want).max()), rtol=0)
    np.testing.assert_allclose(back, wav, atol=1e-4)                  # the round trip itself
    for coef in (0.97, 0.5):
        pre = dsp.preemphasis(_t(wav), coef).numpy()
        np.testing.assert_allclose(pre, _np(jdsp.preemphasis(jnp.asarray(wav), coef)),
                                   atol=TOL_FRAMING, rtol=0)
        inv = dsp.inv_preemphasis(_t(pre), coef)
        assert inv.dtype == torch.float32 and inv.device.type == "cpu"
        want = _np(jdsp.inv_preemphasis(jnp.asarray(pre), coef))
        np.testing.assert_allclose(inv.numpy(), want, atol=TOL_FRAMING * np.abs(want).max(), rtol=0)


def test_db_maps_against_jax():
    x = np.abs(_noise(2, 500, 3.0)) ** 2 + np.array([0.0] * 499 + [1e-9], np.float32)
    db = dsp.amp_to_db(_t(x)).numpy()
    np.testing.assert_allclose(db, _np(jdsp.amp_to_db(jnp.asarray(x))), atol=TOL_SPEC, rtol=0)
    np.testing.assert_allclose(dsp.db_to_amp(_t(db)).numpy(), _np(jdsp.db_to_amp(jnp.asarray(db))),
                               rtol=TOL_SPEC, atol=0)
    norm = dsp.normalize_db(_t(db), -100.0, 20.0).numpy()
    np.testing.assert_allclose(norm, _np(jdsp.normalize_db(jnp.asarray(db), -100.0, 20.0)),
                               atol=TOL_SPEC, rtol=0)
    np.testing.assert_allclose(dsp.denormalize_db(_t(norm), -100.0, 20.0).numpy(),
                               _np(jdsp.denormalize_db(jnp.asarray(norm), -100.0, 20.0)),
                               atol=TOL_SPEC, rtol=0)


STATS = dict(average_mel_level_db=tuple(np.linspace(-40.0, -20.0, 12).tolist()),
             stddev_mel_level_db=tuple(np.linspace(5.0, 10.0, 12).tolist()))


@pytest.mark.parametrize("stats", [False, True], ids=["min_ref", "standardized"])
@pytest.mark.parametrize("preemphasis", [0.97, 0.0])
def test_spectrograms_of_audio_against_jax(stats, preemphasis):
    kw = dict(SMALL, preemphasis=preemphasis, **(STATS if stats else {}))
    mine, theirs = Audio(HParams(**kw), device="cpu"), JaxAudio(JaxHParams(**kw))
    for seed in (3, 4):
        wav = _noise(seed, 5000)
        mel, want = mine.melspectrogram(wav), theirs.melspectrogram(wav)
        assert mel.shape == want.shape == (1 + 5000 // mine.hparams.hop_length, 12)
        np.testing.assert_allclose(mel, want, atol=TOL_SPEC, rtol=0)
        spec, want = mine.spectrogram(wav), theirs.spectrogram(wav)
        assert spec.shape == want.shape and spec.shape[1] == 129
        np.testing.assert_allclose(spec, want, atol=TOL_SPEC, rtol=0)
        np.testing.assert_allclose(mine.denormalize_mel(mel), theirs.denormalize_mel(mel),
                                   atol=TOL_SPEC * 100, rtol=0)     # dB: 100 x the [0, 1] range
    if stats:
        assert mel.min() < 0.0 or mel.max() > 1.0


def test_trim_against_jax():
    hp = HParams(sample_rate=8000)
    for seed in (5, 6):
        wav = _tone(seed, silence=(5000, 7000))
        got = Audio(hp, device="cpu").trim(wav)
        np.testing.assert_array_equal(got, JaxAudio(JaxHParams(sample_rate=8000)).trim(wav))
        assert 0 < got.size < wav.size
    assert dsp.trim_silence(np.zeros(0, np.float32)).size == 0
    silent = np.zeros(5000, np.float32)
    np.testing.assert_array_equal(dsp.trim_silence(silent), jdsp.trim_silence(silent))


def _jax_phases(shape):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(0), shape, minval=-np.pi,
                                         maxval=np.pi))


def test_griffin_lim_with_jax_start_phases():
    hp = HParams(**SMALL)
    mag = np.abs(_np(jdsp.stft(jnp.asarray(_tone(7)), hp.n_fft, hp.hop_length, hp.win_length)))
    length = mag.shape[0] * hp.hop_length
    kw = dict(n_fft=hp.n_fft, hop_length=hp.hop_length, win_length=hp.win_length, n_iters=8,
              length=length)
    want = _np(jdsp.griffin_lim(jnp.asarray(mag), **kw))
    got = dsp.griffin_lim(_t(mag), angles=_t(_jax_phases(mag.shape)), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=TOL_GL * float(np.abs(want).max()), rtol=0)
    # the facade: denormalize, the power, Griffin-Lim, the inverse pre-emphasis
    spec = JaxAudio(JaxHParams(**SMALL)).spectrogram(_tone(8))
    want = JaxAudio(JaxHParams(**SMALL)).inv_spectrogram(spec)
    got = Audio(hp, device="cpu").inv_spectrogram(spec, angles=_jax_phases(spec.shape))
    assert got.shape == want.shape == (spec.shape[0] * hp.hop_length,)
    np.testing.assert_allclose(got, want, atol=TOL_GL * float(np.abs(want).max()), rtol=0)


def test_griffin_lim_draws_its_phases_from_the_generator():
    hp = HParams(**SMALL)
    spec = Audio(hp, device="cpu").spectrogram(_tone(9))
    audio = Audio(hp, device="cpu")
    a = audio.inv_spectrogram(spec, generator=torch.Generator().manual_seed(3))
    b = audio.inv_spectrogram(spec, generator=torch.Generator().manual_seed(3))
    c = audio.inv_spectrogram(spec, generator=torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0
    np.testing.assert_array_equal(audio.inv_spectrogram(spec), audio.inv_spectrogram(spec))
    phases = torch.rand(2000, generator=torch.Generator().manual_seed(0)) * 2 * np.pi - np.pi
    assert -np.pi <= float(phases.min()) and float(phases.max()) < np.pi


def test_wav_io_against_jax(tmp_path):
    hp, jhp = HParams(sample_rate=8000), JaxHParams(sample_rate=8000)
    mine, theirs = Audio(hp, device="cpu"), JaxAudio(jhp)
    wav = _tone(10)
    mine.save_wav(wav, str(tmp_path / "port.wav"))
    theirs.save_wav(wav, str(tmp_path / "jax.wav"))
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    rng = np.random.default_rng(11)
    cases = {
        "int16": (rng.integers(-32768, 32767, 300)).astype(np.int16),
        "int32": (rng.integers(-2**31, 2**31 - 1, 300)).astype(np.int32),
        "uint8": (rng.integers(0, 255, 300)).astype(np.uint8),
        "float32": rng.standard_normal(300).astype(np.float32),
        "stereo": (rng.integers(-32768, 32767, (300, 2))).astype(np.int16),
    }
    for name, data in cases.items():
        path = str(tmp_path / f"{name}.wav")
        wavfile.write(path, 8000, data)
        got = mine.load_wav(path)
        assert got.dtype == np.float32 and got.ndim == 1
        np.testing.assert_array_equal(got, theirs.load_wav(path), err_msg=name)
    wavfile.write(str(tmp_path / "rate.wav"), 16000, cases["int16"])
    with pytest.raises(ValueError, match="resampling is not performed"):
        mine.load_wav(str(tmp_path / "rate.wav"))


@pytest.mark.parametrize("kw", [
    dict(num_mels=8, average_mel_level_db=(1.0,)),
    dict(num_mels=8, average_mel_level_db=(1.0, 2.0), stddev_mel_level_db=(1.0, 2.0)),
    dict(num_mels=2, average_mel_level_db=(1.0, 2.0), stddev_mel_level_db=(1.0, 0.0)),
], ids=["missing_std", "wrong_length", "non_positive_std"])
def test_mel_statistics_are_validated_as_in_jax(kw):
    with pytest.raises(ValueError) as jax_error:
        JaxAudio(JaxHParams(**kw))
    with pytest.raises(ValueError) as error:
        Audio(HParams(**kw), device="cpu")
    assert str(error.value) == str(jax_error.value)


def test_audio_wants_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is allowed to work")
    with pytest.raises(RuntimeError, match="CUDA"):
        Audio(HParams())
    assert Audio(HParams(), device="cpu").device.type == "cpu"


def _numpy_griffin_lim(spec, hp, phases):
    """Griffin-Lim in float64 with numpy's FFT: denormalize, the power, the iterations
    (librosa's centred framing and window-square overlap-add), the inverse pre-emphasis."""
    from scipy.signal import lfilter

    db = np.clip(spec.astype(np.float64), 0, 1) * -hp.min_level_db + hp.min_level_db
    mag = (10.0 ** ((db + hp.ref_level_db) * 0.05)) ** hp.power
    window = dsp.hann_window(hp.win_length, hp.n_fft).astype(np.float64)
    n, hop, pad = hp.n_fft, hp.hop_length, hp.n_fft // 2
    length = spec.shape[0] * hop

    def istft(s):
        frames = np.fft.irfft(s, n=n, axis=-1) * window
        sig = np.zeros(n + hop * (len(frames) - 1))
        norm = np.zeros_like(sig)
        for i, frame in enumerate(frames):
            sig[i * hop:i * hop + n] += frame
            norm[i * hop:i * hop + n] += window ** 2
        return (sig / np.maximum(norm, 1e-10))[pad:pad + length]

    def stft(w):
        padded = np.pad(w, (pad, pad), mode="reflect")
        count = 1 + (len(padded) - n) // hop
        frames = np.stack([padded[i * hop:i * hop + n] for i in range(count)]) * window
        return np.fft.rfft(frames, n=n, axis=-1)

    s = mag * np.exp(1j * phases.astype(np.float64))
    for _ in range(hp.griffin_lim_iters):
        r = stft(istft(s))
        s = mag * (r / np.maximum(np.abs(r), 1e-10))[: len(mag)]
    return lfilter([1.0], [1.0, -hp.preemphasis], istft(s))


def test_griffin_lim_of_a_flat_spectrogram_against_float64():
    """The port's float64 Griffin-Lim against numpy's on a flat spectrogram, with JAX's
    start phases; JAX's complex64 one on the same input is printed beside it (``-s``)."""
    hp, jhp = HParams(**SMALL), JaxHParams(**SMALL)
    rng = np.random.default_rng(12)
    spec = np.clip(rng.normal(-0.02, 0.05, (40, 129)), -0.2, 0.2).astype(np.float32)
    assert (spec <= 0).mean() > 0.5                    # mostly at the floor
    phases = _jax_phases(spec.shape)
    want = _numpy_griffin_lim(spec, hp, phases)
    peak = float(np.abs(want).max())
    got = Audio(hp, device="cpu").inv_spectrogram(spec, angles=phases)
    assert got.dtype == np.float32
    complex64 = JaxAudio(jhp).inv_spectrogram(spec)     # its own phases: key 0, as here
    print("flat spectrogram, share of the peak from float64: port",
          float(np.abs(got - want).max()) / peak, "JAX complex64",
          float(np.abs(complex64 - want).max()) / peak)
    np.testing.assert_allclose(got, want, atol=1e-6 * peak, rtol=0)
