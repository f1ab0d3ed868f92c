"""Signal processing primitives: STFT, mel filterbank, dB scaling, Griffin-Lim.

Counterpart of the JAX package's ``audio/dsp.py`` in torch: every transform
runs on the device of the tensor it is given, the card or the CPU. The
conventions match librosa's defaults, as the JAX package's do:

* STFT: centered, reflect padding, periodic Hann window, ``win_length``
  padded symmetrically to ``n_fft``. The frames come from an index grid over
  the padded signal, as JAX ``frame_signal`` takes them; ``torch.stft`` pads
  and windows by other conventions and is not used.
* Mel filterbank: Slaney mel scale (linear < 1 kHz, log above) with Slaney
  area normalization (``librosa.filters.mel`` defaults), built in numpy.
* dB scale: ``20 * log10(max(x, 1e-5))`` with ref/min-level normalization
  to [0, 1] as in the keithito/NII Tacotron lineage.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import scipy.signal
import torch

_AMIN = 1e-5


# --------------------------------------------------------------------------- #
# Windows and filterbanks (host-side constant construction, numpy)
# --------------------------------------------------------------------------- #


def hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window of ``win_length``, centered in ``n_fft`` zeros."""
    n = np.arange(win_length)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    lpad = (n_fft - win_length) // 2
    return np.pad(win, (lpad, n_fft - win_length - lpad)).astype(np.float32)


def _hz_to_mel_slaney(freq):
    freq = np.asanyarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = freq >= min_log_hz
    mels = np.where(
        log_t, min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep, mels
    )
    return mels


def _mel_to_hz_slaney(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    freqs = np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sample_rate: int, n_fft: int, num_mels: int, fmin: float = 0.0, fmax: float = 0.0
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (num_mels, n_fft//2+1).

    Matches ``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)`` defaults
    (htk=False, norm='slaney').
    """
    if fmax <= 0:
        fmax = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), num_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : num_mels + 2] - hz_pts[:num_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _window(win_length: int, n_fft: int, like: torch.Tensor) -> torch.Tensor:
    """The Hann window on ``like``'s device, in float64 for a float64 or complex128
    ``like``, else float32."""
    double = like.dtype in (torch.float64, torch.complex128)
    return torch.as_tensor(hann_window(win_length, n_fft), device=like.device,
                           dtype=torch.float64 if double else torch.float32)


# --------------------------------------------------------------------------- #
# torch transforms (on the tensor's device)
# --------------------------------------------------------------------------- #


def preemphasis(wav: torch.Tensor, coef: float) -> torch.Tensor:
    """y[t] = x[t] - coef * x[t-1] (scipy.signal.lfilter([1,-k],[1],x))."""
    return torch.cat([wav[:1], wav[1:] - coef * wav[:-1]])


def inv_preemphasis(wav: torch.Tensor, coef: float) -> torch.Tensor:
    """Inverse of :func:`preemphasis`, y[t] = x[t] + coef * y[t-1]: a linear
    recurrence, run by ``scipy.signal.lfilter`` on the host (a loop over samples
    on the device would take a launch per sample). Returned on ``wav``'s device."""
    x = wav.detach().cpu().numpy()
    y = scipy.signal.lfilter([1.0], [1.0, -coef], x).astype(x.dtype, copy=False)
    return torch.from_numpy(np.ascontiguousarray(y)).to(wav.device)


def _reflect_indices(length: int, pad: int, device) -> torch.Tensor:
    """Indices of ``numpy.pad(x, (pad, pad), mode="reflect")`` into x, for any pad
    (the reflection repeats with period 2 * (length - 1) where pad >= length)."""
    idx = torch.arange(-pad, length + pad, device=device).abs()
    if length == 1:
        return torch.zeros_like(idx)
    period = 2 * (length - 1)
    idx = idx % period
    return torch.where(idx >= length, period - idx, idx)


def frame_signal(wav: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Center-padded framing: (num_frames, n_fft), librosa centering."""
    pad = n_fft // 2
    padded = wav[_reflect_indices(wav.shape[0], pad, wav.device)]
    return padded.unfold(0, n_fft, hop_length)


def stft(wav: torch.Tensor, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """Complex STFT, shape (num_frames, n_fft//2 + 1). Centered, Hann."""
    frames = frame_signal(wav, n_fft, hop_length) * _window(win_length, n_fft, wav)[None, :]
    return torch.fft.rfft(frames, n=n_fft, dim=-1)


def istft(
    spec: torch.Tensor, n_fft: int, hop_length: int, win_length: int, length: int
) -> torch.Tensor:
    """Inverse STFT via windowed overlap-add with window-square normalization."""
    window = _window(win_length, n_fft, spec)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window[None, :]
    num_frames = frames.shape[0]
    total = n_fft + hop_length * (num_frames - 1)
    idx = (
        torch.arange(num_frames, device=spec.device)[:, None] * hop_length
        + torch.arange(n_fft, device=spec.device)[None, :]
    ).reshape(-1)
    sig = torch.zeros(total, dtype=frames.dtype, device=spec.device)
    winsq = torch.zeros(total, dtype=frames.dtype, device=spec.device)
    sig.index_add_(0, idx, frames.reshape(-1))
    winsq.index_add_(0, idx, (window[None, :] ** 2).expand_as(frames).reshape(-1))
    sig = sig / torch.clamp(winsq, min=1e-10)
    pad = n_fft // 2
    return sig[pad : pad + length]


def amp_to_db(x: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(torch.clamp(x, min=_AMIN))


def db_to_amp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x * 0.05)


def normalize_db(db: torch.Tensor, min_level_db: float, ref_level_db: float) -> torch.Tensor:
    """(dB - ref) mapped to [0, 1] over the [min_level_db, 0] range."""
    return torch.clamp((db - ref_level_db - min_level_db) / -min_level_db, 0.0, 1.0)


def denormalize_db(x: torch.Tensor, min_level_db: float, ref_level_db: float) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0) * -min_level_db + min_level_db + ref_level_db


def standardize_mel_db(
    mel_db: torch.Tensor, average: torch.Tensor, stddev: torch.Tensor
) -> torch.Tensor:
    """Per-bin standardization of a dB-scale mel: (mel - mean) / std.

    Where the ``average_mel_level_db`` / ``stddev_mel_level_db`` statistics are
    configured they replace the min/ref-level [0,1] normalization, so the model
    trains on zero-mean unit-variance features per mel bin.
    """
    return (mel_db - average[None, :]) / stddev[None, :]


def destandardize_mel_db(
    mel: torch.Tensor, average: torch.Tensor, stddev: torch.Tensor
) -> torch.Tensor:
    """Inverse of :func:`standardize_mel_db` (back to dB scale)."""
    return mel * stddev[None, :] + average[None, :]


def linear_spectrogram(
    wav: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    win_length: int,
    preemphasis_coef: float,
    min_level_db: float,
    ref_level_db: float,
) -> torch.Tensor:
    """Normalized linear magnitude spectrogram, (frames, n_fft//2+1)."""
    if preemphasis_coef > 0:
        wav = preemphasis(wav, preemphasis_coef)
    mag = torch.abs(stft(wav, n_fft, hop_length, win_length))
    return normalize_db(amp_to_db(mag), min_level_db, ref_level_db)


def mel_spectrogram(
    wav: torch.Tensor,
    *,
    sample_rate: int,
    n_fft: int,
    hop_length: int,
    win_length: int,
    num_mels: int,
    fmin: float,
    fmax: float,
    preemphasis_coef: float,
    min_level_db: float,
    ref_level_db: float,
    average_mel_level_db=None,
    stddev_mel_level_db=None,
) -> torch.Tensor:
    """Normalized mel spectrogram, (frames, num_mels).

    When per-bin stats are given (``average_mel_level_db`` /
    ``stddev_mel_level_db``, each length ``num_mels``), the dB mel is
    standardized per bin instead of min/ref-level normalized to [0, 1].
    """
    if preemphasis_coef > 0:
        wav = preemphasis(wav, preemphasis_coef)
    mag = torch.abs(stft(wav, n_fft, hop_length, win_length))
    mel_basis = torch.as_tensor(
        mel_filterbank(sample_rate, n_fft, num_mels, fmin, fmax), device=wav.device
    )
    mel_db = amp_to_db(mag @ mel_basis.T)
    if average_mel_level_db is not None and stddev_mel_level_db is not None:
        return standardize_mel_db(
            mel_db,
            torch.as_tensor(average_mel_level_db, dtype=torch.float32, device=wav.device),
            torch.as_tensor(stddev_mel_level_db, dtype=torch.float32, device=wav.device),
        )
    return normalize_db(mel_db, min_level_db, ref_level_db)


def griffin_lim(
    magnitude: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    win_length: int,
    n_iters: int,
    length: int,
    generator: Optional[torch.Generator] = None,
    angles: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Griffin-Lim phase reconstruction from a linear magnitude spectrogram.

    ``magnitude``: (frames, n_fft//2+1) linear amplitudes; the iterations run
    on its device. The start phases are ``angles`` where given (radians, the
    magnitude's shape), else drawn uniformly in [-pi, pi) from ``generator``
    (on the magnitude's device). Returns the float64 waveform.

    The iterations run in float64 (complex128), where the JAX package runs
    complex64: on a flat spectrogram (a decoder's output clamped at the dB floor)
    the iterations amplify rounding, and in float32 the card's waveform and the
    CPU's were 1.5e-4 of the peak apart (``chip_smoke.py``, a ``streaming`` lane);
    in float64 the two devices agree.
    """
    if angles is None:
        angles = torch.rand(
            magnitude.shape, generator=generator, device=magnitude.device
        ) * (2.0 * math.pi) - math.pi
    if not torch.is_tensor(angles):
        angles = torch.tensor(np.asarray(angles, np.float32))
    angles = angles.to(dtype=torch.float64, device=magnitude.device)
    magnitude = magnitude.to(torch.complex128)
    spec = magnitude * torch.exp(1j * angles)
    for _ in range(n_iters):
        wav = istft(spec, n_fft, hop_length, win_length, length)
        rebuilt = stft(wav, n_fft, hop_length, win_length)
        phase = rebuilt / torch.clamp(torch.abs(rebuilt), min=1e-10)
        spec = magnitude * phase[: magnitude.shape[0]]
    return istft(spec, n_fft, hop_length, win_length, length)


# --------------------------------------------------------------------------- #
# Silence trimming (host-side, numpy; offline preprocessing only)
# --------------------------------------------------------------------------- #


def trim_silence(
    wav: np.ndarray, top_db: float = 60.0, frame_length: int = 2048, hop_length: int = 512
) -> np.ndarray:
    """Trim leading/trailing silence (librosa.effects.trim semantics)."""
    wav = np.asarray(wav)
    if wav.size == 0:
        return wav
    n_frames = max(1, 1 + (max(wav.size - frame_length, 0)) // hop_length)
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(frame_length)[None, :]
    padded = np.pad(wav, (0, max(0, idx.max() + 1 - wav.size)))
    rms = np.sqrt(np.mean(padded[idx] ** 2, axis=-1))
    ref = np.max(rms)
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / np.maximum(ref, 1e-10))
    non_silent = np.flatnonzero(db > -top_db)
    if non_silent.size == 0:
        return wav[:0]
    start = int(non_silent[0]) * hop_length
    end = min(wav.size, int(non_silent[-1] + 1) * hop_length + frame_length)
    return wav[start:end]
