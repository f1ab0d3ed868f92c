"""The ``Audio`` facade over the torch DSP of ``dsp.py``.

Counterpart of the JAX package's ``audio/audio.py``: ``load_wav``,
``save_wav``, ``trim``, ``melspectrogram``, ``spectrogram``,
``denormalize_mel`` and ``inv_spectrogram``. The transforms run on
``device``, the card unless the caller asks for the CPU; they take and give
numpy arrays. Wav file I/O is host-side scipy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy.io import wavfile

from self_attention_tacotron_torch.audio import dsp
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.utils.platform import resolve_device


class Audio:
    """Stateless audio transform bundle configured from :class:`HParams`."""

    def __init__(self, hparams: HParams, device="cuda"):
        self.hparams = hparams
        self.device = resolve_device(device)
        avg, std = hparams.average_mel_level_db, hparams.stddev_mel_level_db
        if bool(avg) != bool(std):
            raise ValueError(
                "average_mel_level_db and stddev_mel_level_db must be set together"
            )
        if avg and (len(avg) != hparams.num_mels or len(std) != hparams.num_mels):
            raise ValueError(
                f"per-bin mel stats must have length num_mels={hparams.num_mels}; "
                f"got {len(avg)} / {len(std)}"
            )
        if std and any(s <= 0 for s in std):
            raise ValueError("stddev_mel_level_db entries must be positive")

    @property
    def uses_mel_standardization(self) -> bool:
        """True when per-bin mel mean/std normalization is configured."""
        return bool(self.hparams.average_mel_level_db)

    # --------------------------- file I/O --------------------------- #

    def load_wav(self, path: str) -> np.ndarray:
        sr, data = wavfile.read(path)
        if sr != self.hparams.sample_rate:
            raise ValueError(
                f"{path}: sample rate {sr} != hparams.sample_rate "
                f"{self.hparams.sample_rate} (resampling is not performed)"
            )
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            data = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            data = (data.astype(np.float32) - 128.0) / 128.0
        else:
            data = data.astype(np.float32)
        if data.ndim > 1:
            data = data.mean(axis=-1)
        return data

    def save_wav(self, wav: np.ndarray, path: str) -> None:
        wav = np.asarray(wav)
        peak = max(0.01, float(np.max(np.abs(wav))))
        wavfile.write(
            path,
            self.hparams.sample_rate,
            (wav / peak * 32767).astype(np.int16),
        )

    # --------------------------- transforms ------------------------- #

    def trim(self, wav: np.ndarray) -> np.ndarray:
        hp = self.hparams
        return dsp.trim_silence(
            wav, hp.trim_top_db, hp.trim_frame_length, hp.trim_hop_length
        )

    def _tensor(self, array) -> torch.Tensor:
        return torch.tensor(np.asarray(array, np.float32), device=self.device)

    def melspectrogram(self, wav: np.ndarray) -> np.ndarray:
        """(frames, num_mels) normalized mel spectrogram."""
        hp = self.hparams
        stats = self.uses_mel_standardization
        mel = dsp.mel_spectrogram(
            self._tensor(wav),
            sample_rate=hp.sample_rate,
            n_fft=hp.n_fft,
            hop_length=hp.hop_length,
            win_length=hp.win_length,
            num_mels=hp.num_mels,
            fmin=hp.mel_fmin,
            fmax=hp.fmax,
            preemphasis_coef=hp.preemphasis,
            min_level_db=hp.min_level_db,
            ref_level_db=hp.ref_level_db,
            average_mel_level_db=hp.average_mel_level_db if stats else None,
            stddev_mel_level_db=hp.stddev_mel_level_db if stats else None,
        )
        return mel.cpu().numpy()

    def spectrogram(self, wav: np.ndarray) -> np.ndarray:
        """(frames, num_freq) normalized linear spectrogram."""
        hp = self.hparams
        spec = dsp.linear_spectrogram(
            self._tensor(wav),
            n_fft=hp.n_fft,
            hop_length=hp.hop_length,
            win_length=hp.win_length,
            preemphasis_coef=hp.preemphasis,
            min_level_db=hp.min_level_db,
            ref_level_db=hp.ref_level_db,
        )
        return spec.cpu().numpy()

    def denormalize_mel(self, mel: np.ndarray) -> np.ndarray:
        """Map a normalized mel back to dB scale (inverse of melspectrogram).

        Per-bin standardized features -> mean/std destandardization; otherwise
        the min/ref-level [0,1] denormalization.
        """
        hp = self.hparams
        mel = self._tensor(mel)
        if self.uses_mel_standardization:
            out = dsp.destandardize_mel_db(
                mel, self._tensor(hp.average_mel_level_db), self._tensor(hp.stddev_mel_level_db)
            )
        else:
            out = dsp.denormalize_db(mel, hp.min_level_db, hp.ref_level_db)
        return out.cpu().numpy()

    def inv_spectrogram(
        self,
        spectrogram: np.ndarray,
        generator: Optional[torch.Generator] = None,
        angles=None,
    ) -> np.ndarray:
        """Griffin-Lim waveform reconstruction from a normalized linear spec,
        float32 (the magnitudes, the iterations and the inverse pre-emphasis in
        float64).

        The start phases are ``angles`` where given, else drawn from
        ``generator`` (on this facade's device; a fresh one seeded 0 if None).
        """
        hp = self.hparams
        # float64 from the start: on a flat spectrogram Griffin-Lim amplifies the
        # rounding of the magnitudes too (see dsp.griffin_lim)
        spec = self._tensor(spectrogram).double()
        if angles is None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        amp = dsp.db_to_amp(dsp.denormalize_db(spec, hp.min_level_db, hp.ref_level_db))
        wav = dsp.griffin_lim(
            amp**hp.power,
            n_fft=hp.n_fft,
            hop_length=hp.hop_length,
            win_length=hp.win_length,
            n_iters=hp.griffin_lim_iters,
            length=spec.shape[0] * hp.hop_length,
            generator=generator,
            angles=angles,
        )
        if hp.preemphasis > 0:
            wav = dsp.inv_preemphasis(wav, hp.preemphasis)
        return wav.cpu().numpy().astype(np.float32)
