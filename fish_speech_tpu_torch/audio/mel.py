"""Log-mel spectrogram with the reference's framing.

Counterpart of `fish_speech_tpu/audio/mel.py`, with the same semantics:

  * reflect-pad the signal by (n_fft - hop) / 2 on each side,
  * frames of n_fft samples at stride hop from offset 0, the tail
    zero-padded, so num_frames = ceil(len_padded / hop) - 3,
  * periodic Hann window (denominator n_fft), rFFT, magnitude, + 1e-6,
  * the 160-bin slaney mel filterbank, clamp(1e-5, 100), log.

The framing is an unfold, the FFT `torch.fft.rfft` and the mel
projection one (F, n_fft/2+1) x (n_fft/2+1, n_mels) product, in float32
on the caller's device (CUDA unless asked otherwise).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from fish_speech_tpu_torch.config import SpecTransformConfig
from fish_speech_tpu_torch.device import resolve_device


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-scale, slaney-normed mel filterbank, (n_fft//2+1, n_mels)
    float32 (the librosa formula)."""
    if fmax is None:
        fmax = sr / 2.0
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.atleast_1d(np.asarray(f, dtype=np.float64))
        mel = f / f_sp
        log_t = f >= min_log_hz
        mel[log_t] = min_log_mel + np.log(f[log_t] / min_log_hz) / logstep
        return mel

    def mel_to_hz(m):
        m = np.atleast_1d(np.asarray(m, dtype=np.float64))
        f = m * f_sp
        log_t = m >= min_log_mel
        f[log_t] = min_log_hz * np.exp(logstep * (m[log_t] - min_log_mel))
        return f

    n_freqs = n_fft // 2 + 1
    fftfreqs = np.linspace(0, sr / 2, n_freqs)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin)[0], hz_to_mel(fmax)[0], n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)


def num_frames(n_samples: int, n_fft: int, hop: int) -> int:
    """Frame count of the reference's streaming framing."""
    padded = n_samples + 2 * ((n_fft - hop) // 2)
    return max(-(-padded // hop) - 3, 0)


def frames_magnitude(signal: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """signal (T,) float32, already padded to (F-1)*hop + n_fft ->
    (F, n_fft//2+1) magnitudes + 1e-6."""
    frames = signal.unfold(0, n_fft, hop)
    ramp = torch.arange(n_fft, dtype=torch.float32, device=signal.device)
    window = 0.5 * (1.0 - torch.cos(2.0 * math.pi * ramp / n_fft))
    spec = torch.fft.rfft(frames * window, dim=-1)
    return spec.abs().float() + 1e-6


class LogMelSpectrogram:
    def __init__(self, cfg: SpecTransformConfig = SpecTransformConfig(), device="cuda") -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self._mel = torch.from_numpy(
            mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels)).to(self.device)

    def __call__(self, audio) -> torch.Tensor:
        """audio: (T,) or (1, T) float -> (1, n_mels, frames) log-mel."""
        audio = np.asarray(audio, dtype=np.float32).reshape(-1)
        n_fft, hop = self.cfg.n_fft, self.cfg.hop_length
        pad = (n_fft - hop) // 2
        f = num_frames(audio.shape[0], n_fft, hop)
        if f == 0:
            return torch.zeros((1, self.cfg.n_mels, 0), dtype=torch.float32, device=self.device)
        padded = np.concatenate([audio[:pad][::-1], audio, audio[-pad:][::-1]])
        need = (f - 1) * hop + n_fft
        if padded.shape[0] < need:
            padded = np.pad(padded, (0, need - padded.shape[0]))
        else:
            padded = padded[:need]
        mags = frames_magnitude(torch.from_numpy(padded).to(self.device), n_fft, hop)
        mel = torch.log(torch.clamp(mags @ self._mel, 1e-5, 100.0))
        return mel.T[None]
