"""Waveform -> log-mel frontend (port of ``frontend/mel.py``, PaSST frontend).

PaSST (``src/models/passt/passt_feature_extraction.py:53-94``): wav
peak-norm -> pre-emphasis -> STFT(1024/320/800, Hann periodic=False,
center/reflect) -> power -> Kaldi mel banks -> log "fast normalisation".

The STFT is ``torch.stft`` (cuFFT on the card) with the reference's
frame layout: reflect-padded by n_fft // 2 on both sides, the 800-sample
window zero-padded symmetrically to 1024. The mel projection stays in
float32. Training draws one fmin/fmax pair per call
(:meth:`PasstFrontend.draw_fminmax`) and builds the mel banks for that
pair on the device (``frontend/mel.py:212-243`` of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from transformer4sed_tpu_torch.utils.device import resolve_device


def hann_window(win_length: int, periodic: bool = False) -> np.ndarray:
    """Hann window; ``periodic=False`` is torch.hann_window(periodic=False),
    the PaSST frontend's; the HTSAT frontend's is periodic."""
    n = win_length if periodic else win_length - 1
    k = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(np.float32)


def stft_power(wav: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
               window: torch.Tensor) -> torch.Tensor:
    """Center-padded STFT -> |X|^2, shape ``[B, n_fft//2 + 1, T]``."""
    spec = torch.stft(
        wav.float(), n_fft, hop_length=hop_length, win_length=win_length,
        window=window, center=True, pad_mode="reflect", return_complex=True,
    )
    return spec.real ** 2 + spec.imag ** 2


def _kaldi_mel(freq):
    return 1127.0 * torch.log(1.0 + freq / 700.0)


def kaldi_mel_banks(n_mels: int, n_fft: int, sr: float, fmin: float, fmax: float,
                    device=None) -> torch.Tensor:
    """Kaldi-style mel filterbank ``[n_mels, n_fft//2 + 1]`` in float32
    (torchaudio.compliance.kaldi.get_mel_banks parity); the Nyquist column
    is the zero pad the reference adds by hand."""
    num_fft_bins = n_fft // 2
    f32 = dict(dtype=torch.float32, device=device)
    mel_low = _kaldi_mel(torch.tensor(fmin, **f32))
    mel_high = _kaldi_mel(torch.tensor(fmax, **f32))
    mel_delta = (mel_high - mel_low) / (n_mels + 1)

    bins = torch.arange(n_mels, **f32)[:, None]
    left_mel = mel_low + bins * mel_delta
    center_mel = left_mel + mel_delta
    right_mel = center_mel + mel_delta

    freqs = (sr / n_fft) * torch.arange(num_fft_bins, **f32)[None, :]
    mel = _kaldi_mel(freqs)
    up = (mel - left_mel) / (center_mel - left_mel)
    down = (right_mel - mel) / (right_mel - center_mel)
    weights = torch.clamp_min(torch.minimum(up, down), 0.0)
    return torch.nn.functional.pad(weights, (0, 1))


def fast_normalize(mel: torch.Tensor) -> torch.Tensor:
    """PaSST "fast normalization": (log(x + 1e-5) + 4.5) / 5."""
    return (torch.log(mel + 1e-5) + 4.5) / 5.0


def peak_normalize_wav(wav: torch.Tensor) -> torch.Tensor:
    max_abs = torch.amax(torch.abs(wav), dim=-1, keepdim=True)
    return wav / (max_abs + 1e-10)


@dataclass
class PasstFrontend:
    """PaSST log-mel frontend. ``__call__`` returns the *power mel*
    ``[B, n_mels, T]``; apply :meth:`normalize` afterwards."""

    n_mels: int = 128
    sr: int = 32000
    win_length: int = 800
    hop_length: int = 320
    n_fft: int = 1024
    fmin: float = 0.0
    fmax: Optional[float] = None
    wav_norm: bool = True
    fmin_aug_range: int = 10
    fmax_aug_range: int = 2000
    preemphasis: float = 0.97
    device: Optional[torch.device] = None
    _window: torch.Tensor = field(init=False, repr=False)
    _basis: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._window = torch.as_tensor(hann_window(self.win_length), device=self.device)
        self._basis = kaldi_mel_banks(self.n_mels, self.n_fft, self.sr, self.fmin,
                                      self.effective_fmax, device=self.device)

    @property
    def effective_fmax(self) -> float:
        if self.fmax is not None:
            return self.fmax
        return self.sr // 2 - self.fmax_aug_range // 2

    def draw_fminmax(self, gen: torch.Generator) -> Tuple[float, float]:
        """One training pair: fmin + U{0 .. fmin_aug_range - 1}, fmax +
        fmax_aug_range // 2 - U{0 .. fmax_aug_range - 1}."""
        lo = int(torch.randint(0, self.fmin_aug_range, (), generator=gen, device=gen.device))
        hi = int(torch.randint(0, self.fmax_aug_range, (), generator=gen, device=gen.device))
        return float(self.fmin + lo), float(self.effective_fmax + self.fmax_aug_range // 2 - hi)

    def __call__(self, wav: torch.Tensor,
                 fminmax: Optional[Tuple[float, float]] = None) -> torch.Tensor:
        """wav [B, n_samples] -> power mel [B, n_mels, T] (float32); with
        ``fminmax`` (training) the banks are built for that pair."""
        if wav.ndim == 1:
            wav = wav[None]
        wav = wav.to(device=self.device, dtype=torch.float32)
        if self.wav_norm:
            wav = peak_normalize_wav(wav)
        # pre-emphasis: y[t] = x[t+1] - 0.97 x[t]
        wav = wav[:, 1:] - self.preemphasis * wav[:, :-1]
        power = stft_power(wav, self.n_fft, self.hop_length, self.win_length, self._window)
        basis = self._basis
        if fminmax is not None:
            basis = kaldi_mel_banks(self.n_mels, self.n_fft, self.sr, fminmax[0], fminmax[1],
                                    device=self.device)
        return torch.einsum("mf,bft->bmt", basis, power)

    def normalize(self, mel: torch.Tensor) -> torch.Tensor:
        return fast_normalize(mel)
