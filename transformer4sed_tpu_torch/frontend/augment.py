"""Batch-level mel/label augmentations (port of ``frontend/augment.py``).

Each augmentation of the reference suite (``src/preprocess/data_aug.py``)
is split in two: ``draw_*`` takes a ``torch.Generator`` and returns the
random numbers the call needs (small tensors on the generator's device),
and the function of the augmentation's own name applies those draws. The
draw semantics are the JAX package's: ``frame_shift`` draws per sample,
``mixup`` and ``filt_aug`` per batch, ``freq_mask`` and ``add_noise`` per
sample. The tests feed the apply steps the draws that JAX made.

Shapes: mel features ``[B, F, T]``; strong labels ``[B, C, T_lab]`` with
``T = net_pooling * T_lab``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch


# -- frame shift ---------------------------------------------------------------

def draw_frame_shift(gen: torch.Generator, batch: int, max_shift_frame: int) -> torch.Tensor:
    """Per-sample shifts ``int(N(0, 1) * max_shift_frame)`` (truncated toward 0)."""
    z = torch.randn(batch, generator=gen, device=gen.device)
    return (z * max_shift_frame).to(torch.int64)


def _roll_rows(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Per-sample ``roll`` along the last axis: out[b, ..., i] = x[b, ..., i - s_b]."""
    t = x.shape[-1]
    idx = (torch.arange(t, device=x.device)[None, :] - shifts.to(x.device)[:, None]) % t
    idx = idx.reshape(x.shape[0], *([1] * (x.ndim - 2)), t).expand(x.shape)
    return torch.gather(x, -1, idx)


def frame_shift(features: torch.Tensor, shifts: torch.Tensor,
                label: Optional[torch.Tensor] = None, net_pooling: float = 1):
    """Circular time shift of each sample's mel (and its label, by
    ``floor(shift / net_pooling)``, floor toward minus infinity as the
    reference's ``-abs(shift) // net_pooling``, ``data_aug.py:19``)."""
    shifted = _roll_rows(features, shifts)
    if label is None:
        return shifted
    lab_shift = torch.floor(shifts.to(torch.float32) / float(net_pooling)).to(torch.int64)
    return shifted, _roll_rows(label, lab_shift)


# -- mixup ----------------------------------------------------------------------

def _gamma(gen: torch.Generator, shape: float) -> float:
    """One Gamma(shape, 1) draw (Marsaglia-Tsang; the shape < 1 boost)."""
    boost = 1.0
    if shape < 1.0:
        u = float(torch.rand((), generator=gen, device=gen.device))
        boost = u ** (1.0 / shape)
        shape += 1.0
    d = shape - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = float(torch.randn((), generator=gen, device=gen.device))
        v = (1.0 + c * x) ** 3
        if v <= 0:
            continue
        u = float(torch.rand((), generator=gen, device=gen.device))
        if math.log(max(u, 1e-300)) < 0.5 * x * x + d - d * v + d * math.log(v):
            return d * v * boost


def draw_beta(gen: torch.Generator, alpha: float, beta: float) -> float:
    """One Beta(alpha, beta) draw, as X / (X + Y) of two Gamma draws."""
    x, y = _gamma(gen, alpha), _gamma(gen, beta)
    return x / (x + y)


def draw_mixup(gen: torch.Generator, batch: int, alpha: float = 0.2, beta: float = 0.2):
    """(permutation [B], coefficient c) for one mixup call."""
    perm = torch.randperm(batch, generator=gen, device=gen.device)
    return perm, draw_beta(gen, alpha, beta)


def mixup(features: torch.Tensor, perm: torch.Tensor, c: float,
          label: Optional[torch.Tensor] = None, mixup_label_type: str = "soft"):
    """Mix each sample with ``features[perm]`` by ``c`` ('soft' mixes labels
    by the same c; 'hard' unions them and maps c into [0.3, 0.7])."""
    if mixup_label_type == "hard":
        c = c * 0.4 + 0.3
    perm = perm.to(features.device)
    mixed = c * features + (1.0 - c) * features[perm]
    if label is None:
        return mixed
    if mixup_label_type == "soft":
        mixed_label = torch.clamp(c * label + (1.0 - c) * label[perm], 0.0, 1.0)
    elif mixup_label_type == "hard":
        mixed_label = torch.clamp(label + label[perm], 0.0, 1.0)
    else:
        raise NotImplementedError(f"mixup_label_type {mixup_label_type!r}")
    return mixed, mixed_label


# -- FilterAugment ----------------------------------------------------------------

def _eff_min_bw(n_freq: int, n_bands: int, min_bw: int) -> int:
    """The reference's min-bandwidth shrink until the bands fit."""
    while n_freq - n_bands * min_bw + 1 < 0:
        min_bw -= 1
    return min_bw


@dataclass
class FiltAugDraw:
    n_bands: int            # band count, in [n_band[0], n_band[1])
    raw: torch.Tensor       # [n_bands - 1] boundary draws, int
    factors_db: torch.Tensor  # [B, max_bands] ('step') or [B, max_bands + 1] ('linear')


def draw_filt_aug(gen: torch.Generator, batch: int, n_freq: int,
                  db_range: Sequence[float] = (-0.5, 0.5), n_band: Sequence[int] = (3, 6),
                  min_bw: int = 6, filter_type: str = "step") -> FiltAugDraw:
    lo, hi = int(n_band[0]), int(n_band[1])
    dev = gen.device
    n_bands = int(torch.randint(lo, hi, (), generator=gen, device=dev))
    mbw = _eff_min_bw(n_freq, n_bands, min_bw)
    raw = torch.randint(0, n_freq - n_bands * mbw + 1, (max(n_bands - 1, 0),), generator=gen,
                        device=dev)
    width = (hi - 1) + (1 if filter_type == "linear" else 0)
    factors_db = (torch.rand(batch, width, generator=gen, device=dev)
                  * (db_range[1] - db_range[0]) + db_range[0])
    return FiltAugDraw(n_bands, raw, factors_db)


def filt_aug(features: torch.Tensor, draw: FiltAugDraw, min_bw: int = 6,
             filter_type: str = "step", norm_std: float = 5.0) -> torch.Tensor:
    """FilterAugment (ICASSP 2022 variant), additive in the log domain:
    ``features + log(filt + 1e-5) / norm_std`` with a per-batch random EQ of
    ``n_bands`` bands at least ``min_bw`` apart (``data_aug.py:150-192``);
    one band is unit gain."""
    b, n_freq, _ = features.shape
    dev = features.device
    nb = draw.n_bands
    if nb <= 1:  # one band: unit gain, as the JAX package (log(1 + 1e-5) is added)
        freq_filt = torch.ones(b, n_freq, device=dev)
        return features + (torch.log(freq_filt + 1e-5) / norm_std)[:, :, None]
    mbw = _eff_min_bw(n_freq, nb, min_bw)
    inner = torch.sort(draw.raw.to(dev)).values + torch.arange(1, nb, device=dev) * mbw
    bounds = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), inner.to(torch.int64)])
    upper = torch.cat([bounds[1:], torch.full((1,), n_freq, dtype=torch.int64, device=dev)])
    freq_idx = torch.arange(n_freq, device=dev)
    band_of = (freq_idx[None, :] >= bounds[:, None]).sum(0) - 1  # [n_freq]
    factors_db = draw.factors_db.to(dev)
    if filter_type == "step":
        freq_filt = (10.0 ** (factors_db / 20.0))[:, band_of]
    elif filter_type == "linear":
        # dB interpolation inside each band, then dB -> gain (the JAX
        # package's fix of the reference's linear branch)
        left, right = factors_db[:, band_of], factors_db[:, band_of + 1]
        span = torch.clamp_min((upper - bounds)[band_of], 1)
        frac = (freq_idx - bounds[band_of]) / span
        freq_filt = 10.0 ** ((left + (right - left) * frac) / 20.0)
    else:
        raise ValueError(f"unknown filter_type {filter_type!r}")
    return features + (torch.log(freq_filt + 1e-5) / norm_std)[:, :, None]


# -- frequency masking -----------------------------------------------------------

def draw_freq_mask(gen: torch.Generator, batch: int, n_freq: int, mask_param: int):
    """(widths, starts) [B]: width ~ U[0, mask_param), start ~ U[0, F - width)."""
    widths = torch.rand(batch, generator=gen, device=gen.device) * mask_param
    starts = torch.rand(batch, generator=gen, device=gen.device) * (n_freq - widths)
    return widths, starts


def freq_mask(features: torch.Tensor, widths: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Per-sample SpecAugment frequency mask; masked bins -> 0."""
    widths, starts = widths.to(features.device), starts.to(features.device)
    pos = torch.arange(features.shape[1], device=features.device)[None, :]
    mask = (pos >= starts[:, None]) & (pos < (starts + widths)[:, None])
    return torch.where(mask[:, :, None], 0.0, features)


# -- additive noise ---------------------------------------------------------------

def draw_add_noise(gen: torch.Generator, shape, snrs: Tuple[float, float] = (15, 30)):
    """(snr_db [B, 1, 1], unit normal noise of ``shape``)."""
    snr_db = ((snrs[0] - snrs[1]) * torch.rand(shape[0], 1, 1, generator=gen, device=gen.device)
              + snrs[1])
    return snr_db, torch.randn(*shape, generator=gen, device=gen.device)


def add_noise(features: torch.Tensor, snr_db: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Gaussian noise at a per-sample SNR (``data_aug.py:195-204``); the
    signal level is the unbiased std, as torch.std."""
    snr = 10.0 ** (snr_db.to(features.device) / 20.0)
    sigma = torch.std(features, dim=(1, 2), keepdim=True, unbiased=True) / snr
    return features + noise.to(features.device) * sigma


# -- frequency warp ---------------------------------------------------------------

def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` along the last axis of ``fp`` (``xp`` increasing, the
    end values held outside it)."""
    idx = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    f0, f1 = fp[..., idx - 1], fp[..., idx]
    out = f0 + ((x - xp[idx - 1]) / (xp[idx] - xp[idx - 1])) * (f1 - f0)
    out = torch.where(x < xp[0], fp[..., :1], out)
    return torch.where(x > xp[-1], fp[..., -1:], out)


def freq_nonlinear(mel: torch.Tensor, phase: float, f: float = 1.0, bias: float = 0.02):
    """Sinusoidal frequency-axis warp by linear re-interpolation
    (``data_aug.py:207-222``), one phase per call."""
    n_freq = mel.shape[1]
    ind = torch.arange(n_freq, dtype=torch.float32, device=mel.device)
    x = ind / n_freq
    ind_t = n_freq * (x + bias * torch.sin(2.0 * math.pi * (f * x + phase)))
    return _interp(ind, ind_t, mel.transpose(1, 2)).transpose(1, 2)


# -- composite view generator ------------------------------------------------------

@dataclass
class ViewDraw:
    warp: Optional[Tuple[float, float]] = None  # (phase, bias) of freq_nonlinear
    filt: Optional[FiltAugDraw] = None
    mask: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def draw_feature_transformation(gen: torch.Generator, shape, n_transform: int,
                                choice: Sequence[int],
                                filter_db_range: Sequence[float] = (-0.5, 0.5),
                                filter_bands: Sequence[int] = (3, 6),
                                filter_minimum_bandwidth: int = 6, filter_type: str = "step",
                                freq_mask_ratio: Optional[int] = None,
                                noise_snrs: Optional[Tuple[float, float]] = None
                                ) -> List[ViewDraw]:
    """The draws of ``n_transform`` independent views of a [B, F, T] batch."""
    b, n_freq, _ = shape
    views = []
    for _ in range(n_transform):
        view = ViewDraw()
        if choice[3]:
            bias = 0.03 * float(torch.rand((), generator=gen, device=gen.device))
            view.warp = (float(torch.rand((), generator=gen, device=gen.device)), bias)
        if choice[0]:
            view.filt = draw_filt_aug(gen, b, n_freq, filter_db_range, filter_bands,
                                      filter_minimum_bandwidth, filter_type)
        if choice[1]:
            view.mask = draw_freq_mask(gen, b, n_freq, freq_mask_ratio)
        if choice[2]:
            view.noise = draw_add_noise(gen, shape, noise_snrs)
        views.append(view)
    return views


def feature_transformation(features: torch.Tensor, views: Sequence[ViewDraw],
                           filter_minimum_bandwidth: int = 6, filter_type: str = "step",
                           norm_std: float = 5.0):
    """Apply each view's draws in the reference's order: warp -> filt_aug ->
    freq mask -> noise (``data_aug.py:111-147``). One view returns a
    tensor, several a list (distinct student/teacher views)."""
    out = []
    for view in views:
        x = features
        if view.warp is not None:
            x = freq_nonlinear(x, view.warp[0], bias=view.warp[1])
        if view.filt is not None:
            x = filt_aug(x, view.filt, filter_minimum_bandwidth, filter_type, norm_std)
        if view.mask is not None:
            x = freq_mask(x, *view.mask)
        if view.noise is not None:
            x = add_noise(x, *view.noise)
        out.append(x)
    return out[0] if len(out) == 1 else out
