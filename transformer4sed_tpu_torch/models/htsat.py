"""HTS-AT: hierarchical token-semantic audio transformer (port of ``models/htsat.py``).

The audio branch of CLAP (``src/models/htsat/htsat.py:621-945``):

  * log-mel (64 slaney bins, torchlibrosa semantics: :class:`HTSATFrontend`)
    -> per-mel-bin BatchNorm ``bn0`` -> ``reshape_wav2img`` frequency-ratio
    folding into a [spec_size, spec_size] image (short mels are resized by
    the bicubic matrix of :func:`bicubic_resize_matrix`, the same numbers
    the JAX package multiplies by);
  * Swin stages (window attention with relative-position bias, shifted
    windows, patch merging); the attention is
    ``kernels/window_attention.py:swin_window_attention``, the CUDA kernels
    on the card and their plain versions on the CPU (the JAX package's
    ``use_flash=False`` scores compute the same function and have no second
    path here);
  * heads: the token-semantic ``tscam`` convolution -> framewise and clipwise
    outputs, plus ``fine_grained_embedding`` (freq-fold mean of the last
    feature map), which HTSAT_CNN consumes, and ``embedding``.

Module attribute names are upstream's (``patch_embed.proj``,
``layers.{i}.blocks.{j}.attn.relative_position_bias_table``,
``layers.{i}.downsample.reduction``, ``bn0``, ``tscam_conv``, and the
``attn_mask`` / ``relative_position_index`` buffers), so a published
``.pt`` file loads with ``load_state_dict``. Matmuls and convolutions run
in ``dtype`` with f32 params; layer norms, BatchNorm statistics, softmax
and the residual stream are f32. Stochastic depth and dropout are 0 in
every shipped config and are not ported.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from transformer4sed_tpu_torch.frontend.mel import hann_window, stft_power
from transformer4sed_tpu_torch.kernels.window_attention import swin_window_attention
from transformer4sed_tpu_torch.models.interpolate import interpolate_time
from transformer4sed_tpu_torch.models.layers import Dense, LayerNorm
from transformer4sed_tpu_torch.models.norm import RefBatchNorm
from transformer4sed_tpu_torch.models.vit import Mlp
from transformer4sed_tpu_torch.utils.device import resolve_device


# -- slaney mel (librosa default, used by torchlibrosa LogmelFilterBank) -------

def _hz_to_slaney_mel(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, f / f_sp)


def _slaney_mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def slaney_mel_banks(n_mels: int, n_fft: int, sr: float, fmin: float, fmax: float) -> np.ndarray:
    """librosa.filters.mel(htk=False, norm='slaney') parity, [n_mels, n_fft//2+1]."""
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0, sr / 2, n_freqs)
    mel_pts = np.linspace(_hz_to_slaney_mel(fmin), _hz_to_slaney_mel(fmax), n_mels + 2)
    hz_pts = _slaney_mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


@dataclass
class HTSATFrontend:
    """torchlibrosa Spectrogram + LogmelFilterBank parity (CLAP tiny config):
    wav [B, S] -> log-mel [B, 1, T, n_mels] in dB. The STFT is ``torch.stft``
    with a periodic Hann window. There is no training draw:
    :meth:`draw_fminmax` returns None and :meth:`normalize` is the identity,
    so the trainers treat it like :class:`PasstFrontend`."""

    sr: int = 32000
    n_fft: int = 1024
    hop_length: int = 320
    n_mels: int = 64
    fmin: float = 50.0
    fmax: float = 14000.0
    ref: float = 1.0
    amin: float = 1e-10
    device: Optional[torch.device] = None
    _window: torch.Tensor = field(init=False, repr=False)
    _basis: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._window = torch.as_tensor(hann_window(self.n_fft, periodic=True), device=self.device)
        self._basis = torch.as_tensor(
            slaney_mel_banks(self.n_mels, self.n_fft, self.sr, self.fmin, self.fmax),
            device=self.device)

    def draw_fminmax(self, gen: torch.Generator) -> None:
        return None

    def __call__(self, wav: torch.Tensor, fminmax=None) -> torch.Tensor:
        if wav.ndim == 1:
            wav = wav[None]
        wav = wav.to(device=self.device, dtype=torch.float32)
        power = stft_power(wav, self.n_fft, self.hop_length, self.n_fft, self._window)
        mel = torch.einsum("mf,bft->bmt", self._basis, power)
        logmel = 10.0 * torch.log10(torch.clamp_min(mel, self.amin))
        logmel = logmel - 10.0 * float(np.log10(max(self.ref, self.amin)))
        return logmel.transpose(1, 2)[:, None]  # [B, 1, T, F]

    def normalize(self, mel: torch.Tensor) -> torch.Tensor:
        return mel


@functools.lru_cache(maxsize=16)
def bicubic_resize_matrix(in_len: int, out_len: int, a: float = -0.75) -> np.ndarray:
    """[out, in] weights reproducing torch ``F.interpolate(mode='bicubic',
    align_corners=True)`` along one axis (cubic convolution, Keys A=-0.75,
    out-of-range taps clamped to the border)."""

    def cc1(x):  # |x| <= 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def cc2(x):  # 1 < |x| < 2
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    w = np.zeros((out_len, in_len), dtype=np.float64)
    scale = (in_len - 1) / (out_len - 1) if out_len > 1 else 0.0
    for i in range(out_len):
        real = i * scale
        f = int(np.floor(real))
        frac = real - f
        taps = (f - 1, f, f + 1, f + 2)
        coefs = (cc2(frac + 1.0), cc1(frac), cc1(1.0 - frac), cc2(2.0 - frac))
        for idx, cf in zip(taps, coefs):
            w[i, min(max(idx, 0), in_len - 1)] += cf
    return w.astype(np.float32)


# -- Swin pieces ----------------------------------------------------------------

def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, w*w, C]."""
    b, h, width, c = x.shape
    x = x.reshape(b, h // w, w, width // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def window_reverse(windows: torch.Tensor, w: int, h: int, width: int) -> torch.Tensor:
    """[B*nW, w*w, C] -> [B, H, W, C]."""
    b = windows.shape[0] // (h * width // w // w)
    x = windows.reshape(b, h // w, width // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, width, -1)


def _relative_position_index(w: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))  # [2, w, w]
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # [2, w², w²]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)  # [w², w²]


def _shift_attn_mask(h: int, width: int, w: int, shift: int) -> np.ndarray:
    """Additive [-100 / 0] mask for shifted windows, [nW, w², w²]."""
    img = np.zeros((h, width))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // w, w, width // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, qkv_bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_relative_position_index(window_size)))
        # parallel.partition.TPShard once qkv / proj are sharded: this rank's
        # heads, and their columns of the (replicated) bias table
        self.tp = None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                n_windows: int = 1) -> torch.Tensor:
        bnw, n, _ = x.shape
        qkv = self.qkv(x)
        c = qkv.shape[-1] // 3  # this rank's width under tensor parallelism
        table = self.relative_position_bias_table
        h = self.num_heads
        if self.tp is not None:
            h = self.tp.heads
            table = self.tp.local(table, 1)
        hd = c // h
        q, k, v = qkv.reshape(bnw, n, 3, h, hd).unbind(2)
        bias = table[self.relative_position_index.reshape(-1)].reshape(n, n, h)
        bias = bias.permute(2, 0, 1).contiguous()  # [H, w², w²]
        n_w = n_windows if mask is None else int(mask.shape[0])
        out = swin_window_attention(q, k, v, bias, mask, n_w, hd ** -0.5)
        return self.proj(out.reshape(bnw, n, c))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, input_resolution: Tuple[int, int], num_heads: int,
                 window_size: int, shift_size: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, dtype=torch.float32):
        super().__init__()
        hgt, wdt = input_resolution
        self.input_resolution = (hgt, wdt)
        win = min(window_size, hgt, wdt)
        # a window as large as the grid is not shifted (stage 3: resolution 8)
        shift = 0 if win >= min(hgt, wdt) else shift_size
        self.window_size, self.shift_size = win, shift
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, win, qkv_bias=qkv_bias, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self.register_buffer(
            "attn_mask",
            torch.from_numpy(_shift_attn_mask(hgt, wdt, win, shift)) if shift else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hgt, wdt = self.input_resolution
        b, l, c = x.shape
        assert l == hgt * wdt
        win, shift = self.window_size, self.shift_size
        h = self.norm1(x).reshape(b, hgt, wdt, c)
        if shift:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        attn_out = self.attn(window_partition(h, win), mask=self.attn_mask,
                             n_windows=(hgt // win) * (wdt // win))
        h = window_reverse(attn_out, win, hgt, wdt)
        if shift:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        x = x + h.reshape(b, l, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, input_resolution: Tuple[int, int], dtype=torch.float32):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hgt, wdt = self.input_resolution
        b, _, c = x.shape
        x = x.reshape(b, hgt, wdt, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1).reshape(b, -1, 4 * c)
        return self.reduction(self.norm(x))


class _PatchEmbed(nn.Module):
    """conv(k = patch, s = stride) + LayerNorm: [B, 1, S, S] -> [B, L, D]."""

    def __init__(self, patch_size: int, patch_stride: Tuple[int, int], embed_dim: int, dtype):
        super().__init__()
        self.proj = nn.Conv2d(1, embed_dim, kernel_size=patch_size, stride=tuple(patch_stride))
        self.norm = LayerNorm(embed_dim, eps=1e-5)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        dt = self.compute_dtype
        h = F.conv2d(x.to(dt), self.proj.weight.to(dt), self.proj.bias.to(dt),
                     stride=self.proj.stride)
        gh, gw = h.shape[2], h.shape[3]
        return self.norm(h.flatten(2).transpose(1, 2)), (gh, gw)


class _Stage(nn.Module):
    def __init__(self, blocks: Sequence[nn.Module], downsample: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x if self.downsample is None else self.downsample(x)


class HTSAT(nn.Module):
    """HTS-AT Swin backbone + token-semantic heads (CLAP audio branch)."""

    def __init__(self, spec_size: int = 256, patch_size: int = 4,
                 patch_stride: Tuple[int, int] = (4, 4), num_classes: int = 527,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window_size: int = 8,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, mel_bins: int = 64,
                 dtype=torch.float32):
        super().__init__()
        self.spec_size, self.mel_bins = spec_size, mel_bins
        self.patch_stride = tuple(patch_stride)
        self.depths = tuple(depths)
        self.compute_dtype = dtype
        self.freq_ratio = spec_size // mel_bins
        self.num_features = int(embed_dim * 2 ** (len(depths) - 1))
        self.bn0 = RefBatchNorm(mel_bins, momentum=0.1, eps=1e-5)
        self.patch_embed = _PatchEmbed(patch_size, self.patch_stride, embed_dim, dtype)
        res = (spec_size // self.patch_stride[0], spec_size // self.patch_stride[1])
        stages = []
        for i, depth in enumerate(depths):
            dim = int(embed_dim * 2 ** i)
            blocks = [SwinBlock(dim, res, num_heads[i], window_size,
                                0 if j % 2 == 0 else window_size // 2, mlp_ratio, qkv_bias, dtype)
                      for j in range(depth)]
            last = i == len(depths) - 1
            stages.append(_Stage(blocks, None if last else PatchMerging(dim, res, dtype)))
            if not last:
                res = (res[0] // 2, res[1] // 2)
        self.layers = nn.ModuleList(stages)
        self.norm = LayerNorm(self.num_features, eps=1e-5)
        sf = spec_size // (2 ** (len(depths) - 1)) // self.patch_stride[0]
        self.c_freq_bin = sf // self.freq_ratio
        self.tscam_conv = nn.Conv2d(self.num_features, num_classes,
                                    kernel_size=(self.c_freq_bin, 3), padding=(0, 1))
        self._resize = {}  # (in, out, device, dtype) -> bicubic matrix on the device

    def _resize_matrix(self, in_len: int, out_len: int, like: torch.Tensor) -> torch.Tensor:
        key = (in_len, out_len, like.device, like.dtype)
        if key not in self._resize:
            self._resize[key] = torch.as_tensor(
                bicubic_resize_matrix(in_len, out_len), device=like.device).to(like.dtype)
        return self._resize[key]

    def reshape_wav2img(self, x: torch.Tensor) -> torch.Tensor:
        """Fold [B, 1, T, F] log-mel into a [B, 1, S, S] image (htsat.py:848-863)."""
        b, c, t, f = x.shape
        target_t = self.spec_size * self.freq_ratio
        target_f = self.spec_size // self.freq_ratio
        assert t <= target_t and f <= target_f, "mel larger than swin input"
        if t < target_t:
            x = torch.einsum("ot,bctf->bcof", self._resize_matrix(t, target_t, x), x)
        if f < target_f:
            x = torch.einsum("of,bctf->bcto", self._resize_matrix(f, target_f, x), x)
        x = x.transpose(2, 3)  # [B, C, F, T]
        x = x.reshape(b, c, target_f, self.freq_ratio, target_t // self.freq_ratio)
        x = x.permute(0, 1, 3, 2, 4)
        return x.reshape(b, c, self.freq_ratio * target_f, target_t // self.freq_ratio)

    def forward(self, mel: torch.Tensor) -> Dict[str, torch.Tensor]:
        """mel: [B, 1, T, F] log-mel. Returns the reference's output dict:
        framewise_output, clipwise_output, fine_grained_embedding,
        embedding, latent_t. BatchNorm follows ``self.training``."""
        x = self.reshape_wav2img(self.bn0(mel[:, 0])[:, None])  # [B, 1, S, S]
        frames_num = x.shape[2]
        h, _ = self.patch_embed(x)
        for stage in self.layers:
            h = stage(h)
        h = self.norm(h)
        b, _, c = h.shape
        down = 2 ** (len(self.depths) - 1)
        sf = frames_num // down // self.patch_stride[0]
        st = x.shape[3] // down // self.patch_stride[1]
        grid = h.transpose(1, 2).reshape(b, c, sf, st)

        # unfold the freq-ratio folding: [B, C, F', ratio * T']
        cfb = self.c_freq_bin
        grid = grid.reshape(b, c, sf // cfb, cfb, st).permute(0, 1, 3, 2, 4).reshape(b, c, cfb, -1)
        fine_grained = grid.mean(dim=2).transpose(1, 2)  # [B, T'', C]
        embedding = grid.reshape(b, c, -1).mean(dim=2)

        # token-semantic head: conv (c_freq_bin, 3) over [B, C, F', T'']
        dt = self.compute_dtype
        logits = F.conv2d(grid.to(dt), self.tscam_conv.weight.to(dt), self.tscam_conv.bias.to(dt),
                          padding=self.tscam_conv.padding)[:, :, 0].transpose(1, 2)
        framewise = interpolate_time(torch.sigmoid(logits), 8 * self.patch_stride[1], "nearest")
        return {
            "framewise_output": framewise,
            "clipwise_output": torch.sigmoid(logits.mean(dim=1)),
            "fine_grained_embedding": fine_grained,
            "embedding": embedding,
            "latent_t": fine_grained.shape[1],
        }


def create_htsat_model(config: str = "tiny", **overrides) -> HTSAT:
    """Factory matching the reference ``create_htsat_model`` sizes
    (``htsat.py:901-945``)."""
    sizes = {
        "tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(4, 8, 16, 32)),
        "base": dict(embed_dim=128, depths=(2, 2, 12, 2), num_heads=(4, 8, 16, 32)),
        "large": dict(embed_dim=256, depths=(2, 2, 12, 2), num_heads=(4, 8, 16, 32)),
    }
    kwargs = dict(sizes[config])
    kwargs.update(overrides)
    return HTSAT(**kwargs)
