"""PMAM frame-feature extraction (port of ``pmam/features.py``).

The reference pulls frame embeddings with forward hooks on a decoder block or
the interpolation module, and keeps one random frame per ``downsample_rate``
frames (``recipes/desed/pmam/extractor_feature.py:64-125``). The JAX package
taps them through flax's ``capture_intermediates``; here the model's own
:meth:`~models.passt_sed.PaSST_SED.tap` stops its eval forward at the tap, so no
hook is registered. Feature-layer names: ``transformer_{k}`` (the output of
decoder block k, after the MLM masker when the model has one) or
``after_interpolate`` (``frame_before_mask``, the decoder's input).

The draws (each batch's mask, then its frame offsets) come from one
``torch.Generator``, or are handed in so a test can feed the JAX package's.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from transformer4sed_tpu_torch.models.mlm import MLMDraws


def draw_offsets(generator: torch.Generator, length: int, downsample_rate: int) -> torch.Tensor:
    """One offset in [0, downsample_rate) for each interval of ``length`` rows."""
    n = -(-length // downsample_rate)
    return torch.randint(0, downsample_rate, (n,), generator=generator, device=generator.device)


def sample_features(features: torch.Tensor, downsample_rate: int,
                    generator: Optional[torch.Generator] = None,
                    offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Random-offset temporal downsampling (``extractor_feature.py:64-69``):
    [L, C] flattened frame features -> one row per ``downsample_rate``
    interval, at the interval's start plus its offset (clipped to the last
    row). The offsets are drawn from ``generator`` or given."""
    length = features.shape[0]
    if offsets is None:
        offsets = draw_offsets(generator, length, downsample_rate)
    intervals = torch.arange(0, length, downsample_rate, device=features.device)
    idx = torch.clamp(intervals + offsets.to(features.device), max=length - 1)
    return features[idx]


@torch.no_grad()
def extract_frame_features(model, mel_batches: Iterable[torch.Tensor],
                           feature_layer: str = "transformer_0", downsample_rate: int = 4,
                           generator: Optional[torch.Generator] = None,
                           mlm_draws: Optional[Sequence[MLMDraws]] = None,
                           offsets: Optional[Sequence[torch.Tensor]] = None) -> np.ndarray:
    """The frozen model (in eval mode) over the mel batches: tap
    ``feature_layer``, flatten each batch's [B, T, C] to [B*T, C], downsample,
    and return the [N, C] features as float32 numpy. Batch i's mask draws and
    offsets come from ``generator`` or from ``mlm_draws[i]`` / ``offsets[i]``."""
    chunks = []
    for i, mel in enumerate(mel_batches):
        feats = model.tap(mel, feature_layer, generator,
                          None if mlm_draws is None else mlm_draws[i])
        flat = feats.reshape(-1, feats.shape[-1])
        sampled = sample_features(flat, downsample_rate, generator,
                                  None if offsets is None else offsets[i])
        chunks.append(sampled.float().cpu().numpy())
    return np.concatenate(chunks, axis=0)
