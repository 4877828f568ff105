"""PaSST backbone (port of ``models/passt.py``).

ViT on log-mel "images" with disentangled time/frequency positional
embeddings (``src/models/passt/passt.py:366-612``): 16x16 patches at
stride 10, ``time_new_pos_embed`` cropped to the input's time grid,
``freq_new_pos_embed``, cls + dist tokens with their own
``new_pos_embed``, the f-major token sequence through ``depth`` pre-norm
blocks, named taps, final LayerNorm. In training (``train=True``) an input
shorter than the nominal time grid takes its time embedding from a random
offset drawn from the caller's generator (``models/passt.py:102-112`` of
the JAX package). Patchout, also training only
(``src/models/passt/passt.py:553-571``): structured patchout drops
``s_patchout_t`` time columns and ``s_patchout_f`` frequency rows of the
patch grid, unstructured patchout ``u_patchout`` tokens of the sequence, each
a random subset kept in order; token dropout ``drop_rate`` follows the cls and
dist tokens. All are zero in the flagship. The draws (:class:`PatchoutDraws`)
come from the caller's generator, or are handed in.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from transformer4sed_tpu_torch.models.layers import LayerNorm
from transformer4sed_tpu_torch.models.vit import Block, PatchEmbed, dropout


@dataclass
class PatchoutDraws:
    """The training draws of one backbone forward: the time-embedding offset
    and the sorted indices kept by each patchout (None: that one is off)."""

    offset: int = 0
    keep_t: Optional[torch.Tensor] = None
    keep_f: Optional[torch.Tensor] = None
    keep_tokens: Optional[torch.Tensor] = None


def _draw_keep(gen: torch.Generator, n: int, n_drop: int) -> torch.Tensor:
    """Sorted indices of a random subset of ``n - n_drop`` out of ``n``."""
    return torch.sort(torch.randperm(n, generator=gen, device=gen.device)[:n - n_drop]).values


class PaSST(nn.Module):
    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 img_size: Tuple[int, int] = (128, 998), tap_layer: int = 10,
                 u_patchout: int = 0, s_patchout_t: int = 0, s_patchout_f: int = 0,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.tap_layer = tap_layer
        self.u_patchout = u_patchout
        self.s_patchout_t, self.s_patchout_f = s_patchout_t, s_patchout_f
        self.drop_rate = drop_rate
        self.grid_size = tuple(
            (size - patch) // stride + 1
            for size, patch, stride in zip(img_size, PatchEmbed.PATCH, PatchEmbed.STRIDE)
        )
        self.patch_embed = PatchEmbed(embed_dim, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.new_pos_embed = nn.Parameter(torch.zeros(1, 2, embed_dim))
        self.freq_new_pos_embed = nn.Parameter(torch.zeros(1, embed_dim, self.grid_size[0], 1))
        self.time_new_pos_embed = nn.Parameter(torch.zeros(1, embed_dim, 1, self.grid_size[1]))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, drop=drop_rate, drop_path=drop_path_rate, dtype=dtype)
            for _ in range(depth))
        self.norm = LayerNorm(embed_dim, eps=1e-6)

    def draw_patchout(self, generator: Optional[torch.Generator], f_dim: int,
                      t_dim: int) -> PatchoutDraws:
        """The training draws for a patch grid of ``f_dim`` x ``t_dim`` (after
        the crop to the nominal time grid), in the order the reference makes
        them: offset, time columns, frequency rows, tokens."""
        nominal_t = self.grid_size[1]
        wants = (t_dim < nominal_t, self.s_patchout_t, self.s_patchout_f, self.u_patchout)
        if not any(wants):
            return PatchoutDraws()
        if generator is None:
            raise ValueError("train=True draws a time offset on a short input, and patchout: "
                             "pass a torch.Generator")
        draws = PatchoutDraws()
        if t_dim < nominal_t:
            draws.offset = int(torch.randint(0, nominal_t - t_dim + 1, (), generator=generator,
                                             device=generator.device))
        if self.s_patchout_t:
            draws.keep_t = _draw_keep(generator, t_dim, self.s_patchout_t)
            t_dim -= self.s_patchout_t
        if self.s_patchout_f:
            draws.keep_f = _draw_keep(generator, f_dim, self.s_patchout_f)
            f_dim -= self.s_patchout_f
        if self.u_patchout:
            draws.keep_tokens = _draw_keep(generator, f_dim * t_dim, self.u_patchout)
        return draws

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                patchout_draws: Optional[PatchoutDraws] = None) -> Dict[str, torch.Tensor]:
        """x: [B, 1, F, T] normalised log-mel. Returns ``layer{k}_out``
        [B, P+2, D] (f32) for the tap layer k, ``frame`` (final-norm tokens,
        f32) and the grid sizes ``f_dim``/``t_dim``. In training,
        ``generator`` draws the time-embedding offset, the patchout subsets
        (unless ``patchout_draws`` gives them) and the dropout masks."""
        out: Dict[str, torch.Tensor] = {}
        patches = self.patch_embed(x)  # [B, D, F', T'] in the compute dtype
        b, d, f_dim, t_dim = patches.shape
        nominal_t = self.grid_size[1]
        if t_dim > nominal_t:
            patches = patches[:, :, :, :nominal_t]
            t_dim = nominal_t
        draws = PatchoutDraws()
        if train:
            draws = patchout_draws or self.draw_patchout(generator, f_dim, t_dim)
        time_pos = self.time_new_pos_embed
        if t_dim < nominal_t:
            time_pos = time_pos[:, :, :, draws.offset:draws.offset + t_dim]
        # bf16 patches + f32 embeddings promote to f32, as in the reference
        patches = patches.float() + time_pos + self.freq_new_pos_embed
        if draws.keep_t is not None:
            patches = patches.index_select(3, draws.keep_t.to(patches.device))
            t_dim = patches.shape[3]
        if draws.keep_f is not None:
            patches = patches.index_select(2, draws.keep_f.to(patches.device))
            f_dim = patches.shape[2]

        seq = patches.reshape(b, d, f_dim * t_dim).transpose(1, 2)  # f-major tokens
        if draws.keep_tokens is not None:
            seq = seq.index_select(1, draws.keep_tokens.to(seq.device))
        cls = (self.cls_token + self.new_pos_embed[:, :1]).expand(b, -1, -1)
        dist = (self.dist_token + self.new_pos_embed[:, 1:]).expand(b, -1, -1)
        h = dropout(torch.cat([cls, dist, seq], dim=1), self.drop_rate, train, generator)
        h = h.to(self.dtype)

        for i, blk in enumerate(self.blocks):
            h = blk(h, train, generator)
            if i + 1 == self.tap_layer:
                out[f"layer{i + 1}_out"] = h.float()
        out["frame"] = self.norm(h)
        out["f_dim"] = f_dim
        out["t_dim"] = t_dim
        return out
