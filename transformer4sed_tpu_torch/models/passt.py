"""PaSST backbone (port of ``models/passt.py``).

ViT on log-mel "images" with disentangled time/frequency positional
embeddings (``src/models/passt/passt.py:366-612``): 16x16 patches at
stride 10, ``time_new_pos_embed`` cropped to the input's time grid,
``freq_new_pos_embed``, cls + dist tokens with their own
``new_pos_embed``, the f-major token sequence through ``depth`` pre-norm
blocks, named taps, final LayerNorm. In training (``train=True``) an input
shorter than the nominal time grid takes its time embedding from a random
offset drawn from the caller's generator (``models/passt.py:102-112`` of
the JAX package). Patchout is zero in the flagship and not ported yet
(ROADMAP.md, queue 1, item 1).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from transformer4sed_tpu_torch.models.layers import LayerNorm
from transformer4sed_tpu_torch.models.vit import Block, PatchEmbed


class PaSST(nn.Module):
    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 img_size: Tuple[int, int] = (128, 998), tap_layer: int = 10,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.tap_layer = tap_layer
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
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, dtype=dtype) for _ in range(depth))
        self.norm = LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """x: [B, 1, F, T] normalised log-mel. Returns ``layer{k}_out``
        [B, P+2, D] (f32) for the tap layer k, ``frame`` (final-norm tokens,
        f32) and the grid sizes ``f_dim``/``t_dim``. ``generator`` draws the
        training time-embedding offset."""
        out: Dict[str, torch.Tensor] = {}
        patches = self.patch_embed(x)  # [B, D, F', T'] in the compute dtype
        b, d, f_dim, t_dim = patches.shape
        nominal_t = self.grid_size[1]
        time_pos = self.time_new_pos_embed
        if t_dim < nominal_t:
            offset = 0
            if train:
                if generator is None:
                    raise ValueError("train=True on a short input draws a time offset: "
                                     "pass a torch.Generator")
                offset = int(torch.randint(0, nominal_t - t_dim + 1, (), generator=generator,
                                           device=generator.device))
            time_pos = time_pos[:, :, :, offset:offset + t_dim]
        elif t_dim > nominal_t:
            patches = patches[:, :, :, :nominal_t]
            t_dim = nominal_t
        # bf16 patches + f32 embeddings promote to f32, as in the reference
        patches = patches.float() + time_pos + self.freq_new_pos_embed

        seq = patches.reshape(b, d, f_dim * t_dim).transpose(1, 2)  # f-major tokens
        cls = (self.cls_token + self.new_pos_embed[:, :1]).expand(b, -1, -1)
        dist = (self.dist_token + self.new_pos_embed[:, 1:]).expand(b, -1, -1)
        h = torch.cat([cls, dist, seq], dim=1).to(self.dtype)

        for i, blk in enumerate(self.blocks):
            h = blk(h)
            if i + 1 == self.tap_layer:
                out[f"layer{i + 1}_out"] = h.float()
        out["frame"] = self.norm(h)
        out["f_dim"] = f_dim
        out["t_dim"] = t_dim
        return out
