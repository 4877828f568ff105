"""BERT-style masking of frame-token sequences for masked-reconstruction
pretraining (port of ``models/mlm.py``).

``MlmModule`` of the reference (``src/models/transformer/mask.py:49-107``):

  * ``strategy='random'``: iid Bernoulli(mask_rate) over frames;
  * ``strategy='block'``: T splits into ``T // block_width`` segments, one
    uniform draw per segment, and the ``~mask_rate`` share with the smallest
    draws is masked (the sorted-threshold construction, so the masked count
    per clip is exact);
  * a masked frame becomes the mask token with probability
    ``mask_style[0]``, a random frame of the flattened batch with probability
    ``mask_style[1]``, and stays as it is otherwise.

Masking is a draw step (:meth:`MLMMasker.draw`, from a ``torch.Generator``)
and an apply step (:meth:`MLMMasker.apply`), so a test can feed the apply
step another package's draws. The masking really masks (the reference's
in-place write is lost on its non-contiguous input; ``PARITY.md``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass
class MLMDraws:
    """noise: [B, T] (random) or [B, T // block_width] (block) uniforms that
    choose the masked frames; probs: [B, T] uniforms that choose each masked
    frame's style; rand_src: [B, T] int64 rows of the flattened batch."""

    noise: torch.Tensor
    probs: torch.Tensor
    rand_src: torch.Tensor


@dataclass(frozen=True)
class MLMMasker:
    mask_rate: float = 0.75
    mask_style: Tuple[float, float, float] = (0.8, 0.1, 0.1)
    strategy: str = "block"
    block_width: int = 10

    def __post_init__(self):
        if self.strategy not in ("random", "block"):
            raise ValueError(f"unknown mask strategy {self.strategy!r}")

    def draw(self, gen: torch.Generator, batch: int, seq_len: int) -> MLMDraws:
        n = seq_len if self.strategy == "random" else seq_len // self.block_width
        kw = dict(generator=gen, device=gen.device)
        return MLMDraws(noise=torch.rand((batch, n), **kw),
                        probs=torch.rand((batch, seq_len), **kw),
                        rand_src=torch.randint(0, batch * seq_len, (batch, seq_len), **kw))

    def mask_ids(self, noise: torch.Tensor, seq_len: int) -> torch.Tensor:
        """[B, T] bool mask of the frames to corrupt, from the noise draws."""
        if self.strategy == "random":
            return noise <= self.mask_rate
        num_seg = seq_len // self.block_width
        kth = min(int(num_seg * self.mask_rate), num_seg - 1)
        threshold = torch.sort(noise, dim=1).values[:, kth:kth + 1]
        frame_mask = torch.repeat_interleave(noise <= threshold, self.block_width, dim=1)
        pad = seq_len - num_seg * self.block_width
        if pad:
            frame_mask = torch.cat([frame_mask, frame_mask.new_zeros((noise.shape[0], pad))], 1)
        return frame_mask

    def apply(self, token_seq: torch.Tensor, mask_token: torch.Tensor,
              draws: MLMDraws) -> Tuple[torch.Tensor, torch.Tensor]:
        """Corrupt ``token_seq`` [B, T, C]; returns (masked_seq, mask_id_seq)."""
        b, t, c = token_seq.shape
        dev = token_seq.device
        mask_id = self.mask_ids(draws.noise.to(dev), t)
        probs = draws.probs.to(dev)
        p_tok, p_rand = self.mask_style[0], self.mask_style[1]
        use_token = mask_id & (probs < p_tok)
        use_random = mask_id & (probs >= p_tok) & (probs < p_tok + p_rand)
        random_tokens = token_seq.reshape(b * t, c)[draws.rand_src.to(dev)]
        out = torch.where(use_token[..., None], mask_token.reshape(1, 1, c).to(token_seq.dtype),
                          token_seq)
        return torch.where(use_random[..., None], random_tokens, out), mask_id
