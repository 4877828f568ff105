"""PaSST_SED, the MAT-SED network (port of ``models/passt_sed.py``).

PaSST encoder tapped at ``passt_feature_layer`` -> drop cls/dist tokens
-> ``out_norm`` -> frequency mean-pool over the [B, f, t, C] patch grid
-> pad the time grid by its last frame (99 -> 100) -> x``decode_ratio``
linear interpolation -> Transformer-XL decoder -> classifier ->
``sigmoid(logits / temp_w)``, pad-mask zeroing, linear-softmax weak
pooling; the AT adapter attention-pools the backbone's final-norm frame
tokens. Params keep the upstream cai525 state-dict names (including
upstream's ``at_adpater`` spelling), so published ``.pt`` files load
with ``load_state_dict``. ``train=True`` is the forward of the
mean-teacher step; it is differentiable end to end through the attention
kernels' autograd Functions.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn as nn

from transformer4sed_tpu_torch.core.pooling_math import linear_softmax_pool
from transformer4sed_tpu_torch.models.interpolate import interpolate_time
from transformer4sed_tpu_torch.models.layers import Dense, LayerNorm
from transformer4sed_tpu_torch.models.passt import PaSST
from transformer4sed_tpu_torch.models.pooling import AttentionPooling
from transformer4sed_tpu_torch.models.sed_model import SEDOutput
from transformer4sed_tpu_torch.models.xl import TransformerXLDecoder
from transformer4sed_tpu_torch.utils.device import resolve_device

_LATER = "is not ported yet: ROADMAP.md, queue 1, item 2 (head and decoder options)"
_MLM_SLICE = "is not ported yet: ROADMAP.md, queue 1, item 1 (the MLM pretrain slice)"


class PaSST_SED(nn.Module):
    def __init__(
        self,
        class_num: int = 10,
        decode_ratio: int = 10,
        interpolate_mode: str = "linear",
        passt_feature_layer: int = 10,
        embed_dim: int = 768,
        decoder_dim: int = 768,
        f_pool: str = "mean_pool",
        decoder: str = "transformerXL",
        decoder_layer_num: int = 3,
        decoder_pos_emd_len: int = 1000,
        decoder_win_len: Optional[Any] = None,
        at_adapter: bool = False,
        mlm: bool = False,
        s_patchout_f: int = 0,
        s_patchout_t: int = 0,
        backbone_depth: int = 12,
        backbone_num_heads: int = 12,
        backbone_img_size: Tuple[int, int] = (128, 998),
        decoder_num_heads: int = 12,
        at_adapter_heads: int = 12,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        if f_pool != "mean_pool":
            raise NotImplementedError(f"f_pool={f_pool!r} {_LATER}")
        if decoder != "transformerXL":
            raise NotImplementedError(f"decoder={decoder!r} {_LATER}")
        if decoder_win_len is not None:
            raise NotImplementedError(f"decoder_win_len (local attention) {_LATER}")
        if interpolate_mode != "linear":
            raise NotImplementedError(f"interpolate_mode={interpolate_mode!r} {_LATER}")
        if mlm:
            raise NotImplementedError(f"mlm=True (masked reconstruction) {_MLM_SLICE}")
        if s_patchout_f or s_patchout_t:
            raise NotImplementedError(f"structured patchout {_MLM_SLICE}")
        if decoder_dim != embed_dim:
            raise ValueError("the XL decoder runs at the backbone width")
        device = resolve_device(device)
        self.decode_ratio = decode_ratio
        self.passt_feature_layer = passt_feature_layer
        self.backbone = PaSST(
            embed_dim=embed_dim, depth=backbone_depth, num_heads=backbone_num_heads,
            img_size=tuple(backbone_img_size), tap_layer=passt_feature_layer, dtype=dtype,
        )
        self.out_norm = LayerNorm(embed_dim, eps=1e-5)
        self.decoder = TransformerXLDecoder(
            decoder_dim, decoder_layer_num=decoder_layer_num, num_heads=decoder_num_heads,
            seq_len=decoder_pos_emd_len, dtype=dtype,
        )
        self.classifier = Dense(decoder_dim, class_num)
        self.at_adpater = (
            nn.ModuleList([AttentionPooling(embed_dim, at_adapter_heads, dtype=dtype),
                           Dense(embed_dim, class_num)])
            if at_adapter else None
        )
        self.to(device)

    def forward(
        self,
        mel: torch.Tensor,  # [B, F, T] normalised log-mel
        temp_w: float = 1.0,
        pad_mask: Optional[torch.Tensor] = None,  # [B, frames] bool, True = padded
        encoder_win: bool = False,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> SEDOutput:
        if encoder_win:
            raise NotImplementedError(f"encoder_win (sliding-window fusion) {_LATER}")
        backbone_out = self.backbone(mel[:, None], train=train, generator=generator)
        feat = self.out_norm(backbone_out[f"layer{self.passt_feature_layer}_out"][:, 2:, :])
        b, _, c = feat.shape
        x = feat.reshape(b, backbone_out["f_dim"], backbone_out["t_dim"], c).mean(dim=1)
        x = torch.cat([x, x[:, -1:, :]], dim=1)
        x = self.decoder(interpolate_time(x, self.decode_ratio))

        at_out = None
        if self.at_adpater is not None:
            pool, head = self.at_adpater
            at_out = torch.sigmoid(head(pool(backbone_out["frame"][:, 2:, :])))

        sed = torch.sigmoid(self.classifier(x) / temp_w)
        if pad_mask is not None:
            sed = torch.where(pad_mask[:, :, None], 0.0, sed)
        return SEDOutput(
            strong=sed.transpose(1, 2),
            weak=linear_softmax_pool(sed, axis=1),
            at_out=at_out,
        )
