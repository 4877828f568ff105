"""HTSAT-based SED heads (port of ``HTSAT_CNN`` in ``models/htsat_heads.py``).

HTSAT_CNN (``src/models/htsat/htsat_cnn.py:13-209``): the backbone's
``fine_grained_embedding`` ([B, 32, 768] for the CLAP-tiny config) is
upsampled by ``backbone_upsample_ratio``, the CNN branch's features are
resized onto that grid, both are projected to ``decoder_dim`` and merged
with a learned weight, normalised, decoded by a Transformer-XL (or by
nothing) and classified frame by frame: ``sigmoid(logits / temp_w)``,
pad-mask zeroing, clipping to [1e-7, 1], linear-softmax weak pooling.
Params keep the upstream state-dict names (``backbone``, ``cnn.cnn``,
``cnn_projector``, ``transformer_projector``, ``merge_weight``,
``norm_after_merge``, ``sed_decoder``, ``sed_head``). ``CLAP_SED`` and
``DASM_HTSAT`` come with their recipes (ROADMAP.md, queue 1, items 10-11).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from transformer4sed_tpu_torch.core.pooling_math import linear_softmax_pool
from transformer4sed_tpu_torch.models.cnn import CNN
from transformer4sed_tpu_torch.models.htsat import create_htsat_model
from transformer4sed_tpu_torch.models.interpolate import interpolate_time, resize_time
from transformer4sed_tpu_torch.models.layers import Dense, LayerNorm
from transformer4sed_tpu_torch.models.sed_model import SEDOutput
from transformer4sed_tpu_torch.models.xl import TransformerXLDecoder
from transformer4sed_tpu_torch.utils.device import resolve_device

_DECODERS = "is not ported yet: ROADMAP.md, queue 1, item 2 (head and decoder options)"
_MLM_MODE = "is not ported yet: ROADMAP.md, queue 1, item 10 (the HTSAT family's remaining parts)"


class HTSAT_CNN(nn.Module):
    """HTSAT fine-grained embedding + CNN merge + SED decoder head."""

    def __init__(
        self,
        class_num: int = 10,
        decoder_dim: int = 768,
        num_heads: int = 12,
        decoder: str = "transformerXL",
        decoder_layer_num: int = 2,
        decoder_pos_emd_len: int = 1000,
        decoder_expand_rate: float = 1.0,
        backbone_upsample_ratio: int = 10,
        htsat_config: str = "tiny",
        htsat_kwargs: Optional[Dict[str, Any]] = None,  # create_htsat_model overrides
        cnn_param: Optional[Dict[str, Any]] = None,
        mlm_dict: Optional[Dict[str, Any]] = None,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        if decoder in ("gru", "conformer"):
            raise NotImplementedError(f"decoder={decoder!r} {_DECODERS}")
        if decoder not in ("transformerXL", "no"):
            raise ValueError(f"invalid decoder {decoder!r}")
        if mlm_dict is not None:
            raise NotImplementedError(f"mlm_dict (masked reconstruction) {_MLM_MODE}")
        device = resolve_device(device)
        self.backbone_upsample_ratio = backbone_upsample_ratio
        self.backbone = create_htsat_model(htsat_config, dtype=dtype, **(htsat_kwargs or {}))
        self.cnn = None
        if cnn_param is not None:
            self.cnn = CNN(dtype=dtype, **dict(cnn_param))
            self.cnn_projector = Dense(self.cnn.out_channels, decoder_dim)
            self.merge_weight = nn.Parameter(torch.full((1,), 0.5))
        self.transformer_projector = Dense(self.backbone.num_features, decoder_dim)
        self.norm_after_merge = LayerNorm(decoder_dim, eps=1e-5)
        self.sed_decoder = None
        if decoder == "transformerXL":
            self.sed_decoder = TransformerXLDecoder(
                decoder_dim, decoder_layer_num=decoder_layer_num, num_heads=num_heads,
                seq_len=decoder_pos_emd_len, mlp_ratio=decoder_expand_rate, dtype=dtype)
        self.sed_head = Dense(decoder_dim, class_num)
        self.to(device)

    def forward(
        self,
        mel: torch.Tensor,  # [B, 1, T, F] log-mel (HTSATFrontend output)
        temp_w: float = 0.1,
        pad_mask: Optional[torch.Tensor] = None,  # [B, frames] bool, True = padded
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        dropout_masks: Optional[Sequence[torch.Tensor]] = None,
    ) -> SEDOutput:
        """BatchNorm and dropout follow the module's mode (``model.train()``
        / ``model.eval()``); ``train`` is accepted so the trainers call every
        model alike, and must agree with that mode. The CNN's dropout masks
        are drawn from ``generator`` (or given as ``dropout_masks``)."""
        if train != self.training:
            raise ValueError(f"train={train} but the module is in "
                             f"{'training' if self.training else 'eval'} mode")
        feat = self.backbone(mel)["fine_grained_embedding"]  # [B, T', C]
        x = interpolate_time(feat, self.backbone_upsample_ratio, "linear")
        if self.cnn is not None:
            cnn_feat = self.cnn(mel, generator=generator, dropout_masks=dropout_masks)
            assert cnn_feat.shape[-1] == 1  # [B, C, T'', 1]
            cnn_feat = resize_time(cnn_feat[:, :, :, 0].transpose(1, 2), x.shape[1], "linear")
            x = self.transformer_projector(x) + self.merge_weight * self.cnn_projector(cnn_feat)
        else:
            x = self.transformer_projector(x)
        x = self.norm_after_merge(x)
        if self.sed_decoder is not None:
            x = self.sed_decoder(x)
        logits = self.sed_head(x)
        sed = torch.sigmoid(logits / temp_w)
        if pad_mask is not None:
            sed = torch.where(pad_mask[:, :, None], 0.0, sed)
        sed = torch.clamp(sed, 1e-7, 1.0)
        return SEDOutput(
            strong=sed.transpose(1, 2),
            weak=linear_softmax_pool(sed, axis=1),
            extras={"logit": logits.transpose(1, 2)},
        )
