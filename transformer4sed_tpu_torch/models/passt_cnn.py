"""PaSST_CNN, the PMAM network (port of ``models/passt_cnn.py``).

PaSST_SED with a parallel CNN branch merged before the decoder
(``src/models/cnn_transformer/passt_cnn.py:9-92``): the transformer frame
embedding [B, T, embed_dim] and the CNN's features of the same mel (seen as
[B, 1, T, F], resized in time onto the decoder grid) merge as
``transformer_projector(x) + merge_weight * cnn_projector(cnn_feat)`` at the
decoder's width, which may differ from the backbone's (PMAM: 768 -> 384,
12 decoder heads of 32). The CNN's BatchNorm and dropout follow the module's
mode (``model.train()`` / ``model.eval()``), like ``HTSAT_CNN``'s. Params
keep the upstream names (``cnn.cnn.*``, ``cnn_projector``,
``transformer_projector``, ``merge_weight``).

Not ported yet: the ``FDY-CNN`` and ``resnet`` branches (ROADMAP.md, queue 1,
item 10), ``PasstComplexCNN``, ``PaSST_CNN(mlm=True)`` with the prototype
loss of the post-pretrain stage (item 12) and ``encoder_win`` (item 2).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from transformer4sed_tpu_torch.models.cnn import CNN, BatchRows
from transformer4sed_tpu_torch.models.interpolate import resize_time
from transformer4sed_tpu_torch.models.layers import Dense
from transformer4sed_tpu_torch.models.passt_sed import _LATER, PaSST_SED
from transformer4sed_tpu_torch.models.sed_model import SEDOutput
from transformer4sed_tpu_torch.utils.device import resolve_device

_CNN_FAMILY = "is not ported yet: ROADMAP.md, queue 1, item 10 (the rest of models/cnn.py)"
_PMAM = "is not ported yet: ROADMAP.md, queue 1, item 12 (PMAM's post-pretrain stage)"


class PaSST_CNN(PaSST_SED):
    projects_frames = True

    def __init__(self, cnn_name: str = "base", cnn_param: Optional[Dict[str, Any]] = None,
                 device=None, **kwargs):
        if kwargs.get("mlm"):
            raise NotImplementedError(f"PaSST_CNN(mlm=True) {_PMAM}")
        if cnn_param is not None and cnn_name in ("FDY-CNN", "resnet"):
            raise NotImplementedError(f"cnn_name={cnn_name!r} {_CNN_FAMILY}")
        if cnn_param is not None and cnn_name != "base":
            raise NotImplementedError(f"unknown cnn encoder {cnn_name!r}")
        device = resolve_device(device)
        super().__init__(device="cpu", **kwargs)
        self.cnn = None
        if cnn_param is not None:
            self.cnn = CNN(dtype=self.compute_dtype, **dict(cnn_param))
            self.cnn_projector = Dense(self.cnn.out_channels, self.decoder_dim)
            # trainable only in MLM mode upstream; the fine-tune stages give it
            # the decoder group's learning rate (train/optim.py)
            self.merge_weight = nn.Parameter(torch.full((1,), 0.5))
        self.transformer_projector = Dense(self.embed_dim, self.decoder_dim)
        self.to(device)

    def forward(
        self,
        mel: torch.Tensor,  # [B, F, T] normalised log-mel
        temp_w: float = 1.0,
        pad_mask: Optional[torch.Tensor] = None,
        encoder_win: bool = False,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        dropout_masks: Optional[Sequence[torch.Tensor]] = None,
        rows: Optional[BatchRows] = None,
    ) -> SEDOutput:
        """``train`` must agree with the module's mode, which BatchNorm and the
        CNN's dropout follow. The CNN's dropout masks are drawn from
        ``generator`` (or given as ``dropout_masks``); in a data-parallel
        step, for the global batch, of which ``rows`` are this rank's."""
        if encoder_win:
            raise NotImplementedError(f"encoder_win (sliding-window fusion) {_LATER}")
        if self.cnn is not None and train != self.training:
            raise ValueError(f"train={train} but the module is in "
                             f"{'training' if self.training else 'eval'} mode")
        x, backbone_out = self._encode_frames(mel, train, generator)
        if self.cnn is not None:
            cnn_feat = self.cnn(mel.transpose(1, 2)[:, None], generator=generator,
                                dropout_masks=dropout_masks, rows=rows)  # [B, C, T', F']
            if cnn_feat.shape[-1] != 1:
                raise ValueError("the CNN branch must pool frequency to 1, got "
                                 f"{tuple(cnn_feat.shape)}")
            cnn_feat = resize_time(cnn_feat[:, :, :, 0].transpose(1, 2), x.shape[1], "linear")
            x = self.transformer_projector(x) + self.merge_weight * self.cnn_projector(cnn_feat)
        else:
            x = self.transformer_projector(x)
        return self._finish(x, backbone_out, temp_w, pad_mask, generator, None)
