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
``transformer_projector``, ``merge_weight``). With ``encoder_win`` (PMAM's
finetune2) only the PaSST branch is windowed (``PaSST_SED._encode_frames``);
the CNN branch sees the whole clip.

With ``mlm=True`` (PMAM's post-pretraining, ``config/pmam/post_pretrain.yaml``)
the merged frames go through the MLM masker, then the decoder, the AT branch
and the ``mlm_mlp`` head (``PaSST_SED._finish``): the output carries
``mlm_pred``, ``frame_before_mask`` and ``mask_id_seq``, read by the
prototype loss of ``pmam/train.py``.

Not ported yet: the ``FDY-CNN`` and ``resnet`` branches (ROADMAP.md, queue 1,
item 9) and ``PasstComplexCNN``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from transformer4sed_tpu_torch.models.cnn import CNN, BatchRows
from transformer4sed_tpu_torch.models.interpolate import resize_time
from transformer4sed_tpu_torch.models.layers import Dense
from transformer4sed_tpu_torch.models.mlm import MLMDraws
from transformer4sed_tpu_torch.models.passt import PatchoutDraws
from transformer4sed_tpu_torch.models.passt_sed import PaSST_SED
from transformer4sed_tpu_torch.models.sed_model import SEDOutput
from transformer4sed_tpu_torch.utils.device import resolve_device

_CNN_FAMILY = "is not ported yet: ROADMAP.md, queue 1, item 9 (the rest of models/cnn.py)"


class PaSST_CNN(PaSST_SED):
    projects_frames = True

    def __init__(self, cnn_name: str = "base", cnn_param: Optional[Dict[str, Any]] = None,
                 device=None, **kwargs):
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

    def _frames(self, mel, train, generator, patchout_draws=None, encoder_win=False,
                mix_rate=0.5, win_param=(512, 49), window_draws=None, rows=None,
                dropout_masks=None, upto_tap=False):
        """The PaSST branch's frames and the CNN branch's, merged at the
        decoder's width; and the backbone's output."""
        if self.cnn is not None and train != self.training:
            raise ValueError(f"train={train} but the module is in "
                             f"{'training' if self.training else 'eval'} mode")
        x, backbone_out = self._encode_frames(mel, train, generator, patchout_draws, encoder_win,
                                              mix_rate, win_param, window_draws, rows, upto_tap)
        if self.cnn is not None:
            cnn_feat = self.cnn(mel.transpose(1, 2)[:, None], generator=generator,
                                dropout_masks=dropout_masks, rows=rows)  # [B, C, T', F']
            if cnn_feat.shape[-1] != 1:
                raise ValueError("the CNN branch must pool frequency to 1, got "
                                 f"{tuple(cnn_feat.shape)}")
            cnn_feat = resize_time(cnn_feat[:, :, :, 0].transpose(1, 2), x.shape[1],
                                   self.interpolate_mode)
            x = self.transformer_projector(x) + self.merge_weight * self.cnn_projector(cnn_feat)
        else:
            x = self.transformer_projector(x)
        return x, backbone_out

    def forward(
        self,
        mel: torch.Tensor,  # [B, F, T] normalised log-mel
        temp_w: float = 1.0,
        pad_mask: Optional[torch.Tensor] = None,
        encoder_win: bool = False,
        mix_rate: float = 0.5,
        win_param: Tuple[int, int] = (512, 49),
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        dropout_masks: Optional[Sequence[torch.Tensor]] = None,
        rows: Optional[BatchRows] = None,
        window_draws: Optional[Sequence[PatchoutDraws]] = None,
        mlm_draws: Optional[MLMDraws] = None,
        patchout_draws: Optional[PatchoutDraws] = None,
    ) -> SEDOutput:
        """``train`` must agree with the module's mode, which BatchNorm and the
        CNN's dropout follow. The CNN's dropout masks are drawn from
        ``generator`` (or given as ``dropout_masks``); in a data-parallel
        step, for the global batch, of which ``rows`` are this rank's. The
        window groups' backbone draws come after the clip's and before the
        CNN's (or are given as ``window_draws``, as in PaSST_SED); with
        ``mlm=True`` the mask is drawn last (or given as ``mlm_draws``)."""
        x, backbone_out = self._frames(mel, train, generator, patchout_draws, encoder_win,
                                       mix_rate, win_param, window_draws, rows, dropout_masks)
        return self._finish(x, backbone_out, temp_w, pad_mask, generator, mlm_draws, rows)
