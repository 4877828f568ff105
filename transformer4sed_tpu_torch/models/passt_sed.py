"""PaSST_SED, the MAT-SED network (port of ``models/passt_sed.py``).

PaSST encoder tapped at ``passt_feature_layer`` -> drop cls/dist tokens
-> ``out_norm`` -> frequency pooling over the [B, f, t, C] patch grid (the
mean, or ``f_pool='attention'``: each time column's f tokens through an
:class:`AttentionPooling` of ``f_pool_heads`` heads, 6 in every shipped
config) -> pad the time grid by its last frame (99 -> 100) ->
x``decode_ratio`` interpolation (``interpolate_mode`` linear or nearest) ->
with ``encoder_win`` (finetune2), the sliding-window fusion ``mix_rate *
local + (1 - mix_rate) * global``, the local embedding from windows of
``win_param = (width, step)`` mel frames (``models/slide.py``: one backbone
call per width group, each window through backbone, f-pool and
interpolation without the pad) -> Transformer-XL decoder (local attention
with ``decoder_win_len``) -> classifier -> ``sigmoid(logits / temp_w)``,
pad-mask zeroing, linear-softmax weak pooling; the AT adapter
attention-pools the backbone's final-norm frame tokens. With ``mlm=True`` (masked-reconstruction
pretraining) the decoder's input is corrupted by :class:`MLMMasker` and the
decoder's output goes through ``mlm_mlp`` instead of the classifier; the
output then carries ``mlm_pred``, ``frame_before_mask`` and ``mask_id_seq``.
Params keep the upstream cai525 state-dict names (including upstream's
``at_adpater`` spelling and ``mlm_mlp.0`` / ``mlm_mlp.2``), so published
``.pt`` files load with ``load_state_dict``. ``lora_rank`` > 0 puts LoRA
adapters (rank ``lora_rank``, scale ``lora_alpha / lora_rank``) on every
backbone block's ``qkv``, ``proj``, ``fc1`` and ``fc2`` (``models/lora.py``).
``train=True`` is the forward
of the train steps; it is differentiable end to end through the attention
kernels' autograd Functions; in training every backbone call (the clip's,
then each window group's) makes its own draws: the time-embedding offset (a
window is shorter than the nominal grid), patchout and dropout.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from transformer4sed_tpu_torch.core.pooling_math import linear_softmax_pool
from transformer4sed_tpu_torch.models.cnn import BatchRows
from transformer4sed_tpu_torch.models.interpolate import interpolate_time
from transformer4sed_tpu_torch.models.layers import Dense, LayerNorm
from transformer4sed_tpu_torch.models.mlm import MLMDraws, MLMMasker
from transformer4sed_tpu_torch.models.passt import PaSST, PatchoutDraws
from transformer4sed_tpu_torch.models.pooling import AttentionPooling
from transformer4sed_tpu_torch.models.sed_model import SEDOutput
from transformer4sed_tpu_torch.models.slide import slide_window_encode
from transformer4sed_tpu_torch.models.vit import fast_gelu
from transformer4sed_tpu_torch.models.xl import TransformerXLDecoder
from transformer4sed_tpu_torch.utils.device import resolve_device

_LATER = "is not ported yet: ROADMAP.md, queue 1, item 12 (head and decoder options)"


class PaSST_SED(nn.Module):
    # whether a projector maps the backbone's width onto the decoder's (PaSST_CNN)
    projects_frames = False

    def __init__(
        self,
        class_num: int = 10,
        decode_ratio: int = 10,
        interpolate_mode: str = "linear",
        passt_feature_layer: int = 10,
        embed_dim: int = 768,
        decoder_dim: int = 768,
        f_pool: str = "mean_pool",
        f_pool_heads: int = 6,
        decoder: str = "transformerXL",
        decoder_layer_num: int = 3,
        decoder_pos_emd_len: int = 1000,
        decoder_win_len: Optional[Any] = None,
        at_adapter: bool = False,
        mlm: bool = False,
        mlm_dict: Optional[Dict[str, Any]] = None,
        s_patchout_f: int = 0,
        s_patchout_t: int = 0,
        backbone_depth: int = 12,
        backbone_num_heads: int = 12,
        backbone_img_size: Tuple[int, int] = (128, 998),
        decoder_num_heads: int = 12,
        at_adapter_heads: int = 12,
        lora_rank: int = 0,
        lora_alpha: float = 1.0,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        if f_pool not in ("mean_pool", "attention"):
            raise NotImplementedError(f"f_pool={f_pool!r} {_LATER}")
        if decoder != "transformerXL":
            raise NotImplementedError(f"decoder={decoder!r} {_LATER}")
        if interpolate_mode not in ("linear", "nearest"):
            raise ValueError(f"unknown interpolation mode {interpolate_mode!r}")
        if decoder_dim != embed_dim and not self.projects_frames:
            raise ValueError("PaSST_SED feeds the pooled backbone frames to the decoder as they "
                             "are, so decoder_dim must equal embed_dim (PaSST_CNN projects them)")
        device = resolve_device(device)
        self.embed_dim, self.decoder_dim, self.compute_dtype = embed_dim, decoder_dim, dtype
        self.decode_ratio, self.interpolate_mode = decode_ratio, interpolate_mode
        self.passt_feature_layer = passt_feature_layer
        self.backbone = PaSST(
            embed_dim=embed_dim, depth=backbone_depth, num_heads=backbone_num_heads,
            img_size=tuple(backbone_img_size), tap_layer=passt_feature_layer,
            s_patchout_f=s_patchout_f, s_patchout_t=s_patchout_t, dtype=dtype,
            lora_rank=lora_rank, lora_alpha=lora_alpha,
        )
        self.out_norm = LayerNorm(embed_dim, eps=1e-5)
        self.f_pool_module = (AttentionPooling(embed_dim, f_pool_heads, dtype=dtype)
                              if f_pool == "attention" else None)
        self.decoder = TransformerXLDecoder(
            decoder_dim, decoder_layer_num=decoder_layer_num, num_heads=decoder_num_heads,
            seq_len=decoder_pos_emd_len, window_len=decoder_win_len, dtype=dtype,
        )
        self.classifier = Dense(decoder_dim, class_num)
        self.at_adpater = (
            nn.ModuleList([AttentionPooling(embed_dim, at_adapter_heads, dtype=dtype),
                           Dense(embed_dim, class_num)])
            if at_adapter else None
        )
        self.masker = None
        if mlm:
            d = dict(mlm_dict or {})
            out_dim = d.pop("out_dim", decoder_dim)
            self.masker = MLMMasker(
                mask_rate=d.get("mask_rate", 0.75),
                mask_style=tuple(d.get("mask_style", (0.8, 0.1, 0.1))),
                strategy=d.get("strategy", "block"), block_width=d.get("block_width", 10))
            self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_dim))
            # upstream's Sequential(Linear, GELU, Linear): slots 0 and 2 hold the params
            self.mlm_mlp = nn.Sequential(Dense(decoder_dim, decoder_dim), nn.Identity(),
                                         Dense(decoder_dim, out_dim))
        self.to(device)

    # -- pieces (shared with PaSST_CNN) ------------------------------------------------

    def _f_pool(self, backbone_out: Dict[str, Any]) -> torch.Tensor:
        feat = self.out_norm(backbone_out[f"layer{self.passt_feature_layer}_out"][:, 2:, :])
        b, _, c = feat.shape
        f_dim, t_dim = backbone_out["f_dim"], backbone_out["t_dim"]
        grid = feat.reshape(b, f_dim, t_dim, c)
        if self.f_pool_module is None:
            return grid.mean(dim=1)
        cols = grid.transpose(1, 2).reshape(b * t_dim, f_dim, c)
        return self.f_pool_module(cols).reshape(b, t_dim, c)

    def _encode_frames(self, mel, train, generator, patchout_draws=None, encoder_win=False,
                       mix_rate=0.5, win_param=(512, 49), window_draws=None, rows=None,
                       upto_tap=False):
        """Backbone -> f-pool -> pad and interpolate, fused with the sliding
        windows' embedding under ``encoder_win``: ([B, T, D], backbone_out);
        ``upto_tap`` stops the backbone at its tap layer (no final-norm
        tokens: nothing after the decoder's input is read)."""
        backbone_out = self.backbone(mel[:, None], train=train, generator=generator,
                                     patchout_draws=patchout_draws, upto_tap=upto_tap, rows=rows)
        x = self._f_pool(backbone_out)
        x = torch.cat([x, x[:, -1:, :]], dim=1)
        x = interpolate_time(x, self.decode_ratio, self.interpolate_mode)
        if encoder_win:
            x_local = slide_window_encode(
                lambda win, group: self._encode_window(
                    win, train, generator, None if window_draws is None else window_draws[group],
                    None if rows is None else rows.repeat(win.shape[0])),
                mel, emb_len=x.shape[1], win_width=win_param[0], step=win_param[1])
            x = mix_rate * x_local + (1.0 - mix_rate) * x
        return x, backbone_out

    def _encode_window(self, mel_win, train, generator, patchout_draws=None, rows=None):
        """Window mel [N, F, W] -> frame embedding [N, t*ratio, C] (no 99 -> 100 pad);
        the backbone stops at the tap layer, since nothing reads a window's
        final-norm tokens."""
        out = self.backbone(mel_win[:, None], train=train, generator=generator,
                            patchout_draws=patchout_draws, upto_tap=True, rows=rows)
        return interpolate_time(self._f_pool(out), self.decode_ratio, self.interpolate_mode)

    def _frames(self, mel, train, generator, patchout_draws=None, encoder_win=False,
                mix_rate=0.5, win_param=(512, 49), window_draws=None, rows=None,
                dropout_masks=None, upto_tap=False):
        """The decoder's input frames [B, T, decoder_dim] and the backbone's
        output (PaSST_CNN adds its CNN branch here)."""
        return self._encode_frames(mel, train, generator, patchout_draws, encoder_win, mix_rate,
                                   win_param, window_draws, rows, upto_tap)

    def _mask(self, x, generator, mlm_draws, rows=None):
        """The MLM masker on the decoder's input: (masked frames, mask ids)."""
        if mlm_draws is None:
            if generator is None:
                raise ValueError("an MLM forward draws its mask: pass a torch.Generator")
            mlm_draws = self.masker.draw(generator, x.shape[0], x.shape[1], rows)
        return self.masker.apply(x, self.mask_token, mlm_draws,
                                 None if rows is None else rows.gather)

    @torch.no_grad()
    def tap(self, mel: torch.Tensor, feature_layer: str = "transformer_0",
            generator: Optional[torch.Generator] = None,
            mlm_draws: Optional[MLMDraws] = None) -> torch.Tensor:
        """The PMAM tokenizer's frame features [B, T, C] of an eval forward:
        ``transformer_k``, the output of decoder block k (after the MLM
        masker when the model has one, as in the JAX package, whose eval
        forward masks too), or ``after_interpolate``, the decoder's input
        before masking (``frame_before_mask``). The forward stops at the tap
        (the backbone at its tap layer, the decoder after block k), as the
        compiled JAX program, which returns only the tap, prunes the rest; the
        mask is drawn from ``generator`` or given as ``mlm_draws``."""
        m = re.fullmatch(r"transformer_(\d+)", feature_layer)
        if m is None and feature_layer != "after_interpolate":
            raise RuntimeError(f"unknown feature layer {feature_layer!r}")
        x, _ = self._frames(mel, False, generator, upto_tap=True)
        if m is None:
            return x
        if self.masker is not None:
            x, _ = self._mask(x, generator, mlm_draws)
        return self.decoder(x, upto=int(m.group(1)))

    def _finish(self, x, backbone_out, temp_w, pad_mask, generator, mlm_draws,
                rows=None) -> SEDOutput:
        """MLM mask -> decoder -> AT branch -> classifier and pools (or the MLM head)."""
        frame_before_mask = x
        mask_id_seq = None
        if self.masker is not None:
            x, mask_id_seq = self._mask(x, generator, mlm_draws, rows)
        x = self.decoder(x)

        at_out = None
        if self.at_adpater is not None:
            pool, head = self.at_adpater
            at_out = torch.sigmoid(head(pool(backbone_out["frame"][:, 2:, :])))

        if self.masker is not None:
            mlm_pred = self.mlm_mlp[2](fast_gelu(self.mlm_mlp[0](x)))
            return SEDOutput(mlm_pred=mlm_pred, frame_before_mask=frame_before_mask,
                             mask_id_seq=mask_id_seq, at_out=at_out)

        sed = torch.sigmoid(self.classifier(x) / temp_w)
        if pad_mask is not None:
            sed = torch.where(pad_mask[:, :, None], 0.0, sed)
        return SEDOutput(
            strong=sed.transpose(1, 2),
            weak=linear_softmax_pool(sed, axis=1),
            at_out=at_out,
            frame_before_mask=frame_before_mask,
        )

    def forward(
        self,
        mel: torch.Tensor,  # [B, F, T] normalised log-mel
        temp_w: float = 1.0,
        pad_mask: Optional[torch.Tensor] = None,  # [B, frames] bool, True = padded
        encoder_win: bool = False,
        mix_rate: float = 0.5,
        win_param: Tuple[int, int] = (512, 49),
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        mlm_draws: Optional[MLMDraws] = None,
        patchout_draws: Optional[PatchoutDraws] = None,
        window_draws: Optional[Sequence[PatchoutDraws]] = None,
        rows: Optional[BatchRows] = None,
    ) -> SEDOutput:
        """``generator`` makes the forward's draws (the training time offset
        and patchout of the clip, then of each window group, the MLM mask);
        ``mlm_draws``, ``patchout_draws`` and ``window_draws`` (one per width
        group, in :func:`models.slide.width_groups` order) hand them in
        instead. In a data-parallel step ``mel`` holds this rank's ``rows``
        of the global batch: dropout, DropPath and the MLM mask are drawn for
        the global batch and those rows kept, and the mask's random tokens
        come from the whole batch (``rows.gather``)."""
        x, backbone_out = self._encode_frames(mel, train, generator, patchout_draws, encoder_win,
                                              mix_rate, win_param, window_draws, rows)
        return self._finish(x, backbone_out, temp_w, pad_mask, generator, mlm_draws, rows)
