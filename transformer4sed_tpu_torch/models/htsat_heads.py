"""HTSAT-based SED heads (port of ``models/htsat_heads.py``): HTSAT_CNN
(closed set), CLAP_SED (text queries against CLAP audio frames) and
DASM_HTSAT (DASM's open-vocabulary queries on HTSAT).

HTSAT_CNN (``src/models/htsat/htsat_cnn.py:13-209``): the backbone's
``fine_grained_embedding`` ([B, 32, 768] for the CLAP-tiny config) is
upsampled by ``backbone_upsample_ratio``, the CNN branch's features are
resized onto that grid, both are projected to ``decoder_dim`` and merged
with a learned weight, normalised, decoded by a Transformer-XL (or by
nothing) and classified frame by frame: ``sigmoid(logits / temp_w)``,
pad-mask zeroing, clipping to [1e-7, 1], linear-softmax weak pooling.
Params keep the upstream state-dict names (``backbone``, ``cnn.cnn``,
``cnn_projector``, ``transformer_projector``, ``merge_weight``,
``norm_after_merge``, ``sed_decoder``, ``sed_head``).

CLAP_SED (``src/models/htsat/clap_sed.py:9-49``): the backbone's
``fine_grained_embedding`` through ``audio_projector`` (a 2-layer MLP), the
queries (``text_query``, or the ``query`` of a call) through
``text_projector``, the logits ``einsum('qc,btc->btq')`` in float32, then
``sigmoid(logits / temp_w)``, pad-mask zeroing with no clamp, and
linear-softmax pooling over the 32 frames. ``text_query`` is a buffer
upstream and a param in the JAX package, where the common-only step passes
its bank, so the stored one has a zero gradient that AdamW still decays; the
port keeps it a param so that a step moves it as JAX's does.

DASM_HTSAT (``src/models/detect_any_sound/detect_any_sound_htast.py:12-119``):
the backbone's ``fine_grained_embedding``, x``backbone_upsample_ratio``
linear interpolation, ``encoder_win``'s sliding windows (each window [N, F,
W] turned to [N, 1, W, F] for the backbone), the optional CNN merge and
``norm_after_merge``; the AT branch reads ``at_projector`` of the 32 tokens
before the interpolation. The query system, the AT decoder and the SED head
are DASM's (``models/dasm.py:QueryDetector``), under the same attribute and
state-dict names, so DASM's steps, trainers and open-set evaluation take
either network; its scores are clamped to [1e-7, 1] before the pad mask
zeroes the padded frames (DASM masks first). The ``gru`` and ``conformer``
decoders are ROADMAP.md queue 1 item 12; the MLM modes of HTSAT_CNN
(``mlm_dict``, item 9) and DASM_HTSAT (item 14) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from transformer4sed_tpu_torch.core.pooling_math import linear_softmax_pool
from transformer4sed_tpu_torch.models.cnn import CNN, BatchRows
from transformer4sed_tpu_torch.models.dasm import MLP, QueryDetector, as_query, check_options
from transformer4sed_tpu_torch.models.htsat import create_htsat_model
from transformer4sed_tpu_torch.models.interpolate import interpolate_time, resize_time
from transformer4sed_tpu_torch.models.layers import Dense, LayerNorm
from transformer4sed_tpu_torch.models.sed_model import SEDOutput
from transformer4sed_tpu_torch.models.slide import slide_window_encode
from transformer4sed_tpu_torch.models.xl import TransformerXLDecoder
from transformer4sed_tpu_torch.utils.device import resolve_device

_DECODERS = "is not ported yet: ROADMAP.md, queue 1, item 12 (head and decoder options)"
_MLM_MODE = ("is not ported yet: ROADMAP.md, queue 1, item 9 (PasstComplexCNN, the rest of "
             "models/cnn.py and HTSAT_CNN's mlm_dict)")


def _check_mode(module: nn.Module, train: bool) -> None:
    """HTSAT's bn0 (and a CNN branch's BatchNorm and dropout) follow the
    module's mode; ``train`` must agree with it."""
    if train != module.training:
        raise ValueError(f"train={train} but the module is in "
                         f"{'training' if module.training else 'eval'} mode")


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
        rows: Optional[BatchRows] = None,
    ) -> SEDOutput:
        """BatchNorm and dropout follow the module's mode (``model.train()``
        / ``model.eval()``); ``train`` is accepted so the trainers call every
        model alike, and must agree with that mode. The CNN's dropout masks
        are drawn from ``generator`` (or given as ``dropout_masks``); in a
        data-parallel step, for the global batch, of which ``rows`` are this
        rank's."""
        _check_mode(self, train)
        feat = self.backbone(mel)["fine_grained_embedding"]  # [B, T', C]
        x = interpolate_time(feat, self.backbone_upsample_ratio, "linear")
        if self.cnn is not None:
            cnn_feat = self.cnn(mel, generator=generator, dropout_masks=dropout_masks, rows=rows)
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


class CLAP_SED(nn.Module):
    """Zero-shot-style SED: CLAP audio frames against projected text queries."""

    def __init__(self, embed_dim: int = 768, class_num: int = 10, query_dim: int = 512,
                 htsat_config: str = "tiny", htsat_kwargs: Optional[Dict[str, Any]] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.backbone = create_htsat_model(htsat_config, dtype=dtype, **(htsat_kwargs or {}))
        self.audio_projector = MLP(self.backbone.num_features, embed_dim, embed_dim, 2)
        self.text_projector = MLP(query_dim, embed_dim, embed_dim, 2)
        # the stored bank (upstream registers it from a .pt file); a call's
        # ``query`` replaces it, as in open-set evaluation
        self.text_query = nn.Parameter(torch.zeros(class_num, query_dim))
        self.to(device)

    def forward(self, mel: torch.Tensor, query=None, temp_w: float = 1.0,
                pad_mask: Optional[torch.Tensor] = None, train: bool = False) -> SEDOutput:
        """mel [B, 1, T, F] -> strong [B, Q, 32], weak [B, Q] and the
        logits [B, 32, Q] (``extras['logit']``). There is no ``query_type``:
        the JAX module has none either."""
        _check_mode(self, train)
        audio = self.audio_projector(self.backbone(mel)["fine_grained_embedding"])
        q = self.text_query if query is None else as_query(query, audio.device)
        text = self.text_projector(q)
        logits = torch.einsum("qc,btc->btq", text.float(), audio.float())
        sed = torch.sigmoid(logits / temp_w)
        if pad_mask is not None:
            sed = torch.where(pad_mask[:, :, None], 0.0, sed)
        return SEDOutput(strong=sed.transpose(1, 2), weak=linear_softmax_pool(sed, axis=1),
                         extras={"logit": logits})


class DASM_HTSAT(QueryDetector):
    """DASM's query machinery on the HTSAT fine-grained embedding."""

    def __init__(
        self,
        class_num: int = 10,
        decoder_dim: int = 768,
        num_heads: int = 12,
        decoder: str = "gru",
        decoder_layer_num: int = 2,
        decoder_pos_emd_len: int = 1000,
        decoder_expand_rate: float = 1.0,
        backbone_upsample_ratio: int = 10,
        htsat_config: str = "tiny",
        htsat_kwargs: Optional[Dict[str, Any]] = None,  # create_htsat_model overrides
        at_decoder_layer: int = 2,
        query_projector: bool = False,
        query_dim: Union[int, Sequence[int], None] = None,
        out_type: Optional[str] = "sigmoid",
        cnn_param: Optional[Dict[str, Any]] = None,
        mlm_dict: Optional[Dict[str, Any]] = None,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        check_options("DASM_HTSAT", decoder, mlm_dict, out_type)
        device = resolve_device(device)
        self.backbone_upsample_ratio = backbone_upsample_ratio
        self.backbone = create_htsat_model(htsat_config, dtype=dtype, **(htsat_kwargs or {}))
        width = self.backbone.num_features
        self.cnn = None
        if cnn_param is not None:
            self.cnn = CNN(dtype=dtype, **dict(cnn_param))
            self.cnn_projector = Dense(self.cnn.out_channels, decoder_dim)
            self.merge_weight = nn.Parameter(torch.full((1,), 0.5))
        self.transformer_projector = Dense(width, decoder_dim)
        self.at_projector = Dense(width, decoder_dim)
        self.norm_after_merge = LayerNorm(decoder_dim, eps=1e-5)
        self.sed_decoder = None
        if decoder == "transformerXL":
            self.sed_decoder = TransformerXLDecoder(
                decoder_dim, decoder_layer_num=decoder_layer_num, num_heads=num_heads,
                seq_len=decoder_pos_emd_len, mlp_ratio=decoder_expand_rate, dtype=dtype)
        self.build_query_head(class_num, decoder_dim, num_heads, decoder_expand_rate,
                              at_decoder_layer, query_projector, query_dim, out_type, dtype)
        self.to(device)

    def _encode_window(self, mel_tf: torch.Tensor) -> torch.Tensor:
        """[N, F, W] mel windows -> [N, t * ratio, C] (HtsatSlideWindow)."""
        feat = self.backbone(mel_tf.transpose(1, 2)[:, None])["fine_grained_embedding"]
        return interpolate_time(feat, self.backbone_upsample_ratio, "linear")

    def forward(
        self,
        mel: torch.Tensor,  # [B, 1, T, F] log-mel (HTSATFrontend output)
        temp_w: float = 0.1,
        pad_mask: Optional[torch.Tensor] = None,  # [B, frames] bool, True = padded
        encoder_win: bool = False,
        mix_rate: float = 0.5,
        win_param: Tuple[int, int] = (256, 64),
        query=None,
        query_type: Optional[str] = None,
        tgt_mask=None,  # [Q, Q] bool, True = blocked
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        query_pick: Optional[torch.Tensor] = None,
        dropout_masks: Optional[Sequence[torch.Tensor]] = None,
    ) -> SEDOutput:
        """``train`` must agree with the module's mode (bn0, and a CNN
        branch's BatchNorm and dropout, follow it). In training ``generator``
        draws the CNN's dropout, the modality pick and the AT decoder's
        dropout masks, unless ``query_pick`` and ``dropout_masks`` hand the
        last two in."""
        _check_mode(self, train)
        feat = self.backbone(mel)["fine_grained_embedding"]  # [B, T', C]
        x = interpolate_time(feat, self.backbone_upsample_ratio, "linear")
        if encoder_win:
            x_local = slide_window_encode(
                lambda win, group: self._encode_window(win), mel[:, 0].transpose(1, 2),
                emb_len=x.shape[1], win_width=win_param[0], step=win_param[1])
            x = mix_rate * x_local + (1.0 - mix_rate) * x
        if self.cnn is not None:
            cnn_feat = self.cnn(mel, generator=generator)  # [B, C, T'', 1]
            if cnn_feat.shape[-1] != 1:
                raise ValueError("the CNN branch must pool frequency to 1, got "
                                 f"{tuple(cnn_feat.shape)}")
            cnn_feat = resize_time(cnn_feat[:, :, :, 0].transpose(1, 2), x.shape[1], "linear")
            x = self.transformer_projector(x) + self.merge_weight * self.cnn_projector(cnn_feat)
        else:
            x = self.transformer_projector(x)
        x = self.norm_after_merge(x)
        # the AT branch over the 32 tokens before the interpolation
        return self.detect(x, self.at_projector(feat), temp_w, pad_mask, query, query_type,
                           tgt_mask, train, generator, query_pick, dropout_masks,
                           pad_after_clamp=True)
