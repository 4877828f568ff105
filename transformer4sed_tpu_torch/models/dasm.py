"""DASM, open-vocabulary SED with text or audio queries (port of
``models/dasm.py``; upstream ``src/models/detect_any_sound/detect_any_sound.py``
and ``at_adapter.py``).

  * PaSST backbone (LoRA with ``lora_rank`` > 0) tapped at
    ``passt_feature_layer`` -> ``norm_before_pool`` -> the attention f-pool
    (``f_pool_heads``) over each time column of the f x t patch grid -> the
    grid padded by its last frame -> x``backbone_upsample_ratio`` linear
    interpolation; with ``encoder_win`` the sliding windows' embedding is
    fused in (``models/slide.py``); with ``cnn_param`` the CNN branch is
    merged as ``transformer_projector(x) + merge_weight * cnn_projector(cnn)``;
    then ``norm_after_merge``;
  * the queries: the learnable ``at_query`` bank, or external query tensors
    through one Linear + GELU projector per modality (``query_dim``). Given
    a list of banks, training draws one modality per query, eval takes the
    first; a single bank with several projectors needs ``query_type``
    ('text' or 'audio'), as in the JAX package (which raises without it);
  * the AT decoder: ``at_decoder_layer`` cross-attention-first post-norm
    layers (cross-attention to ``at_projector`` of the backbone's
    final-norm frame tokens, then self-attention among the queries, then the
    FFN), dropout 0.1 after each sublayer in training; ``tgt_mask`` (bool,
    True = blocked) hides query pairs from the self-attention;
  * the SED head: the XL ``sed_decoder`` (or ``decoder='no'``), ``sed_head``,
    the 3-layer ``mask_embedding_layer`` MLP on the decoded queries, the
    logits ``einsum('bqc,btc->btq')`` in float32, then
    ``sigmoid(logits / temp_w) * prior`` where the clip prior is the AT
    head's sigmoid (``out_type='sigmoid'``) or the diagonal of its (C+1)-way
    softmax (``'logit'``); pad-mask zeroing, the clamp to [1e-7, 1] and
    linear-softmax pooling.

The attentions of the AT decoder and of the f-pool are flax
``MultiHeadDotProductAttention`` in the JAX package, plain XLA attention with
no Pallas kernel; here they are plain PyTorch
(:func:`models.pooling.dot_product_attention`). The backbone and the XL decoder
run the port's kernels (rows 1 and 2 served, 7, 8, 12 and 13 in a train
step). Params keep upstream's state-dict names (``at_decoder.decoder.layers.{i}``
with torch ``nn.MultiheadAttention``'s ``in_proj_weight`` / ``out_proj``,
``query_projector.{m}.0``, ``mask_embedding_layer.layers.{i}``), so the JAX
package's ``convert_dasm`` reads a port state dict. The precision follows the
JAX package's: the backbone, the XL decoder and the attentions compute in
``dtype``; the Dense layers the JAX module builds without a dtype promote
(f32 here, fed f32 norms); LayerNorms return f32.

The training draws (the backbone's, the per-query modality pick and the AT
decoder's dropout masks) come from the caller's generator, or are handed in
(``query_pick``, ``dropout_masks``). The other SED decoders (``gru``,
``conformer``, ``transformer``) are not ported yet (ROADMAP.md, queue 1, item
12), nor is the MLM mode (``mlm_dict``, item 14).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from transformer4sed_tpu_torch.core.pooling_math import linear_softmax_pool
from transformer4sed_tpu_torch.models.cnn import CNN, device_generator, draw_dropout
from transformer4sed_tpu_torch.models.interpolate import interpolate_time, resize_time
from transformer4sed_tpu_torch.models.layers import Dense, LayerNorm
from transformer4sed_tpu_torch.models.passt import PaSST
from transformer4sed_tpu_torch.models.pooling import AttentionPooling, dot_product_attention
from transformer4sed_tpu_torch.models.sed_model import SEDOutput
from transformer4sed_tpu_torch.models.slide import slide_window_encode
from transformer4sed_tpu_torch.models.vit import apply_dropout, fast_gelu
from transformer4sed_tpu_torch.models.xl import TransformerXLDecoder
from transformer4sed_tpu_torch.utils.device import resolve_device

AT_DROPOUT = 0.1  # the AT decoder's dropout after each sublayer (JAX models/dasm.py:75)
_LATER_DECODERS = "is not ported yet: ROADMAP.md, queue 1, item 12 (head and decoder options)"


class MLP(nn.Module):
    """``num_layers`` Dense layers with GELU between them (upstream's DETR MLP)."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(Dense(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = fast_gelu(x)
        return x


class CrossAttentionFirstDecoderLayer(nn.Module):
    """Post-norm decoder layer: cross-attention, self-attention, FFN, each
    followed by dropout, the residual add and its LayerNorm (flax's eps,
    1e-6). Upstream's ``nn.TransformerDecoderLayer`` names."""

    def __init__(self, dim: int, num_heads: int, dim_ffn: int, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.multihead_attn = nn.MultiheadAttention(dim, num_heads, batch_first=True)
        self.self_attn = nn.MultiheadAttention(dim, num_heads, batch_first=True)
        self.linear1 = Dense(dim, dim_ffn)
        self.linear2 = Dense(dim_ffn, dim)
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.norm3 = LayerNorm(dim, eps=1e-6)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_mask: Optional[torch.Tensor] = None,
                masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """``masks``: the four scaled keep masks of a training forward (None
        in eval)."""
        def drop(x, i):
            return x if masks is None else apply_dropout(x, masks[i])

        h = dot_product_attention(self.multihead_attn, tgt, memory, self.num_heads, self.dtype)
        x = self.norm1(tgt + drop(h, 0))
        h = dot_product_attention(self.self_attn, x, x, self.num_heads, self.dtype, tgt_mask)
        x = self.norm2(x + drop(h, 1))
        h = drop(fast_gelu(self.linear1(x)), 2)
        return self.norm3(x + drop(self.linear2(h), 3))


class QueryBasedAudioTaggingDecoder(nn.Module):
    """A stack of :class:`CrossAttentionFirstDecoderLayer` under upstream's
    ``decoder.layers.{i}``."""

    def __init__(self, n_layers: int, dim: int, num_heads: int, dim_ffn: int,
                 dtype=torch.float32):
        super().__init__()
        self.decoder = nn.ModuleDict({"layers": nn.ModuleList(
            CrossAttentionFirstDecoderLayer(dim, num_heads, dim_ffn, dtype)
            for _ in range(n_layers))})

    @property
    def layers(self) -> nn.ModuleList:
        return self.decoder["layers"]

    def forward(self, feat_encoder: torch.Tensor, queries: torch.Tensor,
                tgt_mask: Optional[torch.Tensor] = None,
                masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        x = queries
        for i, layer in enumerate(self.layers):
            x = layer(x, feat_encoder, tgt_mask, None if masks is None else masks[4 * i:4 * i + 4])
        return x


def multi_label_to_multi_class(weak: torch.Tensor) -> torch.Tensor:
    """[B, C] multi-label -> [B, C, C+1] per-query multi-class targets: query
    c's target is class c where present, the void class C where not."""
    b, c = weak.shape
    out = weak.new_zeros(b, c, c + 1)
    out[:, :, :-1] = torch.eye(c, dtype=weak.dtype, device=weak.device)[None] * weak[:, :, None]
    out[:, :, -1] = 1.0 - weak
    return out


def multi_class_to_multi_label(mc: torch.Tensor) -> torch.Tensor:
    """[B, C, C+1] -> [B, C], the class diagonal."""
    return torch.diagonal(mc[:, :, :-1], dim1=1, dim2=2)


def as_query(q, device) -> torch.Tensor:
    """A query bank (array or tensor; a tensor keeps its autograd graph) as
    f32 on ``device``."""
    q = q if torch.is_tensor(q) else torch.from_numpy(np.asarray(q, np.float32))
    return q.to(device=device, dtype=torch.float32)


def check_options(model: str, decoder: str, mlm_dict, out_type) -> None:
    """Refuse what DASM and DASM_HTSAT take in the JAX package and the port
    lacks, naming its ROADMAP.md queue 1 item."""
    if decoder in ("gru", "conformer", "transformer"):
        raise NotImplementedError(f"decoder={decoder!r} {_LATER_DECODERS}")
    if decoder not in ("transformerXL", "no"):
        raise ValueError(f"invalid decoder {decoder!r}")
    if mlm_dict is not None:
        raise NotImplementedError(f"{model}'s MLM mode (mlm_dict) is not ported yet: ROADMAP.md, "
                                  "queue 1, item 14 (the MLM modes of DASM and DASM_HTSAT)")
    if out_type not in ("logit", "sigmoid", None):
        raise RuntimeError(f"unknown out_type {out_type!r}")


class QueryDetector(nn.Module):
    """The query system, the AT decoder and the SED head that DASM and
    DASM_HTSAT share: :meth:`build_query_head` registers them (after the
    subclass's ``sed_decoder``, in upstream's state-dict order) and
    :meth:`detect` runs them on the SED decoder's input frames and the AT
    branch's tokens."""

    def build_query_head(self, class_num: int, decoder_dim: int, num_heads: int,
                         decoder_expand_rate: float, at_decoder_layer: int, query_projector: bool,
                         query_dim, out_type: Optional[str], dtype) -> None:
        self.decoder_dim = decoder_dim
        self.mask_embedding_layer = (MLP(decoder_dim, decoder_dim, decoder_dim, 3)
                                     if out_type else None)
        self.sed_head = Dense(decoder_dim, decoder_dim)
        self.at_dropout = AT_DROPOUT  # the rate of the AT decoder's training draws
        self.at_query = None
        self.query_projector = None
        if not query_projector:
            self.at_query = nn.Parameter(torch.zeros(class_num, decoder_dim))
        elif isinstance(query_dim, int):
            # upstream's single Sequential(Linear, GELU): the GELU has no params
            self.query_projector = nn.Sequential(Dense(query_dim, decoder_dim))
        else:
            self.query_projector = nn.ModuleList(nn.Sequential(Dense(d, decoder_dim))
                                                 for d in query_dim)
        self.at_decoder = QueryBasedAudioTaggingDecoder(
            at_decoder_layer, decoder_dim, num_heads, int(decoder_dim * decoder_expand_rate),
            dtype=dtype)
        head_out = {"logit": class_num + 1, "sigmoid": 1}.get(out_type)
        self.at_head = MLP(decoder_dim, decoder_dim, head_out, 2) if out_type else None

    @property
    def projectors(self) -> List[nn.Module]:
        """The query projectors' Dense layers, one per modality."""
        if self.query_projector is None:
            return []
        if isinstance(self.query_projector, nn.Sequential):
            return [self.query_projector[0]]
        return [seq[0] for seq in self.query_projector]

    def project_queries(self, query=None, query_type: Optional[str] = None, train: bool = False,
                        generator: Optional[torch.Generator] = None,
                        query_pick: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The [Q, D] queries of a forward: ``at_query``; an external tensor
        used as it is (a model without projectors); or the projected banks."""
        dev = self.sed_head.weight.device
        if query is None:
            if self.query_projector is not None:
                raise ValueError(
                    "query_projector=True DASM needs external query tensors every call "
                    "(dataset.text_query/audio_query banks); there is no learnable at_query to "
                    "fall back to")
            return self.at_query
        if self.query_projector is None:
            return as_query(query, dev)
        projs = self.projectors
        if isinstance(query, (list, tuple)):
            stacked = torch.stack([fast_gelu(p(as_query(q, dev))) for p, q in zip(projs, query)],
                                  dim=1)  # [Q, n_modal, D]
            n_q, n_modal, _ = stacked.shape
            if train and n_modal > 1:
                if query_pick is None:
                    if generator is None:
                        raise ValueError("training with several query modalities draws one per "
                                         "query: pass a torch.Generator")
                    query_pick = torch.randint(0, n_modal, (n_q,), generator=generator,
                                               device=generator.device)
                pick = query_pick.to(stacked.device)
            else:
                pick = torch.zeros(n_q, dtype=torch.int64, device=stacked.device)
            return stacked[torch.arange(n_q, device=stacked.device), pick]
        if len(projs) > 1:
            idx = {"text": 0, "audio": 1}.get(query_type)
            if idx is None:
                raise RuntimeError("query_type must be 'text' or 'audio' with multi-modal "
                                   "projectors")
            return fast_gelu(projs[idx](as_query(query, dev)))
        return fast_gelu(projs[0](as_query(query, dev)))

    def draw_dropout_masks(self, generator: torch.Generator, batch: int,
                           n_queries: int) -> List[torch.Tensor]:
        """The AT decoder's scaled keep masks of one training forward, drawn
        on the model's device."""
        dev = self.sed_head.weight.device
        gen = device_generator(generator, dev)
        masks = []
        for layer in self.at_decoder.layers:
            widths = (self.decoder_dim, self.decoder_dim, layer.linear1.out_features,
                      self.decoder_dim)
            masks += [draw_dropout(gen, (batch, n_queries, w), self.at_dropout, dev)
                      for w in widths]
        return masks

    def detect(self, x: torch.Tensor, at_feat: torch.Tensor, temp_w: float,
               pad_mask: Optional[torch.Tensor], query, query_type: Optional[str], tgt_mask,
               train: bool, generator: Optional[torch.Generator],
               query_pick: Optional[torch.Tensor],
               dropout_masks: Optional[Sequence[torch.Tensor]],
               pad_after_clamp: bool = False) -> SEDOutput:
        """The AT branch on ``at_feat`` [B, N, D] (queries, the AT decoder
        with its training dropout, the AT head), then the SED decoder on the
        frames ``x`` [B, T, D], ``sed_head``, the f32 logits
        ``einsum('bqc,btc->btq')``, ``sigmoid(logits / temp_w) * prior``,
        the pad mask and the clamp to [1e-7, 1] (DASM masks, then clamps;
        DASM_HTSAT clamps, then masks: ``pad_after_clamp``), linear-softmax
        pooling."""
        q = self.project_queries(query, query_type, train, generator, query_pick)
        queries = q[None].expand(at_feat.shape[0], -1, -1)
        if train and dropout_masks is None:
            if generator is None:
                raise ValueError("the AT decoder's dropout in training needs a torch.Generator")
            dropout_masks = self.draw_dropout_masks(generator, at_feat.shape[0], q.shape[0])
        blocked = None if tgt_mask is None else torch.as_tensor(tgt_mask, device=at_feat.device)
        mask_feat = self.at_decoder(at_feat, queries, blocked, dropout_masks if train else None)
        at_out = None
        if self.at_head is not None:
            at_out = self.at_head(mask_feat)  # [B, Q, C+1] or [B, Q, 1]
            if at_out.shape[-1] == 1:
                at_out = torch.sigmoid(at_out[..., 0])

        if self.sed_decoder is not None:
            x = self.sed_decoder(x)
        frames = self.sed_head(x)
        mask_embedding = (self.mask_embedding_layer(mask_feat)
                          if self.mask_embedding_layer is not None else mask_feat)
        logits = torch.einsum("bqc,btc->btq", mask_embedding.float(), frames.float())
        if at_out is None:
            prior = 1.0
        elif at_out.ndim == 3:  # 'logit': the softmax diagonal as the clip prior
            prior = multi_class_to_multi_label(torch.softmax(at_out.float(), dim=-1))[:, None, :]
        else:
            prior = at_out.float()[:, None, :]
        sed = torch.sigmoid(logits / temp_w) * prior
        if pad_mask is not None and not pad_after_clamp:
            sed = torch.where(pad_mask[:, :, None], 0.0, sed)
        sed = torch.clamp(sed, 1e-7, 1.0)
        if pad_mask is not None and pad_after_clamp:
            sed = torch.where(pad_mask[:, :, None], 0.0, sed)
        return SEDOutput(strong=sed.transpose(1, 2), weak=linear_softmax_pool(sed, axis=1),
                         at_out=at_out)


class DASM(QueryDetector):
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
        embed_dim: int = 768,
        backbone_depth: int = 12,
        backbone_num_heads: int = 12,
        backbone_img_size: Tuple[int, int] = (128, 998),
        passt_feature_layer: int = 10,
        lora_rank: int = 0,
        lora_alpha: float = 1.0,
        at_decoder_layer: int = 2,
        f_pool_heads: int = 6,
        query_projector: bool = False,
        query_dim: Union[int, Sequence[int], None] = None,
        out_type: Optional[str] = "sigmoid",
        cnn_param: Optional[Dict[str, Any]] = None,
        mlm_dict: Optional[Dict[str, Any]] = None,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        check_options("DASM", decoder, mlm_dict, out_type)
        device = resolve_device(device)
        self.passt_feature_layer = passt_feature_layer
        self.backbone_upsample_ratio = backbone_upsample_ratio
        self.backbone = PaSST(
            embed_dim=embed_dim, depth=backbone_depth, num_heads=backbone_num_heads,
            img_size=tuple(backbone_img_size), tap_layer=passt_feature_layer, dtype=dtype,
            lora_rank=lora_rank, lora_alpha=lora_alpha)
        self.norm_before_pool = LayerNorm(embed_dim, eps=1e-5)
        self.f_pool_module = AttentionPooling(embed_dim, f_pool_heads, dtype=dtype)
        self.cnn = None
        if cnn_param is not None:
            self.cnn = CNN(dtype=dtype, **dict(cnn_param))
            self.cnn_projector = Dense(self.cnn.out_channels, decoder_dim)
            self.merge_weight = nn.Parameter(torch.full((1,), 0.5))
        self.transformer_projector = Dense(embed_dim, decoder_dim)
        self.at_projector = Dense(embed_dim, decoder_dim)
        self.norm_after_merge = LayerNorm(decoder_dim, eps=1e-5)
        self.sed_decoder = (
            TransformerXLDecoder(decoder_dim, decoder_layer_num=decoder_layer_num,
                                 num_heads=num_heads, seq_len=decoder_pos_emd_len,
                                 mlp_ratio=decoder_expand_rate, dtype=dtype)
            if decoder == "transformerXL" else None)
        self.build_query_head(class_num, decoder_dim, num_heads, decoder_expand_rate,
                              at_decoder_layer, query_projector, query_dim, out_type, dtype)
        self.to(device)

    # -- pieces -----------------------------------------------------------------------

    def _f_pool(self, backbone_out: Dict[str, Any]) -> torch.Tensor:
        feat = self.norm_before_pool(backbone_out[f"layer{self.passt_feature_layer}_out"][:, 2:])
        b, _, c = feat.shape
        f_dim, t_dim = backbone_out["f_dim"], backbone_out["t_dim"]
        cols = feat.reshape(b, f_dim, t_dim, c).transpose(1, 2).reshape(b * t_dim, f_dim, c)
        return self.f_pool_module(cols).reshape(b, t_dim, c)

    def _encode_window(self, mel_win, train, generator):
        out = self.backbone(mel_win[:, None], train=train, generator=generator, upto_tap=True)
        return interpolate_time(self._f_pool(out), self.backbone_upsample_ratio, "linear")

    # -- forward -------------------------------------------------------------------------

    def forward(
        self,
        mel: torch.Tensor,  # [B, F, T] normalised log-mel
        temp_w: float = 0.1,
        pad_mask: Optional[torch.Tensor] = None,  # [B, frames] bool, True = padded
        encoder_win: bool = False,
        mix_rate: float = 0.5,
        win_param: Tuple[int, int] = (512, 49),
        query=None,
        query_type: Optional[str] = None,
        tgt_mask=None,  # [Q, Q] bool, True = blocked
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        query_pick: Optional[torch.Tensor] = None,
        dropout_masks: Optional[Sequence[torch.Tensor]] = None,
    ) -> SEDOutput:
        """``train`` must agree with the module's mode when the model has a CNN
        branch (its BatchNorm and dropout follow the mode). In training
        ``generator`` draws the backbone's time offset (a clip shorter than
        the nominal grid), the CNN's dropout, the modality pick and the AT
        decoder's dropout masks, unless ``query_pick`` and ``dropout_masks``
        hand the last two in."""
        if self.cnn is not None and train != self.training:
            raise ValueError(f"train={train} but the module is in "
                             f"{'training' if self.training else 'eval'} mode")
        backbone_out = self.backbone(mel[:, None], train=train, generator=generator)
        x = self._f_pool(backbone_out)
        x = torch.cat([x, x[:, -1:, :]], dim=1)
        x = interpolate_time(x, self.backbone_upsample_ratio, "linear")
        if encoder_win:
            x_local = slide_window_encode(
                lambda win, group: self._encode_window(win, train, generator),
                mel, emb_len=x.shape[1], win_width=win_param[0], step=win_param[1])
            x = mix_rate * x_local + (1.0 - mix_rate) * x
        if self.cnn is not None:
            cnn_feat = self.cnn(mel.transpose(1, 2)[:, None], generator=generator)  # [B, C, T', 1]
            if cnn_feat.shape[-1] != 1:
                raise ValueError("the CNN branch must pool frequency to 1, got "
                                 f"{tuple(cnn_feat.shape)}")
            cnn_feat = resize_time(cnn_feat[:, :, :, 0].transpose(1, 2), x.shape[1], "linear")
            x = self.transformer_projector(x) + self.merge_weight * self.cnn_projector(cnn_feat)
        else:
            x = self.transformer_projector(x)
        x = self.norm_after_merge(x)

        # the AT branch over the backbone's final-norm frame tokens
        at_feat = self.at_projector(backbone_out["frame"][:, 2:, :])
        return self.detect(x, at_feat, temp_w, pad_mask, query, query_type, tgt_mask, train,
                           generator, query_pick, dropout_masks)
