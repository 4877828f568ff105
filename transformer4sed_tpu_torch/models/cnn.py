"""CNN branch (port of ``CNN`` in ``models/cnn.py``).

The reference DCASE CRNN-style stack (``src/models/cnn/base.py:33-113``):
conv -> batch / group norm -> {relu, leakyrelu, GLU, context gating} ->
dropout -> average pool, layer after layer. Input [B, 1, T, F] (the
reference feeds ``mel.transpose(1, 2).unsqueeze(1)``), output
[B, C, T', F']. Modules sit in ``self.cnn`` under upstream's names
(``cnn.conv{i}``, ``cnn.batchnorm{i}`` or ``cnn.layernorm{i}``,
``cnn.glu{i}`` / ``cnn.cg{i}``), so upstream state dicts load. The
BatchNorm is the reference's ``BatchNorm2d(eps=0.001, momentum=0.99)``,
not torch's defaults. Dropout is a draw step and an apply step: in
training the keep masks come from the ``torch.Generator`` passed to
``forward``. They are as large as the activations, so they are drawn on the
activations' device: a generator that lives elsewhere (a CPU generator,
whose small draws are the same for a model on any device) only seeds one
there (:func:`device_generator`). ``DynamicConv2d``, ``FDY_CNN``, ``ResNet`` and
``DropBlock2D`` are not ported yet (ROADMAP.md, queue 1, item 10).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from transformer4sed_tpu_torch.models.layers import Dense
from transformer4sed_tpu_torch.models.norm import RefBatchNorm


class GLUGate(nn.Module):
    """linear(x) * sigmoid(x) with the linear on the channel axis (reference GLU)."""

    def __init__(self, channels: int):
        super().__init__()
        self.linear = Dense(channels, channels)

    def forward(self, x):  # NHWC
        return self.linear(x) * torch.sigmoid(x)


class ContextGating(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.linear = Dense(channels, channels)

    def forward(self, x):  # NHWC
        return x * torch.sigmoid(self.linear(x))


class _ChannelsLastGroupNorm(nn.GroupNorm):
    """GroupNorm(1 group) over an NHWC tensor, computed and returned in float32."""

    def forward(self, x):
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.num_groups, self.weight, self.bias,
                         self.eps)
        return y.permute(0, 2, 3, 1)


def _norm(kind: str, channels: int) -> nn.Module:
    if kind == "batch":
        # reference: nn.BatchNorm2d(eps=0.001, momentum=0.99) (base.py:75):
        # torch momentum, the weight of the new batch statistic
        return RefBatchNorm(channels, momentum=0.99, eps=0.001)
    return _ChannelsLastGroupNorm(1, channels, eps=1e-6)


def _activation(name: str, channels: int) -> Tuple[str, nn.Module]:
    """(upstream module-name stem, module) of an activation."""
    name = name.lower()
    if name == "relu":
        return "relu", nn.ReLU()
    if name == "leakyrelu":
        return "relu", nn.LeakyReLU(0.2)
    if name == "glu":
        return "glu", GLUGate(channels)
    if name == "cg":
        return "cg", ContextGating(channels)
    raise ValueError(f"unknown activation {name!r}")


def device_generator(gen: torch.Generator, device) -> torch.Generator:
    """``gen`` itself when it lives on ``device``'s kind of device, else a
    generator there seeded by one draw from ``gen``."""
    device = torch.device(device)
    if gen.device.type == device.type:
        return gen
    seed = int(torch.randint(0, 2 ** 62, (), generator=gen, device=gen.device))
    return torch.Generator(device=device).manual_seed(seed)


def draw_dropout(gen: torch.Generator, shape, rate: float, device) -> torch.Tensor:
    """The scaled keep mask of one dropout call: 1 / (1 - rate) where kept, 0
    where dropped (drawn on the generator's device, moved to ``device``)."""
    keep = torch.rand(tuple(shape), generator=gen, device=gen.device) >= rate
    return keep.to(device=device, dtype=torch.float32) / (1.0 - rate)


class CNN(nn.Module):
    """CRNN-style conv pyramid. Input [B, 1, T, F] -> [B, C, T', F']."""

    def __init__(self, n_in_channel: int = 1, activation: str = "glu", conv_dropout: float = 0.0,
                 kernel_size: Sequence[int] = (3, 3, 3), padding: Sequence[int] = (1, 1, 1),
                 stride: Sequence[int] = (1, 1, 1), nb_filters: Sequence[int] = (64, 64, 64),
                 pooling: Sequence[Tuple[int, int]] = ((1, 4), (1, 4), (1, 4)),
                 normalization: str = "batch", dtype=torch.float32):
        super().__init__()
        geometry = dict(kernel_size=kernel_size, padding=padding, stride=stride, pooling=pooling)
        for name, values in geometry.items():
            if len(values) < len(nb_filters):
                raise ValueError(
                    f"cnn_param.{name} has {len(values)} entries for {len(nb_filters)} "
                    "nb_filters — provide one per conv layer")
        self.conv_dropout = conv_dropout
        self.out_channels = nb_filters[-1]
        self.pooling = [tuple(p) for p in pooling[:len(nb_filters)]]
        self.compute_dtype = dtype
        self.cnn = nn.Module()
        self._act_names = []
        norm_stem = "batchnorm" if normalization == "batch" else "layernorm"
        self._norm_stem = norm_stem
        c_in = n_in_channel
        for i, c_out in enumerate(nb_filters):
            self.cnn.add_module(f"conv{i}", nn.Conv2d(c_in, c_out, kernel_size[i], stride[i],
                                                      padding[i]))
            self.cnn.add_module(f"{norm_stem}{i}", _norm(normalization, c_out))
            stem, act = _activation(activation, c_out)
            self.cnn.add_module(f"{stem}{i}", act)
            self._act_names.append(f"{stem}{i}")
            c_in = c_out

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """In training with ``conv_dropout`` the keep masks are drawn from
        ``generator``, or taken from ``dropout_masks`` (one scaled NHWC mask
        per layer, as :func:`draw_dropout` makes them)."""
        dt = self.compute_dtype
        drop = self.training and self.conv_dropout > 0
        if drop and generator is None and dropout_masks is None:
            raise ValueError("conv_dropout in training needs a torch.Generator")
        if drop and dropout_masks is None:
            generator = device_generator(generator, x.device)
        h = x
        for i, (pt, pf) in enumerate(self.pooling):
            conv = getattr(self.cnn, f"conv{i}")
            h = F.conv2d(h.to(dt), conv.weight.to(dt), conv.bias.to(dt), stride=conv.stride,
                         padding=conv.padding)
            h = h.permute(0, 2, 3, 1)  # NHWC: the norm and the gates act on the trailing axis
            h = getattr(self.cnn, f"{self._norm_stem}{i}")(h)
            h = getattr(self.cnn, self._act_names[i])(h)
            if drop:
                mask = (dropout_masks[i] if dropout_masks is not None
                        else draw_dropout(generator, h.shape, self.conv_dropout, h.device))
                h = h * mask.to(h.dtype)
            h = F.avg_pool2d(h.permute(0, 3, 1, 2), (pt, pf))
        return h
