"""Serving artifacts through ``torch.export`` (port of ``recipes/export.py``).

The whole serving forward, wav -> frontend -> model -> median filter
(``recipes/serve.py:ServingForward``), is traced once by
``torch.export.export`` at a fixed batch size and written to one ``.pt2``
file with the weights inside. The attention runs through the kernels'
custom ops (``t4s::flash_nhd_fwd``, ``t4s::xl_nhd_fwd``, ``t4s::xl_hm_fwd``,
``t4s::window_fwd``), so the program calls the hand-written kernels on the
card and their plain versions on the CPU. A consumer needs no config,
checkpoint or model code, only the kernels' ops registered, which
:func:`load_exported` does by importing ``transformer4sed_tpu_torch.kernels``::

    from transformer4sed_tpu_torch.recipes.export import load_exported
    program, meta = load_exported("model.pt2")
    scores, weak = program.module()(wav, pad_mask)   # [B, T, C], [B, C]

The program runs on the device it was exported on (the card unless
``--device cpu`` is given). The sidecar ``<out>.meta.json`` carries what
feeding and decoding need (classes, sample rate, clip length, batch size,
frame grid; the JAX sidecar's keys, with ``torch_version`` for
``jax_version``), so ``recipes.serve --exported model.pt2`` scores a
directory with no config at all.

Usage:
  python -m transformer4sed_tpu_torch.recipes.export \\
      --config_dir config/mat-sed/finetune1.yaml --ckpt <checkpoint or .pt> \\
      --out model.pt2 [--batch_size 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import torch


def export_serving_forward(model, frontend, codec, batch_size: int = 64, median_filter=7,
                           model_kwargs: Optional[dict] = None) -> torch.export.ExportedProgram:
    """``torch.export`` of the serving forward with the weights inside, on
    the model's device: ``(wav [B, S] f32, pad_mask [B, T] bool) -> (scores
    [B, T, C], weak [B, C])``, the signature of ``InferenceEngine.forward``."""
    from transformer4sed_tpu_torch.recipes.serve import ServingForward

    dev = next(model.parameters()).device
    program = ServingForward(model.eval(), frontend, median_filter, dict(model_kwargs or {}))
    n_samples = int(round(codec.audio_len * codec.sr))
    args = (torch.zeros((batch_size, n_samples), dtype=torch.float32, device=dev),
            torch.zeros((batch_size, codec.n_frames), dtype=torch.bool, device=dev))
    with torch.no_grad():
        return torch.export.export(program, args, strict=False)


def write_artifact(path: str, exported: torch.export.ExportedProgram, codec, batch_size: int,
                   labels=None) -> dict:
    """Write the program (``torch.export.save``) and the decode-side
    metadata sidecar ``<path>.meta.json``."""
    torch.export.save(exported, path)
    meta = {
        "labels": list(labels if labels is not None else codec.labels),
        "sr": codec.sr,
        "audio_len": codec.audio_len,
        "n_samples": int(round(codec.audio_len * codec.sr)),
        "pred_len": codec.n_frames,
        "frame_len": codec.frame_len,
        "frame_hop": codec.frame_hop,
        "net_pooling": codec.net_pooling,
        "batch_size": batch_size,
        "torch_version": torch.__version__,
        "signature": "(wav [B,S] f32, pad_mask [B,T] bool) -> (scores [B,T,C], weak [B,C])",
    }
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def codec_from_meta(meta: dict):
    """The label codec of an artifact's sidecar (serving without a config)."""
    from transformer4sed_tpu_torch.core.codec import LabelCodec

    codec = LabelCodec(
        labels=tuple(meta["labels"]),
        audio_len=meta["audio_len"],
        frame_len=meta["frame_len"],
        frame_hop=meta["frame_hop"],
        net_pooling=meta.get("net_pooling", 1),
        sr=meta["sr"],
    )
    if codec.n_frames != meta["pred_len"]:
        raise ValueError(f"artifact metadata inconsistent: derived n_frames {codec.n_frames} "
                         f"!= stored pred_len {meta['pred_len']}")
    return codec


def load_exported(path: str):
    """An artifact -> (``torch.export.ExportedProgram``, metadata dict or None).
    Imports the kernels first: the program calls their ops."""
    import transformer4sed_tpu_torch.kernels  # noqa: F401  registers the t4s:: ops

    exported = torch.export.load(path)
    meta = None
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return exported, meta


def main(argv=None) -> int:
    from transformer4sed_tpu_torch.recipes import cli
    from transformer4sed_tpu_torch.utils.config import load_yaml_with_include
    from transformer4sed_tpu_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(description="export the serving forward")
    parser.add_argument("--config_dir", required=True)
    parser.add_argument("--ckpt", required=True,
                        help="a port checkpoint or an upstream .pt state dict")
    parser.add_argument("--out", required=True, help="output artifact path (.pt2)")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--lora_ckpt", choices=("merged", "unmerged"), default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' exports the plain versions)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    s = cli.serving_model(load_yaml_with_include(args.config_dir), args.ckpt, device,
                          args.lora_ckpt)
    exported = export_serving_forward(s.model, s.frontend, s.codec, args.batch_size,
                                      s.median_filter, s.model_kwargs)
    meta = write_artifact(args.out, exported, s.codec, args.batch_size)
    print(f"exported {os.path.getsize(args.out) / 1e6:.1f} MB artifact to {args.out} "
          f"(device {device}, batch {args.batch_size}, classes {len(meta['labels'])})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
