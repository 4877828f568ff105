"""Query-bank tooling for DASM's text and audio modalities (port of
``recipes/queries.py``).

Audio queries: per-class prototypes, the label-weighted mean of HTSAT
fine-grained frame embeddings over strongly labelled clips (upstream
``recipes/audioset_strong/detect_any_sound/queries_extract/
extract_audio_queries.py:38-106``). Each batch is one masked matmul on the
embeddings' device, ``labels @ embeddings``; the sums and counts gather in
float64 on the host.

Text queries: :func:`build_text_query_bank` assembles the [C, D] bank in the
label list's order from a precomputed embedding table (``'sound of ' +
label`` first, then the bare label), and a text encoder plugged in as
``--text_encoder pkg.module:fn`` (fn: list[str] -> [N, D]) embeds the labels
the table lacks.

Usage:
  python -m transformer4sed_tpu_torch.recipes.queries build_text \\
      --labels labels.json --embeddings table.npz --out text_queries.npy
  python -m transformer4sed_tpu_torch.recipes.queries extract_audio \\
      --config_dir <yaml of an HTSAT network> --ckpt <checkpoint or .pt> \\
      --tsv strong.tsv --wav_dir clips/ --out audio_queries.npy [--device cpu]

``extract_audio`` embeds on the card (the HTSAT backbone's Swin window
attention kernel) unless ``--device cpu`` is given, and reads the TSV with
the port's reader (``data/tsv.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch


@torch.no_grad()
def extract_audio_queries(embed_fn: Callable[[torch.Tensor], torch.Tensor], batches: Iterable,
                          n_classes: int, embed_dim: int, frame_labels_key: str = "label",
                          cap_classes: Sequence[int] = (), cap_threshold: int = 0) -> np.ndarray:
    """Per-class mean frame embeddings, [C, D] float32 (zero rows for the
    classes never seen).

    ``embed_fn`` maps a batch's ``wav`` [B, S] to frame embeddings [B, T', D]
    (a tensor on any device); each batch's frame labels [B, C, T_lab] are
    taken at frame ``(t * T_lab) // T'`` and thresholded at 0.5. A class of
    ``cap_classes`` stops taking frames once its count passes
    ``cap_threshold`` (upstream's ``exp_event_set``)."""
    sums = np.zeros((n_classes, embed_dim), np.float64)
    counts = np.zeros((n_classes,), np.int64)
    cap = {int(c) for c in cap_classes}
    for batch in batches:
        emb = embed_fn(torch.as_tensor(batch["wav"])).float()
        labels = torch.as_tensor(batch[frame_labels_key]).to(emb.device)
        t_emb, t_lab = emb.shape[1], labels.shape[-1]
        idx = torch.clamp((torch.arange(t_emb, device=emb.device) * t_lab) // t_emb, 0, t_lab - 1)
        lab = (labels.index_select(2, idx) > 0.5).float()  # [B, C, T']
        s = torch.einsum("bct,btd->cd", lab, emb).double().cpu().numpy()
        n = lab.sum(dim=(0, 2)).cpu().numpy().astype(np.int64)
        for c in range(n_classes):
            if c in cap and counts[c] > cap_threshold:
                continue
            sums[c] += s[c]
            counts[c] += n[c]
    means = np.zeros_like(sums, dtype=np.float32)
    seen = counts > 0
    means[seen] = (sums[seen] / counts[seen, None]).astype(np.float32)
    return means


def load_labels(path: str) -> Tuple[str, ...]:
    """The class list of a labeldict JSON ({label: index}, in index order), a
    JSON list, or a text file with one label a line."""
    if path.endswith(".json"):
        with open(path) as f:
            obj = json.load(f)
        if isinstance(obj, dict):
            from transformer4sed_tpu_torch.recipes.audioset_strong import load_label_dict

            return load_label_dict(path)
        return tuple(obj)
    with open(path) as f:
        return tuple(ln.strip() for ln in f if ln.strip())


def load_embedding_table(emb_path: str, names_path: Optional[str] = None
                         ) -> Tuple[Sequence[str], np.ndarray]:
    """(names, embeddings [N, D]) from an ``.npz`` ('names' and 'embeddings'
    arrays) or an ``.npy`` matrix with a names file of one name a row."""
    if emb_path.endswith(".npz"):
        with np.load(emb_path, allow_pickle=False) as z:
            if "names" not in z or "embeddings" not in z:
                raise ValueError(f"{emb_path}: .npz table needs 'names' and 'embeddings' arrays")
            return [str(n) for n in z["names"]], np.asarray(z["embeddings"])
    emb = np.load(emb_path)
    if names_path is None:
        raise ValueError(f"{emb_path}: .npy embedding matrix needs --embedding_names "
                         f"(one name per row)")
    with open(names_path) as f:
        names = [ln.strip() for ln in f if ln.strip()]
    if len(names) != emb.shape[0]:
        raise ValueError(f"--embedding_names lists {len(names)} names but the table has "
                         f"{emb.shape[0]} rows")
    return names, emb


def load_text_encoder(spec: str) -> Callable[[Sequence[str]], np.ndarray]:
    """The text-encoder plug point ``pkg.module:fn`` (``encode_text`` when
    no function is named): a callable from prompt strings to [N, D]."""
    import importlib

    mod_name, _, attr = spec.partition(":")
    fn = getattr(importlib.import_module(mod_name), attr or "encode_text")
    if not callable(fn):
        raise TypeError(f"{spec} resolved to non-callable {fn!r}")
    return fn


def build_text_query_bank(labels: Sequence[str], table_names: Sequence[str],
                          table_embeddings: np.ndarray, prompt: str = "sound of ",
                          text_encoder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
                          normalize: bool = False) -> np.ndarray:
    """[C, D] float32 bank in ``labels``' order: a label's row is the table's
    ``prompt + label``, else its bare label; the labels in neither go to
    ``text_encoder`` (prompted), and without one they raise. ``normalize``
    scales each row to unit L2 norm."""
    index = {str(n): i for i, n in enumerate(table_names)}
    emb = np.asarray(table_embeddings, np.float32)
    rows: list = [None] * len(labels)
    missing: list = []
    for li, lab in enumerate(labels):
        for cand in (prompt + lab, lab):
            if cand in index:
                rows[li] = emb[index[cand]]
                break
        else:
            missing.append(li)
    if missing:
        if text_encoder is None:
            raise ValueError(
                f"{len(missing)} labels missing from the embedding table (first: "
                f"{[labels[li] for li in missing[:5]]}); pass --text_encoder pkg.module:fn to "
                f"embed them, or extend the table")
        encoded = np.asarray(text_encoder([prompt + labels[li] for li in missing]), np.float32)
        if encoded.shape[0] != len(missing):
            raise ValueError(f"text encoder returned {encoded.shape[0]} rows for "
                             f"{len(missing)} labels")
        for k, li in enumerate(missing):
            rows[li] = encoded[k]
    bank = np.stack(rows).astype(np.float32)
    if normalize:
        bank = bank / np.maximum(np.linalg.norm(bank, axis=1, keepdims=True), 1e-12)
    return bank


def _cmd_build_text(args) -> int:
    labels = load_labels(args.labels)
    names, emb = load_embedding_table(args.embeddings, args.embedding_names)
    encoder = load_text_encoder(args.text_encoder) if args.text_encoder else None
    bank = build_text_query_bank(labels, names, emb, prompt=args.prompt, text_encoder=encoder,
                                 normalize=args.normalize)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".", exist_ok=True)
    np.save(args.out, bank)
    names_out = os.path.splitext(args.out)[0] + "_names.txt"
    with open(names_out, "w") as f:
        f.write("\n".join(labels) + "\n")
    print(f"wrote {bank.shape[0]}x{bank.shape[1]} query bank to {args.out} (names: {names_out})")
    return 0


def _cmd_extract_audio(args) -> int:
    from transformer4sed_tpu_torch.data.datasets import StronglyLabeledDataset
    from transformer4sed_tpu_torch.data.loader import DataLoader
    from transformer4sed_tpu_torch.data.tsv import read_tsv
    from transformer4sed_tpu_torch.models.htsat import HTSAT
    from transformer4sed_tpu_torch.recipes import cli, common
    from transformer4sed_tpu_torch.utils.config import load_yaml_with_include, resolve_meta_path
    from transformer4sed_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    config = load_yaml_with_include(args.config_dir)
    label_dict = resolve_meta_path(args.labels or config.get("dataset", {}).get("label_dict"))
    codec = common.codec_from_config(
        config, labels=list(load_labels(label_dict)) if label_dict else None)
    model, frontend = cli.build_model(config, device)
    if not isinstance(getattr(model, "backbone", None), HTSAT):
        raise SystemExit(f"{type(model).__name__} has no HTSAT backbone with a "
                         "fine_grained_embedding; audio-query extraction needs an HTSAT-family "
                         "model (HTSAT_CNN, CLAP_SED, DASM_HTSAT)")
    model.load_state_dict(cli.read_weights(args.ckpt, model, config))
    model = model.to(device).eval()

    def embed_fn(wav):
        mel = frontend.normalize(frontend(wav.to(device)))
        return model.backbone(mel)["fine_grained_embedding"]

    ds = StronglyLabeledDataset(read_tsv(args.tsv), args.wav_dir, False, codec)
    loader = DataLoader(ds, batch_size=args.batch_size, drop_last=False,
                        num_workers=args.num_workers)
    cap_classes = [int(c) for c in args.cap_classes.split(",") if c] if args.cap_classes else ()
    bank = extract_audio_queries(embed_fn, iter(loader), codec.n_classes,
                                 model.backbone.num_features, cap_classes=cap_classes,
                                 cap_threshold=args.cap_threshold)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".", exist_ok=True)
    np.save(args.out, bank)
    print(f"wrote {bank.shape[0]}x{bank.shape[1]} audio query bank to {args.out}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="DASM query-bank tooling")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("build_text",
                       help="assemble a [C, D] text query bank from labels and an embedding table")
    p.add_argument("--labels", required=True,
                   help="labeldict json / json list / txt, defines the class order")
    p.add_argument("--embeddings", required=True,
                   help=".npz with names and embeddings, or .npy matrix")
    p.add_argument("--embedding_names", default=None,
                   help="names txt for an .npy matrix (one per row)")
    p.add_argument("--out", required=True, help="output .npy path")
    p.add_argument("--prompt", default="sound of ",
                   help="prompt prefix tried for table lookup and encoding")
    p.add_argument("--normalize", action="store_true", help="L2-normalise rows")
    p.add_argument("--text_encoder", default=None,
                   help="pkg.module:fn plug-point for labels missing from the table")
    p.set_defaults(fn=_cmd_build_text)

    p = sub.add_parser("extract_audio",
                       help="per-class audio prototypes from HTSAT fine-grained embeddings")
    p.add_argument("--config_dir", required=True)
    p.add_argument("--ckpt", required=True, help="a port checkpoint or an upstream .pt")
    p.add_argument("--tsv", required=True,
                   help="strong-label tsv (filename/onset/offset/event_label)")
    p.add_argument("--wav_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--labels", default=None,
                   help="labeldict json (defaults to dataset.label_dict from the config)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--cap_classes", default=None,
                   help="comma-separated class indices capped once their frame count passes "
                        "--cap_threshold (upstream's exp_event_set)")
    p.add_argument("--cap_threshold", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain versions)")
    p.set_defaults(fn=_cmd_extract_audio)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
