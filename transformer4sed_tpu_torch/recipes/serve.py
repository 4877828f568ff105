"""Batch serving: score a directory of clips with one model at a fixed batch
size (port of ``recipes/serve.py``).

Each batch goes frontend -> model -> ``[B, T, C]`` frame scores ->
per-class median filter, plus the weak clip scores (:class:`ServingForward`).
A ragged last batch is padded with zero waves and all-true pad masks, so
every forward has the same shape. Results come back one batch behind:
batch k's scores are copied to pinned host memory on the stream right after
its forward, and are handed out while batch k+1 runs. :meth:`decode` turns a
clip's filtered scores into ``(label, onset, offset)`` events.

:func:`main` scores a directory: one score TSV per clip in the
sed_scores_eval layout (``onset offset <labels>``) and ``events.jsonl``,
from a config and a checkpoint (a port checkpoint or an upstream ``.pt``
state dict) or from a ``recipes.export`` artifact (``--exported``). An
open-vocabulary DASM serves the queries of ``--query`` (an ``.npy`` bank, one
row a class, through the projector of ``--query_type``), and
``--query_names`` (one event name a row) becomes the output class list; a
learnable-query DASM serves its own bank without ``--query``. It runs
on the card unless ``--device cpu`` is given. Under a process group of
several ranks each rank scores a strided share of the clips and writes
their TSVs, and rank 0 writes the one ``events.jsonl`` in the clips' order:
the port's form of the JAX engine's ``data_parallel``, which shards each
batch over the chips of one program.

Usage:
  python -m transformer4sed_tpu_torch.recipes.serve \\
      --config_dir config/mat-sed/finetune1.yaml --ckpt <checkpoint or .pt> \\
      --wav_dir /data/clips --out_dir scores/ [--batch_size 64] [--device cpu]
  python -m transformer4sed_tpu_torch.recipes.serve --config_dir config/dasm/closed_set.yaml \\
      --ckpt <checkpoint> --query queries.npy [--query_type text|audio] \\
      [--query_names names.txt] --wav_dir /data/clips --out_dir scores/
  python -m transformer4sed_tpu_torch.recipes.serve --exported model.pt2 \\
      --wav_dir /data/clips --out_dir scores/
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from transformer4sed_tpu_torch.core.filters import apply_class_filter
from transformer4sed_tpu_torch.utils.device import resolve_device


class ServingForward(torch.nn.Module):
    """wav [B, S], pad_mask [B, T] -> (median-filtered scores [B, T, C],
    weak [B, C]): the forward that :class:`InferenceEngine` runs and that
    ``recipes.export`` exports."""

    def __init__(self, model: torch.nn.Module, frontend, median_filter, model_kwargs: Dict):
        super().__init__()
        self.model = model
        self.frontend = frontend
        self.median_filter = median_filter
        self.model_kwargs = model_kwargs

    def forward(self, wav: torch.Tensor, pad_mask: torch.Tensor):
        mel = self.frontend.normalize(self.frontend(wav))
        out = self.model(mel, pad_mask=pad_mask, **self.model_kwargs)
        return apply_class_filter(out.strong.transpose(1, 2), self.median_filter), out.weak


class InferenceEngine:
    """Fixed-batch scorer. ``model`` and ``frontend`` must live on ``device``."""

    def __init__(self, model, frontend, codec, median_filter: Union[int, Sequence[int]] = 7,
                 batch_size: int = 8, threshold: float = 0.5,
                 model_kwargs: Optional[Dict] = None, device=None):
        self.device = resolve_device(device)
        for what, dev in (("model", next(model.parameters()).device),
                          ("frontend", frontend.device)):
            if dev.type != self.device.type:
                raise ValueError(f"{what} is on {dev}, the engine on {self.device}")
        self.model = model.eval()
        self.frontend = frontend
        self.codec = codec
        self.median_filter = (list(median_filter) if not isinstance(median_filter, int)
                              else median_filter)
        self.batch_size = batch_size
        self.threshold = threshold
        self.model_kwargs = dict(model_kwargs or {})
        self.program = ServingForward(self.model, frontend, self.median_filter, self.model_kwargs)

    @classmethod
    def from_exported(cls, path: str, threshold: float = 0.5, device=None) -> "InferenceEngine":
        """Serve a ``recipes.export`` artifact: the weights are inside the
        program and the sidecar ``<path>.meta.json`` gives the codec and the
        batch size, so no config, checkpoint or model code is read (the
        kernels' ops are registered by importing the kernels)."""
        from transformer4sed_tpu_torch.recipes.export import codec_from_meta, load_exported

        self = cls.__new__(cls)
        self.device = resolve_device(device)
        exported, meta = load_exported(path)
        if meta is None:
            raise ValueError(f"missing sidecar {path}.meta.json next to the artifact")
        where = {t.device.type for t in exported.state_dict.values()}
        if where != {self.device.type}:
            raise ValueError(f"{path} holds weights on {sorted(where)}, the engine is on "
                             f"{self.device}")
        self.model = self.frontend = self.median_filter = None
        self.model_kwargs = {}
        self.codec = codec_from_meta(meta)
        self.batch_size = int(meta["batch_size"])
        self.threshold = threshold
        self.program = exported.module()
        return self

    @torch.no_grad()
    def forward(self, wav: torch.Tensor, pad_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """wav [B, S], pad_mask [B, T] -> (filtered scores [B, T, C], weak [B, C])."""
        return self.program(wav, pad_mask)

    def _put(self, batch) -> Tuple[List[str], torch.Tensor, torch.Tensor]:
        wav = np.asarray(batch["wav"], dtype=np.float32)
        pm = np.asarray(batch["pad_mask"], dtype=bool)
        n = len(batch["filename"])
        if n < self.batch_size:
            reps = self.batch_size - n
            wav = np.concatenate([wav, np.zeros((reps,) + wav.shape[1:], wav.dtype)])
            pm = np.concatenate([pm, np.ones((reps,) + pm.shape[1:], pm.dtype)])
        pin = self.device.type == "cuda"
        wav_t, pm_t = torch.from_numpy(wav), torch.from_numpy(pm)
        if pin:
            wav_t, pm_t = wav_t.pin_memory(), pm_t.pin_memory()
        return (list(batch["filename"]), wav_t.to(self.device, non_blocking=pin),
                pm_t.to(self.device, non_blocking=pin))

    def score_batches(self, batches: Iterable[Dict]) -> Iterator[Tuple[List[str], np.ndarray, np.ndarray]]:
        """Yield (filenames, scores [n, T, C], weak [n, C]) per host batch of
        dicts with 'wav' [n, S], 'pad_mask' [n, T] and 'filename' (n names)."""
        pending = []
        for batch in batches:
            names, wav, pm = self._put(batch)
            scores, weak = self.forward(wav, pm)
            n = len(names)
            if self.device.type == "cuda":
                s_host = torch.empty(scores[:n].shape, dtype=scores.dtype, pin_memory=True)
                w_host = torch.empty(weak[:n].shape, dtype=weak.dtype, pin_memory=True)
                s_host.copy_(scores[:n], non_blocking=True)
                w_host.copy_(weak[:n], non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
            else:
                s_host, w_host, ready = scores[:n], weak[:n], None
            pending.append((names, s_host, w_host, ready))
            if len(pending) > 1:
                yield self._finish(pending.pop(0))
        for item in pending:
            yield self._finish(item)

    @staticmethod
    def _finish(item):
        names, s, w, ready = item
        if ready is not None:
            ready.synchronize()
        return names, s.numpy(), w.numpy()

    def decode(self, scores: np.ndarray) -> List[List]:
        """One clip's filtered scores [T, C] -> [label, onset, offset] events."""
        return self.codec.decode_strong((np.asarray(scores) > self.threshold).astype(np.float32))


def write_scores_tsv(path: str, scores: np.ndarray, codec) -> None:
    """One clip's scores [T, C] as the JAX serve CLI writes them: a header
    ``onset offset <labels>`` and one row a frame, the frame edges
    ``np.linspace(0, audio_len, T + 1)``."""
    ts = np.linspace(0.0, codec.audio_len, scores.shape[0] + 1)
    rows = np.concatenate([ts[:-1, None], ts[1:, None], scores], axis=1)
    np.savetxt(path, rows, delimiter="\t", header="onset\toffset\t" + "\t".join(codec.labels),
               comments="")


def merge_strided(parts: Sequence[Sequence]) -> List:
    """The items of a list split over ranks as ``items[rank::ranks]``, given
    each rank's share in rank order, back in the list's order."""
    n = sum(len(p) for p in parts)
    return [parts[i % len(parts)][i // len(parts)] for i in range(n)]


def score_directory(engine: InferenceEngine, wav_dir: str, out_dir: str, batch_size: int,
                    num_workers: int = 4) -> List[str]:
    """Score this rank's share of ``wav_dir``'s clips (all of them without a
    process group): write each clip's score TSV to ``out_dir`` and return
    its ``events.jsonl`` lines in the clips' order."""
    from transformer4sed_tpu_torch.data.datasets import UnlabeledDataset
    from transformer4sed_tpu_torch.data.loader import DataLoader

    codec = engine.codec
    loader = DataLoader(UnlabeledDataset(wav_dir, True, codec), batch_size=batch_size,
                        drop_last=False, num_workers=num_workers, process_shard_items=True)
    lines = []
    for names, scores, _ in engine.score_batches(iter(loader)):
        for name, clip in zip(names, scores):
            write_scores_tsv(os.path.join(out_dir, f"{os.path.splitext(name)[0]}.tsv"), clip, codec)
            events = [{"event": label, "onset": onset, "offset": offset}
                      for label, onset, offset in engine.decode(clip)]
            lines.append(json.dumps({"filename": name, "events": events}))
    return lines


def _run_engine(engine: InferenceEngine, args, num_workers: int) -> int:
    """Score ``--wav_dir`` with a built engine: per-clip score TSVs on every
    rank, the merged ``events.jsonl`` on rank 0."""
    from transformer4sed_tpu_torch.parallel import multihost

    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.perf_counter()
    lines = score_directory(engine, args.wav_dir, args.out_dir, engine.batch_size, num_workers)
    dt = time.perf_counter() - t0
    lines = merge_strided(multihost.gather_objects(lines))
    if multihost.is_primary():
        with open(os.path.join(args.out_dir, "events.jsonl"), "w") as f:
            f.writelines(line + "\n" for line in lines)
    print(f"scored {len(lines)} clips in {dt:.3f}s ({len(lines) / max(dt, 1e-9):.2f} clips/s)")
    return 0


def main(argv=None) -> int:
    from transformer4sed_tpu_torch.parallel import multihost
    from transformer4sed_tpu_torch.recipes import cli, common
    from transformer4sed_tpu_torch.utils.config import load_yaml_with_include

    parser = argparse.ArgumentParser(description="batch SED scoring")
    parser.add_argument("--config_dir", default=None)
    parser.add_argument("--ckpt", default=None,
                        help="a port checkpoint or an upstream .pt state dict")
    parser.add_argument("--exported", default=None,
                        help="recipes.export artifact (.pt2): serve without config or "
                             "checkpoint; weights and geometry come from the artifact and its "
                             ".meta.json sidecar")
    parser.add_argument("--wav_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--lora_ckpt", choices=("merged", "unmerged"), default=None)
    parser.add_argument("--query", default=None,
                        help=".npy of external query embeddings (open-vocabulary DASM)")
    parser.add_argument("--query_type", default="text", choices=["text", "audio"])
    parser.add_argument("--query_names", default=None,
                        help="text file, one event name per query row; becomes the output "
                             "class list")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)  # raises before anything is written without a card
    multihost.maybe_initialize()
    if args.exported:
        if args.query or args.query_names:
            parser.error("--exported artifacts have their query baked in at export time; "
                         "--query/--query_names only apply to --config_dir serving")
        if args.config_dir or args.ckpt:
            parser.error("pass either --exported or --config_dir/--ckpt, not both")
        engine = InferenceEngine.from_exported(args.exported, args.threshold, device)
        return _run_engine(engine, args, num_workers=4)
    if not args.config_dir or not args.ckpt:
        parser.error("--config_dir and --ckpt are required unless --exported is given")
    config = load_yaml_with_include(args.config_dir)
    labels = None
    if args.query_names:
        with open(args.query_names) as f:
            labels = [ln.strip() for ln in f if ln.strip()]
    extra = {}
    if args.query:
        if config.get("model_name", "PaSST_SED") != "DASM":
            parser.error(f"--query serves an open-vocabulary DASM; {args.config_dir} builds "
                         f"{config.get('model_name', 'PaSST_SED')}")
        # the rows are checked against the class list before the model is built
        query = np.load(args.query)
        n_classes = len(labels) if labels is not None else len(
            common.label_dict_labels(config) or config["dataset"]["labels"])
        if query.shape[0] != n_classes:
            parser.error(
                f"--query has {query.shape[0]} rows but the class list has {n_classes}; "
                + ("they must match one-to-one" if labels is not None else
                   "pass --query_names with one event name per query row to define the output "
                   "classes"))
        extra = {"query": torch.from_numpy(query.astype(np.float32)).to(device),
                 "query_type": args.query_type}
    engine = cli.serving_engine(config, args.ckpt, device, args.batch_size, args.threshold,
                                lora_ckpt=args.lora_ckpt, labels=labels, model_kwargs=extra)
    return _run_engine(engine, args, num_workers=config.get("generals", {}).get("num_workers", 4))


if __name__ == "__main__":
    sys.exit(main())
