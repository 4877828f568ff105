"""Single-clip and long-audio inference (port of ``recipes/infer.py``).

A WAV or FLAC file -> frontend -> model -> median filter -> threshold ->
``(event, onset, offset)`` list. :func:`infer_clip` scores one clip padded
or cut to the codec's length; :func:`infer_long_audio` scores audio of any
length through windows of ``codec.audio_len`` seconds, all in one batched
forward, whose frame scores are overlap-added into segment scores
(``eval/scores.py:segment_scores_overlap_add``, the reference's MAESTRO
long-file path). Both run on the model's device; :func:`main` builds the
model on the card unless ``--device cpu`` is given. An open-vocabulary DASM
takes its queries as ``query`` (and ``query_type``; ``--query``,
``--query_type``).

Usage:
  python -m transformer4sed_tpu_torch.recipes.infer \\
      --config_dir config/mat-sed/finetune1.yaml --ckpt <checkpoint or .pt> \\
      --wav clip.wav [--threshold 0.5] [--long [--stride 5.0]] [--query queries.npy
      [--query_type text|audio]] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from transformer4sed_tpu_torch.core.filters import apply_class_filter
from transformer4sed_tpu_torch.data.audio_io import pad_wav


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _with_query(model_kwargs: Optional[dict], query, query_type: Optional[str]) -> dict:
    """The forward's kwargs with an open-vocabulary DASM's query, if any."""
    kwargs = dict(model_kwargs or {})
    if query is not None:
        kwargs["query"] = query
        kwargs["query_type"] = query_type
    return kwargs


@torch.no_grad()
def infer_clip(model, frontend, wav: np.ndarray, codec, threshold: float = 0.5,
               median_filter=7, model_kwargs: Optional[dict] = None, query=None,
               query_type: Optional[str] = None
               ) -> Tuple[List[Tuple[str, float, float]], np.ndarray, np.ndarray]:
    """One clip, padded or cut to ``codec.audio_len`` -> (events, strong
    scores [C, T] before the filter, weak [C]); ``query`` / ``query_type``:
    an open-vocabulary DASM's."""
    model_kwargs = _with_query(model_kwargs, query, query_type)
    dev = _device_of(model)
    wav_p, pad_mask = pad_wav(np.asarray(wav, np.float32), int(codec.audio_len * codec.sr), codec)
    mel = frontend.normalize(frontend(torch.from_numpy(wav_p[None]).to(dev)))
    out = model(mel, pad_mask=torch.from_numpy(pad_mask[None]).to(dev), **model_kwargs)
    filtered = apply_class_filter(out.strong.transpose(1, 2), median_filter)
    binary = (filtered[0] > threshold).float().cpu().numpy()
    events = [(label, onset, offset) for label, onset, offset in codec.decode_strong(binary)]
    return events, out.strong[0].float().cpu().numpy(), out.weak[0].float().cpu().numpy()


def window_starts(n_samples: int, win: int, hop: int) -> List[int]:
    """Starts of the windows of ``win`` samples a ``hop`` apart over
    ``n_samples``; the last one reaches the end or past it."""
    return list(range(0, max(n_samples - win, 0) + hop, hop)) or [0]


@torch.no_grad()
def infer_long_audio(model, frontend, wav: np.ndarray, codec, threshold: float = 0.5,
                     median_filter=7, stride: Optional[float] = None,
                     segment_length: float = 1.0, model_kwargs: Optional[dict] = None,
                     query=None, query_type: Optional[str] = None
                     ) -> Tuple[List[Tuple[str, float, float]], np.ndarray]:
    """Audio of any length -> (events, segment scores [n_segments, C]).

    Windows of ``codec.audio_len`` seconds advance by ``stride`` (default
    half a window) and run as one batched forward; their filtered frame
    scores are overlap-added into segments of ``segment_length`` seconds,
    and a class's event runs from the first segment over ``threshold`` to
    the next one under it.
    """
    from transformer4sed_tpu_torch.eval.scores import ClipScores, segment_scores_overlap_add

    model_kwargs = _with_query(model_kwargs, query, query_type)
    dev = _device_of(model)
    wav = np.asarray(wav, np.float32)
    win = int(codec.audio_len * codec.sr)
    hop = max(int((stride if stride is not None else codec.audio_len / 2) * codec.sr), 1)
    duration = len(wav) / codec.sr
    chunks, pad_masks, clip_ids = [], [], []
    for s in window_starts(len(wav), win, hop):
        piece, pm = pad_wav(wav[s:s + win], win, codec)
        chunks.append(piece)
        pad_masks.append(pm)
        on_cs = int(round(s / codec.sr * 100))
        off_cs = int(round(min((s + win) / codec.sr, duration) * 100))
        clip_ids.append(f"clip-{on_cs}-{off_cs}")

    mel = frontend.normalize(frontend(torch.from_numpy(np.stack(chunks)).to(dev)))
    out = model(mel, pad_mask=torch.from_numpy(np.stack(pad_masks)).to(dev), **model_kwargs)
    filtered = apply_class_filter(out.strong.transpose(1, 2), median_filter)
    filtered = filtered.float().cpu().numpy()
    edges = np.linspace(0.0, codec.audio_len, filtered.shape[1] + 1)
    frame_scores = {cid: ClipScores(filtered[i], edges, codec.labels)
                    for i, cid in enumerate(clip_ids)}
    segs = segment_scores_overlap_add(frame_scores, {"clip": duration}, codec.labels,
                                      segment_length=segment_length)["clip"]
    binary = segs.scores > threshold
    events = []
    for ci, label in enumerate(codec.labels):
        on = None
        for si in range(binary.shape[0]):
            if binary[si, ci] and on is None:
                on = segs.timestamps[si]
            elif not binary[si, ci] and on is not None:
                events.append((label, float(on), float(segs.timestamps[si])))
                on = None
        if on is not None:
            events.append((label, float(on), float(segs.timestamps[-1])))
    return events, segs.scores


def main(argv=None) -> int:
    from transformer4sed_tpu_torch.data.audio_io import load_audio
    from transformer4sed_tpu_torch.recipes import cli
    from transformer4sed_tpu_torch.utils.config import load_yaml_with_include
    from transformer4sed_tpu_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(description="single-clip SED inference")
    parser.add_argument("--config_dir", required=True)
    parser.add_argument("--ckpt", required=True,
                        help="a port checkpoint or an upstream .pt state dict")
    parser.add_argument("--wav", required=True)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--query", default=None, help=".npy query embeddings (open-vocabulary "
                        "DASM)")
    parser.add_argument("--query_type", default=None, choices=[None, "text", "audio"])
    parser.add_argument("--long", action="store_true",
                        help="arbitrary-length audio via sliding windows + overlap-add")
    parser.add_argument("--stride", type=float, default=None,
                        help="window stride in seconds (default half a window)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    s = cli.serving_model(load_yaml_with_include(args.config_dir), args.ckpt, device)
    wav = load_audio(args.wav, s.codec.sr)
    query = (None if args.query is None
             else torch.from_numpy(np.load(args.query).astype(np.float32)).to(device))
    kwargs = dict(threshold=args.threshold, median_filter=s.median_filter,
                  model_kwargs=s.model_kwargs, query=query, query_type=args.query_type)
    if args.long:
        events, _ = infer_long_audio(s.model, s.frontend, wav, s.codec, stride=args.stride,
                                     **kwargs)
        print(json.dumps({"events": events}, indent=2))
        return 0
    events, _, weak = infer_clip(s.model, s.frontend, wav, s.codec, **kwargs)
    print(json.dumps({"events": events, "weak": weak.tolist()}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
