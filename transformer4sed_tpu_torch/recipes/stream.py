"""Streaming (online) SED: score a live audio stream incrementally (port of
``recipes/stream.py``).

Audio arrives in chunks of any size. Windows of ``codec.audio_len`` seconds
advance by ``hop_seconds`` through a host ring buffer; each window runs one
forward of the same shape (``[1, S]``) on the model's device, and its
median-filtered frame scores overlap-add into a running timeline on the
host. Frames that no later window can touch are final and are emitted
once, so the latency is at most one window; emitted rows are compacted
away, so a stream of any length holds O(window) state.

Usage::

    scorer = StreamingScorer(model, frontend, codec)
    for chunk in microphone():                  # any chunk sizes
        for t0, scores in scorer.push(chunk):   # finalized frames
            ...
    for t0, scores in scorer.flush():           # the tail
        ...

``python -m transformer4sed_tpu_torch.recipes.stream`` streams a file
through the scorer (on the card unless ``--device cpu`` is given).
"""

from __future__ import annotations

import sys
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from transformer4sed_tpu_torch.core.filters import apply_class_filter


class StreamingScorer:
    """Incremental overlap-add scorer over a live waveform stream.

    Emits ``(frame_onset_seconds, scores[C])`` rows in time order, each
    exactly once, whatever the chunking of the input.
    """

    def __init__(self, model, frontend, codec, hop_seconds: Optional[float] = None,
                 median_filter=7, model_kwargs: Optional[dict] = None):
        self.codec = codec
        self.win = int(codec.audio_len * codec.sr)
        if hop_seconds is None:
            hop_seconds = codec.audio_len / 5.0
        self.hop = max(int(hop_seconds * codec.sr), 1)
        if self.hop > self.win:
            raise ValueError(
                f"hop_seconds ({hop_seconds}) must not exceed the window length "
                f"({codec.audio_len}s): gaps between windows would drop audio")
        self.model = model.eval()
        self.frontend = frontend
        self.median_filter = median_filter
        self.model_kwargs = dict(model_kwargs or {})
        self.device = next(model.parameters()).device
        self.windows = 0  # forwards run
        self._buffer = np.zeros(0, np.float32)
        self._consumed = 0  # samples dropped from the left of the buffer
        self._next_win = 0  # sample index of the next window start
        # the accumulators hold frames [_frame_base, _frame_base + len);
        # finalized rows are compacted away
        self._acc: Optional[np.ndarray] = None  # [frames, C] running sums
        self._cnt: Optional[np.ndarray] = None
        self._frame_base = 0
        self._emitted = 0  # finalized frames (absolute)
        self._frames_per_win: Optional[int] = None
        self._n_classes = 0

    @torch.no_grad()
    def _forward(self, wav: np.ndarray) -> np.ndarray:
        """One window [S] -> filtered scores [T, C] on the host."""
        mel = self.frontend.normalize(self.frontend(torch.from_numpy(wav[None]).to(self.device)))
        out = self.model(mel, **self.model_kwargs)
        self.windows += 1
        scores = apply_class_filter(out.strong.transpose(1, 2), self.median_filter)[0]
        return scores.float().cpu().numpy()

    def _frame_of(self, sample: int) -> int:
        """Timeline frame of a sample position (the window's frame grid)."""
        return int(round(sample / self.win * self._frames_per_win))

    def _grow(self, n_frames_rel: int):
        if self._acc is None or n_frames_rel > self._acc.shape[0]:
            new = max(n_frames_rel, 2 * (self._acc.shape[0] if self._acc is not None else 256))
            acc = np.zeros((new, self._n_classes), np.float32)
            cnt = np.zeros((new, 1), np.float32)
            if self._acc is not None:
                acc[:self._acc.shape[0]] = self._acc
                cnt[:self._cnt.shape[0]] = self._cnt
            self._acc, self._cnt = acc, cnt

    def _run_window(self, start: int, wav: np.ndarray):
        scores = self._forward(np.ascontiguousarray(wav, np.float32))
        if self._frames_per_win is None:
            self._frames_per_win, self._n_classes = scores.shape
        f0 = self._frame_of(start) - self._frame_base
        if f0 < 0:
            # frames below the compacted base are final and never revised
            # (the flush window can reach back)
            scores = scores[-f0:]
            f0 = 0
        if not scores.shape[0]:
            return
        self._grow(f0 + scores.shape[0])
        self._acc[f0:f0 + scores.shape[0]] += scores
        self._cnt[f0:f0 + scores.shape[0]] += 1.0

    def _finalize_until(self, frame_end: int) -> List[Tuple[float, np.ndarray]]:
        out = []
        if self._acc is None:
            return out
        frame_end = min(frame_end, self._frame_base + self._acc.shape[0])
        sec_per_frame = self.codec.audio_len / self._frames_per_win
        for f in range(self._emitted, frame_end):
            rel = f - self._frame_base
            if self._cnt[rel, 0] > 0:
                out.append((f * sec_per_frame, self._acc[rel] / self._cnt[rel, 0]))
        self._emitted = max(self._emitted, frame_end)
        drop = self._emitted - self._frame_base  # compact: drop the finalized rows
        if drop > 0:
            self._acc = self._acc[drop:].copy()
            self._cnt = self._cnt[drop:].copy()
            self._frame_base = self._emitted
        return out

    def push(self, chunk: np.ndarray) -> List[Tuple[float, np.ndarray]]:
        """Feed a waveform chunk; returns the newly finalized
        ``(frame_onset_seconds, scores[C])`` rows."""
        self._buffer = np.concatenate([self._buffer, np.asarray(chunk, np.float32)])
        total = self._consumed + len(self._buffer)
        while self._next_win + self.win <= total:
            lo = self._next_win - self._consumed
            self._run_window(self._next_win, self._buffer[lo:lo + self.win])
            self._next_win += self.hop
        # keep what a later hop window or the flush window (which starts at
        # total - win, never before the next hop window) can still need
        drop = max(total - self.win, 0) - self._consumed
        if drop > 0:
            self._buffer = self._buffer[drop:]
            self._consumed += drop
        if self._frames_per_win is None:
            return []
        return self._finalize_until(self._frame_of(self._next_win))  # before the next window

    def flush(self) -> List[Tuple[float, np.ndarray]]:
        """End of stream: score one last window that ends at the stream's end
        (zero-padded for a stream shorter than a window), then emit every
        row left. Rows :meth:`push` finalized are not revised; when the
        stream's length lands on the hop grid the rows equal an offline
        overlap-add of the same windows."""
        total = self._consumed + len(self._buffer)
        last_hop_start = self._next_win - self.hop if self._next_win > 0 else None
        start = max(total - self.win, 0)
        if total > self._next_win and start != last_hop_start:
            lo = start - self._consumed
            if lo < 0:
                raise RuntimeError("the stream's buffer dropped samples the flush window needs")
            wav = self._buffer[lo:]
            if len(wav) < self.win:
                wav = np.concatenate([wav, np.zeros(self.win - len(wav), np.float32)])
            self._run_window(start, wav[:self.win])
        if self._frames_per_win is None:
            return []
        return self._finalize_until(self._frame_of(total) if total else 0)

    def stream(self, chunks) -> Iterator[Tuple[float, np.ndarray]]:
        """The finalized rows over an iterable of chunks, the flush's too."""
        for chunk in chunks:
            yield from self.push(chunk)
        yield from self.flush()


def main(argv=None) -> int:
    """Stream a file through the scorer as if it were live input, printing
    one JSON line a finalized frame, or with ``--threshold`` one a detected
    event::

        python -m transformer4sed_tpu_torch.recipes.stream \\
            --config_dir config/mat-sed/finetune1.yaml --ckpt <checkpoint or .pt> \\
            --wav long.wav [--hop 2.0] [--chunk 0.5] [--threshold 0.5] [--device cpu]
    """
    import argparse
    import json

    from transformer4sed_tpu_torch.data.audio_io import load_audio
    from transformer4sed_tpu_torch.recipes import cli
    from transformer4sed_tpu_torch.utils.config import load_yaml_with_include
    from transformer4sed_tpu_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(description="streaming SED over a wav file")
    parser.add_argument("--config_dir", required=True)
    parser.add_argument("--ckpt", required=True,
                        help="a port checkpoint or an upstream .pt state dict")
    parser.add_argument("--wav", required=True)
    parser.add_argument("--hop", type=float, default=None,
                        help="window hop seconds (default window/5)")
    parser.add_argument("--chunk", type=float, default=0.5, help="simulated input chunk seconds")
    parser.add_argument("--threshold", type=float, default=None,
                        help="emit thresholded events instead of frame scores")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    s = cli.serving_model(load_yaml_with_include(args.config_dir), args.ckpt, device)
    scorer = StreamingScorer(s.model, s.frontend, s.codec, hop_seconds=args.hop,
                             median_filter=s.median_filter, model_kwargs=s.model_kwargs)
    wav = load_audio(args.wav, s.codec.sr)
    chunk = max(int(args.chunk * s.codec.sr), 1)

    open_events = {}  # label -> onset (threshold mode)
    last_t = 0.0
    for t0, scores in scorer.stream(wav[i:i + chunk] for i in range(0, len(wav), chunk)):
        if args.threshold is None:
            print(json.dumps({"t": round(t0, 4), "scores": [round(float(x), 5) for x in scores]}))
            continue
        last_t = t0
        for ci, label in enumerate(s.codec.labels):
            on = scores[ci] > args.threshold
            if on and label not in open_events:
                open_events[label] = t0
            elif not on and label in open_events:
                print(json.dumps({"event": label, "onset": round(open_events.pop(label), 4),
                                  "offset": round(t0, 4)}))
    for label, onset in sorted(open_events.items(), key=lambda kv: kv[1]):
        print(json.dumps({"event": label, "onset": round(onset, 4), "offset": round(last_t, 4)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
