"""Batch serving: score clips with one model at a fixed batch size
(port of ``recipes/serve.py:InferenceEngine``).

Each batch goes frontend -> model -> ``[B, T, C]`` frame scores ->
per-class median filter, plus the weak clip scores. A ragged last batch
is padded with zero waves and all-true pad masks, so every forward has
the same shape. Results come back one batch behind: batch k's scores
are copied to pinned host memory on the stream right after its forward,
and are handed out while batch k+1 runs. :meth:`decode` turns a clip's
filtered scores into ``(label, onset, offset)`` events.

The command-line ``main()`` comes with the slice that ports the config
loader; the engine is built from explicit arguments.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from transformer4sed_tpu_torch.core.filters import apply_class_filter
from transformer4sed_tpu_torch.utils.device import resolve_device


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

    @torch.no_grad()
    def forward(self, wav: torch.Tensor, pad_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """wav [B, S], pad_mask [B, T] -> (filtered scores [B, T, C], weak [B, C])."""
        mel = self.frontend.normalize(self.frontend(wav))
        out = self.model(mel, pad_mask=pad_mask, **self.model_kwargs)
        scores = out.strong.transpose(1, 2)
        return apply_class_filter(scores, self.median_filter), out.weak

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
