"""Waveform IO: load -> mono -> resample -> pad/truncate -> pad mask.

Port of the JAX package's ``data/audio_io.py`` (reference
``src/preprocess/feats_extraction.py:7-38``): librosa.load at the codec
sample rate, downmix to mono, zero-pad or truncate to ``audio_len * sr``
samples, and a frame-level pad mask (True where frames are padding). The
hot path is the port's C++ library (``native/wav_core.cpp``: RIFF and FLAC
decode + windowed-sinc resampling, GIL-free, a batch thread pool); the
Python path is scipy.io.wavfile / the pure-Python FLAC decoder
(``data/flac.py``) and scipy's ``resample_poly``, chosen on the magic bytes.
``native=False`` takes the Python path (the JAX package's
``T4S_DISABLE_NATIVE_WAV``); files the native library rejects are redone
through it. ``DECODES`` counts the files each path decoded, ``BATCHES`` the
calls of :func:`load_wav_batch` by path.
"""

from __future__ import annotations

import collections
import ctypes
import math
import threading
from fractions import Fraction
from typing import Tuple

import numpy as np

from transformer4sed_tpu_torch.native.build import load_wav_core

# files decoded by each path, "native" and "python" (loader threads count too)
DECODES: collections.Counter = collections.Counter()
# calls of load_wav_batch, "native" (one C call) and "python" (file by file)
BATCHES: collections.Counter = collections.Counter()
_DECODES_LOCK = threading.Lock()


def _count(path: str, n: int = 1, counter: collections.Counter = DECODES) -> None:
    with _DECODES_LOCK:
        counter[path] += n


def to_mono(wav: np.ndarray) -> np.ndarray:
    """Mean over channels. The JAX ``to_mono``'s random-channel option has
    no caller in either package and is not ported."""
    return wav.mean(axis=-1) if wav.ndim > 1 else wav


def _decode_wav(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC":
        from transformer4sed_tpu_torch.data.flac import decode_flac

        return decode_flac(path)
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, sr


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return wav
    from scipy.signal import resample_poly

    frac = Fraction(target_sr, orig_sr).limit_denominator(1000)
    return resample_poly(wav, frac.numerator, frac.denominator).astype(np.float32)


def load_audio(path: str, sr: int) -> np.ndarray:
    """Load a WAV or FLAC file as mono float32 at sample rate ``sr``."""
    wav, orig_sr = _decode_wav(path)
    wav = to_mono(wav)
    _count("python")
    return resample(wav, orig_sr, sr).astype(np.float32)


def pad_wav(wav: np.ndarray, pad_to: int, codec) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad or truncate to ``pad_to`` samples; return (wav, pad_mask).

    pad_mask: [codec.n_frames] bool, True where the frame is padding.
    """
    if len(wav) < pad_to:
        pad_from = len(wav)
        wav = np.pad(wav, (0, pad_to - len(wav)), mode="constant")
    else:
        wav = wav[:pad_to]
        pad_from = pad_to
    return wav.astype(np.float32), _pad_mask_from_len(pad_from, codec)


def _pad_mask_from_len(true_len: int, codec) -> np.ndarray:
    pad_idx = math.ceil(float(codec.time_to_frame(true_len / codec.sr)))
    return np.arange(codec.n_frames) >= pad_idx


def waveform_modification(path: str, pad_to: int, codec,
                          native: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Decode -> mono -> resample(sr) -> pad/truncate + frame pad mask.

    The native library decodes where ``native`` is set and it builds (a
    file it rejects falls through); else the Python path above."""
    lib = load_wav_core() if native else None
    if lib is not None:
        out = np.empty(pad_to, dtype=np.float32)
        true_len = ctypes.c_long(0)
        err = lib.t4s_load_wav(
            str(path).encode(), int(codec.sr), int(pad_to),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(true_len),
        )
        if err == 0:
            _count("native")
            return out, _pad_mask_from_len(int(true_len.value), codec)
    wav = load_audio(path, codec.sr)
    return pad_wav(wav, pad_to, codec)


def load_wav_batch(paths, pad_to: int, codec, n_threads: int = 8, native: bool = True):
    """Batch load: (wavs [N, pad_to] f32, pad_masks [N, F]).

    With the native library, one C call decodes and resamples the whole
    batch on a thread pool with the GIL released (ctypes), and only the
    files it rejects are redone through the Python path. Without it, each
    file goes through :func:`waveform_modification`. ``data/loader.py``'s
    batches decode through it."""
    paths = [str(p) for p in paths]
    n = len(paths)
    lib = load_wav_core() if native and n else None
    _count("native" if lib is not None else "python", counter=BATCHES)
    if lib is not None:
        out = np.empty((n, pad_to), dtype=np.float32)
        true_len = np.zeros(n, dtype=np.int64)
        err = np.zeros(n, dtype=np.int32)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        lib.t4s_load_wav_batch(
            arr, n, int(codec.sr), int(pad_to),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            true_len.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            err.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            int(n_threads),
        )
        masks = np.stack([_pad_mask_from_len(int(t), codec) for t in true_len])
        failed = np.nonzero(err)[0]
        _count("native", n - len(failed))
        for i in failed:
            out[i], masks[i] = pad_wav(load_audio(paths[i], codec.sr), pad_to, codec)
        return out, masks
    wavs, masks = [], []
    for p in paths:
        w, m = waveform_modification(p, pad_to, codec, native=False)
        wavs.append(w)
        masks.append(m)
    return (
        np.stack(wavs) if wavs else np.zeros((0, pad_to), np.float32),
        np.stack(masks) if masks else np.zeros((0, codec.n_frames), bool),
    )
