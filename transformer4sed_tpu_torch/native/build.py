"""Build and load the port's C++ host libraries (port of the JAX package's
``native/build.py``).

``psds_core.cpp`` (the PSDS threshold sweep) and ``wav_core.cpp`` (WAV and
FLAC decode, mono downmix, windowed-sinc resampling, batch thread pool) are
the port's own copies beside this file. Each is compiled with ``g++`` at
first use into ``_build/`` beside the package (listed in ``.gitignore``);
the library's file name carries a hash of its source, so an edited source
is rebuilt. A loader returns ``None`` where no compiler or library is at
hand, and its callers then take their NumPy or Python path: the native
path is an accelerator, never a hard dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}


def _build(name: str) -> Optional[Path]:
    src = SRC_DIR / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    so_path = BUILD_DIR / f"lib{name}-{digest}.so"
    if so_path.exists():
        return so_path
    tmp = so_path.with_name(f"{so_path.stem}.{os.getpid()}.tmp.so")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, so_path)
        return so_path
    except (OSError, subprocess.CalledProcessError):
        return None


def _declare_psds(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.psds_class_sweep.restype = None
    lib.psds_class_sweep.argtypes = [
        ctypes.POINTER(ctypes.c_float), i64p,      # scores, score_off
        dp, i64p,                                  # stamps, stamp_off
        ctypes.c_int64,                            # n_clips
        dp, i64p,                                  # gt, gt_off
        ctypes.c_int64, ctypes.c_int64,            # n_classes, class_idx
        dp, ctypes.c_int64,                        # thresholds
        ctypes.c_double, ctypes.c_double, ctypes.c_double,  # dtc/gtc/cttc
        ctypes.c_int,                              # compute_ct
        i64p, i64p, i64p,                          # tp, fp, ct
    ]
    lib.psds_class_exact.restype = ctypes.c_int64
    lib.psds_class_exact.argtypes = [
        ctypes.POINTER(ctypes.c_float), i64p,      # scores, score_off
        dp, i64p,                                  # stamps, stamp_off
        ctypes.c_int64,                            # n_clips
        dp, i64p,                                  # gt, gt_off
        ctypes.c_int64, ctypes.c_int64,            # n_classes, class_idx
        dp, ctypes.c_int,                          # gt_dur_hours, compute_ct
        ctypes.c_double, ctypes.c_double, ctypes.c_double,  # dtc/gtc/cttc
        dp, i64p, i64p, dp,                        # thr/tp/fp/ctr out
    ]


def _declare_wav(lib: ctypes.CDLL) -> None:
    lib.t4s_load_wav.restype = ctypes.c_int
    lib.t4s_load_wav.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_long),
    ]
    lib.t4s_load_wav_batch.restype = None
    lib.t4s_load_wav_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
        ctypes.c_int, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]


def _load(name: str, declare) -> Optional[ctypes.CDLL]:
    with _LOCK:
        if name not in _LIBS:
            lib = None
            so = _build(name)
            if so is not None:
                try:
                    lib = ctypes.CDLL(str(so))
                    declare(lib)
                except OSError:
                    lib = None
            _LIBS[name] = lib
        return _LIBS[name]


def load_psds_core() -> Optional[ctypes.CDLL]:
    """The PSDS sweep library, or None when it cannot be built."""
    return _load("psds_core", _declare_psds)


def load_wav_core() -> Optional[ctypes.CDLL]:
    """The native waveform loader, or None when it cannot be built."""
    return _load("wav_core", _declare_wav)
