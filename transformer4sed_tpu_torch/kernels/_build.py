"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for ``sm_90a`` at first use into ``_build/`` beside
the package (listed in ``.gitignore``). The library's file name carries
a hash of its sources and flags, so an edited kernel is rebuilt and a
built one is reused. :func:`build` starts one nvcc per source, all at
once, and waits for every one of them.

:func:`define_op` registers a kernel's no-grad forward as a
``torch.library`` custom op ``t4s::<name>``: the ctypes launch for CUDA
tensors, the plain version for CPU tensors and a fake implementation that
gives the output's shape, dtype and strides, so that ``torch.export``
traces the served forward through the op and the exported program calls
the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("flash_attention", "flash_attention_bwd", "flash_attention_hm",
           "flash_attention_hm_bwd", "xl_attention", "xl_attention_bwd", "xl_attention_hm",
           "window_attention", "window_attention_bwd", "flash_attention_bias", "flash_variants")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, object] = {}  # (source, symbol) -> bound launcher
BUILD_LOG: Dict[str, str] = {}  # name -> nvcc's stderr (register/spill report with verbose)


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a host with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES, verbose: bool = False) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, in parallel.
    ``verbose`` adds ``-Xptxas -v`` and keeps nvcc's report in BUILD_LOG."""
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in names}
    procs = {}
    for name, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *flags, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        out, err = proc.communicate()
        BUILD_LOG[name] = out + err
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}{err}")
            continue
        os.replace(tmp, targets[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first use)."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, n_ptrs: int, n_strides: int, n_ints: int = 4,
             n_floats: int = 1):
    """ctypes binding of ``symbol`` in ``csrc/<name>.cu``, the attention
    launchers' C interface: ``n_ptrs`` pointers, ``n_ints`` ints (batch,
    length, heads, head dim; the window kernels add the windows per image
    and a planted fault, the flash backwards a planted fault's key tile, the
    flash forwards a planted fault's switch, the XL kernels a planted
    fault), ``n_strides`` 64-bit strides, ``n_floats`` floats (the softmax
    scale) and the stream; returns cudaError_t. Bound once per process."""
    key = (name, symbol)
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_longlong] * n_strides + [ctypes.c_float] * n_floats
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


# the kernels' custom ops, t4s::<name>: defined and implemented on this
# library directly (Library.define / Library.impl), which costs the host less a
# call than torch.library.custom_op's wrappers (PERF.md, §6)
_OPS = torch.library.Library("t4s", "DEF")


def define_op(name: str, schema: str, cpu: Callable, cuda: Callable, fake: Callable):
    """The custom op ``t4s::<name>`` with ``schema`` (its arguments and
    result, e.g. ``"(Tensor q, int h) -> Tensor"``): ``cpu`` for CPU tensors,
    ``cuda`` (the kernel's launch and its launch count) for CUDA tensors,
    ``fake`` for tracing. No other device has an implementation, so such a
    call raises. Returns the op's ``OpOverload``."""
    _OPS.define(name + schema)
    _OPS.impl(name, cpu, "CPU")
    _OPS.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"t4s::{name}", fake, lib=_OPS)
    return getattr(torch.ops.t4s, name).default
