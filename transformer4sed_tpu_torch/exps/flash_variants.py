"""Timing and numerics of the flash forward's tail-masking variants at the
backbone's shape (port of ``exps/flash_variants.py``).

Variant A (tail-only masking): the -inf select of the ragged key tail runs
in the last key tile only; the tiles before it are whole. Variant B: A with
exp2 and log2(e) folded into the scale. :func:`flash_a` runs either as the
CUDA kernel of ``csrc/flash_variants.cu`` (row 16 of the kernel table: two
modes of the wgmma forward body ``csrc/flash_fwd.cuh``, B the very kernel
row 3 runs) on a CUDA tensor and as its plain version on a CPU one;
:func:`main` times "current" (row 3,
``kernels.flash_attention.flash_attention``), "A tail-mask" and "B
tail+exp2" on the card and prints each one's time and its largest error
against the plain version.

Run: python -m transformer4sed_tpu_torch.exps.flash_variants [B] [T]
(default B=64, T=1190: 12 heads of 64, bf16).
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence

import torch

from transformer4sed_tpu_torch.kernels import _build
from transformer4sed_tpu_torch.kernels.flash_attention import (
    _check_hm,
    flash_attention,
    flash_attention_reference,
    hm_empty,
    hm_strides,
)


def flash_a_reference(q, k, v, sm_scale: float, use_exp2: bool = False):
    """Plain version: softmax attention on [B, H, T, d], scores and softmax in
    float32 (exp and exp2 of the folded scale are one function)."""
    return flash_attention_reference(q, k, v, sm_scale)


def flash_a(q, k, v, sm_scale: float, use_exp2: bool = False):
    """softmax(scale * Q K^T) V on head-major q/k/v [B, H, T, d] (any batch,
    head and row strides) -> [B, H, T, d]: variant A (natural exp) or B
    (``use_exp2``) of the kernel for CUDA tensors (bf16, head dim 32 or 64),
    the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_a_reference(q, k, v, sm_scale, use_exp2)
    out = _variant_kernel(q, k, v, sm_scale, use_exp2)
    flash_a.launches += 1
    return out


def _variant_kernel(q, k, v, sm_scale: float, use_exp2: bool, skip_tail_mask: int = 0):
    """Launch variant A's or B's kernel on checked operands; ``skip_tail_mask``
    1 leaves the last key tile unmasked: a planted fault's switch, 0 on every
    real path."""
    what = "flash_a"
    _check_hm(what, q, k, v)
    b, h, t, d = q.shape
    out = hm_empty(q.shape, q.dtype, q.device)
    symbol = "t4s_flash_variant_b_fwd" if use_exp2 else "t4s_flash_variant_a_fwd"
    with torch.cuda.device(q.device):
        status = _build.function("flash_variants", symbol, 4, 12, n_ints=5)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, h, d, skip_tail_mask,
            *hm_strides(q, k, v, out), float(sm_scale), torch.cuda.current_stream().cuda_stream)
    _build.check(status, what)
    return out


flash_a.launches = 0


def timeit(fn, n: int = 10, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    """Time the three variants at [B, 12, T, 64] bf16 (inputs from a seeded
    generator on the card) and check each on the first two clips against
    the plain version in float32; print a line each and return
    ``{name: {"ms", "max_err"}}``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: no CUDA device; the variants run only on the card")
    b = int(argv[0]) if len(argv) > 0 else 64
    t = int(argv[1]) if len(argv) > 1 else 1190
    h, d = 12, 64
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, h, t, d, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    ref = flash_attention_reference(*(x[:2].float() for x in (q, k, v)), scale)
    results = {}
    for name, fn in (("current", lambda q, k, v: flash_attention(q, k, v, scale)),
                     ("A tail-mask", lambda q, k, v: flash_a(q, k, v, scale, use_exp2=False)),
                     ("B tail+exp2", lambda q, k, v: flash_a(q, k, v, scale, use_exp2=True))):
        err = float((fn(q[:2], k[:2], v[:2]).float() - ref).abs().max())
        ms = timeit(lambda: fn(q, k, v))
        results[name] = {"ms": ms, "max_err": err}
        print(f"{name:12s}: {ms:7.4f} ms   max|err| vs plain = {err:.2e}", flush=True)
    return results


if __name__ == "__main__":
    main()
