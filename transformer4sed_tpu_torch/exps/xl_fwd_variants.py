"""Design variants of the XL forward body (``csrc/xl_fwd.cuh``) at PMAM's
decoder shape, head dim 32: rows 9 (B=8, ``flash_xl_attention``) and 10
(B=18, ``flash_xl_attention_lse``), timed in turns on the card.

Each variant is a copy of ``csrc/`` with one text edit, built into its own
directory beside the package's build:

  * "base": the sources as they are;
  * "noturn": the two consumer warpgroups no longer take turns at the
    tensor cores (``my_turn`` and ``your_turn`` do nothing);
  * "stages4": a ring of four K/V stages (and five strip tiles) in place of
    three (the head-major library then builds d = 32 only: at d = 64 the
    ring does not fit in shared memory).

An edit whose anchor is not found in the source fails the run, so a
variant never times the base by mistake. Every variant is first held to
the plain version (the element-wise bf16 bound of ``chip_smoke.py``), then
timed by CUDA events over 50 back-to-back calls, in the order base, noturn,
stages4, stages4, noturn, base, twice.

Run: python -m transformer4sed_tpu_torch.exps.xl_fwd_variants
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import torch

from transformer4sed_tpu_torch.kernels import _build
from transformer4sed_tpu_torch.kernels import xl_attention as xa

_HM64 = """  if (head_dim == 64)
    return launch_xl_fwd<64, XF_GIVEN>(batch, n, heads, stream, qur, qvr, kr, vr, nullptr,
                                       nullptr, pr, bw, orr, lp, fault, sm_scale);
"""
VARIANTS = {
    "base": (),
    "noturn": (
        ("xl_fwd.cuh", "auto my_turn = [&]() { bar_sync(1 + wg, XF_CONSUMERS); };",
         "auto my_turn = [&]() {};"),
        ("xl_fwd.cuh", "auto your_turn = [&]() { bar_arrive(2 - wg, XF_CONSUMERS); };",
         "auto your_turn = [&]() {};"),
    ),
    "stages4": (
        ("xl_fwd.cuh", "constexpr int XF_STAGES = 3;", "constexpr int XF_STAGES = 4;"),
        ("xl_attention_hm.cu", _HM64, ""),
    ),
}
HEADS, HEAD_DIM, T = 12, 32, 1000


def _use(root: Path) -> None:
    _build.CSRC_DIR, _build.BUILD_DIR = root / "csrc", root / "_build"
    _build._LIBS.clear()
    _build._FNS.clear()


def build_variants(out: Path) -> None:
    """Copy ``csrc/`` once per variant under ``out``, apply its edits and
    build its head-major library, all nvcc runs at once."""
    src = _build.PACKAGE_DIR / "csrc"
    procs = {}
    for name, edits in VARIANTS.items():
        root = out / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(src, root / "csrc")
        for fname, old, new in edits:
            path = root / "csrc" / fname
            text = path.read_text()
            if old not in text:
                raise RuntimeError(f"variant {name}: {fname} lacks {old!r}")
            path.write_text(text.replace(old, new))
        _use(root)
        _build.BUILD_DIR.mkdir(parents=True)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(_build._target("xl_attention_hm")),
             str(_build.CSRC_DIR / "xl_attention_hm.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        out_text, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out_text}{err}")


def inputs(b: int, seed: int):
    """(qu, qv, k, v, p) as the decoder hands them over: strided head-major
    views of one bf16 [B, T, 3*H*d] projection, qu and qv the q slice plus
    f32 biases rounded to bf16, p a [2T-1, H*d] projection viewed as
    [H, 2T-1, d]."""
    h, d, t = HEADS, HEAD_DIM, T
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, t, 3 * h * d, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].reshape(b, t, h, d).transpose(1, 2)
               for i in range(3))
    bu, bv = (torch.randn(h, d, generator=gen, device="cuda")[:, None] * 0.1 for _ in range(2))
    p = torch.randn(2 * t - 1, h * d, generator=gen, device="cuda").to(torch.bfloat16)
    return ((q.float() + bu).to(torch.bfloat16), (q.float() + bv).to(torch.bfloat16), k, v,
            p.reshape(2 * t - 1, h, d).transpose(0, 1))


def ms_a_call(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("xl_fwd_variants: no CUDA device; this experiment runs only on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    out = _build.BUILD_DIR / "xl_fwd_variants"
    build_variants(out)
    scale = HEAD_DIM ** -0.5
    cases = {9: (xa.flash_xl_attention, inputs(8, seed=0)),
             10: (xa.flash_xl_attention_lse, inputs(18, seed=1))}
    for row, (fn, (qu, qv, k, v, p)) in cases.items():
        ref = xa.flash_xl_attention_reference(qu, qv, k.float(), v.float(), p.float(), scale)
        tol = 1.05 * 2.0 ** -8 * (ref.abs() + xa.flash_xl_attention_reference(
            qu, qv, k.float(), v.float().abs(), p.float(), scale))
        for name in VARIANTS:
            _use(out / name)
            got = fn(qu, qv, k, v, p, scale)
            got = got[0] if isinstance(got, tuple) else got
            worst = float(((got.float() - ref).abs() / tol).max())
            print(f"row {row} variant {name}: max err/bound {worst:.3f} (limit 1)", flush=True)
            if worst > 1.0:
                raise SystemExit(f"variant {name} disagrees with the plain version")
        del ref, tol
    order = list(VARIANTS) + list(reversed(VARIANTS))
    for turn in range(2):
        for name in order:
            _use(out / name)
            times = {row: ms_a_call(lambda: fn(*args, scale)) for row, (fn, args) in cases.items()}
            print(f"turn {turn} {name}: row 9 {times[9]:.4f} ms, row 10 {times[10]:.4f} ms "
                  f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
