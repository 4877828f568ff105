#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases, in order; any failure exits non-zero:
  1. print the card (nvidia-smi name, power limit); build every CUDA kernel
     of the serving path from ``transformer4sed_tpu_torch/csrc`` (one nvcc
     per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes and on small ragged cases, and show that the same
     check rejects planted faults (a dropped key tile, a dropped bias, a
     rel-shift off by one, a band one key wider);
  3. serve three batches of synthetic 10-s clips (the last one ragged, one
     clip short) through ``InferenceEngine`` with the full-width MAT-SED
     flagship (PaSST 768/12/12 tapped at layer 10, 3-layer Transformer-XL
     at T=1000, AT adapter, 10 DESED classes), seeded random weights, bf16
     compute; check shapes, finiteness, events and that the kernels ran
     12 and 3 times per batch;
  4. the same weights on 2 clips on the CPU in f32 (plain versions) and on
     the card (kernels): strong, weak and at_out must agree to the JAX
     package's own bf16-vs-f32 bound;
  5. time each kernel, its plain version and the one-call library
     equivalent (SDPA for the flash kernel) with CUDA events, beside the
     least time the card could take; time served clips/s at B=8 over
     three windows of 160 batches each;
  6. profile two served batches (torch.profiler): device time by kernel
     and the device's busy share of the unprofiled batch time.

The second-to-last line is a JSON ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``. ``--phases`` runs a subset
(and then prints no final record).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "serve", "parity", "timing", "profile")

# H100 SXM published peaks (dense): bf16 tensor cores and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# Kernel vs its plain version in f32 on the same bf16 inputs. An output is
# sum_j a_j v_j / sum_j a_j; the kernel rounds each weight a_j before the
# P.V product, and the output, to bf16 (unit roundoff u = 2^-8); the rest
# is f32 on exact bf16 products (the XL kernel's bf16 q+u and q+v are part
# of the function, and the plain version rounds them too). So, element by
# element, |out - ref| <= u * (|ref| + A|v|), where A|v| is the plain
# version applied to |v| (it is linear in v). f32 score sums and exp2 add
# under 1 % of that: KERNEL_SLACK.
BF16_U = 2.0 ** -8
KERNEL_SLACK = 1.05
# Those roundings are unbiased, so the mean error stays near the floor set
# by rounding the exact result to bf16 once, mean|bf16(ref) - ref|; a term
# dropped or shifted lifts it far above.
KERNEL_MEAN_FACTOR = 4.0
# card bf16 vs CPU f32 on probabilities: the JAX package's own bound for
# the same-params eval forward in the two compute dtypes
# (tests/test_precision.py, docs/PRECISION.md)
DTYPE_MAX_ABS = 5e-2
MEDIAN_WINDOW = [5, 20, 5, 5, 5, 20, 20, 20, 5, 20]  # config/mat-sed/finetune1.yaml
FLAGSHIP = dict(
    class_num=10, embed_dim=768, decoder_dim=768, backbone_depth=12, backbone_num_heads=12,
    passt_feature_layer=10, decoder="transformerXL", decoder_layer_num=3,
    decoder_pos_emd_len=1000, decoder_num_heads=12, at_adapter=True, at_adapter_heads=12,
)
SR, CLIP_SAMPLES = 32000, 320000


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(ok, what: str) -> None:
    """A failed check ends the run (unlike ``assert``, also under -O)."""
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def held(what, out, ref, ref_abs_v):
    """Log the kernel's error against its bound (KERNEL_SLACK,
    KERNEL_MEAN_FACTOR); return (within both limits, max abs error)."""
    import torch

    err = (out.float() - ref).abs()
    tol = KERNEL_SLACK * BF16_U * (ref.abs() + ref_abs_v)
    worst = float((err / tol).max())
    mean = float(err.mean())
    floor = float((ref.to(torch.bfloat16).float() - ref).abs().mean())
    ok = worst <= 1.0 and mean <= KERNEL_MEAN_FACTOR * floor
    log(f"{what}: max_abs_err {float(err.max()):.3e}, max err/bound {worst:.3f} (limit 1); "
        f"mean {mean:.3e} = {mean / floor:.2f}x the bf16 rounding floor {floor:.3e} "
        f"(limit {KERNEL_MEAN_FACTOR}): {'within' if ok else 'OUTSIDE'}")
    return ok, float(err.max())


# -- phase 2: kernels against their plain versions ------------------------------

def flash_inputs(b, n, c, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, n, 3 * c, generator=gen, device="cuda").to(torch.bfloat16)
    return qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]


def xl_inputs(b, t, c, h, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = flash_inputs(b, t, c, seed)
    bu = torch.randn(h, c // h, generator=gen, device="cuda") * 0.1
    bv = torch.randn(h, c // h, generator=gen, device="cuda") * 0.1
    # P as the model makes it: a [2T-1, H*d] projection viewed as [H, 2T-1, d]
    p = torch.randn(2 * t - 1, c, generator=gen, device="cuda").to(torch.bfloat16)
    return q, k, v, bu, bv, p.reshape(2 * t - 1, h, c // h).transpose(0, 1)


def check_kernels(results):
    import torch

    from transformer4sed_tpu_torch.kernels.flash_attention import (
        flash_attention_nhd,
        flash_attention_nhd_reference,
    )
    from transformer4sed_tpu_torch.kernels.xl_attention import (
        flash_xl_attention_nhd,
        xl_attention_nhd_reference,
    )

    rejected = []  # planted faults: each must fall outside the bound

    cases = [  # (b, n, c, h, main path?)
        (8, 1190, 768, 12, True),
        (2, 77, 768, 12, False),
        (1, 130, 256, 4, False),
    ]
    for b, n, c, h, main in cases:
        q, k, v = flash_inputs(b, n, c, seed=n)
        ref = flash_attention_nhd_reference(q.float(), k.float(), v.float(), h)
        ref_abs_v = flash_attention_nhd_reference(q.float(), k.float(), v.float().abs(), h)
        out = flash_attention_nhd(q, k, v, h)
        ok, mx = held(f"kernel flash_attention_nhd B={b} N={n} C={c} H={h}", out, ref, ref_abs_v)
        check(ok, "flash_attention_nhd disagrees with its plain version")
        if main:
            results["flash_attention_nhd"]["max_abs_err"] = mx
            m = n // 64 * 64  # a kernel that skipped the ragged last key tile
            out = flash_attention_nhd(q[:, :m], k[:, :m], v[:, :m], h)
            rejected.append(held(f"planted fault: last {n - m} keys dropped", out,
                                 ref[:, :m], ref_abs_v[:, :m])[0])

    wide_band = (1, 2, 5, 16, 31, 64, 100, 128, 255, 500, 999, 2000)
    cases = [  # (b, t, c, h, band, main path?)
        (8, 1000, 768, 12, None, True),
        (8, 1000, 768, 12, wide_band, False),
        (2, 77, 768, 12, None, False),
        (1, 130, 256, 4, (3, 20, 1, 260), False),
    ]
    for b, t, c, h, band, main in cases:
        q, k, v, bu, bv, p = xl_inputs(b, t, c, h, seed=t)
        scale = (c // h) ** -0.5

        def ref_of(vv):  # q stays bf16: q+u and q+v round as in the kernel
            return xl_attention_nhd_reference(q, k.float(), vv, bu, bv, p.float(), h, scale,
                                              band)

        ref, ref_abs_v = ref_of(v.float()), ref_of(v.float().abs())
        out = flash_xl_attention_nhd(q, k, v, bu, bv, p, h, scale, band)
        ok, mx = held(f"kernel flash_xl_attention_nhd B={b} T={t} C={c} H={h} band={band}",
                      out, ref, ref_abs_v)
        check(ok, "flash_xl_attention_nhd disagrees with its plain version")
        if main:
            results["flash_xl_attention_nhd"]["max_abs_err"] = mx
            out = flash_xl_attention_nhd(q, k, v, torch.zeros_like(bu), bv, p, h, scale)
            rejected.append(held("planted fault: pos_bias_u dropped", out, ref, ref_abs_v)[0])
            out = flash_xl_attention_nhd(q, k, v, bu, bv, p.roll(1, dims=1), h, scale)
            rejected.append(held("planted fault: rel-shift off by one", out, ref, ref_abs_v)[0])
        if band == wide_band:
            wider = tuple(w + 2 for w in band)
            out = flash_xl_attention_nhd(q, k, v, bu, bv, p, h, scale, wider)
            rejected.append(held("planted fault: band one key wider each side", out, ref,
                                 ref_abs_v)[0])
    check(not any(rejected), "the kernel check let a planted fault through")
    log(f"all {len(rejected)} planted faults fall outside the bound")


# -- phases 3 and 4: the served flagship ------------------------------------------

def desed_labels():
    with open(ROOT / "meta" / "desed" / "labeldict_DESED.json") as f:
        table = json.load(f)
    return [name for name, _ in sorted(table.items(), key=lambda kv: kv[1])]


def synthetic_clips(n, seed):
    """n 10-s clips of noise plus tone bursts; clip 5 is 6.5 s long."""
    import numpy as np

    rng = np.random.RandomState(seed)
    t = np.arange(CLIP_SAMPLES) / SR
    clips = []
    for i in range(n):
        wav = 0.05 * rng.randn(CLIP_SAMPLES)
        for _ in range(3):
            on = rng.uniform(0, 8)
            dur = rng.uniform(0.3, 2.0)
            f0 = rng.uniform(200, 4000)
            wav += np.sin(2 * np.pi * f0 * t) * ((t >= on) & (t < on + dur))
        if i == 5:
            wav = wav[:208000]
        clips.append(wav.astype(np.float32))
    return clips


def make_batches(clips, codec, batch_size):
    import numpy as np

    from transformer4sed_tpu_torch.data.audio_io import pad_wav

    padded = [pad_wav(w, CLIP_SAMPLES, codec) for w in clips]
    return [
        {"wav": np.stack([p[0] for p in padded[i:i + batch_size]]),
         "pad_mask": np.stack([p[1] for p in padded[i:i + batch_size]]),
         "filename": [f"clip{j:03d}.wav" for j in range(i, min(i + batch_size, len(clips)))]}
        for i in range(0, len(clips), batch_size)
    ]


def build_engine(device, dtype, state_dict=None):
    import torch

    from transformer4sed_tpu_torch.core.codec import LabelCodec
    from transformer4sed_tpu_torch.frontend.mel import PasstFrontend
    from transformer4sed_tpu_torch.models.passt_sed import PaSST_SED
    from transformer4sed_tpu_torch.recipes.serve import InferenceEngine
    from transformer4sed_tpu_torch.utils.weights import init_weights_

    codec = LabelCodec(desed_labels(), audio_len=10.0, frame_len=1024, frame_hop=320,
                       net_pooling=1, sr=SR)
    model = PaSST_SED(**FLAGSHIP, dtype=dtype, device="cpu")
    if state_dict is None:
        init_weights_(model, seed=0)
    else:
        model.load_state_dict(state_dict)
    model.to(device)
    widths = [int(w / 156 * codec.n_frames) for w in MEDIAN_WINDOW]
    engine = InferenceEngine(model.eval(), PasstFrontend(device=device), codec, widths,
                             batch_size=8, threshold=0.5, model_kwargs={"temp_w": 0.5},
                             device=device)
    return engine


def serve(engine, results):
    import numpy as np

    from transformer4sed_tpu_torch.kernels.flash_attention import flash_attention_nhd
    from transformer4sed_tpu_torch.kernels.xl_attention import flash_xl_attention_nhd

    clips = synthetic_clips(20, seed=1)
    batches = make_batches(clips, engine.codec, 8)
    check([len(b["filename"]) for b in batches] == [8, 8, 4], "batches of 8, 8 and 4 clips")
    flash_attention_nhd.launches = 0
    flash_xl_attention_nhd.launches = 0
    served = list(engine.score_batches(batches))
    launches = (flash_attention_nhd.launches, flash_xl_attention_nhd.launches)
    log(f"served {sum(len(n) for n, _, _ in served)} clips in {len(served)} batches; "
        f"launches flash_attention_nhd {launches[0]}, flash_xl_attention_nhd {launches[1]}")
    check(launches == (12 * len(batches), 3 * len(batches)),
          f"kernel launches {launches} on the served path, expected 12 and 3 per batch")
    results["flash_attention_nhd"]["launches"] = launches[0]
    results["flash_xl_attention_nhd"]["launches"] = launches[1]

    t_frames = engine.codec.n_frames
    n_events = 0
    for (names, scores, weak), batch in zip(served, batches):
        check(names == batch["filename"], "results come back in order")
        check(scores.shape == (len(names), t_frames, 10) and weak.shape == (len(names), 10),
              f"output shapes {scores.shape}, {weak.shape}")
        check(np.all(np.isfinite(scores)) and np.all(np.isfinite(weak)), "finite outputs")
        check(np.all((scores >= 0) & (scores <= 1)) and np.all((weak > 0) & (weak <= 1)),
              "probabilities in [0, 1]")
        for i in range(len(names)):
            for label, onset, offset in engine.decode(scores[i]):
                check(label in engine.codec.labels and 0.0 <= onset < offset <= 10.0,
                      f"event {label, onset, offset}")
                n_events += 1
    short = served[0][1][5]  # 6.5-s clip: frames from 650 are padding
    check(np.all(short[650 + max(engine.median_filter) // 2:] == 0.0), "padded frames are zero")
    log(f"decoded {n_events} events; scores finite in [0, 1]; padded frames zero")
    return batches


def parity(card_engine, batches):
    import numpy as np
    import torch

    state = {k: v.detach().cpu() for k, v in card_engine.model.state_dict().items()}
    cpu_engine = build_engine("cpu", torch.float32, state_dict=state)
    wav = torch.from_numpy(batches[0]["wav"][4:6].copy())  # clip 5 is the short one
    pm = torch.from_numpy(batches[0]["pad_mask"][4:6].copy())
    outs = {}
    for name, engine in (("cpu_f32", cpu_engine), ("card_bf16", card_engine)):
        with torch.no_grad():
            mel = engine.frontend.normalize(engine.frontend(wav.to(engine.device)))
            out = engine.model(mel, pad_mask=pm.to(engine.device), temp_w=0.5)
        outs[name] = {k: getattr(out, k).float().cpu().numpy() for k in ("strong", "weak", "at_out")}
    worst = 0.0
    for key in ("strong", "weak", "at_out"):
        diff = float(np.abs(outs["cpu_f32"][key] - outs["card_bf16"][key]).max())
        worst = max(worst, diff)
        log(f"card bf16 vs CPU f32 {key}: max_abs_diff {diff:.4e} (tol {DTYPE_MAX_ABS})")
    check(worst <= DTYPE_MAX_ABS, "the card's path disagrees with the CPU f32 path")


# -- phase 5: timing ------------------------------------------------------------

def time_kernels(results):
    import torch
    import torch.nn.functional as F

    from transformer4sed_tpu_torch.kernels.flash_attention import (
        flash_attention_nhd,
        flash_attention_nhd_reference,
    )
    from transformer4sed_tpu_torch.kernels.xl_attention import (
        flash_xl_attention_nhd,
        xl_attention_nhd_reference,
    )

    b, n, c, h = 8, 1190, 768, 12
    d = c // h
    q, k, v = flash_inputs(b, n, c, seed=0)
    r = results["flash_attention_nhd"]
    r["ms"] = cuda_ms(lambda: flash_attention_nhd(q, k, v, h))
    r["plain_ms"] = cuda_ms(lambda: flash_attention_nhd_reference(q, k, v, h), iters=5)
    heads = lambda x: x.reshape(b, n, h, d).transpose(1, 2)  # noqa: E731
    r["library_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)))
    flops = 4.0 * b * h * n * n * d
    nbytes = 4.0 * b * n * c * 2
    bound(r, flops, nbytes)

    t = 1000
    q, k, v, bu, bv, p = xl_inputs(b, t, c, h, seed=0)
    r = results["flash_xl_attention_nhd"]
    r["ms"] = cuda_ms(lambda: flash_xl_attention_nhd(q, k, v, bu, bv, p, h, d ** -0.5))
    r["plain_ms"] = cuda_ms(
        lambda: xl_attention_nhd_reference(q, k, v, bu, bv, p, h, d ** -0.5), iters=5)
    r["library_ms"] = None  # no one PyTorch call computes rel-position attention
    flops = 6.0 * b * h * t * t * d  # content QK^T, (q+v)P^T at the T^2 needed offsets, PV
    nbytes = 4.0 * b * t * c * 2 + h * (2 * t - 1) * d * 2 + 2 * h * d * 4
    bound(r, flops, nbytes)
    for name, r in results.items():
        log(f"time {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms), "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({r['flops'] / 1e9:.1f} GFLOP, {r['bytes'] / 1e6:.1f} MB)")


def bound(r, flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    r["bound_ms"] = max(t_ops, t_bytes)
    r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    r["flops"], r["bytes"] = flops, nbytes


def time_serving(engine, batches, windows=3, per_window=160):
    """Served clips/s over ``windows`` back-to-back windows of ``per_window``
    batches of 8 (the full host batches replayed, a few seconds each);
    log each window's rate and return the median window's ms per batch."""
    import torch

    full = [b for b in batches if len(b["filename"]) == engine.batch_size]
    stream = full * (per_window // len(full))
    list(engine.score_batches(full))  # warm-up
    rates = []
    for w in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(len(names) for names, _, _ in engine.score_batches(stream))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append(n / dt)
        log(f"served window {w}: {n} clips at B={engine.batch_size} in {dt:.3f} s: "
            f"{n / dt:.2f} clips/s (host batches to decoded-ready scores, frontend and "
            "median filter included)")
    mid = sorted(rates)[len(rates) // 2]
    log(f"served clips/s over {windows} windows: median {mid:.2f}, min {min(rates):.2f}, "
        f"max {max(rates):.2f}, spread {(max(rates) - min(rates)) / mid:.1%} of the median")
    return engine.batch_size / mid * 1e3


def profile_serving(engine, batches, batch_ms, top=15):
    """Device time by kernel over two served batches of 8."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    full = [b for b in batches if len(b["filename"]) == engine.batch_size]
    list(engine.score_batches(full))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        list(engine.score_batches(full))
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    check(kernels, "the profiler recorded no CUDA kernels")
    per_batch = lambda e: e.self_device_time_total / 1e3 / len(full)  # noqa: E731
    device_ms = sum(per_batch(e) for e in kernels)
    log(f"profile: {device_ms:.3f} ms of device time per batch of {engine.batch_size} against "
        f"{batch_ms:.3f} ms per batch unprofiled: device busy {device_ms / batch_ms:.1%}")
    for e in sorted(kernels, key=per_batch, reverse=True)[:top]:
        log(f"  {per_batch(e):8.3f} ms {per_batch(e) / device_ms:6.1%} x{e.count // len(full):4d}  "
            f"{e.key[:90]}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma list of {PHASES} (default: all)")
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        parser.error(f"unknown phases {sorted(phases - set(PHASES))}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from transformer4sed_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    paths = _build.build(verbose=True)
    log(f"built {len(paths)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    results = {
        "flash_attention_nhd": {
            "name": "flash_attention_nhd", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/flash_attention.cu",
            "replaces": "transformer4sed_tpu/kernels/flash_attention.py:507",
        },
        "flash_xl_attention_nhd": {
            "name": "flash_xl_attention_nhd", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/xl_attention.cu",
            "replaces": "transformer4sed_tpu/kernels/xl_attention.py:648",
        },
    }
    if "kernels" in phases:
        check_kernels(results)
    engine = batches = None
    if phases & {"serve", "parity", "timing", "profile"}:
        t0 = time.perf_counter()
        engine = build_engine("cuda", torch.bfloat16)
        log(f"built the flagship in {time.perf_counter() - t0:.1f} s")
        batches = serve(engine, results)
    if "parity" in phases:
        t0 = time.perf_counter()
        parity(engine, batches)
        log(f"parity phase {time.perf_counter() - t0:.1f} s")
    if "timing" in phases:
        time_kernels(results)
        batch_ms = time_serving(engine, batches)
        if "profile" in phases:
            profile_serving(engine, batches, batch_ms)
    if phases != set(PHASES):
        return 0

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    log(card)
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results.values()]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
