"""What the kernels' custom-op dispatch costs the served flagship: the host's
time a call of rows 1 and 2 through their ops against the direct launch,
and the served clips/s, for one tree of the port.

    python transformer4sed_tpu_torch/exps/serve_dispatch.py [--tree DIR] [--windows 5]
        [--batches 40]

imports ``transformer4sed_tpu_torch`` from ``DIR`` (default: the tree this
file is in), so that the same script times a parent's tree and its
change's, each from its own ``git archive``, on one card in turns. It
prints the card's name and power limit, then:

  * where the tree registers the ops (``t4s::flash_nhd_fwd``,
    ``t4s::xl_nhd_fwd``): the host's µs a call of each row at the served
    flagship's shapes (B=8: [8, 1190, 12*64] and [8, 1000, 12*64]), by the
    wrapper (``flash_attention_nhd``, ``flash_xl_attention_nhd`` under
    ``no_grad``), by the op itself and by the launch without the op (the
    op's CUDA implementation called directly); each as ``CALLS`` calls
    enqueued behind a GPU sleep, so that the host's clock over the
    enqueueing times the host alone (the median of ``ROUNDS`` rounds);
    a tree without the ops times the wrapper, its direct launch;
  * the served flagship's clips/s at B=8 (``config/mat-sed/finetune1.yaml``
    at full width and depth, seeded weights, bf16, host batches of
    synthetic 10-s clips in, median-filtered scores on the host out) over
    ``--windows`` windows of ``--batches`` batches after a warm-up;

and, as its last line, one JSON object with those numbers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CALLS, ROUNDS = 100, 7
SR, CLIP_SAMPLES, BATCH = 32000, 320000, 8


def host_us(fn) -> float:
    """Median host µs a call of ``fn`` over ROUNDS rounds of CALLS calls
    enqueued behind a 20-ms GPU sleep (the device never waits on the host,
    nor the host on the device)."""
    import torch

    fn()
    times = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(3.5e7))
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        times.append((time.perf_counter() - t0) * 1e6 / CALLS)
        torch.cuda.synchronize()
    return statistics.median(times)


def dispatch_costs(tree_has_ops: bool):
    """{row: {"wrapper": µs, "op": µs, "direct": µs}} at the served shapes."""
    import torch

    from transformer4sed_tpu_torch.kernels import flash_attention as fa
    from transformer4sed_tpu_torch.kernels import xl_attention as xa

    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(BATCH, 1190, 3 * 768, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv[..., :768], qkv[..., 768:1536], qkv[..., 1536:]
    xqkv = torch.randn(BATCH, 1000, 3 * 768, generator=gen, device="cuda").to(torch.bfloat16)
    xq, xk, xv = xqkv[..., :768], xqkv[..., 768:1536], xqkv[..., 1536:]
    bu, bv = (torch.randn(12, 64, generator=gen, device="cuda") for _ in range(2))
    p = torch.randn(12, 1999, 64, generator=gen, device="cuda").to(torch.bfloat16)
    calls = {
        "row 1": {"wrapper": lambda: fa.flash_attention_nhd(q, k, v, 12)},
        "row 2": {"wrapper": lambda: xa.flash_xl_attention_nhd(xq, xk, xv, bu, bv, p, 12, 0.125)},
    }
    if tree_has_ops:
        calls["row 1"].update(op=lambda: torch.ops.t4s.flash_nhd_fwd(q, k, v, 12, 0.125),
                              direct=lambda: fa._nhd_fwd_cuda(q, k, v, 12, 0.125))
        calls["row 2"].update(
            op=lambda: torch.ops.t4s.xl_nhd_fwd(xq, xk, xv, bu, bv, p, 12, 0.125, None),
            direct=lambda: xa._nhd_fwd_cuda(xq, xk, xv, bu, bv, p, 12, 0.125, None))
    with torch.no_grad():
        return {row: {how: host_us(fn) for how, fn in fns.items()} for row, fns in calls.items()}


def served_rates(tree: Path, windows: int, batches: int):
    """Clips/s of each window of ``batches`` served batches at B=8."""
    import numpy as np
    import torch

    from transformer4sed_tpu_torch.recipes import cli, common
    from transformer4sed_tpu_torch.recipes.serve import InferenceEngine
    from transformer4sed_tpu_torch.utils.config import load_yaml_with_include
    from transformer4sed_tpu_torch.utils.weights import init_weights_

    dev = torch.device("cuda")
    config = load_yaml_with_include(str(tree / "config" / "mat-sed" / "finetune1.yaml"))
    codec = common.codec_from_config(config)
    model, frontend = cli.build_model(config, dev)
    model = init_weights_(model, seed=0).to(dev)
    engine = InferenceEngine(model, frontend, codec,
                             common.median_filter_from_config(config, codec), batch_size=BATCH,
                             model_kwargs=config["PaSST_SED"]["test_kwargs"], device=dev)
    rng = np.random.RandomState(1)
    batch = {"wav": (0.1 * rng.randn(BATCH, CLIP_SAMPLES)).astype(np.float32),
             "pad_mask": np.zeros((BATCH, codec.n_frames), bool),
             "filename": [f"clip{i}.wav" for i in range(BATCH)]}
    list(engine.score_batches([batch] * 4))  # warm-up
    rates = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(len(names) for names, _, _ in engine.score_batches([batch] * batches))
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
    return rates


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    parser.add_argument("--windows", type=int, default=5)
    parser.add_argument("--batches", type=int, default=40)
    args = parser.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("serve_dispatch: no CUDA device; this script times the card", file=sys.stderr)
        return 1
    import transformer4sed_tpu_torch.kernels  # noqa: F401  registers the ops where the tree has them
    from transformer4sed_tpu_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build()
    has_ops = hasattr(torch.ops.t4s, "flash_nhd_fwd")
    costs = dispatch_costs(has_ops)
    for row, hows in costs.items():
        print(f"{tree.name} {row}: host µs a call " + ", ".join(
            f"{how} {us:.2f}" for how, us in hows.items()), flush=True)
    rates = served_rates(tree, args.windows, args.batches)
    print(f"{tree.name} served flagship B={BATCH} clips/s over {len(rates)} windows of "
          f"{args.batches} batches: " + ", ".join(f"{r:.2f}" for r in rates)
          + f"; median {statistics.median(rates):.2f} ({card})", flush=True)
    print(json.dumps({"tree": str(tree), "card": card, "ops": has_ops, "host_us": costs,
                      "clips_per_s": rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
