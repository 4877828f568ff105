"""Where the card's bf16 DASM forward parts from the CPU's f32 one.

    python transformer4sed_tpu_torch/exps/dasm_parity_probe.py

builds ``chip_smoke.py``'s served DASM (``config/dasm/closed_set.yaml``,
seeded weights, the seeded [447, 512] text bank) three times with the same
weights: on the card (bf16, the kernels), on the CPU in f32 and, as a second
witness, on the CPU in bf16 (the kernels' plain versions in the card's
dtype). It runs phase ``dasm_parity``'s two clips through each
(``chip_smoke.dasm_capture``) and prints, for card against CPU f32, CPU
bf16 against CPU f32 and card against CPU bf16, the relative L2 errors of
z = logits / temp_w, the AT head's 448-way logits, the prior, strong and
weak, the spread of |z|, the largest gap of z and where the sigmoid factor
sigmoid(z) parts most (``chip_smoke.dasm_gaps``); then each side's tail
against f64 of its own tensors and the tail errors of the three planted
faults of check (a). If the card's gaps are of the CPU bf16 path's size,
bf16 arithmetic, not the kernels or the port, makes them. Needs a card,
like ``chip_smoke.py``.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("dasm_parity_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(cs.card_line())
    card_engine = cs.build_dasm_engine("cuda")
    batches = cs.make_batches(cs.synthetic_clips(20, seed=1), card_engine.codec, cs.DASM_BATCH)
    wav, pm = cs.dasm_parity_clips(batches)
    state = {k: v.detach().cpu() for k, v in card_engine.model.state_dict().items()}
    captures = {"card bf16": cs.dasm_capture(card_engine, wav, pm)}
    for name, dtype in (("CPU f32", None), ("CPU bf16", torch.bfloat16)):
        t0 = time.perf_counter()
        captures[name] = cs.dasm_capture(cs.build_dasm_engine("cpu", state, dtype=dtype), wav, pm)
        cs.log(f"{name}: built and ran in {time.perf_counter() - t0:.1f} s")
    for other, ref in (("card bf16", "CPU f32"), ("CPU bf16", "CPU f32"),
                       ("card bf16", "CPU bf16")):
        cs.log_dasm_gaps(f"{other} vs {ref}", cs.dasm_gaps(captures[other], captures[ref]))
    for name, c in captures.items():
        cs.log(f"{name}: its tail against f64 of its own tensors {cs.dasm_tail_error(c):.3e}")
    card = captures["card bf16"]
    for what, strong in cs.dasm_tail_faults(card).items():
        cs.log(f"card bf16, planted fault {what}: tail error "
               f"{cs.dasm_tail_error(card, strong):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
