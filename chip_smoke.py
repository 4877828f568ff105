#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                              # every phase, one card
    python3 chip_smoke.py --phases build,kernels,train # the short call after a kernel edit
    python3 chip_smoke.py --phases build,window_kernels  # the Swin window kernels alone
    python3 chip_smoke.py --phases build,hm_kernels      # the head-major XL kernels alone
    python3 chip_smoke.py --phases build,pmam_serve,pmam_train  # the PMAM paths, no timing
    python3 chip_smoke.py --phases build,flash_hm_kernels  # the head-major flash kernels alone
    python3 chip_smoke.py --phases build,parallel_train,multichip_dryrun  # the parallel layouts
    python3 chip_smoke.py --phases build,bias_kernels,variant_kernels,masked_decoder  # rows 4, 16
    python3 chip_smoke.py --phases build,finetune2_serve,finetune2_train  # the sliding windows
    python3 chip_smoke.py --phases kernel_timing  # every kernel's time alone, no build check
    python3 chip_smoke.py --phases build,score  # the test stage's scoring path alone
    python3 chip_smoke.py --phases build,stages  # the matsed_* stages through the CLI
    python3 chip_smoke.py --phases build,pmam_stages  # the pmam_* stages and PMAM's chain
    python3 chip_smoke.py --phases build,score,serving  # serve, infer, stream and export
    python3 chip_smoke.py --phases build,dasm_serve,dasm_parity,dasm_train,dasm_train_parity,audioset_stages

Four networks run: the MAT-SED flagship (PaSST_SED, phases 3 to 6, its
MLM pretrain step, phases 17 and 18, its decoder with an explicit mask, phase
19, and finetune2's sliding windows, phases 20 to 23), HTSAT_CNN (phases 9 to
12), PMAM's PaSST_CNN (phases 13 to 16, and its finetune2 step in 22 and
23) and DASM (phases 24 to 28). The CPU f32 train parities of phases 6, 6a,
16, 18, 23 and 4d's check (e) run the PaSST backbone cut to PARITY_DEPTH of
its blocks (PARITY_CUT), with their bounds unchanged; every other phase runs
the full depth. Phases, in order (19 runs right after 2); any failure exits
non-zero:
  1. print the card (nvidia-smi name, power limit); build every CUDA kernel
     from ``transformer4sed_tpu_torch/csrc`` (one nvcc per source, in
     parallel): the serving forwards and the training LSE forwards and
     backwards; check the build: no kernel of the flash family, of the
     heads-in-lanes XL forward, of the XL backward or of the Swin window
     attention spills (rows 1 to 8, 11 to 16), the flash forward's (rows 1,
     3, 4, 5, 7, 16), the heads-in-lanes XL forward's (rows 2, 12), the
     window forward's (row 14) and the flash, XL and window backwards' SASS
     hold HGMMA and UTMALDG and no HMMA, row 4's LDGSTS (its bias by
     cp.async), the backwards' UTMAREDG and no atomic (``cuobjdump`` of the
     built libraries, fresh or cached); the head-major XL forward's (rows 9,
     10, still on ``mma.sync``) is logged;
  2. hold each kernel against its plain PyTorch version on the card, at the
     main paths' shapes and on small ragged and banded cases (rows 1 and 8
     also at finetune2's window length N = 602, rows 1 and 7 at a negative
     and a zero scale, rows 2, 12 and 13 also at T = 320, 5 and 193, and the
     flash and XL backwards' pre- and post-passes), and show that the same
     check rejects planted faults (a dropped key tile, the last key tile
     left unmasked, a dropped bias, a rel-shift off by one, a band one key
     wider; in rows 2 and 12's kernel the strip tiles' start clamped at P
     row 0, the newest strip tile read from the step before, the skew
     one strip row off, pos_bias_u rounded to bf16 before the add (on inputs
     with sharp scores); for the backwards an LSE shifted by log 2,
     a zeroed O, the last key tile's dQ partial left out, P rolled by one
     row, pos_bias_v dropped, and in row 13 the XL backward's own three: the
     last key tile's dQ partial left out, the strip pieces' start clamped at
     P row 0, the last step's dP carry never added); the Swin window forward
     and backward at HTSAT-tiny's four
     stage shapes at B=64, shifted and unshifted, and at two and one heads
     (the layout's heads a rank under tensor parallelism; one head also over
     stage 0's 4096 windows, past the wrap of the kernels' rings), with six more
     planted faults (head 0's bias for every head, window 0's shift mask for
     every window, head-dim lanes 24..31 read from the next head, a dbias
     that misses the last window, K read from the slot of the group's other
     head, the last chunk's dbias and dshift reductions skipped); the
     head-major XL forward, LSE forward and
     backward at PMAM's decoder shapes ([8, 12, 1000, 32] and [18, 12, 1000,
     32], strided views of [B, T, 3*384] projections), on ragged and banded
     cases, at head dim 64 and once at [2, 12, 3000, 64], with eight more
     planted faults (qv read for qu, k's head stride taken as its row stride,
     a band one key wider, dqu and dqv swapped, a dP that misses the last
     batch, and the XL backward's three in row 11); the head-major flash
     forward, LSE forward and backward (rows 3, 5 and 6) at [8, 12, 1190, 64]
     and [24, 12, 1190, 64] (strided views of [B, 1190, 2304] projections),
     [8, 12, 1190, 32] contiguous and ragged
     T = 37 and 130, with six more planted faults (k's head stride taken as
     its row stride, the last key tile dropped, the LSE forward's last key
     tile left unmasked, an LSE shifted by log 2 in the backward, the last
     key tile's dQ partial left out, dk of head h written to head h+1); the
     biased flash
     forward (row 4) at [8, 12, 1000, 64] and [8, 12, 1000, 32] with a banded,
     key-masked bias and a fully masked row, ragged T = 37 and 130 (one with
     a batch-expanded bias) and at scales -0.125 and 0, five more planted
     faults (bias dropped, read transposed, last key tile dropped, the last
     key tile left unmasked, -inf for -1e30) and its backward against
     autograd of the plain version; the flash variants (row 16, A and B) at
     the entry point's [64, 12, 1190, 64], ragged T and scales -0.125 and 0,
     three more planted faults (the padded tail counted, and in A and in B
     the last key tile left unmasked), then the entry point at [64, 12,
     1190, 64];
  3. serve three batches of synthetic 10-s clips (the last one ragged, one
     clip short) through ``InferenceEngine`` with the full-width MAT-SED
     flagship (PaSST 768/12/12 tapped at layer 10, 3-layer Transformer-XL
     at T=1000, AT adapter, 10 DESED classes), seeded random weights, bf16
     compute; check shapes, finiteness, events and that the kernels ran
     12 and 3 times per batch (and no training kernel ran);
  4. the same weights on 2 clips on the CPU in f32 (plain versions) and on
     the card (kernels): strong, weak and at_out must agree to the JAX
     package's own bf16-vs-f32 bound;
  4a. score: the test stage's scoring path (``recipes/matsed.py:306-434``)
     on a mini DESED split written from ``synthetic_bursts`` (48 clips, 16-bit
     WAV, 8 at 44.1 kHz, 8 stereo, one 6.5 s long; their bursts, three
     classes a clip, as the ground truth; strong-label and duration TSVs):
     the port's dataset and loader (batches of 8, every file through the
     native WAV library), frontend and flagship on the card, decode on the
     card with the recipe's median windows and weak mask, then PSDS1, PSDS2,
     event and segment F1, and cSEBB then PSDS1 on the host; checks: (a) the
     card's decode equals the CPU's on the same f32 scores, (b) the native
     PSDS sweep is within 1e-9 of the NumPy one, (c) both native libraries
     were built and used, (d) the ground truth scores itself (PSDS1 >= 0.99,
     event F1 1), (e) a planted fault (every event 1 s late) fails (d), (f)
     rows 1 and 2 ran 12 and 3 times a batch; prints the path's clips/s and
     its host split beside the card's name and power limit;
  4b. serving (run after 4a in the whole script, on its 48 clips, its
     split written anew when 4a does not run, and the same seeded
     flagship): (a) ``recipes/serve.py:main`` at B=8 from a port checkpoint
     and from a ``.pt`` of the flagship's weights (``--config_dir
     config/mat-sed/finetune1.yaml``, on the card by default): its per-clip
     TSVs and ``events.jsonl`` equal, bitwise and by file name,
     ``InferenceEngine.score_batches`` and ``decode`` on the same loader's
     batches, rows 1 and 2 at 12 and 3 launches a batch; (b)
     ``recipes/infer.py:infer_clip`` on one clip equals the engine at B=1,
     and ``infer_long_audio`` on 60 s of six clips (11 windows in one
     forward) equals the overlap-add of the engine's scores of the same
     windows, bitwise; (c) ``recipes/stream.py:StreamingScorer`` on 30 s in
     chunks of 0.5 and 1.7 s gives the rows of a manual overlap-add of the
     same windows, bitwise; (d) ``recipes/export.py:main`` then
     ``serve.main --exported`` for the flagship (B=8; the TSVs of (a)),
     PMAM's PaSST_CNN (``config/pmam/finetune1.yaml``, B=8) and HTSAT_CNN
     (``config/audioset_strong/htsat_cnn.yaml``, B=64), each on 16 clips
     against its own engine, each program calling its network's
     ``t4s::`` ops (rows 1 and 2, 1 and 9, 14 and 2); (e) a planted fault,
     file names rolled within each batch before the TSVs are written, falls
     outside (a); prints clips/s of ``main`` beside the engine's and ms a
     stream window beside the card's name and power limit;
  4c. stages: the recipe CLI (``recipes/cli.py``) in-process on the card at
     the flagship's full width, from a mini DESED on disk (strong 12, synth
     4, weak 16, unlabeled 32 clips of ``synthetic_bursts``; validation and
     test: phase 4a's 48 clips and tables) with configs written from the
     shipped ``config/mat-sed/pretrain.yaml`` and ``finetune1.yaml`` (only
     the dataset paths and the epochs changed, each override logged):
     ``matsed_pretrain`` (1 epoch), ``matsed_finetune`` (1 epoch,
     warm-started from the pretrain's best student), ``matsed_finetune``
     again to 2 epochs with ``--resume_ckpt auto``, ``matsed_test``, and
     one epoch of the shipped ``finetune2.yaml`` (its sliding windows) from
     the finetune's best student; checks:
     (a) every stage returns 0 and writes the JAX stage's files, (b) the
     warm start dropped exactly what ``classifier|at_head|at_pool`` names
     and loaded every other key bitwise, (c) the second finetune resumed at
     epoch 1 and ``last_state`` restores into a fresh trainer bitwise, (d)
     finite losses and PSDS, (e) rows 1, 2, 7, 8, 12 and 13 launched per
     stage, every train step at least once each of 7, 8, 12 and 13, (f)
     every batch of the recipes' loaders decoded in one native
     ``load_wav_batch`` call, (g) the ground truth as scores, through the
     test stage's tables and PSDS, scores itself, and a planted fault (a
     test split whose events are 1 s late) fails that; prints each train
     stage's one-pass wall time and steps/s (its first steps included: a
     smoke timing) and the validation and test split (device, decode,
     PSDS sweeps, loader and the rest) beside the card's name and power
     limit;
  4d. pmam_stages: PMAM's chain (``exps/pmam/train.sh``) through the CLI on
     the card at full width and depth: the shipped
     ``config/pmam/post_pretrain.yaml`` (dataset paths and epochs changed,
     and the MLM head's ``out_dim`` made the tap's 384: the shipped 768 cannot
     meet the 384-wide GMM means in either package) over 48 written 10-s
     clips, from a seeded post-pretrain checkpoint (LoRA factors N(0, 0.05)):
     ``pmam_extract``, ``pmam_gmm`` (K = 30, full, 50 iterations),
     ``pmam_pseudo_labels``, ``pmam_train`` (1 epoch, B=24), then
     ``matsed_finetune`` on ``config/pmam/finetune1.yaml`` and
     ``finetune2.yaml`` (1 epoch each, phase 4c's mini DESED) and
     ``matsed_test``; checks: every stage returns 0 and launches what
     PERF.md predicts a batch or step; (a) ``features.npy`` has 2 x 6000
     rows of 384, and the card's bf16 tap of two clips is within 3 %
     (relative Frobenius) of the CPU's f32 tap on the same mask and offsets;
     (b) the GMM's mean log-likelihood never falls by more than f32 noise,
     its weights sum to 1, every covariance factors, and one EM iteration
     in f32 on the card is within 1e-4 (relative) of the same iteration in
     f64 on the CPU; (c) 48 TSVs of 1000 x (2 + 30), probabilities summing
     to 1 within 2e-5, two clips' values equal to ``predict_proba`` of their
     tap computed apart within 1e-6; (d) a finite loss, every LoRA factor
     moved, every other backbone tensor bitwise unchanged, the decoder and
     the MLM head moved, rows 7, 8, 10 and 11 a step; (e) the post-pretrain
     step, card bf16 against CPU f32, 3 steps at B=3 (phase
     ``pmam_train_parity``'s clips, labelled by the tokenizer) with the train-parity
     bounds over the trainable params; (f) finetune1, finetune2 and the test
     log finite numbers, and finetune1 logs the LoRA factors and MLM head it
     drops; (g) two planted faults fall OUTSIDE: LoRA's scale alpha for
     alpha / r against (a), the GMM's means permuted alone against (c);
  5. train: mean-teacher steps of the same flagship at B=24 (strong 8 |
     weak 8 | unlabeled 8) on seeded synthetic clips and labels, default
     augmentation (fmin/fmax draw, frame shift, mixup p=0.5, two filt_aug
     views), clip 20, AdamW 1e-4, EMA 0.999; finite losses, and per step
     the teacher's forward kernels 12 and 3 times, the LSE forwards and
     backwards 12 (flash) and 3 (XL) times each;
  6. train parity: the same weights, 3 steps at B=3 (1|1|1) with
     augmentation off on the CPU in f32 and on the card in bf16: loss
     trajectories and the gradient at the CPU's end state held to the JAX
     package's bf16-vs-f32 bounds (tests/test_precision.py:86-138);
  6a. parallel train: one NCCL rank (MASTER_ADDR 127.0.0.1, a free port),
     a data x model mesh of 1 x 1, the flagship's mean-teacher step at B=24
     through ``shard_params`` and the parallel step wrapper, default
     augmentation: finite losses and per step the teacher's 12 head-major
     forward launches (row 3), the student's 12 head-major LSE forwards and
     backwards (rows 5, 6), none of rows 1, 7 and 8, the XL kernels as in
     phase 5; its 3 steps at B=3 without augmentation step alongside phase 6
     and are held against the card's single-device trainer and the CPU's f32
     one with phase 6's bounds;
  6b. multichip dry run: ``dryrun_multichip(2)`` and ``dryrun_multichip(4)``
     on the CPU (gloo ranks spawned on localhost): the mean-teacher and
     BatchNorm phases over 1 rank, dp and dp x tp2 at the JAX harness's
     tolerances, with the trajectories printed;
  7. time each kernel, its plain version and the one-call library
     equivalent (SDPA forward, SDPA backward through autograd) with CUDA
     events, beside the least time the card could take (the flash and XL
     backwards also as their three launches apart); time served
     clips/s at B=8 over three windows of 80 batches; time train steps/s
     and clips/s at B=24 over three windows, and the peak device memory;
  8. profile two served batches and one train step (torch.profiler):
     device time by kernel and the device's busy share;
  9. serve 148 synthetic 10-s clips (64, 64 and a ragged 20) through
     ``InferenceEngine`` with the full-width HTSAT_CNN of
     config/audioset_strong/htsat_cnn.yaml (HTSAT-tiny, the ten-layer CNN
     branch, 3-layer Transformer-XL at T=320, 447 classes), seeded weights,
     bf16: shapes, finiteness, events, and per batch 12 window-attention
     and 3 XL launches;
 10. the same weights on 2 clips in eval mode, CPU f32 against card bf16;
 11. three supervised steps of HTSAT_CNN at B=64 (frame shift, mixup,
     filt_aug, CNN dropout, AslLoss, the config's param groups, clip 20):
     finite losses, per step 12 window forwards, 12 window backwards, 3 XL
     LSE forwards and 3 XL backwards, and BatchNorm running statistics that
     moved;
 12. HTSAT_CNN train parity: 3 steps at B=4 with augmentation and dropout
     off, CPU f32 against card bf16, held as in phase 6;
 13. serve 20 synthetic 10-s clips (8, 8 and a ragged 4) through
     ``InferenceEngine`` with the full-width PaSST_CNN of
     config/pmam/finetune1.yaml (PaSST 768/12/12 tapped at layer 10, attention
     f-pool, the ten-layer BatchNorm CNN, 3-layer Transformer-XL at T=1000,
     384 wide with 12 heads of 32, AT adapter, 10 DESED classes), bf16:
     shapes, finiteness, events, and per batch 12 flash and 3 head-major XL
     launches and none of the head-dim-64 XL kernel;
 14. the same weights on 2 clips in eval mode, CPU f32 against card bf16;
 15. two mean-teacher steps of PaSST_CNN at the config's B=18 (strong 6 |
     weak 6 | unlabeled 6) with its loss weights, transform, param groups
     (backbone blocks 0 to 7 frozen) and CNN dropout: finite losses, per step
     the teacher's 12 and 3 forwards, the student's 12 flash and 3 head-major
     XL LSE forwards and backwards, none of the head-dim-64 XL kernels, and
     running statistics of both models that moved, each its own;
 16. PMAM train parity: 3 steps at B=3 with augmentation and dropout off, CPU
     f32 against card bf16, held as in phase 6;
 17. two MLM pretrain steps of the flagship with ``mlm=True`` at B=24
     (config/mat-sed/pretrain.yaml: block masking of 75 %, one filt_aug view,
     the encoder group frozen): a finite non-zero loss, a masked share of
     0.76, per step 3 head-dim-64 XL LSE forwards and backwards, 12 flash LSE
     forwards and 10 flash backwards (blocks 11 and 12 feed no MLM output),
     an unchanged encoder;
 18. MLM train parity: 3 steps at B=3 with shift and views off and the mask
     drawn alike, CPU f32 against card bf16, held as in phase 6;
 19. masked decoder: the flagship's 3-layer XL decoder at B=8, T=1000, with
     a per-head band (DECODER_BANDS) given as band widths (row 2; rows 12
     and 13 with gradients) and as an explicit [H, T, T] mask (row 4, its
     backward by recompute): outputs and gradients agree, the launch
     counters show which kernel ran, and three planted faults in the masked
     path (the position scores one key off, pos_bias_u and pos_bias_v
     swapped, the gradients 5 % large) fall outside the agreement's limits;
 20. finetune2 served: the flagship with config/mat-sed/finetune2.yaml's
     windows (512 frames at a step of 31: 17 windows in two width groups)
     serving the clips of phase 3, row 1 once per block of the clip's
     backbone call and once per block up to the tap layer of each window
     group's;
 21. the same weights on the short clip, CPU f32 against card bf16;
 22. finetune2 train: mean-teacher steps with student and teacher windowed
     at the shipped batch (4 | 4 | 4), then PMAM's finetune2 step (teacher
     windowed at [512, 49], student not) at 6 | 6 | 6: finite losses and the
     launches of rows 1, 7, 8 per backbone call (a window group's stops at
     the tap layer);
 23. finetune2 train parity: both steps, 2 steps at B=3 with windows of 512
     at a step of 490 (two width groups), CPU f32 against card bf16, held as
     in phase 6;
 24. dasm_serve: config/dasm/closed_set.yaml's DASM (PaSST 768/12/12 tapped at
     10, the attention f-pool, 3 XL blocks at T=1000, two query projectors, 2
     AT-decoder layers, the 448-way head), seeded weights and seeded [447,
     512] text and [447, 768] audio banks, served at B=8 with the text bank
     on phase 3's clips: shapes, finiteness, events at 0.5 and at half the
     largest score, the padded frames at the floor, rows 1 and 2 at 12 and 3
     a batch; served clips/s over three windows, and the AT decoder's
     forward time against a batch's;
 25. dasm_parity: the same weights on 2 clips, each quantity on its own
     scale: (a) the card's f32 tail (einsum, / temp_w, sigmoid, prior, pad,
     clamp) against f64 of its own tensors, (b) card bf16 against CPU f32 on
     z = logits / temp_w, the AT head's logits, the prior, strong and weak,
     by relative L2 error; five planted faults fall outside;
 26. dasm_train: the closed-set step (DASMStep: shift, mixup, filt_aug, the
     AT decoder's dropout, a modality drawn per query, strong BCE + the
     448-way CE) at the shipped B=48: finite losses, rows 7, 8, 12 and 13 at
     12, 12, 3 and 3 a step and nothing else; three windows of four steps,
     peak memory, the AT decoder's forward and backward time;
 27. dasm_train_parity: that step at full width and depth, 2 steps at B=2
     without augmentation or dropout, CPU f32 against card bf16, held as in
     phase 6;
 28. audioset_stages: ``audioset_supervised`` (htsat_cnn.yaml), ``dasm_train``
     (closed_set.yaml), ``dasm_ov`` (open_vocab.yaml) and ``openset_eval``
     through the CLI on the card from a mini 447-class tree of written
     clips (the vendored label tables, 34 novel labels), dataset paths and
     epochs changed and ``query_type: text`` for open_vocab.yaml's one bank;
     checks (a) to (d) (files, finite logs, launches, the warm start, then
     ``serve --query`` and ``infer --query`` bitwise against the engine);
then, inside phases 7 and 8, the window kernels at the four stages (device
and host times, and their sums over an HTSAT_CNN step beside the bound),
the head-major XL,
head-major flash,
biased and variant flash kernels' times beside their bounds and plain versions
(and SDPA for the window and flash kernels, with the bias as a float mask for
row 4), rows 1, 7 and 8 at the window shape beside SDPA's forward and
backward there, the parallel-layout train steps/s
beside phase 7's, and HTSAT_CNN's, PMAM's and finetune2's served clips/s, the
train steps/s of HTSAT_CNN, PMAM, MLM and both finetune2 steps, peak memory
and profiles. Phases 7 and 8 time and profile the
flagship's kernels and single-device paths right after phase 5, before
phase 6a brings up the process group and builds the sharded trainer; the
parallel-layout step is timed after phase 6b, and the group is destroyed
before phase 9.

The second-to-last line is a JSON ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``. ``--phases`` runs a subset
(and then prints no final record); the build is checked only where the
subset names ``build``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
PHASES = ("build", "kernels", "serve", "parity", "score", "serving", "stages", "pmam_stages",
          "train", "train_parity", "parallel_train", "multichip_dryrun", "htsat_serve",
          "htsat_parity", "htsat_train", "htsat_train_parity", "pmam_serve", "pmam_parity",
          "pmam_train", "pmam_train_parity", "mlm_train", "mlm_train_parity", "masked_decoder",
          "finetune2_serve", "finetune2_parity", "finetune2_train", "finetune2_train_parity",
          "dasm_serve", "dasm_parity", "dasm_train", "dasm_train_parity", "audioset_stages",
          "timing", "profile")
# subsets of a phase, for the short call after an edit; never part of the whole run
SUB_PHASES = ("window_kernels", "hm_kernels", "flash_hm_kernels", "bias_kernels",
              "variant_kernels", "htsat_timing", "pmam_timing", "kernel_timing")

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
# The backwards round to bf16 once before each product (P before dV = P^T dO,
# dS before dK, dQ and, in XL, dQv and dP) and round dq/dk/dv/dP once at the
# end; dS itself, the recomputed scores and P are f32 on exact bf16 products,
# as in the plain version, which runs in f32 on the same bf16 inputs (q stays
# bf16 in the XL one, so q+u and q+v round as in the kernel). Rounding one
# operand of a product perturbs each term by at most u times the term, so,
# element by element, |grad - ref| <= u * (|ref| + the same product taken on
# absolute values), e.g. P^T|dO| for dv and scale * |dS|^T |Q| for dk, which
# the plain formulas give when run on |dS| and |operands| (bwd_bound_terms).
# dS = P (dP - delta) is f32 on both sides, but dP - delta can cancel (a
# band-1 row has dS = 0 exactly): the f32 error of each 64-term dot,
# gamma_64 = 64 * 2^-24 times the sum of |terms| (Higham), is added to |dS|
# in units of u, as F32_DOT * P * (|dO| |V|^T + rowsum |dO| |O|).
F32_DOT = 64 * 2.0 ** -24 / BF16_U
# The log-sum-exp has no bf16 rounding: the kernel and the plain version
# differ by f32 sums in another order and exp2 for exp, a few ulps of the
# 1190 scores it sums; LSE_RTOL bounds that relative to 1 + |lse|.
LSE_RTOL = 2.0 ** -14
# card bf16 vs CPU f32 on probabilities: the JAX package's own bound for
# the same-params eval forward in the two compute dtypes
# (tests/test_precision.py, docs/PRECISION.md)
DTYPE_MAX_ABS = 5e-2
# phase dasm_parity, where a seeded DASM's probabilities are small (the
# 448-way prior near 1/448) and each quantity is held on its own scale.
# (a) The card's f32 tail (the einsum of its bf16 mask embedding and frames,
# / temp_w, sigmoid, prior, pad, clamp) against the same tail in f64 from the
# same card tensors, max |err| over max |strong|: f32 rounding of a 768-term
# dot product and a 448-way softmax is near 1e-6 of that.
DASM_TAIL_RTOL = 1e-4
# (b) Card bf16 against CPU f32, relative L2 error of z = logits / temp_w,
# the AT head's logits, the prior, strong and weak: bf16 rounds every GEMM
# operand (u = 2^-8) through 12 backbone blocks, 3 XL blocks, 2 AT-decoder
# layers and the MLPs; PMAM_TAP_REL's 3 %, the train parity's loss bound.
DASM_REL_L2 = 0.03
# card bf16 vs CPU f32 training: the JAX package's own bounds for the same
# comparison (tests/test_precision.py:86-138): relative loss delta over the
# trajectory (mean, max) and the gradient at the f32 end state (cosine,
# norm ratio)
TRAIN_LOSS_REL_MEAN, TRAIN_LOSS_REL_MAX = 0.03, 0.10
TRAIN_GRAD_COS = 0.995
TRAIN_GRAD_RATIO = (0.9, 1.1)
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


def cuda_ms(fn, iters: int = 20, warmup: int = 3, queued: bool = False) -> float:
    """ms a call of ``fn`` over ``iters`` back-to-back calls, by CUDA events:
    the host's time and the device's, whichever is longer. ``queued``: the
    device's alone (``queued_ms``)."""
    import torch

    if queued:
        return queued_ms(fn, iters, warmup)[0]
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


def queued_ms(fn, iters: int = 20, warmup: int = 3):
    """(device ms, host ms) a call of ``fn``: ``iters`` calls enqueued behind
    a 20 ms GPU sleep, so that the CUDA events around them time the device
    alone, not the host's enqueueing of calls whose device time is shorter
    than their host time (the window kernels past stage 0); the host's
    time, by its clock over the enqueueing, is what each call costs the
    host: its checks, tensor maps and launch."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(3.5e7))  # about 20 ms at the H100's 1.98 GHz boost clock
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


def held(what, out, ref, abs_term):
    """Log the kernel's error against its bound, KERNEL_SLACK * u * (|ref| +
    abs_term) with abs_term the product on absolute values (A|v| for the
    forwards), and against KERNEL_MEAN_FACTOR; return (within both limits,
    max abs error)."""
    import torch

    err = (out.float() - ref).abs()
    tol = KERNEL_SLACK * BF16_U * (ref.abs() + abs_term)
    worst = float(torch.where(err == 0, 0.0, err / tol).max())
    mean = float(err.mean())
    floor = float((ref.to(torch.bfloat16).float() - ref).abs().mean())
    ok = worst <= 1.0 and mean <= KERNEL_MEAN_FACTOR * floor
    log(f"{what}: max_abs_err {float(err.max()):.3e}, max err/bound {worst:.3f} (limit 1); "
        f"mean {mean:.3e} = {mean / floor:.2f}x the bf16 rounding floor {floor:.3e} "
        f"(limit {KERNEL_MEAN_FACTOR}): {'within' if ok else 'OUTSIDE'}")
    return ok, float(err.max())


def lse_held(what, lse, ref):
    """Log the log-sum-exp's error against its f32 bound (LSE_RTOL);
    return (within, max abs error)."""
    err = (lse - ref).abs()
    worst = float((err / (LSE_RTOL * (1.0 + ref.abs()))).max())
    ok = worst <= 1.0
    log(f"{what}: lse max_abs_err {float(err.max()):.3e}, max err/bound {worst:.3f} (limit 1, "
        f"bound {LSE_RTOL:.2e} * (1 + |lse|)): {'within' if ok else 'OUTSIDE'}")
    return ok, float(err.max())


def held_all(what, names, outs, refs, extras):
    """held() for each result of a backward; (all within, max abs error)."""
    oks, worst = [], 0.0
    for name, out, ref, extra in zip(names, outs, refs, extras):
        ok, mx = held(f"{what} {name}", out, ref, extra)
        oks.append(ok)
        worst = max(worst, mx)
    return all(oks), worst


def kernel_wrappers():
    """Every kernel wrapper of the port by name; each counts its launches."""
    from transformer4sed_tpu_torch.kernels import flash_attention as fa
    from transformer4sed_tpu_torch.kernels import window_attention as wa
    from transformer4sed_tpu_torch.kernels import xl_attention as xa

    from transformer4sed_tpu_torch.exps import flash_variants as fv

    fns = (fa.flash_attention_nhd, xa.flash_xl_attention_nhd, fa.flash_attention_nhd_lse,
           fa.flash_attention_nhd_backward, xa.flash_xl_attention_nhd_lse,
           xa.flash_xl_attention_nhd_backward, wa.window_attention, wa.window_attention_backward,
           xa.flash_xl_attention, xa.flash_xl_attention_lse, xa.flash_xl_attention_backward,
           fa.flash_attention, fa.flash_attention_lse, fa.flash_attention_backward,
           fa.flash_attention_bias, fv.flash_a, fa.flash_bwd_prepass, fa.flash_bwd_postpass,
           xa.flash_xl_bwd_prepass, xa.flash_xl_bwd_postpass)
    return {f.__name__: f for f in fns}


def reset_launches():
    for f in kernel_wrappers().values():
        f.launches = 0


def read_launches():
    return {name: f.launches for name, f in kernel_wrappers().items()}


def with_bwd_passes(per_step):
    """A path's launches a step with the backwards' passes: one pre-pass and
    one post-pass of the flash backward for every launch of row 6 or row 8,
    and of the XL backward for every launch of row 11 or row 13."""
    n = sum(per_step.get(k, 0) for k in ("flash_attention_nhd_backward", "flash_attention_backward"))
    n_xl = sum(per_step.get(k, 0)
               for k in ("flash_xl_attention_nhd_backward", "flash_xl_attention_backward"))
    return dict(per_step, flash_bwd_prepass=n, flash_bwd_postpass=n, flash_xl_bwd_prepass=n_xl,
                flash_xl_bwd_postpass=n_xl)


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


# planted faults of the heads-in-lanes XL forward (rows 2 and 12, csrc/xl_fwd.cuh)
XL_FWD_FAULTS = (("clamp_strip", "the strip tiles' start clamped at P row 0, not zero-filled"),
                 ("stale_tile", "the newest strip tile read from the step before"),
                 ("skew", "the skew one strip row off"),
                 ("round_u", "pos_bias_u rounded to bf16 before the add (sharp scores)"))


def check_kernels(results):
    import torch

    from transformer4sed_tpu_torch.kernels.flash_attention import (
        _forward_kernel,
        flash_attention_nhd,
        flash_attention_nhd_lse,
        flash_attention_nhd_lse_reference,
        flash_attention_nhd_reference,
    )
    from transformer4sed_tpu_torch.kernels.xl_attention import (
        XF_FAULTS,
        flash_xl_attention_nhd,
        xl_attention_nhd_reference,
    )
    from transformer4sed_tpu_torch.kernels.xl_attention import _forward_kernel as xl_forward_kernel

    rejected = []  # planted faults: each must fall outside the bound

    cases = [  # (b, n, c, h, main path?)
        (8, 1190, 768, 12, True),
        (2, 77, 768, 12, False),
        (1, 130, 256, 4, False),
        (128, 602, 768, 12, False),  # finetune2's served windows: 602 = 4 * 128 + 90 keys
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
            out, _ = _forward_kernel(q, k, v, h, (c // h) ** -0.5, with_lse=False,
                                     skip_tail_mask=1)
            rejected.append(held("planted fault: the last key tile unmasked (zero keys counted)",
                                 out, ref, ref_abs_v)[0])
        del ref, ref_abs_v, out
        torch.cuda.empty_cache()
    # rows 1 and 7 take any scale the reference takes: zero and negative too
    q, k, v = flash_inputs(2, 77, 768, seed=78)
    qf, kf, vf = q.float(), k.float(), v.float()
    for scale in (-0.125, 0.0):
        ref, ref_lse = flash_attention_nhd_lse_reference(qf, kf, vf, 12, scale)
        ref_abs_v = flash_attention_nhd_reference(qf, kf, vf.abs(), 12, scale)
        ok, _ = held(f"kernel flash_attention_nhd B=2 N=77 scale={scale}",
                     flash_attention_nhd(q, k, v, 12, scale), ref, ref_abs_v)
        out, lse = flash_attention_nhd_lse(q, k, v, 12, scale)
        ok_o, _ = held(f"kernel flash_attention_nhd_lse B=2 N=77 scale={scale} out", out, ref,
                       ref_abs_v)
        ok_l, _ = lse_held(f"kernel flash_attention_nhd_lse B=2 N=77 scale={scale}", lse, ref_lse)
        check(ok and ok_o and ok_l, f"rows 1 and 7 disagree with their plain versions at "
              f"scale {scale}")

    wide_band = (1, 2, 5, 16, 31, 64, 100, 128, 255, 500, 999, 2000)
    cases = [  # (b, t, c, h, band, main path?)
        (8, 1000, 768, 12, None, True),
        (8, 1000, 768, 12, wide_band, False),
        (2, 77, 768, 12, None, False),
        (1, 130, 256, 4, (3, 20, 1, 260), False),
        (64, 320, 768, 12, None, False),  # HTSAT_CNN's decoder
        (1, 5, 768, 12, None, False),  # T under one key tile: most strip rows zero-filled
        (2, 193, 768, 12, None, False),  # a strip tile past P row 2T-2
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
            for fault, what in XL_FWD_FAULTS[:3]:
                out, _ = xl_forward_kernel(q, k, v, bu, bv, p, h, scale, None, with_lse=False,
                                           fault=XF_FAULTS[fault])
                rejected.append(held(f"planted fault: {what}", out, ref, ref_abs_v)[0])
        if band == wide_band:
            wider = tuple(w + 2 for w in band)
            out = flash_xl_attention_nhd(q, k, v, bu, bv, p, h, scale, wider)
            rejected.append(held("planted fault: band one key wider each side", out, ref,
                                 ref_abs_v)[0])
        del ref, ref_abs_v, out
        torch.cuda.empty_cache()
    # pos_bias_u rounded to bf16 before the add moves q + u by at most one bf16
    # step, which the 0.1-scale biases above hide under the bound; unit-scale
    # biases and keys four times larger (exact in bf16) sharpen the scores
    # until that step shows. The kernel itself is held to the same bound on them.
    q, k, v, bu, bv, p = xl_inputs(2, 1000, 768, 12, seed=1001)
    bu, bv, k = bu * 10, bv * 10, (k.float() * 4).to(torch.bfloat16)
    ref, ref_abs_v = (xl_attention_nhd_reference(q, k.float(), vv, bu, bv, p.float(), 12, 0.125)
                      for vv in (v.float(), v.float().abs()))
    ok, _ = held("kernel flash_xl_attention_nhd B=2 T=1000 C=768 H=12, sharp scores",
                 flash_xl_attention_nhd(q, k, v, bu, bv, p, 12, 0.125), ref, ref_abs_v)
    check(ok, "flash_xl_attention_nhd disagrees with its plain version on sharp scores")
    fault, what = XL_FWD_FAULTS[3]
    out, _ = xl_forward_kernel(q, k, v, bu, bv, p, 12, 0.125, None, with_lse=False,
                               fault=XF_FAULTS[fault])
    rejected.append(held(f"planted fault: {what}", out, ref, ref_abs_v)[0])
    check_train_kernels(results, rejected)
    check_window_kernels(results, rejected)
    check_hm_kernels(results, rejected)
    check_flash_hm_kernels(results, rejected)
    check_bias_kernels(results, rejected)
    check_variant_kernels(results, rejected)
    check(not any(rejected), "the kernel check let a planted fault through")
    log(f"all {len(rejected)} planted faults fall outside the bound")


def flash_bwd_terms(q, k, v, o, lse, do, h):
    """The backward's products on absolute values (the bound above):
    scale |dS| |K| for dq, scale |dS|^T |Q| for dk, P^T |dO| for dv."""
    import torch

    from transformer4sed_tpu_torch.kernels.flash_attention import (
        _merge_heads,
        _split_heads,
        row_delta,
    )

    scale = (q.shape[-1] // h) ** -0.5
    qh, kh, vh, doh = (_split_heads(x.float(), h) for x in (q, k, v, do))
    pr = torch.exp(torch.matmul(qh, kh.transpose(-1, -2)) * scale - lse[..., None])
    ads = (pr * (torch.matmul(doh, vh.transpose(-1, -2)) - row_delta(o, do, h)[..., None])).abs()
    ads += F32_DOT * pr * (torch.matmul(doh.abs(), vh.abs().transpose(-1, -2))
                           + row_delta(o.abs(), do.abs(), h)[..., None])
    return (_merge_heads(torch.matmul(ads, kh.abs())) * scale,
            _merge_heads(torch.matmul(ads.transpose(-1, -2), qh.abs())) * scale,
            _merge_heads(torch.matmul(pr.transpose(-1, -2), doh.abs())))


def xl_bwd_terms(q, k, v, bu, bv, p, o, lse, do, h, scale, band):
    """The XL backward's products on absolute values (:func:`hm_bwd_terms` on
    the head-major views): scale (|dS||K| + unshift|dS| |P|) for dq, scale
    |dS|^T |q+u| for dk, A^T |dO| for dv, the (b, t) sums of dq's two parts
    for the bias gradients, scale unshift|dS|^T |q+v| summed over batch for dP."""
    from transformer4sed_tpu_torch.kernels.flash_attention import _merge_heads, _split_heads
    from transformer4sed_tpu_torch.kernels.xl_attention import add_pos_bias

    qu, qv = add_pos_bias(q, bu, bv, h)
    dqu, dqv, dk, dv, dp = hm_bwd_terms(qu, qv, *(_split_heads(x, h) for x in (k, v)), p,
                                        _split_heads(o, h), lse, _split_heads(do, h), scale, band)
    return (_merge_heads(dqu + dqv), _merge_heads(dk), _merge_heads(dv), dqu.sum((0, 2)),
            dqv.sum((0, 2)), dp)


def grad_output(shape, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)


BWD_KEYS = 128  # keys a block of the flash backward (csrc/flash_bwd.cuh: FB_KEYS)


def side_rows_held(side, ref, oh, doh):
    """(within, delta's max abs error, report) of a pre-pass's side rows
    against its plain version's: the base-2 log-sum-exp to an f32 rounding
    (+inf where the plain version has it), delta to twice the f32 error of a
    d-term dot (2 * d * 2^-24 * rowsum |dO||O|, both sides summing in their
    own order)."""
    import torch

    t, d = oh.shape[2], oh.shape[3]
    inf = torch.isinf(ref[..., 0])
    l2_ok = bool((torch.isinf(side[..., 0]) == inf).all())
    l2_rel = float(((side[..., 0] - ref[..., 0]).abs() / ref[..., 0].abs().clamp_min(1e-30))
                   [~inf].max())
    delta_err = (side[..., 1] - ref[..., 1]).abs()
    terms = torch.zeros_like(delta_err)
    terms[..., :t] = (doh.float().abs() * oh.float().abs()).sum(-1)
    delta_worst = float(torch.where(delta_err == 0, 0.0,
                                    delta_err / (2 * d * 2.0 ** -24 * terms)).max())
    ok = l2_ok and l2_rel <= 2.0 ** -22 and delta_worst <= 1.0
    return ok, float(delta_err.max()), (
        f"L*log2e max rel err {l2_rel:.3e} (limit {2.0 ** -22:.2e}), inf rows alike {l2_ok}; "
        f"delta max_abs_err {float(delta_err.max()):.3e}, max err/bound {delta_worst:.3f} "
        "(limit 1)")


def check_bwd_passes(results, o, lse, do, h):
    """The flash backwards' pre- and post-pass against their plain versions on
    the row-8 operands (heads-in-lanes views): the side rows as
    :func:`side_rows_held` holds them, the workspace, filled with NaN first, to
    zeros; the post-pass's bf16 dq with the forward's element-wise bound (one
    rounding)."""
    import torch

    from transformer4sed_tpu_torch.kernels.flash_attention import (
        _split_heads,
        bwd_padded_rows,
        flash_bwd_postpass,
        flash_bwd_postpass_reference,
        flash_bwd_prepass,
        flash_bwd_prepass_reference,
    )

    oh, doh = _split_heads(o, h), _split_heads(do, h)
    b, _, t, d = oh.shape
    tp = bwd_padded_rows(t)
    work = torch.full((b, h, tp, d), float("nan"), device="cuda")
    side, work = flash_bwd_prepass(oh, doh, lse, dq_acc=work)
    ref, _ = flash_bwd_prepass_reference(oh.float(), doh.float(), lse)
    ok, delta_err, report = side_rows_held(side, ref, oh, doh)
    zeroed = bool((work == 0).all())
    ok = ok and zeroed
    log(f"kernel flash_bwd_prepass B={b} H={h} T={t}: {report}; workspace zeroed {zeroed}: "
        f"{'within' if ok else 'OUTSIDE'}")
    check(ok, "flash_bwd_prepass disagrees with its plain version")
    results["flash_bwd_prepass"]["max_abs_err"] = delta_err

    gen = torch.Generator(device="cuda").manual_seed(t)
    work = torch.randn(b, h, tp, d, generator=gen, device="cuda")
    scale = d ** -0.5
    dq = torch.empty(o.shape, dtype=torch.bfloat16, device="cuda")
    out = flash_bwd_postpass(work, _split_heads(dq, h), scale)
    ref = flash_bwd_postpass_reference(work, torch.empty(oh.shape, device="cuda"), scale)
    ok, mx = held(f"kernel flash_bwd_postpass B={b} H={h} T={t}", out, ref, 0.0)
    check(ok and out.data_ptr() == dq.data_ptr(),
          "flash_bwd_postpass disagrees with its plain version")
    results["flash_bwd_postpass"]["max_abs_err"] = mx


# planted faults of the XL backward kernel (rows 11 and 13), fed to both
XL_BWD_FAULTS = (("skip_dq_tile", "the last key tile's dQ partial left out"),
                 ("clamp_strip", "the strip pieces' start clamped at P row 0, not zero-filled"),
                 ("no_flush", "the last step's dP carry never added"))


def check_xl_bwd_passes(results, o, lse, do, h, scale, q=None, bu=None, bv=None):
    """The XL backwards' pre- and post-pass against their plain versions, on
    row 13's operands (with q and the biases) or row 11's ([B, H, T, d] views):
    the side rows as :func:`side_rows_held` holds them, both workspaces, filled with
    NaN first, to zeros, qu and qv equal to the bit; the post-pass's bf16
    dq (and dqv) and dP from a random workspace to one rounding, and its
    dbu and dbv, f32 sums of B * ceil(T / 128) column sums in another order,
    to twice 2^-24 * that count * the sum of their absolute values (each
    order's worst case, Higham)."""
    import torch

    from transformer4sed_tpu_torch.kernels.flash_attention import _split_heads, bwd_padded_rows
    from transformer4sed_tpu_torch.kernels.xl_attention import (
        XB_KEYS,
        flash_xl_bwd_postpass,
        flash_xl_bwd_postpass_reference,
        flash_xl_bwd_prepass,
        flash_xl_bwd_prepass_reference,
        xl_bwd_dp_rows,
    )

    lanes = q is not None
    oh, doh, qh = ((_split_heads(x, h) for x in (o, do, q)) if lanes else (o, do, None))
    b, _, t, d = oh.shape
    cols = d if lanes else 2 * d
    tp, n_kt = bwd_padded_rows(t), -(-t // XB_KEYS)
    ws = torch.full((b * h * tp * cols + h * xl_bwd_dp_rows(t) * d,), float("nan"),
                    device="cuda")
    side, dq_acc, dp_acc, qu, qv = flash_xl_bwd_prepass(oh, doh, lse, cols, qh, bu, bv, ws=ws)
    ref = flash_xl_bwd_prepass_reference(oh.float(), doh.float(), lse, cols, qh, bu, bv)
    ok, delta_err, report = side_rows_held(side, ref[0], oh, doh)
    zeroed = bool((ws == 0).all())
    # the same f32 sum rounded once on both sides: qu and qv equal to the bit
    same = not lanes or bool(torch.equal(qu, ref[3]) and torch.equal(qv, ref[4]))
    ok = ok and zeroed and same
    tag = f"B={b} H={h} T={t} d={d}"
    log(f"kernel flash_xl_bwd_prepass {tag}: {report}; workspaces zeroed {zeroed}; qu, qv equal "
        f"{same}: {'within' if ok else 'OUTSIDE'}")
    check(ok, "flash_xl_bwd_prepass disagrees with its plain version")

    gen = torch.Generator(device="cuda").manual_seed(t)
    dq_acc.copy_(torch.randn(dq_acc.shape, generator=gen, device="cuda"))
    dp_acc.copy_(torch.randn(dp_acc.shape, generator=gen, device="cuda"))
    colsum = torch.randn(b, h, n_kt, 2, d, generator=gen, device="cuda") if lanes else None
    bf = dict(dtype=torch.bfloat16, device="cuda")
    dq, dqv = (torch.empty(b, t, h, d, **bf).permute(0, 2, 1, 3) for _ in range(2))
    dp = torch.empty(h, 2 * t - 1, d, **bf)
    got = flash_xl_bwd_postpass(dq_acc, dp_acc, colsum, scale, dq, None if lanes else dqv, dp)
    f32 = dict(dtype=torch.float32, device="cuda")
    want = flash_xl_bwd_postpass_reference(
        dq_acc, dp_acc, colsum, scale, torch.empty(dq.shape, **f32),
        None if lanes else torch.empty(dq.shape, **f32), torch.empty(dp.shape, **f32))
    oks, worst = [], 0.0
    for name, i in (("dq", 0), ("dqv", 1), ("dP", 2)):
        if got[i] is not None:
            ok, mx = held(f"kernel flash_xl_bwd_postpass {tag} {name}", got[i], want[i], 0.0)
            oks.append(ok)
            worst = max(worst, mx)
    if lanes:
        err = (got[3] - want[3]).abs()
        tol = 2 * 2.0 ** -24 * b * n_kt * colsum.abs().sum((0, 2)).transpose(0, 1) * abs(scale)
        ratio = float(torch.where(err == 0, 0.0, err / tol).max())
        log(f"kernel flash_xl_bwd_postpass {tag} dbu, dbv: max_abs_err {float(err.max()):.3e}, "
            f"max err/bound {ratio:.3f} (limit 1): {'within' if ratio <= 1 else 'OUTSIDE'}")
        oks.append(ratio <= 1.0)
    check(all(oks), "flash_xl_bwd_postpass disagrees with its plain version")
    if lanes:
        results["flash_xl_bwd_prepass"]["max_abs_err"] = delta_err
        results["flash_xl_bwd_postpass"]["max_abs_err"] = worst


def check_train_kernels(results, rejected):
    """Rows 7, 8, 12 and 13: the LSE forwards (output and lse) and the
    backwards (every cotangent, fed the kernel forward's own o and lse)
    against their plain versions in f32 on the same bf16 inputs, at the
    train step's shapes (B=24) and on ragged and banded cases (rows 12 and
    13 also at HTSAT_CNN's T = 320, T = 5 and T = 193); then eight planted
    faults fed to the backwards, and the backwards' passes."""
    import math

    import torch

    from transformer4sed_tpu_torch.kernels.flash_attention import (
        flash_attention_nhd_backward,
        flash_attention_nhd_backward_reference,
        flash_attention_nhd_lse,
        flash_attention_nhd_lse_reference,
        flash_attention_nhd_reference,
    )
    from transformer4sed_tpu_torch.kernels.xl_attention import (
        XB_FAULTS,
        flash_xl_attention_nhd_backward,
        flash_xl_attention_nhd_lse,
        xl_attention_nhd_backward_reference,
        xl_attention_nhd_lse_reference,
    )

    names = ("dq", "dk", "dv")
    # B=32 N=602: finetune2's window groups (602 = 4 * 128 + 90 keys, a ragged
    # last key tile of the backward's 128)
    for b, n, c, h, main in ((24, 1190, 768, 12, True), (2, 77, 768, 12, False),
                             (1, 130, 256, 4, False), (32, 602, 768, 12, False)):
        tag = f"B={b} N={n} C={c} H={h}"
        q, k, v = flash_inputs(b, n, c, seed=n + 1)
        qf, kf, vf = q.float(), k.float(), v.float()
        do = grad_output((b, n, c), seed=n + 2)
        out, lse = flash_attention_nhd_lse(q, k, v, h)
        ref, ref_lse = flash_attention_nhd_lse_reference(qf, kf, vf, h)
        ok_o, mx_o = held(f"kernel flash_attention_nhd_lse {tag} out", out, ref,
                          flash_attention_nhd_reference(qf, kf, vf.abs(), h))
        ok_l, mx_l = lse_held(f"kernel flash_attention_nhd_lse {tag}", lse, ref_lse)
        check(ok_o and ok_l, "flash_attention_nhd_lse disagrees with its plain version")
        del ref, ref_lse
        refs = flash_attention_nhd_backward_reference(qf, kf, vf, out.float(), lse, do.float(), h)
        terms = flash_bwd_terms(q, k, v, out, lse, do, h)
        grads = flash_attention_nhd_backward(q, k, v, out, lse, do, h)
        ok, mx = held_all(f"kernel flash_attention_nhd_backward {tag}", names, grads, refs, terms)
        check(ok, "flash_attention_nhd_backward disagrees with its plain version")
        if main:
            results["flash_attention_nhd_lse"]["max_abs_err"] = max(mx_o, mx_l)
            results["flash_attention_nhd_backward"]["max_abs_err"] = mx
            bad = flash_attention_nhd_backward(q, k, v, out, lse + math.log(2.0), do, h)
            rejected.append(held_all("planted fault: lse shifted by log 2", names, bad, refs,
                                     terms)[0])
            bad = flash_attention_nhd_backward(q, k, v, torch.zeros_like(out), lse, do, h)
            rejected.append(held_all("planted fault: O zeroed (delta dropped)", names, bad, refs,
                                     terms)[0])
            bad = flash_attention_nhd_backward(q, k, v, out, lse, do, h,
                                               skip_dq_tile=(n - 1) // BWD_KEYS)
            rejected.append(held_all("planted fault: the last key tile's dQ partial left out",
                                     names, bad, refs, terms)[0])
            check_bwd_passes(results, out, lse, do, h)
        del refs, terms, grads
        torch.cuda.empty_cache()

    names = ("dq", "dk", "dv", "dbu", "dbv", "dP")
    # T = 320: HTSAT_CNN's decoder; 5: under one key tile; 193: a strip tile
    # of the forward past P row 2T-2
    for b, t, c, h, band, main in ((24, 1000, 768, 12, None, True),
                                   (2, 77, 768, 12, None, False),
                                   (1, 130, 256, 4, (3, 20, 1, 260), False),
                                   (64, 320, 768, 12, None, False),
                                   (1, 5, 768, 12, None, False),
                                   (2, 193, 768, 12, None, False)):
        tag = f"B={b} T={t} C={c} H={h} band={band}"
        q, k, v, bu, bv, p = xl_inputs(b, t, c, h, seed=t + 1)
        scale = (c // h) ** -0.5
        do = grad_output((b, t, c), seed=t + 2)
        out, lse = flash_xl_attention_nhd_lse(q, k, v, bu, bv, p, h, scale, band)

        def ref_fwd(vv):  # q stays bf16: q+u and q+v round as in the kernel
            return xl_attention_nhd_lse_reference(q, k.float(), vv, bu, bv, p.float(), h, scale,
                                                  band)

        ref, ref_lse = ref_fwd(v.float())
        ok_o, mx_o = held(f"kernel flash_xl_attention_nhd_lse {tag} out", out, ref,
                          ref_fwd(v.float().abs())[0])
        ok_l, mx_l = lse_held(f"kernel flash_xl_attention_nhd_lse {tag}", lse, ref_lse)
        check(ok_o and ok_l, "flash_xl_attention_nhd_lse disagrees with its plain version")
        del ref, ref_lse
        refs = xl_attention_nhd_backward_reference(q, k.float(), v.float(), bu, bv, p.float(),
                                                   out.float(), lse, do.float(), h, scale, band)
        terms = xl_bwd_terms(q, k, v, bu, bv, p, out, lse, do, h, scale, band)
        grads = flash_xl_attention_nhd_backward(q, k, v, bu, bv, p, out, lse, do, h, scale, band)
        ok, mx = held_all(f"kernel flash_xl_attention_nhd_backward {tag}", names, grads, refs,
                          terms)
        check(ok, "flash_xl_attention_nhd_backward disagrees with its plain version")
        if main:
            results["flash_xl_attention_nhd_lse"]["max_abs_err"] = max(mx_o, mx_l)
            results["flash_xl_attention_nhd_backward"]["max_abs_err"] = mx
            bad = flash_xl_attention_nhd_backward(q, k, v, bu, bv, p.roll(1, dims=1), out, lse,
                                                  do, h, scale)
            rejected.append(held_all("planted fault: P rolled one row (dP scatter off by one)",
                                     names, bad, refs, terms)[0])
            bad = flash_xl_attention_nhd_backward(q, k, v, bu, torch.zeros_like(bv), p, out, lse,
                                                  do, h, scale)
            rejected.append(held_all("planted fault: pos_bias_v dropped in the backward", names,
                                     bad, refs, terms)[0])
            for fault, what in XL_BWD_FAULTS:
                bad = flash_xl_attention_nhd_backward(q, k, v, bu, bv, p, out, lse, do, h, scale,
                                                      fault=XB_FAULTS[fault])
                rejected.append(held_all(f"planted fault: {what}", names, bad, refs, terms)[0])
            check_xl_bwd_passes(results, out, lse, do, h, scale, q, bu, bv)
        del refs, terms, grads
        torch.cuda.empty_cache()


# -- phase 2, rows 14 and 15: Swin window attention ---------------------------------

# HTSAT-tiny (config/audioset_strong/htsat_cnn.yaml: spec 256, patch 4, window
# 8, head dim 24): (heads, windows per image) of stages 0..3, at the recipe's
# batch of 64: 64 * nW * H = 16384, 8192, 4096 and 2048 (window, head) pairs
HTSAT_STAGES = ((4, 64), (8, 16), (16, 4), (32, 1))
HTSAT_BATCH = 64
# dbias and dshift are f32 sums of the f32 dS over n_terms windows: each
# block's over its windows in registers, the blocks' added by TMA reductions
# in an order that changes from run to run: |sum - ref| <= 2^-24 * (n_terms
# + F32_TERM) * sum |dS|, the worst case of an f32 sum (Higham) plus F32_TERM
# ulps for each term's own f32 error (24- and 64-term dots, exp2 for exp)
F32_TERM = 512
# the Swin blocks an HTSAT_CNN step runs at each stage, (unshifted, shifted):
# depths (2, 2, 6, 2), every second block shifted where the stage has more
# than one window (stage 3 has one)
HTSAT_STAGE_BLOCKS = ((1, 1), (1, 1), (3, 3), (2, 0))
# (H, nW, B, shifted): the heads a rank under tensor parallelism (HTSAT stage
# 0 at tp2, and one head: the kernels' G = 1 walk), at B=3, three windows a
# position, an odd count; and one head over stage 0's 4096 windows unshifted:
# odd counts of 31 windows a block, 16 steps, past the wrap of either ring
WINDOW_FEW_HEADS = ((2, 64, 3, True), (1, 64, 3, True), (1, 64, 64, False))


def window_inputs(b, h, nw, shifted, seed):
    """(qkv, q, k, v, bias, mask): q, k, v as the model makes them, lane views
    [B*nW, 64, H, 24] of one bf16 qkv projection [B*nW, 64, 3, H, 24]; a
    bias [H, 64, 64] f32; the additive 0 / -100 shift mask [nW, 64, 64] of
    the stage's resolution (or None)."""
    import math

    import torch

    from transformer4sed_tpu_torch.models.htsat import _shift_attn_mask

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b * nw, 64, 3, h, 24, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    bias = torch.randn(h, 64, 64, generator=gen, device="cuda") * 0.5
    mask = None
    if shifted:
        res = 8 * math.isqrt(nw)
        mask = torch.from_numpy(_shift_attn_mask(res, res, 8, 4)).cuda()
        check(mask.shape == (nw, 64, 64), f"shift mask {tuple(mask.shape)} for {nw} windows")
    return qkv, q, k, v, bias, mask


def f32_held(what, out, ref, abs_sum, n_terms):
    """Log an f32 sum's error against its bound (F32_TERM above); return
    (within, max abs error)."""
    import torch

    err = (out.float() - ref).abs()
    # + 1e-30: where every term underflows (P = exp(-100) under a shift mask)
    # the bound is 0 and a denormal on one side would read as inf
    tol = 2.0 ** -24 * (n_terms + F32_TERM) * abs_sum + 1e-30
    worst = float(torch.where(err == 0, 0.0, err / tol).max())
    ok = worst <= 1.0
    log(f"{what}: max_abs_err {float(err.max()):.3e}, max err/bound {worst:.3f} (limit 1, f32 sum "
        f"of {n_terms} terms): {'within' if ok else 'OUTSIDE'}")
    return ok, float(err.max())


def window_bwd_terms(q, k, v, o, g, bias, mask, nw, scale):
    """The window backward's products on absolute values: scale |dS| |K| for
    dq, scale |dS|^T |Q| for dk, P^T |G| for dv (|dS| with its f32 term in
    units of u, as for the other backwards), and sum |dS| over the windows
    for dbias and dshift (with the f32 term at face value)."""
    import torch

    from transformer4sed_tpu_torch.kernels.window_attention import _scores

    qf, kf, vf, gf, of = (x.float() for x in (q, k, v, g, o))
    p = torch.softmax(_scores(q, k, bias, mask, nw, scale), dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = (gf * of).sum(-1).transpose(1, 2)[..., None]
    ads = (p * (dp - delta)).abs()
    del dp
    f32 = p * (torch.einsum("bqhd,bkhd->bhqk", gf.abs(), vf.abs())
               + (gf.abs() * of.abs()).sum(-1).transpose(1, 2)[..., None])
    sums = ads + f32
    ads = ads + F32_DOT * f32
    del f32
    terms = [torch.einsum("bhqk,bkhd->bqhd", ads, kf.abs()) * scale,
             torch.einsum("bhqk,bqhd->bkhd", ads, qf.abs()) * scale,
             torch.einsum("bhqk,bqhd->bkhd", p, gf.abs()),
             sums.sum(0)]
    if mask is not None:
        terms.append(sums.reshape(-1, nw, *sums.shape[1:]).sum((0, 2)))
    return terms


def window_bwd_held(what, grads, refs, terms, n_windows_total, heads, nw):
    """dq, dk, dv against the bf16 bound, dbias and dshift against the f32
    one; (all within, max abs error)."""
    ok, worst = held_all(what, ("dq", "dk", "dv"), grads[:3], refs[:3], terms[:3])
    ok_b, mx = f32_held(f"{what} dbias", grads[3], refs[3], terms[3], n_windows_total)
    oks, worst = [ok, ok_b], max(worst, mx)
    if refs[4] is not None:
        ok_s, mx = f32_held(f"{what} dshift", grads[4], refs[4], terms[4],
                            heads * n_windows_total // nw)
        oks.append(ok_s)
        worst = max(worst, mx)
    return all(oks), worst


def check_window_kernels(results, rejected):
    """Rows 14 and 15 against their plain versions in f32 on the same bf16
    inputs, at the four HTSAT stage shapes at B=64, shifted and unshifted,
    and at stage 0's windows with two heads and with one (WINDOW_FEW_HEADS;
    the backward fed the kernel forward's own output); then six planted
    faults: head 0's bias for every head, window 0's shift mask for every
    window, head-dim lanes 24..31 read from the neighbouring head, a dbias
    that misses the last window, K read from the slot of the group's other
    head (csrc/window.cuh: WA_FAULT_SLOT, forward and backward), and the
    last chunk's dbias and dshift reductions skipped (WA_FAULT_SKIP_REDUCE,
    at stage 2 shifted: four chunks; dbias and dshift each held)."""
    import torch

    from transformer4sed_tpu_torch.kernels.window_attention import (
        WA_FAULTS,
        window_attention,
        window_attention_backward,
        window_attention_backward_plain,
        window_attention_plain,
    )

    scale = 24 ** -0.5
    worst_fwd = worst_bwd = 0.0
    cases = [(stage, h, nw, HTSAT_BATCH, shifted, 10 * stage)
             for stage, (h, nw) in enumerate(HTSAT_STAGES) for shifted in (False, True)]
    cases += [(0, h, nw, b, shifted, 100 + 10 * h + b)
              for h, nw, b, shifted in WINDOW_FEW_HEADS]
    for stage, h, nw, b, shifted, seed in cases:
        tag = f"stage {stage} B={b} nW={nw} H={h} {'shifted' if shifted else 'plain'}"
        qkv, q, k, v, bias, mask = window_inputs(b, h, nw, shifted, seed=seed)
        bnw = q.shape[0]
        qf, kf, vf = q.float(), k.float(), v.float()
        ref = window_attention_plain(qf, kf, vf, bias, mask, nw, scale)
        ref_abs_v = window_attention_plain(qf, kf, vf.abs(), bias, mask, nw, scale)
        out = window_attention(q, k, v, bias, mask, nw, scale)
        ok, mx = held(f"kernel window_attention {tag}", out, ref, ref_abs_v)
        check(ok, "window_attention disagrees with its plain version")
        worst_fwd = max(worst_fwd, mx)
        if stage == 0 and shifted and h == HTSAT_STAGES[0][0]:
            bad = window_attention(q, k, v, bias, mask, nw, scale, fault=WA_FAULTS["slot"])
            rejected.append(held("planted fault: K read from the group's other head's slot",
                                 bad, ref, ref_abs_v)[0])
            bad = window_attention(q, k, v, bias[:1].expand(h, -1, -1).contiguous(), mask, nw,
                                   scale)
            rejected.append(held("planted fault: head 0's bias for every head", bad, ref,
                                 ref_abs_v)[0])
            bad = window_attention(q, k, v, bias, mask[:1].expand(nw, -1, -1).contiguous(),
                                   nw, scale)
            rejected.append(held("planted fault: window 0's shift mask for every window", bad,
                                 ref, ref_abs_v)[0])
            # a kernel that padded the head dim to 32 by reading on: 32-lane
            # q and k slices of the qkv row, lanes 24..31 the next head's
            rows = qkv.reshape(bnw, 64, 3 * h * 24).float()
            c = h * 24
            q32 = torch.stack([rows[..., i * 24:i * 24 + 32] for i in range(h)], 2)
            k32 = torch.stack([rows[..., c + i * 24:c + i * 24 + 32] for i in range(h)], 2)
            bad = window_attention_plain(q32, k32, vf, bias, mask, nw, scale)
            rejected.append(held("planted fault: lanes 24..31 read from the next head",
                                 bad.to(torch.bfloat16), ref, ref_abs_v)[0])
            del rows, q32, k32, bad
        del ref, ref_abs_v

        g = grad_output(tuple(q.shape), seed=seed + 1)
        refs = window_attention_backward_plain(qf, kf, vf, out.float(), g.float(), bias, mask,
                                               nw, scale)
        terms = window_bwd_terms(q, k, v, out, g, bias, mask, nw, scale)
        grads = window_attention_backward(q, k, v, out, g, bias, mask, nw, scale)
        ok, mx = window_bwd_held(f"kernel window_attention_backward {tag}", grads, refs, terms,
                                 bnw, h, nw)
        check(ok, "window_attention_backward disagrees with its plain version")
        worst_bwd = max(worst_bwd, mx)
        if stage == 0 and shifted and h == HTSAT_STAGES[0][0]:
            bad = window_attention_backward(q, k, v, out, g, bias, mask, nw, scale,
                                            fault=WA_FAULTS["slot"])
            rejected.append(window_bwd_held(
                "planted fault: K read from the group's other head's slot", bad, refs, terms,
                bnw, h, nw)[0])
        if stage == 3 and not shifted:
            bad = window_attention_backward(q[:-1], k[:-1], v[:-1], out[:-1], g[:-1], bias,
                                            None, 1, scale)
            rejected.append(f32_held("planted fault: dbias misses the last window", bad[3],
                                     refs[3], terms[3], bnw)[0])
        if stage == 2 and shifted:
            bad = window_attention_backward(q, k, v, out, g, bias, mask, nw, scale,
                                            fault=WA_FAULTS["skip_reduce"])
            what = "planted fault: the last chunk's dbias and dshift reductions skipped"
            rejected.append(f32_held(f"{what}: dbias", bad[3], refs[3], terms[3], bnw)[0])
            rejected.append(f32_held(f"{what}: dshift", bad[4], refs[4], terms[4],
                                     h * bnw // nw)[0])
        del refs, terms, grads, qf, kf, vf
        torch.cuda.empty_cache()
    results["window_attention"]["max_abs_err"] = worst_fwd
    results["window_attention_backward"]["max_abs_err"] = worst_bwd


# -- phase 2, rows 9, 10 and 11: head-major XL attention ------------------------------

# PMAM's decoder (config/pmam/finetune1.yaml): 384 wide, 12 heads of 32, T=1000;
# served at B=8, trained at B=18 (training.batch_size [4, 2, 6, 6])
PMAM_HEADS, PMAM_HEAD_DIM, PMAM_SERVE_BATCH, PMAM_TRAIN_BATCH = 12, 32, 8, 18


def hm_inputs(b, t, h, d, seed):
    """(qu, qv, k, v, p) as ``flash_xl_attention_nhd`` hands them to the
    head-major kernels: k and v strided [B, H, T, d] views of one bf16
    [B, T, 3*H*d] projection, qu and qv the q slice plus each f32 bias
    rounded to bf16, p a [2T-1, H*d] projection viewed as [H, 2T-1, d]."""
    from transformer4sed_tpu_torch.kernels.flash_attention import _split_heads
    from transformer4sed_tpu_torch.kernels.xl_attention import add_pos_bias

    q, k, v, bu, bv, p = xl_inputs(b, t, h * d, h, seed)
    qu, qv = add_pos_bias(q, bu, bv, h)
    return qu, qv, _split_heads(k, h), _split_heads(v, h), p


def hm_bwd_terms(qu, qv, k, v, p, o, lse, do, scale, band):
    """The head-major backward's products on absolute values: scale |dS||K|
    for dqu, scale unshift|dS| |P| for dqv, scale |dS|^T |qu| for dk,
    A^T |dO| for dv, and scale unshift|dS|^T |qv| summed over batch for dP."""
    import torch

    from transformer4sed_tpu_torch.kernels.xl_attention import _hm_scores, rel_unshift

    scores, mask = _hm_scores(qu, qv, k.float(), p.float(), scale, band)
    a = torch.exp(scores - lse[..., None])
    del scores
    if mask is not None:
        a = a.masked_fill(mask[None], 0.0)
    vf, dof = v.float(), do.float()
    ads = (a * (torch.matmul(dof, vf.transpose(-1, -2))
                - (dof * o.float()).sum(-1)[..., None])).abs()
    ads += F32_DOT * a * (torch.matmul(dof.abs(), vf.abs().transpose(-1, -2))
                          + (dof.abs() * o.float().abs()).sum(-1)[..., None])
    skew = rel_unshift(ads)
    return (torch.matmul(ads, k.float().abs()) * scale,
            torch.matmul(skew, p.float().abs()[None]) * scale,
            torch.matmul(ads.transpose(-1, -2), qu.float().abs()) * scale,
            torch.matmul(a.transpose(-1, -2), dof.abs()),
            torch.matmul(skew.transpose(-1, -2), qv.float().abs()).sum(0) * scale)


def check_hm_kernels(results, rejected):
    """Rows 9, 10 and 11 against their plain versions in f32 on the same bf16
    inputs: at PMAM's decoder shapes ([8, 12, 1000, 32] served, [18, 12, 1000,
    32] trained) from strided views of [B, T, 3*384] projections, on small
    ragged and banded cases, at head dim 64, and the forward once at
    [2, 12, 3000, 64] (the 30-s PaSST variant's decoder length); the backward
    is fed the kernel forward's own o and lse, and its dP is held to the bf16
    bound plus an f32-sum term; the backward also at [2, 12, 3000, 64]. Then
    eight planted faults: qv read for qu, k's head stride taken as its row
    stride, a band one key wider, dqu and dqv swapped, a dP that misses the
    last batch, and XL_BWD_FAULTS; and the backward's passes at head dim 32.
    The forward at d = 32 also with three planted faults of its body
    (XL_FWD_FAULTS but round_u, which its mode refuses) and at a negative
    and a zero scale."""
    import torch

    from transformer4sed_tpu_torch.kernels.xl_attention import (
        XB_FAULTS,
        XF_FAULTS,
        _hm_forward_kernel,
        flash_xl_attention,
        flash_xl_attention_backward,
        flash_xl_attention_backward_reference,
        flash_xl_attention_lse,
        flash_xl_attention_lse_reference,
        flash_xl_attention_reference,
    )

    h, d = PMAM_HEADS, PMAM_HEAD_DIM
    pmam_band = (1, 2, 5, 16, 31, 64, 100, 128, 255, 500, 999, 2000)
    cases = [  # (b, t, h, d, band, main path?)
        (PMAM_SERVE_BATCH, 1000, h, d, None, True),
        (PMAM_SERVE_BATCH, 1000, h, d, pmam_band, False),
        (2, 77, h, d, None, False),
        (1, 130, 4, 32, (3, 20, 1, 260), False),
        (2, 203, 6, 64, (7, 64, 1, 500, 33, 128), False),
        (2, 3000, 12, 64, None, False),
    ]
    for b, t, hh, dd, band, main in cases:
        tag = f"B={b} H={hh} T={t} d={dd} band={band}"
        qu, qv, k, v, p = hm_inputs(b, t, hh, dd, seed=t)
        scale = dd ** -0.5

        def ref_of(vv, widths=band):
            return flash_xl_attention_reference(qu, qv, k.float(), vv, p.float(), scale, widths)

        ref, ref_abs_v = ref_of(v.float()), ref_of(v.float().abs())
        out = flash_xl_attention(qu, qv, k, v, p, scale, band)
        check(out.shape == qu.shape and out.transpose(1, 2).is_contiguous(),
              "flash_xl_attention returns a [B, H, T, d] view of a [B, T, H, d] buffer")
        ok, mx = held(f"kernel flash_xl_attention {tag}", out, ref, ref_abs_v)
        check(ok, "flash_xl_attention disagrees with its plain version")
        if main:
            results["flash_xl_attention"]["max_abs_err"] = mx
            out = flash_xl_attention(qv, qv, k, v, p, scale)
            rejected.append(held("planted fault: qv read for qu", out, ref, ref_abs_v)[0])
            s = k.stride()  # [B, H, T, d]: the head and the row stride change places
            bad_k = k.as_strided(k.shape, (s[0], s[2], s[1], s[3]), k.storage_offset())
            out = flash_xl_attention(qu, qv, bad_k, v, p, scale)
            rejected.append(held("planted fault: k's head stride taken as its row stride", out,
                                 ref, ref_abs_v)[0])
            for fault, what in XL_FWD_FAULTS[:3]:
                out, _ = _hm_forward_kernel(qu, qv, k, v, p, scale, None, with_lse=False,
                                            fault=XF_FAULTS[fault])
                rejected.append(held(f"planted fault: {what} (head major, d={dd})", out, ref,
                                     ref_abs_v)[0])
            try:  # the biases are given: nothing to round
                _hm_forward_kernel(qu, qv, k, v, p, scale, None, with_lse=False,
                                   fault=XF_FAULTS["round_u"])
                refused = False
            except RuntimeError:
                refused = True
            check(refused, "the head-major forward took the round_u fault, which has no bias")
        if band == pmam_band:
            wider = tuple(w + 2 for w in band)
            out = flash_xl_attention(qu, qv, k, v, p, scale, wider)
            rejected.append(held("planted fault: band one key wider each side", out, ref,
                                 ref_abs_v)[0])
        del ref, ref_abs_v, out
        torch.cuda.empty_cache()
    # rows 9 and 10 take any scale the reference takes: negative and zero too
    qu, qv, k, v, p = hm_inputs(2, 203, h, d, seed=204)
    kf, vf, pf = k.float(), v.float(), p.float()
    for scale in (-0.125, 0.0):
        tag = f"B=2 H={h} T=203 d={d} scale={scale}"
        ref, ref_lse = flash_xl_attention_lse_reference(qu, qv, kf, vf, pf, scale)
        ref_abs_v = flash_xl_attention_reference(qu, qv, kf, vf.abs(), pf, scale)
        out = flash_xl_attention(qu, qv, k, v, p, scale)
        ok, _ = held(f"kernel flash_xl_attention {tag}", out, ref, ref_abs_v)
        out, lse = flash_xl_attention_lse(qu, qv, k, v, p, scale)
        ok_o, _ = held(f"kernel flash_xl_attention_lse {tag} out", out, ref, ref_abs_v)
        ok_l, _ = lse_held(f"kernel flash_xl_attention_lse {tag}", lse, ref_lse)
        check(ok and ok_o and ok_l, f"rows 9 and 10 disagree with their plain versions at "
              f"scale {scale}")

    names = ("dqu", "dqv", "dk", "dv", "dP")
    cases = [
        (PMAM_TRAIN_BATCH, 1000, h, d, None, True),
        (2, 77, h, d, None, False),
        (1, 130, 4, 32, (3, 20, 1, 260), False),
        (2, 203, 6, 64, (7, 64, 1, 500, 33, 128), False),
        (2, 3000, 12, 64, None, False),
    ]
    for b, t, hh, dd, band, main in cases:
        tag = f"B={b} H={hh} T={t} d={dd} band={band}"
        qu, qv, k, v, p = hm_inputs(b, t, hh, dd, seed=t + 1)
        scale = dd ** -0.5
        # dO as autograd hands it over: the gradient of the merged [B, T, H*d] output
        do = grad_output((b, t, hh, dd), seed=t + 2).permute(0, 2, 1, 3)
        out, lse = flash_xl_attention_lse(qu, qv, k, v, p, scale, band)

        def ref_fwd(vv):
            return flash_xl_attention_lse_reference(qu, qv, k.float(), vv, p.float(), scale, band)

        ref, ref_lse = ref_fwd(v.float())
        ok_o, mx_o = held(f"kernel flash_xl_attention_lse {tag} out", out, ref,
                          ref_fwd(v.float().abs())[0])
        ok_l, mx_l = lse_held(f"kernel flash_xl_attention_lse {tag}", lse, ref_lse)
        check(ok_o and ok_l, "flash_xl_attention_lse disagrees with its plain version")
        del ref, ref_lse
        refs = flash_xl_attention_backward_reference(qu, qv, k.float(), v.float(), p.float(),
                                                     out.float(), lse, do.float(), scale, band)
        terms = list(hm_bwd_terms(qu, qv, k, v, p, out, lse, do, scale, band))
        # dP is an f32 sum of B * T products an element, added in an order that
        # changes from run to run (TMA reductions from different blocks): its
        # worst case, 2^-24 * B * T times the sum of |terms| (Higham), joins the
        # bf16 bound, in units of u
        terms[4] = terms[4] * (1.0 + 2.0 ** -24 * b * t / BF16_U)
        grads = flash_xl_attention_backward(qu, qv, k, v, p, out, lse, do, scale, band)
        ok, mx = held_all(f"kernel flash_xl_attention_backward {tag}", names, grads, refs, terms)
        check(ok, "flash_xl_attention_backward disagrees with its plain version")
        if main:
            results["flash_xl_attention_lse"]["max_abs_err"] = max(mx_o, mx_l)
            results["flash_xl_attention_backward"]["max_abs_err"] = mx
            swapped = (grads[1], grads[0]) + tuple(grads[2:])
            rejected.append(held_all("planted fault: dqu and dqv swapped", names, swapped, refs,
                                     terms)[0])
            bad = flash_xl_attention_backward(qu[:-1], qv[:-1], k[:-1], v[:-1], p, out[:-1],
                                              lse[:-1].contiguous(), do[:-1], scale)
            rejected.append(held("planted fault: dP misses the last batch", bad[4], refs[4],
                                 terms[4])[0])
            for fault, what in XL_BWD_FAULTS:
                bad = flash_xl_attention_backward(qu, qv, k, v, p, out, lse, do, scale,
                                                  fault=XB_FAULTS[fault])
                rejected.append(held_all(f"planted fault: {what}", names, bad, refs, terms)[0])
            check_xl_bwd_passes(results, out, lse, do, hh, scale)
        del refs, terms, grads
        torch.cuda.empty_cache()


# -- phase 2, rows 3, 5 and 6: head-major flash attention ---------------------------

# the flagship's backbone attention as the sharded blocks run it (tp=1: all 12
# heads of 64 per rank) in the parallel train step at B=24, T=1190: the
# teacher's forward (row 3), the student's LSE forward and backward (5, 6)
FLASH_HM_HEADS, FLASH_HM_DIM, FLASH_HM_T = 12, 64, 1190


def flash_hm_inputs(b, t, h, d, seed, strided=True):
    """q, k, v [B, H, T, d] bf16: strided views of one [B, T, 3*H*d]
    projection, as a sharded block hands them to ``tp_flash_attention`` (head
    stride d, row stride 3*H*d), or contiguous tensors."""
    import torch

    from transformer4sed_tpu_torch.kernels.flash_attention import _split_heads

    if strided:
        return tuple(_split_heads(x, h) for x in flash_inputs(b, t, h * d, seed))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(b, h, t, d, generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(3))


def hm_grad_output(b, t, h, d, seed, strided=True):
    """dO as autograd hands it over: the gradient of the merged [B, T, H*d]
    output viewed as [B, H, T, d], or a contiguous tensor."""
    if strided:
        return grad_output((b, t, h, d), seed).permute(0, 2, 1, 3)
    return grad_output((b, h, t, d), seed)


def hm_flash_bwd_terms(q, k, v, o, lse, do, scale):
    """The head-major backward's products on absolute values (the bound of
    :func:`flash_bwd_terms`): scale |dS||K| for dq, scale |dS|^T |Q| for dk,
    P^T |dO| for dv."""
    import torch

    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    pr = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    delta = (dof * of).sum(-1)[..., None]
    ads = (pr * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)).abs()
    ads += F32_DOT * pr * (torch.matmul(dof.abs(), vf.abs().transpose(-1, -2))
                           + (dof.abs() * of.abs()).sum(-1)[..., None])
    return (torch.matmul(ads, kf.abs()) * scale,
            torch.matmul(ads.transpose(-1, -2), qf.abs()) * scale,
            torch.matmul(pr.transpose(-1, -2), dof.abs()))


def check_flash_hm_kernels(results, rejected):
    """Rows 3, 5 and 6 against their plain versions in f32 on the same bf16
    inputs: [8, 12, 1190, 64] and [24, 12, 1190, 64] as strided views of
    [B, 1190, 2304] projections (the sharded flagship's teacher and
    student), [8, 12, 1190, 32] contiguous, and ragged T = 37 and 130; the
    backward is fed the kernel forward's own o and lse. Then six planted
    faults: the head stride taken as the row stride, the last key tile
    dropped, the LSE forward's last key tile left unmasked (TMA's zero keys
    counted), an LSE shifted by log 2 in the backward, the last key tile's
    dQ partial left out, and dk of head h written to head h+1."""
    import math

    import torch

    from transformer4sed_tpu_torch.kernels.flash_attention import (
        _hm_forward_kernel,
        flash_attention,
        flash_attention_backward,
        flash_attention_backward_reference,
        flash_attention_lse,
        flash_attention_lse_reference,
        flash_attention_reference,
    )

    h, d, t = FLASH_HM_HEADS, FLASH_HM_DIM, FLASH_HM_T
    cases = [  # (b, t, h, d, strided, main path?)
        (8, t, h, d, True, False),
        (24, t, h, d, True, True),
        (8, t, h, 32, False, False),
        (2, 37, 4, 64, True, False),
        (2, 130, 2, 32, False, False),
    ]
    for b, tt, hh, dd, strided, main in cases:
        tag = f"B={b} H={hh} T={tt} d={dd} {'strided' if strided else 'contiguous'}"
        q, k, v = flash_hm_inputs(b, tt, hh, dd, seed=tt + dd, strided=strided)
        scale = dd ** -0.5
        ref = flash_attention_reference(q.float(), k.float(), v.float(), scale)
        ref_abs_v = flash_attention_reference(q.float(), k.float(), v.float().abs(), scale)
        out = flash_attention(q, k, v)
        check(out.shape == q.shape and out.transpose(1, 2).is_contiguous(),
              "flash_attention returns a [B, H, T, d] view of a [B, T, H, d] buffer")
        ok, mx = held(f"kernel flash_attention {tag}", out, ref, ref_abs_v)
        check(ok, "flash_attention disagrees with its plain version")
        if main:
            results["flash_attention"]["max_abs_err"] = mx
            s = k.stride()  # [B, H, T, d]: the head and the row stride change places
            bad_k = k.as_strided(k.shape, (s[0], s[2], s[1], s[3]), k.storage_offset())
            out = flash_attention(q, bad_k, v)
            rejected.append(held("planted fault: k's head stride taken as its row stride", out,
                                 ref, ref_abs_v)[0])
            m = tt // 64 * 64  # a kernel that skipped the ragged last key tile
            out = flash_attention(q[:, :, :m], k[:, :, :m], v[:, :, :m])
            rejected.append(held(f"planted fault: last {tt - m} keys dropped", out,
                                 ref[:, :, :m], ref_abs_v[:, :, :m])[0])
        del ref, ref_abs_v, out
        torch.cuda.empty_cache()

    names = ("dq", "dk", "dv")
    cases = [(24, t, h, d, True, True), (8, t, h, 32, False, False),
             (2, 37, 4, 64, True, False), (2, 130, 2, 32, False, False)]
    for b, tt, hh, dd, strided, main in cases:
        tag = f"B={b} H={hh} T={tt} d={dd} {'strided' if strided else 'contiguous'}"
        q, k, v = flash_hm_inputs(b, tt, hh, dd, seed=tt + dd + 1, strided=strided)
        qf, kf, vf = q.float(), k.float(), v.float()
        scale = dd ** -0.5
        do = hm_grad_output(b, tt, hh, dd, seed=tt + 2, strided=strided)
        out, lse = flash_attention_lse(q, k, v)
        ref, ref_lse = flash_attention_lse_reference(qf, kf, vf, scale)
        ref_abs_v = flash_attention_reference(qf, kf, vf.abs(), scale)
        ok_o, mx_o = held(f"kernel flash_attention_lse {tag} out", out, ref, ref_abs_v)
        ok_l, mx_l = lse_held(f"kernel flash_attention_lse {tag}", lse, ref_lse)
        check(ok_o and ok_l, "flash_attention_lse disagrees with its plain version")
        if main:
            bad, _ = _hm_forward_kernel(q, k, v, scale, with_lse=True, skip_tail_mask=1)
            rejected.append(held("planted fault: the last key tile unmasked (zero keys counted)",
                                 bad, ref, ref_abs_v)[0])
            del bad
        del ref, ref_lse, ref_abs_v
        refs = flash_attention_backward_reference(qf, kf, vf, out.float(), lse, do.float(), scale)
        terms = hm_flash_bwd_terms(q, k, v, out, lse, do, scale)
        grads = flash_attention_backward(q, k, v, out, lse, do)
        ok, mx = held_all(f"kernel flash_attention_backward {tag}", names, grads, refs, terms)
        check(ok, "flash_attention_backward disagrees with its plain version")
        if main:
            results["flash_attention_lse"]["max_abs_err"] = max(mx_o, mx_l)
            results["flash_attention_backward"]["max_abs_err"] = mx
            bad = flash_attention_backward(q, k, v, out, lse + math.log(2.0), do)
            rejected.append(held_all("planted fault: lse shifted by log 2", names, bad, refs,
                                     terms)[0])
            bad = flash_attention_backward(q, k, v, out, lse, do,
                                           skip_dq_tile=(tt - 1) // BWD_KEYS)
            rejected.append(held_all("planted fault: the last key tile's dQ partial left out",
                                     names, bad, refs, terms)[0])
            moved = (grads[0], grads[1].roll(1, dims=1), grads[2])
            rejected.append(held_all("planted fault: dk of head h written to head h+1", names,
                                     moved, refs, terms)[0])
        del refs, terms, grads
        torch.cuda.empty_cache()


# -- phases 3 and 4: the served flagship ------------------------------------------

def desed_labels():
    with open(ROOT / "meta" / "desed" / "labeldict_DESED.json") as f:
        table = json.load(f)
    return [name for name, _ in sorted(table.items(), key=lambda kv: kv[1])]


def synthetic_bursts(n, seed):
    """n 10-s clips of noise plus three tone bursts each, and each clip's
    bursts as (onset, offset) seconds; clip 5 is 6.5 s long."""
    import numpy as np

    rng = np.random.RandomState(seed)
    t = np.arange(CLIP_SAMPLES) / SR
    clips, bursts = [], []
    for i in range(n):
        wav = 0.05 * rng.randn(CLIP_SAMPLES)
        bursts.append([])
        for _ in range(3):
            on = rng.uniform(0, 8)
            dur = rng.uniform(0.3, 2.0)
            f0 = rng.uniform(200, 4000)
            wav += np.sin(2 * np.pi * f0 * t) * ((t >= on) & (t < on + dur))
            bursts[-1].append((on, on + dur))
        if i == 5:
            wav = wav[:208000]
        clips.append(wav.astype(np.float32))
    return clips, bursts


def synthetic_clips(n, seed):
    """n 10-s clips of noise plus tone bursts; clip 5 is 6.5 s long."""
    return synthetic_bursts(n, seed)[0]


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


def serve(engine, results, per_batch=None, what="served"):
    """Three host batches through ``engine``: launches per batch as
    ``per_batch`` says (the flagship's 12 and 3 by default, then recorded),
    shapes, finiteness, events, zero padded frames."""
    import numpy as np

    clips = synthetic_clips(20, seed=1)
    batches = make_batches(clips, engine.codec, 8)
    check([len(b["filename"]) for b in batches] == [8, 8, 4], "batches of 8, 8 and 4 clips")
    reset_launches()
    served = list(engine.score_batches(batches))
    launches = read_launches()
    log(f"{what} {sum(len(n) for n, _, _ in served)} clips in {len(served)} batches; "
        f"launches {launches}")
    want = {name: 0 for name in launches}
    want.update({k: n * len(batches) for k, n in
                 (per_batch or dict(flash_attention_nhd=12, flash_xl_attention_nhd=3)).items()})
    check(launches == want, f"kernel launches {launches} on the {what} path, expected {want}")
    if per_batch is None:
        results["flash_attention_nhd"]["launches"] = launches["flash_attention_nhd"]
        results["flash_xl_attention_nhd"]["launches"] = launches["flash_xl_attention_nhd"]

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


def parity(card_engine, batches, build=None, what="flagship", clips=slice(4, 6)):
    """The same weights on ``clips`` of the first batch (clip 5 is the short
    one) in eval mode, with the engine's forward kwargs: CPU f32 (plain
    versions) against the card's bf16 (kernels), on strong, weak and at_out."""
    import numpy as np
    import torch

    state = {k: v.detach().cpu() for k, v in card_engine.model.state_dict().items()}
    cpu_engine = (build or build_engine)("cpu", torch.float32, state_dict=state)
    wav = torch.from_numpy(batches[0]["wav"][clips].copy())
    pm = torch.from_numpy(batches[0]["pad_mask"][clips].copy())
    outs = {}
    for name, engine in (("cpu_f32", cpu_engine), ("card_bf16", card_engine)):
        with torch.no_grad():
            mel = engine.frontend.normalize(engine.frontend(wav.to(engine.device)))
            out = engine.model(mel, pad_mask=pm.to(engine.device), **engine.model_kwargs)
        outs[name] = {k: getattr(out, k).float().cpu().numpy() for k in ("strong", "weak", "at_out")}
    worst = 0.0
    for key in ("strong", "weak", "at_out"):
        diff = float(np.abs(outs["cpu_f32"][key] - outs["card_bf16"][key]).max())
        worst = max(worst, diff)
        log(f"{what} card bf16 vs CPU f32 {key}: max_abs_diff {diff:.4e} (tol {DTYPE_MAX_ABS})")
    check(worst <= DTYPE_MAX_ABS, f"{what}: the card's path disagrees with the CPU f32 path")


# -- phase score: the matsed_test scoring path ------------------------------------

SCORE_CLIPS = 48
SCORE_BATCH = 8
SCORE_SEED = 3
# recipes/matsed.py:402-409 (the JAX test stage)
SCORE_PSDS1 = dict(dtc_threshold=0.7, gtc_threshold=0.7, alpha_ct=0.0, alpha_st=1.0)
SCORE_PSDS2 = dict(dtc_threshold=0.1, gtc_threshold=0.1, cttc_threshold=0.3, alpha_ct=0.5,
                   alpha_st=1.0)
# native sweep against the NumPy one on the same scores
# (tests/test_native_psds.py:61)
NATIVE_PSDS_TOL = 1e-9
# The NumPy sweep is exact (every observed score a threshold) only up to its
# 200 thresholds a class, and slow past that: check (b) rounds the scores to
# 1/50 for both sweeps.
PSDS_CHECK_STEPS = 50
# the ground truth as frame scores loses only the 10-ms frame rounding
GT_PSDS1_MIN = 0.99
GT_SHIFT_S = 1.0  # the planted fault: every ground-truth event 1 s late
GT_SHIFTED_PSDS1_MAX = 0.5


def write_score_split(root, codec):
    """A mini DESED split under ``root``: SCORE_CLIPS clips of
    ``synthetic_bursts`` with their bursts as the ground truth (a clip's
    three bursts take three classes in turn, so every class has events and
    no two events of a class overlap in a clip), as mono 16-bit WAV at 32
    kHz, every sixth from clip 1 at 44.1 kHz and every sixth from clip 2 in
    stereo; clip 5 is 6.5 s long (padded by the loader). Writes
    ``audio/``, ``strong.tsv`` and ``durations.tsv``; returns the
    ground truth {clip: [(onset, offset, label)]} and the durations."""
    import numpy as np
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    from transformer4sed_tpu_torch.data.tsv import write_tsv

    clips, bursts = synthetic_bursts(SCORE_CLIPS, SCORE_SEED)
    (root / "audio").mkdir()
    rows, gt, durations = [], {}, {}
    for i, (wav, events) in enumerate(zip(clips, bursts)):
        name = f"clip{i:03d}"
        dur = len(wav) / SR
        pcm = (np.clip(wav / 4.0, -1.0, 1.0) * 32767).astype(np.int16)
        if i % 6 == 1:
            up = resample_poly(wav / 4.0, 441, 320)
            wavfile.write(root / "audio" / f"{name}.wav", 44100,
                          (np.clip(up, -1.0, 1.0) * 32767).astype(np.int16))
        elif i % 6 == 2:
            wavfile.write(root / "audio" / f"{name}.wav", SR, np.stack([pcm, pcm // 2], axis=1))
        else:
            wavfile.write(root / "audio" / f"{name}.wav", SR, pcm)
        gt[name], durations[name] = [], dur
        for j, (on, off) in enumerate(events):
            if on < dur:
                label = codec.labels[(3 * i + j) % len(codec.labels)]
                gt[name].append((float(on), float(min(off, dur)), label))
                rows.append((f"{name}.wav", float(on), float(min(off, dur)), label))
    write_tsv(str(root / "strong.tsv"), ["filename", "onset", "offset", "event_label"], rows)
    write_tsv(str(root / "durations.tsv"), ["filename", "duration"],
              [(f"{k}.wav", v) for k, v in durations.items()])
    return gt, durations


def score_metrics(scores, events, gt, durations, classes):
    """PSDS1, PSDS2 and the event and segment F1s of one score set, as the
    JAX test stage computes them; with the host ms of the PSDS sweeps."""
    from transformer4sed_tpu_torch.eval.psds import compute_psds_from_scores
    from transformer4sed_tpu_torch.eval.sed_f1 import event_based_f1, segment_based_f1

    t0 = time.perf_counter()
    psds1, single1 = compute_psds_from_scores(scores, gt, durations, **SCORE_PSDS1)
    psds2, _ = compute_psds_from_scores(scores, gt, durations, **SCORE_PSDS2)
    psds_ms = (time.perf_counter() - t0) * 1e3
    preds = {clip: [] for clip in gt}
    for fname, label, onset, offset in events:
        preds[fname.rsplit(".", 1)[0]].append((onset, offset, label))
    return dict(psds1=psds1, psds2=psds2, single1=single1,
                event_f1=event_based_f1(preds, gt, classes),
                segment_f1=segment_based_f1(preds, gt, classes, durations)), psds_ms


def truth_scores(gt, durations, codec, shift=0.0):
    """(clip names, strong [N, C, T], weak [N, C]): the ground truth, its
    events ``shift`` s late and cut at the clip's end, as 0/1 frame scores
    (``codec.encode_strong``) and clip scores."""
    import numpy as np

    names = sorted(gt)
    events = {c: [(on + shift, min(off + shift, durations[c]), lab) for on, off, lab in gt[c]
                  if on + shift < durations[c]] for c in names}
    strong = np.stack([codec.encode_strong([(lab, on, off) for on, off, lab in events[c]]).T
                       for c in names])
    weak = np.stack([codec.encode_weak({lab for _, _, lab in gt[c]}) for c in names])
    return names, strong, weak


def score_ground_truth(gt, durations, codec, dev, shift=0.0):
    """The ground truth (``truth_scores``) through the card's decode, PSDS
    and event F1. The decode runs unfiltered: the recipe's median windows
    (up to 1.28 s) erase true bursts shorter than half a window."""
    import torch

    from transformer4sed_tpu_torch.eval.decode import batched_decode_preds, decode_pred_batch

    names, strong, weak = truth_scores(gt, durations, codec, shift)
    strong_t, weak_t = torch.from_numpy(strong).to(dev), torch.from_numpy(weak).to(dev)
    files = [f"{c}.wav" for c in names]
    _, post = batched_decode_preds(strong_t, files, codec, filter=None, weak_preds=weak_t,
                                   need_weak_mask=True)
    rows = decode_pred_batch(strong_t, weak_t, files, codec, [0.5], 1)[0.5]
    metrics, _ = score_metrics(post, rows, gt, durations, codec.labels)
    return metrics


def score(engine, root):
    """The port's test-stage path (``recipes/matsed.py:306-434``) at the
    flagship's full width, on the split written under ``root``
    (``write_score_split``): files on disk -> native WAV loader -> the port's
    dataset and DataLoader -> frontend and PaSST_SED on the card (rows 1
    and 2) -> ``batched_decode_preds`` on the card with the recipe's
    median windows and weak mask -> PSDS1, PSDS2, event and segment F1 and
    cSEBB then PSDS1 on the host; with checks (a) to (f)."""
    import unittest.mock

    import numpy as np
    import torch

    from transformer4sed_tpu_torch.data import audio_io
    from transformer4sed_tpu_torch.data.datasets import StronglyLabeledDataset
    from transformer4sed_tpu_torch.data.loader import DataLoader
    from transformer4sed_tpu_torch.data.tsv import read_tsv
    from transformer4sed_tpu_torch.eval import psds
    from transformer4sed_tpu_torch.eval.decode import batched_decode_preds, decode_pred_batch
    from transformer4sed_tpu_torch.eval.scores import ClipScores
    from transformer4sed_tpu_torch.eval.sebbs import apply_csebbs
    from transformer4sed_tpu_torch.native.build import load_psds_core, load_wav_core
    from transformer4sed_tpu_torch.recipes.common import load_durations, load_ground_truth

    codec, widths, dev = engine.codec, engine.median_filter, engine.device
    card = card_line()
    t0 = time.perf_counter()  # the host libraries build at first use: before the path's times
    libs = {"wav_core": load_wav_core(), "psds_core": load_psds_core()}
    log(f"score: native libraries {sorted(k for k, v in libs.items() if v is not None)} "
        f"loaded in {time.perf_counter() - t0:.1f} s (g++ at first use)")
    check(all(v is not None for v in libs.values()), "(c) a native library did not build")
    written_gt, _ = write_score_split(root, codec)
    gt = load_ground_truth(str(root / "strong.tsv"))
    durations = load_durations(str(root / "durations.tsv"))
    check({c: e for c, e in gt.items() if e} == {c: e for c, e in written_gt.items() if e},
          "the strong TSV reads back the events it was written with")
    check(sorted(durations) == sorted(gt) and len(gt) == SCORE_CLIPS,
          f"{len(gt)} clips in the ground truth, {len(durations)} durations")
    dataset = StronglyLabeledDataset(read_tsv(str(root / "strong.tsv")), str(root / "audio"),
                                     True, codec)
    loader = DataLoader(dataset, batch_size=SCORE_BATCH, drop_last=False, num_workers=4)
    with torch.no_grad():  # a warm-up forward, outside the counts and the times
        wav0 = torch.zeros(SCORE_BATCH, CLIP_SAMPLES, device=dev)
        pm0 = torch.zeros(SCORE_BATCH, codec.n_frames, dtype=torch.bool, device=dev)
        engine.model(engine.frontend.normalize(engine.frontend(wav0)), pad_mask=pm0,
                     **engine.model_kwargs)
    torch.cuda.synchronize()

    decodes0, sweeps0 = dict(audio_io.DECODES), dict(psds.SWEEPS)
    reset_launches()
    raw, post, rows, held = {}, {}, [], []
    load_ms = forward_ms = decode_ms = 0.0
    t_path = time.perf_counter()
    t0 = time.perf_counter()
    for batch in loader:
        load_ms += (time.perf_counter() - t0) * 1e3
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.no_grad():
            wav = torch.from_numpy(batch["wav"]).to(dev)
            pm = torch.from_numpy(batch["pad_mask"]).to(dev)
            out = engine.model(engine.frontend.normalize(engine.frontend(wav)), pad_mask=pm,
                               **engine.model_kwargs)
            strong, weak = out.strong.float(), out.weak.float()
        end.record()
        end.synchronize()
        forward_ms += start.elapsed_time(end)
        t1 = time.perf_counter()
        r, p = batched_decode_preds(strong, batch["filename"], codec, filter=widths,
                                    weak_preds=weak, need_weak_mask=True)
        ev = decode_pred_batch(strong, weak, batch["filename"], codec, [0.5], widths)[0.5]
        decode_ms += (time.perf_counter() - t1) * 1e3
        raw.update(r)
        post.update(p)
        rows.extend(ev)
        held.append((batch["filename"], strong.cpu().numpy(), weak.cpu().numpy(), r, p, ev))
        t0 = time.perf_counter()
    metrics, psds_ms = score_metrics(post, rows, gt, durations, codec.labels)
    path_s = time.perf_counter() - t_path
    launches = read_launches()
    t1 = time.perf_counter()
    sebb = apply_csebbs(raw)
    sebb_psds1, _ = psds.compute_psds_from_scores(sebb, gt, durations, **SCORE_PSDS1)
    sebb_ms = (time.perf_counter() - t1) * 1e3
    decodes = {k: audio_io.DECODES[k] - decodes0.get(k, 0) for k in ("native", "python")}
    sweeps = {k: psds.SWEEPS[k] - sweeps0.get(k, 0) for k in ("native", "numpy")}

    n_batches = -(-SCORE_CLIPS // SCORE_BATCH)
    log(f"score: {SCORE_CLIPS} clips from disk in {n_batches} batches of {SCORE_BATCH}; "
        f"launches {launches}")
    want = {name: 0 for name in launches}
    want.update(flash_attention_nhd=12 * n_batches, flash_xl_attention_nhd=3 * n_batches)
    check(launches == want, f"(f) kernel launches {launches} on the score path, expected {want}")
    log(f"score (f): rows 1 and 2 launched 12 and 3 times a batch, no other kernel")

    # (a) the card's decode against the CPU's on the same f32 score arrays
    for names, strong, weak, r, p, ev in held:
        r_cpu, p_cpu = batched_decode_preds(strong, names, codec, filter=widths, weak_preds=weak,
                                            need_weak_mask=True, device="cpu")
        ev_cpu = decode_pred_batch(strong, weak, names, codec, [0.5], widths, device="cpu")[0.5]
        for card_set, cpu_set in ((r, r_cpu), (p, p_cpu)):
            check(list(card_set) == list(cpu_set), "(a) the same clips decoded")
            for clip in cpu_set:
                check(np.array_equal(card_set[clip].scores, cpu_set[clip].scores)
                      and np.array_equal(card_set[clip].timestamps, cpu_set[clip].timestamps),
                      f"(a) {clip}: the card's decode differs from the CPU's")
        check(ev == ev_cpu, "(a) the card's event rows differ from the CPU's")
    log(f"score (a): the card's decode equals the CPU's on the same f32 scores "
        f"({SCORE_CLIPS} clips, raw and filtered arrays, {len(rows)} event rows)")

    for what, value in (("psds1", metrics["psds1"]), ("psds2", metrics["psds2"]),
                        ("cSEBB psds1", sebb_psds1),
                        ("event macro F1", metrics["event_f1"]["macro_f1"]),
                        ("segment macro F1", metrics["segment_f1"]["macro_f1"])):
        check(np.isfinite(value) and 0.0 <= value <= 1.0, f"score: {what} {value}")
    log(f"score metrics (seeded random weights): psds1 {metrics['psds1']:.6f}, psds2 "
        f"{metrics['psds2']:.6f}, cSEBB psds1 {sebb_psds1:.6f}, event F1 macro "
        f"{metrics['event_f1']['macro_f1']:.6f} micro {metrics['event_f1']['micro_f1']:.6f}, "
        f"segment F1 macro {metrics['segment_f1']['macro_f1']:.6f} micro "
        f"{metrics['segment_f1']['micro_f1']:.6f}, {len(rows)} events at 0.5")

    # (b) the native sweep against the NumPy one on the same scores: the
    # model's, and the model's with a seeded share of the ground truth's
    # added (the seeded weights alone detect nothing)
    names, truth, _ = truth_scores(gt, durations, codec)
    rng = np.random.RandomState(SCORE_SEED)
    worst, values = 0.0, []
    for mix in (0.0, 1.0):
        coarse = {}
        for i, c in enumerate(names):
            share = mix * rng.uniform(-0.3, 0.6, (1, len(codec.labels)))
            s = np.clip(post[c].scores + share * truth[i].T, 0.0, 1.0)
            coarse[c] = ClipScores(np.round(s * PSDS_CHECK_STEPS) / PSDS_CHECK_STEPS,
                                   post[c].timestamps, codec.labels)
        for setting in (SCORE_PSDS1, SCORE_PSDS2):
            native = psds.compute_psds_from_scores(coarse, gt, durations, **setting)
            with unittest.mock.patch.object(psds, "_native_sweeper", lambda *a, **k: None):
                numpy_path = psds.compute_psds_from_scores(coarse, gt, durations, **setting)
            check(native[1].keys() == numpy_path[1].keys(), "(b) the same classes swept")
            worst = max([worst, abs(native[0] - numpy_path[0])]
                        + [abs(native[1][c] - numpy_path[1][c]) for c in numpy_path[1]])
            values.append(f"{native[0]:.6f}")
    log(f"score (b): native vs NumPy sweep on the scores rounded to 1/{PSDS_CHECK_STEPS}, "
        f"the model's and the model's plus a seeded share of the ground truth (PSDS1, PSDS2: "
        f"{', '.join(values)}), PSDS and per class: max diff {worst:.3e} "
        f"(limit {NATIVE_PSDS_TOL})")
    check(worst <= NATIVE_PSDS_TOL, "(b) the native PSDS sweep disagrees with the NumPy one")

    # (c) both native libraries built and ran
    log(f"score (c): files decoded {decodes}, PSDS class sweeps {sweeps}")
    check(decodes == {"native": SCORE_CLIPS, "python": 0},
          "(c) every file must go through the native WAV library")
    check(sweeps["numpy"] == 0 and sweeps["native"] > 0,
          "(c) every PSDS sweep of the path must run on the native library")

    # (d) the ground truth scores itself; (e) a planted fault fails (d)
    truth = score_ground_truth(gt, durations, codec, dev)
    ok = (truth["psds1"] >= GT_PSDS1_MIN and truth["event_f1"]["macro_f1"] == 1.0
          and truth["event_f1"]["micro_f1"] == 1.0)
    log(f"score (d): the ground truth as scores: psds1 {truth['psds1']:.6f} (limit >= "
        f"{GT_PSDS1_MIN}), event F1 macro {truth['event_f1']['macro_f1']:.6f} micro "
        f"{truth['event_f1']['micro_f1']:.6f} (limit 1): {'within' if ok else 'OUTSIDE'}")
    check(ok, "(d) the ground truth does not score itself")
    shifted = score_ground_truth(gt, durations, codec, dev, shift=GT_SHIFT_S)
    ok = shifted["psds1"] >= GT_PSDS1_MIN and shifted["event_f1"]["macro_f1"] == 1.0
    log(f"score planted fault, every event {GT_SHIFT_S} s late: psds1 {shifted['psds1']:.6f} "
        f"(limit >= {GT_PSDS1_MIN}, must be < {GT_SHIFTED_PSDS1_MAX}), event F1 macro "
        f"{shifted['event_f1']['macro_f1']:.6f}: {'within' if ok else 'OUTSIDE'}")
    check(not ok and shifted["psds1"] < GT_SHIFTED_PSDS1_MAX,
          "(e) check (d) let the shifted ground truth through")

    log(f"score path ({card}): {SCORE_CLIPS / path_s:.2f} clips/s from files on disk to "
        f"PSDS2 ({path_s * 1e3:.1f} ms); host ms: loading {load_ms:.1f} (waits on the "
        f"loader), decode on the card {decode_ms:.1f}, PSDS1 + PSDS2 sweeps {psds_ms:.1f}; "
        f"device ms of frontend + model {forward_ms:.1f}; cSEBB + its PSDS1 {sebb_ms:.1f}")


# -- phase serving: the serve, infer, stream and export entry points ---------------

SERVING_BATCH = 8
SERVING_CONFIGS = {  # network -> (shipped config, batch, the ops its exported program calls)
    "flagship": ("config/mat-sed/finetune1.yaml", SERVING_BATCH,
                 {"t4s.flash_nhd_fwd.default": 12, "t4s.xl_nhd_fwd.default": 3}),
    "PMAM": ("config/pmam/finetune1.yaml", SERVING_BATCH,
             {"t4s.flash_nhd_fwd.default": 12, "t4s.xl_hm_fwd.default": 3}),
    "HTSAT_CNN": ("config/audioset_strong/htsat_cnn.yaml", HTSAT_BATCH,
                  {"t4s.window_fwd.default": 12, "t4s.xl_nhd_fwd.default": 3}),
}
# the wrappers whose launches each network's served batch makes
SERVING_LAUNCHES = {"flagship": dict(flash_attention_nhd=12, flash_xl_attention_nhd=3),
                    "PMAM": dict(flash_attention_nhd=12, flash_xl_attention=3),
                    "HTSAT_CNN": dict(window_attention=12, flash_xl_attention_nhd=3)}
SERVING_EXPORT_CLIPS = 16  # PMAM's and HTSAT_CNN's served clips
LONG_CLIPS = (0, 1, 2, 3, 4, 6)  # the long file: six full-length clips, 60 s
STREAM_CLIPS = (0, 1, 2)  # the stream: 30 s
STREAM_CHUNKS_S = (0.5, 1.7)  # two chunkings of the same stream


def engine_pass(engine, wav_dir, batch_size):
    """The engine over ``wav_dir`` through the serve CLI's loader (the same
    batches): {filename: (filtered scores [T, C], events)}, and the host
    seconds of the pass."""
    import torch

    from transformer4sed_tpu_torch.data.datasets import UnlabeledDataset
    from transformer4sed_tpu_torch.data.loader import DataLoader

    loader = DataLoader(UnlabeledDataset(str(wav_dir), True, engine.codec), batch_size=batch_size,
                        drop_last=False, num_workers=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = {}
    for names, scores, _ in engine.score_batches(loader):
        for name, clip in zip(names, scores):
            ref[name] = (clip, engine.decode(clip))
    return ref, time.perf_counter() - t0


def served_as(out_dir, ref):
    """Whether ``out_dir`` holds what the engine served: one TSV a clip whose
    scores equal the engine's bitwise, and ``events.jsonl`` with the
    engine's events, one line a clip, in the clips' order."""
    import numpy as np

    lines = [json.loads(ln) for ln in (out_dir / "events.jsonl").read_text().splitlines()]
    if [e["filename"] for e in lines] != sorted(ref):
        return False
    if sorted(p.name for p in out_dir.glob("*.tsv")) != sorted(f"{n[:-4]}.tsv" for n in ref):
        return False
    for e in lines:
        scores, events = ref[e["filename"]]
        got = np.loadtxt(out_dir / f"{e['filename'][:-4]}.tsv", delimiter="\t", skiprows=1)
        if not (got[:, 2:].shape == scores.shape
                and np.array_equal(got[:, 2:].astype(np.float32), scores)
                and e["events"] == [{"event": lab, "onset": on, "offset": off}
                                    for lab, on, off in events]):
            return False
    return True


def same_outputs(a, b):
    """Two serve outputs with the same TSV and events files, byte for byte."""
    names = sorted(p.name for p in a.iterdir())
    return names == sorted(p.name for p in b.iterdir()) and all(
        (a / n).read_bytes() == (b / n).read_bytes() for n in names)


def run_serve_main(args, out_dir, want_launches):
    """``serve.main`` with ``args`` into ``out_dir``: its printed line, its
    scoring seconds (its own clock) and its launches, checked against
    ``want_launches``."""
    import io

    from transformer4sed_tpu_torch.recipes import serve

    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = serve.main([*args, "--out_dir", str(out_dir)])
    launches = read_launches()
    line = buf.getvalue().strip()
    check(rc == 0 and line.startswith("scored"), f"serve.main {args}: rc {rc}, {line!r}")
    want = {name: 0 for name in launches}
    want.update(want_launches)
    check(launches == want, f"serve.main {args}: launches {launches}, expected {want}")
    return line, float(re.search(r"in ([0-9.]+)s", line).group(1))


def serving(engine, root):
    """The serving entry points on the split of phase score (``root``):
    (a) ``serve.main`` at B=8 from a port checkpoint and from a ``.pt`` of
    the flagship's weights, against the engine on the same batches; (b)
    ``infer_clip`` and ``infer_long_audio``; (c) ``StreamingScorer`` in two
    chunkings against a manual overlap-add; (d) ``export.main`` and
    ``serve.main --exported`` for the flagship, PMAM and HTSAT_CNN; (e) a
    planted fault, file names permuted within a batch, outside (a)."""
    import tempfile
    import unittest.mock

    import numpy as np
    import torch

    from transformer4sed_tpu_torch.core.filters import apply_class_filter
    from transformer4sed_tpu_torch.data.audio_io import pad_wav
    from transformer4sed_tpu_torch.data.datasets import UnlabeledDataset
    from transformer4sed_tpu_torch.data.loader import DataLoader
    from transformer4sed_tpu_torch.eval.scores import ClipScores, segment_scores_overlap_add
    from transformer4sed_tpu_torch.recipes import cli, export, infer, stream
    from transformer4sed_tpu_torch.recipes.serve import InferenceEngine
    from transformer4sed_tpu_torch.utils.checkpoint import save_params
    from transformer4sed_tpu_torch.utils.config import load_yaml_with_include
    from transformer4sed_tpu_torch.utils.weights import init_weights_

    card = card_line()
    codec, dev = engine.codec, engine.device
    audio = root / "audio"
    work = Path(tempfile.mkdtemp(prefix="serving_", dir=root))
    cfg_path, batch, want_calls = SERVING_CONFIGS["flagship"]
    per_batch = SERVING_LAUNCHES["flagship"]
    n_batches = -(-SCORE_CLIPS // batch)
    state = {k: v.detach().cpu() for k, v in engine.model.state_dict().items()}
    ckpt = save_params(str(work / "flagship.ckpt"), state)
    torch.save(state, work / "flagship.pt")
    with torch.no_grad():  # a warm-up forward, outside the counts and the times
        engine.forward(torch.zeros(batch, CLIP_SAMPLES, device=dev),
                       torch.zeros(batch, codec.n_frames, dtype=torch.bool, device=dev))
    ref, engine_s = engine_pass(engine, audio, batch)
    check(len(ref) == SCORE_CLIPS, f"the engine served {len(ref)} clips")

    # (a) serve.main from the port checkpoint and from the .pt, held to the engine
    cfg = str(ROOT / cfg_path)
    launches = {k: n * n_batches for k, n in per_batch.items()}
    rates = {}
    for tag, weights in (("ckpt", ckpt), ("pt", str(work / "flagship.pt"))):
        line, main_s = run_serve_main(["--config_dir", cfg, "--ckpt", weights, "--wav_dir",
                                       str(audio), "--batch_size", str(batch)], work / tag,
                                      launches)
        ok = served_as(work / tag, ref)
        log(f"serving (a) serve.main --ckpt {Path(weights).name}: {line}; TSVs and events "
            f"against the engine's on the same batches, by filename: "
            f"{'bitwise equal' if ok else 'OUTSIDE'}")
        check(ok, f"(a) serve.main --ckpt {weights} differs from the engine")
        rates[tag] = SCORE_CLIPS / main_s
    log(f"serving (a) ({card}): serve.main {rates['ckpt']:.2f} and {rates['pt']:.2f} clips/s "
        f"(its scoring loop, from files on disk), the engine {SCORE_CLIPS / engine_s:.2f} clips/s "
        f"on the same loader; launches a batch {per_batch}; one pass, ungated")

    # (e) the planted fault: file names permuted within each batch
    class Permuted:
        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def score_batches(self, batches):
            for names, scores, weak in self.inner.score_batches(batches):
                yield names[1:] + names[:1], scores, weak

    with unittest.mock.patch.object(cli, "serving_engine", lambda *a, **k: Permuted(engine)):
        run_serve_main(["--config_dir", cfg, "--ckpt", ckpt, "--wav_dir", str(audio)],
                       work / "fault", launches)
    ok = served_as(work / "fault", ref)
    log(f"serving planted fault, file names rolled by one within each batch before the TSVs "
        f"are written: check (a) {'within' if ok else 'OUTSIDE'}")
    check(not ok, "(e) check (a) let file names permuted within a batch through")

    # (b) infer_clip and infer_long_audio, against the engine at their shapes
    loaded = {}
    for b in DataLoader(UnlabeledDataset(str(audio), True, codec), batch_size=batch,
                        drop_last=False, num_workers=4):
        for name, wav, pm in zip(b["filename"], b["wav"], b["pad_mask"]):
            loaded[name] = (wav, pm)
    name0 = "clip000.wav"
    wav0 = loaded[name0][0]
    events, _, weak = infer.infer_clip(engine.model, engine.frontend, wav0, codec,
                                       engine.threshold, engine.median_filter,
                                       engine.model_kwargs)
    one = InferenceEngine(engine.model, engine.frontend, codec, engine.median_filter,
                          batch_size=1, threshold=engine.threshold,
                          model_kwargs=engine.model_kwargs, device=dev)
    _, s1, w1 = next(one.score_batches([{"wav": wav0[None], "pad_mask": loaded[name0][1][None],
                                         "filename": [name0]}]))
    ok = events == [tuple(e) for e in one.decode(s1[0])] and np.array_equal(weak, w1[0])
    diff8 = float(np.abs(s1[0] - ref[name0][0]).max())
    log(f"serving (b) infer_clip on {name0}: {len(events)} events and the weak scores against "
        f"the engine at B=1: {'equal' if ok else 'OUTSIDE'}; its filtered scores against the "
        f"B=8 row: max abs diff {diff8:.3e} (ungated)")
    check(ok, "(b) infer_clip differs from the engine")
    long = np.concatenate([loaded[f"clip{i:03d}.wav"][0] for i in LONG_CLIPS])
    win = CLIP_SAMPLES
    starts = infer.window_starts(len(long), win, win // 2)
    reset_launches()
    t0 = time.perf_counter()
    long_events, segs = infer.infer_long_audio(engine.model, engine.frontend, long, codec,
                                               engine.threshold, engine.median_filter,
                                               model_kwargs=engine.model_kwargs)
    long_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    windows = InferenceEngine(engine.model, engine.frontend, codec, engine.median_filter,
                              batch_size=len(starts), threshold=engine.threshold,
                              model_kwargs=engine.model_kwargs, device=dev)
    pieces = [pad_wav(long[s:s + win], win, codec) for s in starts]
    ids = [f"clip-{round(s / SR * 100)}-{round(min(s + win, len(long)) / SR * 100)}"
           for s in starts]
    _, ws, _ = next(windows.score_batches([{"wav": np.stack([p[0] for p in pieces]),
                                            "pad_mask": np.stack([p[1] for p in pieces]),
                                            "filename": ids}]))
    edges = np.linspace(0.0, codec.audio_len, ws.shape[1] + 1)
    want = segment_scores_overlap_add({c: ClipScores(ws[i], edges, codec.labels)
                                       for i, c in enumerate(ids)},
                                      {"clip": len(long) / SR}, codec.labels)["clip"].scores
    ok = (len(starts) == 11 and segs.shape == (60, len(codec.labels))
          and np.array_equal(segs, want)
          and all(launches[k] == n for k, n in per_batch.items()))
    log(f"serving (b) infer_long_audio on 60 s ({len(starts)} windows in one forward, launches "
        f"{ {k: launches[k] for k in per_batch} }, {long_ms:.1f} ms): segment scores {segs.shape}, {len(long_events)} events; against "
        f"the overlap-add of the engine's scores of the same windows: "
        f"{'bitwise equal' if ok else 'OUTSIDE'}")
    check(ok, "(b) infer_long_audio differs from the engine's windows")

    # (c) the stream, in two chunkings, against a manual overlap-add
    wav30 = np.concatenate([loaded[f"clip{i:03d}.wav"][0] for i in STREAM_CLIPS])
    rows, window_ms = [], []
    for chunk_s in STREAM_CHUNKS_S:
        scorer = stream.StreamingScorer(engine.model, engine.frontend, codec,
                                        median_filter=engine.median_filter,
                                        model_kwargs=engine.model_kwargs)
        chunk = int(chunk_s * SR)
        t0 = time.perf_counter()
        rows.append(list(scorer.stream(wav30[i:i + chunk] for i in range(0, len(wav30), chunk))))
        window_ms.append((time.perf_counter() - t0) * 1e3 / scorer.windows)
    t_frames = codec.n_frames
    acc = np.zeros((3 * t_frames, len(codec.labels)), np.float32)
    cnt = np.zeros((3 * t_frames, 1), np.float32)
    with torch.no_grad():
        for s in range(0, len(wav30) - win + 1, scorer.hop):
            x = torch.from_numpy(wav30[None, s:s + win].copy()).to(dev)
            out = engine.model(engine.frontend.normalize(engine.frontend(x)),
                               **engine.model_kwargs)
            f = apply_class_filter(out.strong.transpose(1, 2), engine.median_filter)[0].float()
            f0 = int(round(s / win * t_frames))
            acc[f0:f0 + t_frames] += f.cpu().numpy()
            cnt[f0:f0 + t_frames] += 1.0
    manual = [(i * (codec.audio_len / t_frames), acc[i] / cnt[i, 0])
              for i in range(3 * t_frames)]
    same = all(len(r) == len(manual) and all(
        ta == tb and np.array_equal(a, b) for (ta, a), (tb, b) in zip(r, manual)) for r in rows)
    log(f"serving (c) StreamingScorer on 30 s, hop {scorer.hop / SR:.1f} s, {scorer.windows} "
        f"windows, chunks of {STREAM_CHUNKS_S[0]} and {STREAM_CHUNKS_S[1]} s: {len(rows[0])} and "
        f"{len(rows[1])} rows; both against a manual overlap-add of the same windows: "
        f"{'bitwise equal' if same else 'OUTSIDE'}; {window_ms[0]:.2f} and {window_ms[1]:.2f} ms "
        f"a window ({card}, host clock, one pass)")
    check(same, "(c) the stream's rows differ from the manual overlap-add or between chunkings")

    # (d) export.main, then serve.main --exported, for the three networks
    clips16 = work / "clips16"
    clips16.mkdir()
    for p in sorted(audio.glob("*.wav"))[:SERVING_EXPORT_CLIPS]:
        (clips16 / p.name).symlink_to(p)
    for net, (cfg_path, batch, want_calls) in SERVING_CONFIGS.items():
        t0 = time.perf_counter()
        cfg = str(ROOT / cfg_path)
        if net == "flagship":
            wav_dir, net_ref, net_ckpt, direct = audio, ref, ckpt, work / "ckpt"
        else:
            config = load_yaml_with_include(cfg)
            model, _ = cli.build_model(config, dev)
            net_ckpt = save_params(str(work / f"{net}.ckpt"), init_weights_(model, seed=0)
                                   .state_dict())
            del model
            net_engine = cli.serving_engine(config, net_ckpt, dev, batch)
            wav_dir, direct = clips16, None
            net_ref, _ = engine_pass(net_engine, wav_dir, batch)
            del net_engine
        art = work / f"{net}.pt2"
        with contextlib.redirect_stdout(sys.stderr):
            check(export.main(["--config_dir", cfg, "--ckpt", net_ckpt, "--out", str(art),
                               "--batch_size", str(batch)]) == 0, f"(d) export.main {net}")
        export_s = time.perf_counter() - t0
        program, meta = export.load_exported(str(art))
        calls = collections.Counter(str(n.target) for n in program.graph.nodes
                                    if str(n.target).startswith("t4s."))
        del program
        check(dict(calls) == want_calls and meta["batch_size"] == batch,
              f"(d) {net}: the program calls {dict(calls)}, expected {want_calls}")
        n_b = -(-len(net_ref) // batch)
        line, _ = run_serve_main(["--exported", str(art), "--wav_dir", str(wav_dir)],
                                 work / f"{net}_exported",
                                 {k: n * n_b for k, n in SERVING_LAUNCHES[net].items()})
        ok = served_as(work / f"{net}_exported", net_ref) and (
            direct is None or same_outputs(work / f"{net}_exported", direct))
        log(f"serving (d) {net}: export.main at B={batch} ({art.stat().st_size / 1e6:.1f} MB, "
            f"export and the reference {export_s:.1f} s), the program calls {dict(calls)}; "
            f"serve.main --exported on {len(net_ref)} clips: {line}; TSVs and events against "
            f"{'(a) and ' if direct else ''}the engine: {'bitwise equal' if ok else 'OUTSIDE'}")
        check(ok, f"(d) {net}: the exported program serves other TSVs than the engine")
        torch.cuda.empty_cache()


# -- phase stages: the matsed_* stages through the recipe CLI ---------------------

# the mini DESED's train sources: (folder, clips, seed); validation and test
# are phase score's 48 clips
STAGE_SOURCES = (("strong", 12, 11), ("synth", 4, 12), ("weak", 16, 13), ("unlabeled", 32, 14))
STAGE_SEED = 42  # --random_seed
DROP_PATTERN = "classifier|at_head|at_pool"  # config/mat-sed/finetune1.yaml:11


def write_stage_split(root, codec):
    """The train sources of a mini DESED under ``root`` (clips of
    ``synthetic_bursts``, each burst a class in turn, as 16-bit WAV at 32
    kHz; strong and synth events, weak clip tags, unlabeled clips) and phase
    score's split under ``root/val``, with a copy of its events table whose
    events are all 1 s late (``strong_late.tsv``, the planted fault of check
    (g)). Returns the validation ground truth and durations."""
    import numpy as np
    from scipy.io import wavfile

    from transformer4sed_tpu_torch.data.tsv import write_tsv

    events = ["filename", "onset", "offset", "event_label"]
    for name, n, seed in STAGE_SOURCES:
        (root / name).mkdir(parents=True)
        clips, bursts = synthetic_bursts(n, seed)
        rows = []
        for i, (wav, clip_bursts) in enumerate(zip(clips, bursts)):
            fname = f"{name}{i:03d}.wav"
            wavfile.write(root / name / fname, SR,
                          (np.clip(wav / 4.0, -1.0, 1.0) * 32767).astype(np.int16))
            dur = len(wav) / SR
            labels = [codec.labels[(3 * i + j) % len(codec.labels)] for j in range(3)]
            if name in ("strong", "synth"):
                rows += [(fname, float(on), float(min(off, dur)), lab)
                         for (on, off), lab in zip(clip_bursts, labels) if on < dur]
            elif name == "weak":
                rows.append((fname, ",".join(sorted(set(labels)))))
        if name == "weak":
            write_tsv(str(root / "weak.tsv"), ["filename", "event_labels"], rows)
        elif rows:
            write_tsv(str(root / f"{name}.tsv"), events, rows)
    (root / "val").mkdir()
    gt, durations = write_score_split(root / "val", codec)
    late = [(f"{c}.wav", on + GT_SHIFT_S, min(off + GT_SHIFT_S, durations[c]), lab)
            for c, evs in sorted(gt.items()) for on, off, lab in evs
            if on + GT_SHIFT_S < durations[c]]
    write_tsv(str(root / "val" / "strong_late.tsv"), events, late)
    return gt, durations


def stage_config(root, name, tag, overrides, family="mat-sed"):
    """The shipped ``config/<family>/<name>.yaml`` read by the port's YAML
    reader, the mini DESED's paths and ``overrides`` ({"section.key": value})
    set and each logged, written as ``root/<tag>.yaml``: its path."""
    from transformer4sed_tpu_torch.utils.config import load_yaml_with_include
    from transformer4sed_tpu_torch.utils.yamlio import safe_dump

    cfg = load_yaml_with_include(str(ROOT / "config" / family / f"{name}.yaml"))
    paths = {
        "dataset.strong_folder": f"{root}/strong", "dataset.strong_tsv": f"{root}/strong.tsv",
        "dataset.weak_folder": f"{root}/weak", "dataset.weak_tsv": f"{root}/weak.tsv",
        "dataset.unlabeled_folder": f"{root}/unlabeled",
        "dataset.val_folder": f"{root}/val/audio", "dataset.val_tsv": f"{root}/val/strong.tsv",
        "dataset.val_dur": f"{root}/val/durations.tsv",
        "dataset.test_folder": f"{root}/val/audio", "dataset.test_tsv": f"{root}/val/strong.tsv",
        "dataset.test_dur": f"{root}/val/durations.tsv",
        "synth_dataset.synth_train_folder": f"{root}/synth",
        "synth_dataset.synth_train_tsv": f"{root}/synth.tsv",
    }
    for key, value in {**paths, **overrides}.items():
        *parents, leaf = key.split(".")
        node = cfg
        for part in parents:
            node = node.setdefault(part, {})
        log(f"stages: {family}/{name}.yaml -> {tag}.yaml: {key} = {value!r} (shipped "
            f"{node.get(leaf)!r})")
        node[leaf] = value
    out = root / f"{tag}.yaml"
    out.write_text(safe_dump(cfg))
    return str(out)


class StageTimes:
    """Host-clock timers wrapped around the recipe's train epochs, its eval
    forwards (synchronised), decodes, PSDS sweeps, validations and tests,
    read per stage."""

    def __init__(self):
        import collections

        self.t = collections.Counter()
        self.n = collections.Counter()

    def wrap(self, owner, name, key, sync=False, count=None):
        import functools

        import torch

        fn = getattr(owner, name)

        @functools.wraps(fn)
        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync and torch.cuda.is_available():
                torch.cuda.synchronize()
            self.t[key] += time.perf_counter() - t0
            self.n[key] += 1 if count is None else count(out, *a)
            return out

        return timed


@contextlib.contextmanager
def without_tensorflow():
    """``import tensorflow`` fails inside, so TensorBoard's writer, where it
    imports, skips TensorFlow, whose import alone takes seconds. Only that
    entry of ``sys.modules`` is set and restored: ``patch.dict`` would also
    drop every module imported meanwhile, and torch._dynamo fails to import
    a second time."""
    had = "tensorflow" in sys.modules
    if not had:
        sys.modules["tensorflow"] = None
    try:
        yield
    finally:
        if not had:
            sys.modules.pop("tensorflow", None)


def read_log(folder):
    return (Path(folder) / "log.txt").read_text()


def finite_log_numbers(text, pattern):
    """Every ``name=value`` (or ``train x val y``) number on the log lines
    matching ``pattern``, as floats."""
    import re

    nums = []
    for line in text.splitlines():
        if re.search(pattern, line):
            nums += [float(v) for v in re.findall(r"(?:=|: |train |val |': )(-?[0-9.]+(?:e-?\d+)?|nan|inf)", line)]
    return nums


def stages(device="cuda"):
    """The ``matsed_*`` stages as a user runs them, through
    ``recipes.cli.main`` on the card, with checks (a) to (g)."""
    import re
    import tempfile
    import unittest.mock

    import numpy as np
    import torch

    from transformer4sed_tpu_torch.data import audio_io
    from transformer4sed_tpu_torch.eval import decode as decode_mod
    from transformer4sed_tpu_torch.recipes import cli, common, matsed
    from transformer4sed_tpu_torch.train import mean_teacher, mlm
    from transformer4sed_tpu_torch.utils import checkpoint
    from transformer4sed_tpu_torch.utils.config import load_yaml_with_include
    from transformer4sed_tpu_torch.utils.logging import Logger
    from transformer4sed_tpu_torch.utils.weights import init_weights_, jax_style_path

    card = card_line()
    dev = torch.device(device)
    with without_tensorflow(), tempfile.TemporaryDirectory(prefix="t4s_stages_") as tmp:
        root = Path(tmp)
        codec = common.codec_from_config(
            load_yaml_with_include(str(ROOT / "config" / "mat-sed" / "finetune1.yaml")))
        t0 = time.perf_counter()
        gt, durations = write_stage_split(root, codec)
        log(f"stages: mini DESED written in {time.perf_counter() - t0:.1f} s: "
            + ", ".join(f"{n} {k}" for n, k, _ in STAGE_SOURCES) + f", val/test {SCORE_CLIPS}")
        pre_cfg = stage_config(root, "pretrain", "pretrain", {
            "training.scheduler.n_epochs": 1, "training.scheduler.n_epochs_cut": 1})
        ft1_cfg = stage_config(root, "finetune1", "finetune1_e1", {
            "training.scheduler.n_epochs": 1, "training.scheduler.n_epochs_cut": 1})
        ft2_cfg = stage_config(root, "finetune1", "finetune1_e2", {
            "training.scheduler.n_epochs": 2, "training.scheduler.n_epochs_cut": 1})
        ft2w_cfg = stage_config(root, "finetune2", "finetune2_e1", {
            "training.scheduler.n_epochs": 1, "training.scheduler.n_epochs_cut": 1})
        late_cfg = stage_config(root, "finetune1", "finetune1_late", {
            "training.scheduler.n_epochs": 2, "training.scheduler.n_epochs_cut": 1,
            "dataset.test_tsv": f"{root}/val/strong_late.tsv"})
        pre_dir, ft_dir = root / "pretrain", root / "finetune"
        best_student = str(pre_dir / "best" / "best_student")
        runs = [
            ("matsed_pretrain", pre_cfg, pre_dir, []),
            ("matsed_finetune", ft1_cfg, ft_dir, ["--pretrained_ckpt", best_student]),
            ("matsed_finetune (resumed)", ft2_cfg, ft_dir,
             ["--pretrained_ckpt", best_student, "--resume_ckpt", "auto"]),
            ("matsed_test", ft2_cfg, ft_dir, ["--resume_ckpt", "auto"]),
            ("matsed_finetune (finetune2.yaml)", ft2w_cfg, root / "finetune2",
             ["--pretrained_ckpt", str(ft_dir / "best" / "best_student")]),
            ("matsed_test (1-s-late test split)", late_cfg, root / "test_late",
             ["--resume_ckpt", str(ft_dir / "best" / "last_state")]),
        ]
        times = StageTimes()
        patches = [
            unittest.mock.patch.object(matsed.MATSEDTrainer, "train_epoch", times.wrap(
                matsed.MATSEDTrainer, "train_epoch", "train", count=lambda out, s, *a: len(
                    s.train_loader))),
            unittest.mock.patch.object(matsed.MLMTrainer, "train_epoch", times.wrap(
                matsed.MLMTrainer, "train_epoch", "train", count=lambda out, s, *a: len(
                    s.train_loader))),
            unittest.mock.patch.object(matsed.MATSEDTrainer, "_eval_forward", times.wrap(
                matsed.MATSEDTrainer, "_eval_forward", "forward", sync=True,
                count=lambda out, s, m, b, k: len(b["filename"]))),
            unittest.mock.patch.object(matsed, "batched_decode_preds", times.wrap(
                matsed, "batched_decode_preds", "decode")),
            unittest.mock.patch.object(matsed, "decode_pred_batch", times.wrap(
                matsed, "decode_pred_batch", "decode")),
            unittest.mock.patch.object(matsed, "compute_psds_from_scores", times.wrap(
                matsed, "compute_psds_from_scores", "psds")),
            unittest.mock.patch.object(matsed.MATSEDTrainer, "validation", times.wrap(
                matsed.MATSEDTrainer, "validation", "eval")),
            unittest.mock.patch.object(matsed.MATSEDTrainer, "test", times.wrap(
                matsed.MATSEDTrainer, "test", "eval")),
            unittest.mock.patch.object(matsed.MLMTrainer, "validation", times.wrap(
                matsed.MLMTrainer, "validation", "eval")),
        ]
        results = {}
        for p in patches:
            p.start()
        try:
            for what, cfg, folder, extra in runs:
                times.t.clear()
                times.n.clear()
                decodes0, batches0 = dict(audio_io.DECODES), dict(audio_io.BATCHES)
                reset_launches()
                t0 = time.perf_counter()
                rc = cli.main([what.split()[0], "--config_dir", cfg, "--save_folder",
                               str(folder), "--random_seed", str(STAGE_SEED), *extra])
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                results[what] = dict(
                    rc=rc, seconds=time.perf_counter() - t0, launches=read_launches(),
                    times=dict(times.t), counts=dict(times.n),
                    decodes={k: audio_io.DECODES[k] - decodes0.get(k, 0)
                             for k in ("native", "python")},
                    batches={k: audio_io.BATCHES[k] - batches0.get(k, 0)
                             for k in ("native", "python")})
                log(f"stages: {what} returned {rc} in {results[what]['seconds']:.1f} s")
        finally:
            for p in patches:
                p.stop()

        # (a) every stage returned 0 and wrote the JAX stage's files
        check(all(r["rc"] == 0 for r in results.values()), "(a) a stage returned non-zero")
        want_files = {
            pre_dir: ["log.txt", "config.yaml", "best/best_student"],
            ft_dir: ["log.txt", "config.yaml", "best/best_student", "best/best_teacher",
                     "best/best_metric.json", "best/last_state", "best/last_state.prev"],
            root / "finetune2": ["log.txt", "config.yaml", "best/best_student",
                                 "best/best_teacher", "best/last_state"],
            root / "test_late": ["log.txt", "config.yaml"],
        }
        for folder, names in want_files.items():
            missing = [n for n in names if not (folder / n).exists()]
            check(not missing, f"(a) {folder.name} lacks {missing}")
        log("stages (a): every stage returned 0; files: "
            + "; ".join(f"{f.name}: {', '.join(n)}" for f, n in want_files.items()))

        # (b) the warm start: rebuilt as the first finetune built it
        args = common.build_argparser().parse_args(
            ["--config_dir", ft1_cfg, "--save_folder", str(root / "unused"),
             "--random_seed", str(STAGE_SEED), "--pretrained_ckpt", best_student])
        config = load_yaml_with_include(ft1_cfg)
        model, _ = cli.build_model(config, dev)
        fresh = {k: v.clone() for k, v in init_weights_(model, seed=STAGE_SEED).state_dict().items()}
        quiet = Logger("t4s_stages_check")
        warm = cli.load_pretrained(model, config, args, quiet, dev).state_dict()
        quiet.close()
        ckpt = checkpoint.restore_params(best_student)
        matched = sorted(k for k in fresh if k in ckpt and ckpt[k].shape == fresh[k].shape)
        dropped = [k for k in matched if re.search(DROP_PATTERN, jax_style_path(k, ckpt[k].dim()))]
        loaded = [k for k in matched if k not in dropped]
        kept = [k for k in fresh if k not in loaded]
        check(dropped == ["classifier.bias", "classifier.weight"],
              f"(b) the warm start dropped {dropped}")
        check(all(torch.equal(warm[k].cpu(), ckpt[k]) for k in loaded),
              "(b) a loaded key differs from the checkpoint")
        check(all(torch.equal(warm[k].cpu(), fresh[k]) for k in kept),
              "(b) a dropped or missing key is not the seeded init")
        line = re.search(r"warm start: (\d+) of (\d+) keys loaded, dropped (\[.*\])",
                         read_log(ft_dir)).groups()
        check(int(line[0]) == len(loaded) and int(line[1]) == len(fresh)
              and line[2] == str(dropped), f"(b) the stage logged {line}")
        log(f"stages (b): the warm start dropped {dropped} (JAX paths matched by "
            f"{DROP_PATTERN!r}), loaded {len(loaded)} of {len(fresh)} keys bitwise, kept "
            f"{len(kept) - len(dropped)} of the finetune model's own (the AT adapter) at the "
            "seeded init; the stage's log agrees")
        del model, warm, fresh

        # (c) the resume, and last_state restored into a fresh trainer bitwise
        ft_log = read_log(ft_dir)
        check(re.search(r"resumed from \S+last_state at step 4 \(epoch 1\)", ft_log),
              "(c) the second finetune did not log a resume at epoch 1")
        stage = cli.setup(["matsed_finetune", "--config_dir", ft2_cfg, "--save_folder",
                           str(root / "restore_check"), "--random_seed", str(STAGE_SEED)])
        trainer = cli.finetune_trainer(stage)
        stage.logger.close()
        trainer.restore_state(str(ft_dir / "best" / "last_state"))
        saved = torch.load(ft_dir / "best" / "last_state", weights_only=True)
        got = trainer.trainer.state_dict()
        n_equal = 0
        for part in ("student", "teacher"):
            for k, v in saved[part].items():
                check(torch.equal(got[part][k].cpu(), v), f"(c) {part} {k} differs")
                n_equal += 1
        for pid, st in saved["optimizer"]["state"].items():
            for k, v in st.items():
                check(torch.equal(got["optimizer"]["state"][pid][k].cpu(), v),
                      f"(c) AdamW {k} of param {pid} differs")
                n_equal += 1
        check(got["scheduler"] == saved["scheduler"] and got["step"] == saved["step"] == 8,
              f"(c) scheduler or step differ ({got['step']}, {saved['step']})")
        log(f"stages (c): resumed at step 4 (epoch 1); last_state (step {saved['step']}) "
            f"restored into a fresh trainer: {n_equal} tensors (student, teacher, AdamW "
            "moments and steps) bitwise, scheduler and step equal")
        del trainer, got, saved, stage

        # (d) finite losses and PSDS
        pre_nums = finite_log_numbers(read_log(pre_dir), r"INFO epoch \d+: train")
        ft_nums = finite_log_numbers(ft_log, r"INFO (epoch \d+: \w+=|val epoch|test \()")
        late_nums = finite_log_numbers(read_log(root / "test_late"), r"INFO test \(")
        ft2w_nums = finite_log_numbers(read_log(root / "finetune2"),
                                       r"INFO (epoch \d+: \w+=|val epoch|test \()")
        check(len(pre_nums) == 2 and len(ft_nums) > 30 and len(late_nums) == 2
              and len(ft2w_nums) > 15
              and all(np.isfinite(v) for v in pre_nums + ft_nums + late_nums + ft2w_nums),
              "(d) a loss or a PSDS is not finite")
        val_lines = re.findall(r"val epoch (\d): (.*)", ft_log)
        test_lines = re.findall(r"test \(median\): (.*)", ft_log)
        log(f"stages (d): {len(pre_nums) + len(ft_nums) + len(late_nums) + len(ft2w_nums)} "
            f"logged losses and "
            f"metrics, all finite; pretrain {re.findall(r'epoch 1: (train .*)', read_log(pre_dir))}; "
            f"validation {val_lines}; test {test_lines} (seeded random weights)")

        # (e) launches per stage
        names = {"row 1": "flash_attention_nhd", "row 2": "flash_xl_attention_nhd",
                 "row 7": "flash_attention_nhd_lse", "row 8": "flash_attention_nhd_backward",
                 "row 12": "flash_xl_attention_nhd_lse",
                 "row 13": "flash_xl_attention_nhd_backward"}
        train_rows = ("row 7", "row 8", "row 12", "row 13")
        for what, r in results.items():
            steps = r["counts"].get("train", 0)
            per = {row: r["launches"][fn] for row, fn in names.items()}
            others = {k: v for k, v in r["launches"].items() if v and k not in names.values()
                      and not k.startswith(("flash_bwd_", "flash_xl_bwd_"))}
            log(f"stages (e): {what}: launches {per}"
                + (f", a train step: " + ", ".join(
                    f"{row} {per[row] / steps:g}" for row in train_rows) if steps else "")
                + f"; {steps} train steps")
            check(not others, f"(e) {what} launched {others}")
            if steps:
                check(all(per[row] >= steps for row in train_rows),
                      f"(e) {what}: a train step without rows 7, 8, 12 and 13")
            else:
                check(all(per[row] == 0 for row in train_rows) and per["row 1"] > 0
                      and per["row 2"] > 0, f"(e) {what}: the test stage ran {per}")

        # (f) the loaders' decodes
        for what, r in results.items():
            check(r["decodes"]["python"] == 0 and r["batches"]["python"] == 0
                  and r["batches"]["native"] > 0,
                  f"(f) {what}: decodes {r['decodes']}, batch calls {r['batches']}")
        log("stages (f): every file through load_wav_batch's one native call a batch: "
            + "; ".join(f"{w}: {r['batches']['native']} calls, {r['decodes']['native']} files"
                        for w, r in results.items()))

        # (g) the ground truth as scores through the test stage's tables and PSDS
        val_gt = common.load_ground_truth(str(root / "val" / "strong.tsv"))
        val_dur = common.load_durations(str(root / "val" / "durations.tsv"))
        names_, truth, weak = truth_scores(gt, durations, codec)
        _, post = decode_mod.batched_decode_preds(
            torch.from_numpy(truth).to(dev), [f"{c}.wav" for c in names_], codec, filter=None,
            weak_preds=torch.from_numpy(weak).to(dev), need_weak_mask=True)
        outcome = {}
        for tag, cfg in (("the test split", ft2_cfg), ("the 1-s-late test split", late_cfg)):
            config = load_yaml_with_include(cfg)
            test_gt, test_dur, _ = matsed.load_test_tables(config, val_gt, val_dur)
            psds1, psds2, _ = matsed.psds_of(post, test_gt, test_dur)
            ok = psds1 >= GT_PSDS1_MIN
            outcome[tag] = ok
            log(f"stages (g): the ground truth as scores against {tag}'s tables (matsed_test's "
                f"load_test_tables and PSDS): psds1 {psds1:.6f}, psds2 {psds2:.6f} (limit psds1 "
                f">= {GT_PSDS1_MIN}): {'within' if ok else 'OUTSIDE'}")
        check(outcome["the test split"], "(g) the ground truth does not score itself")
        check(not outcome["the 1-s-late test split"],
              "(g) the check let the 1-s-late test split through")

    # steps/s and the evaluation split
    for what, r in results.items():
        t, n = r["times"], r["counts"]
        rest = t.get("eval", 0.0) - t.get("forward", 0.0) - t.get("decode", 0.0) - t.get(
            "psds", 0.0)
        train = (f"{n['train']} train steps in {t['train']:.2f} s, one pass: "
                 f"{n['train'] / t['train']:.3f} steps/s (the stage's first steps, loader "
                 "waits and the loss read each step included; a smoke timing, not a steady "
                 "rate); " if n.get("train") else "")
        split = (f" over {n['forward']} clip forwards: device (frontend + model, "
                 f"synchronised) {t['forward']:.2f} s, decode {t.get('decode', 0.0):.2f} s, PSDS "
                 f"sweeps {t.get('psds', 0.0):.2f} s, loader and the rest {rest:.2f} s"
                 if n.get("forward") else " (the masked-reconstruction loss, loader included)")
        log(f"stages ({card}): {what}: {r['seconds']:.1f} s in all; {train}evaluation "
            f"{t.get('eval', 0.0):.2f} s{split}")

# -- phase pmam_stages: PMAM's tokenizer and post-pretraining through the CLI ----------

PMAM_STAGE_CLIPS = 48  # the unlabeled folder of the tokenizer and post-pretraining
PMAM_STAGE_SEED = 21
PMAM_STAGE_BATCH = 24  # config/pmam/post_pretrain.yaml training.batch_size(_val)
PMAM_TOKENS = 30  # pmam.n_components
PMAM_TOKEN_DIM = 384  # the transformer_0 tap: decoder_dim
# The seeded post-pretrain checkpoint's LoRA factors are N(0, 0.05) each:
# (alpha / r) B A then has a std of 0.354 * 0.05 * 0.05 = 8.8e-4, 2.4 % of a
# weight's 1 / sqrt(768) = 0.036, so the adapters matter to every check and the
# planted fault of check (g), scale alpha for alpha / r, makes them 19 %.
# Check (e) measures bf16 against f32 only where the prototype head is smooth.
# The head turns the direction of mlm_pred into logits z = (2 leaky_relu(sim)
# - 1) / T with sim = n . mu_k, a gain of 2 |mu_k| / T, about 540 for the tap's
# GMM means (|mu_k| ~ 27, T = 0.1), so bf16's error in that direction (0.5 to
# 1.7 %) moves z by 0.1 to 1.0. The f32 loss has two steps that such errors
# cross: f32's sigmoid is exactly 1 above z ~ 16.6, where safe_log(1 - p) is
# the constant -100 with no gradient, and the leaky ReLU's slope is 5x larger
# above sim = 0 than below it. Any bf16 path shares this, the port's plain
# path in bf16 on the CPU as much as the kernels (PERF.md, section 6). The
# first AdamW steps are sign-like (a step-0 gradient norm of 300 to 660,
# clipped to 20), and each moves an adapter's product B A by an amount in
# proportion to its factors. At N(0, 0.1), with the adapters at 10 % of every
# weight, that takes a 3-step trajectory onto both steps: 2.8 % of the targets
# cross the kink between card and CPU, and 67 % of the other elements pass the
# clamp, where the CPU's own loss reads 65.7. The compared gradients then
# measure which elements cross a step, not the arithmetic. At N(0, 0.05) no
# element crosses either step at the state whose gradients (e) compares.
PMAM_LORA_STD = 0.05
# (a) the card's bf16 tap against the port's CPU f32 tap on the same mel, mask
# and offsets: ||card - cpu||_F / ||cpu||_F. bf16 rounds each GEMM operand and
# the attention weights (u = 2^-8); ten backbone blocks, the f-pool, the
# projectors and one decoder block add their errors in quadrature to a few
# per mille of the features' size, as phase 15's probabilities (0.05, the JAX
# package's bound) are a few per mille of theirs. 3 % is the train-parity
# bound on the loss's relative delta (TRAIN_LOSS_REL_MEAN).
PMAM_TAP_REL = 0.03
# (b) one EM iteration in f32 on the card against f64 on the CPU, from one
# state: max|card - ref| / max|ref| for the means, covariances and weights
PMAM_EM_REL = 1e-4
# the mean log-likelihood may fall by f32 noise only: sums of 12000 rows of
# ~10^2 in f32 carry a relative error near 1e-6; 1e-5 of (1 + |ll|)
PMAM_LOGLIK_SLACK = 1e-5
# (c) 30 probabilities written with %.6f each round by at most 5e-7
PMAM_PROB_SUM_TOL = 2e-5
# (c) the TSV's values against predict_proba of the tap computed apart: the
# %.6f rounding (5e-7) and nothing else (the same kernels on the same inputs)
PMAM_PROB_TOL = 1e-6
# launches, predicted in PERF.md section 6 before the first run: a tap batch
# stops at backbone block 10 and decoder block 0; a post-pretrain step runs
# every backbone block's LSE forward and backward (the AT branch reads the
# final-norm tokens, and the LoRA factors of all twelve blocks need their
# gradients), the three decoder blocks' LSE forwards and backwards
PMAM_TAP_LAUNCHES = dict(flash_attention_nhd=10, flash_xl_attention=1)
PMAM_POST_LAUNCHES = dict(flash_attention_nhd_lse=12, flash_attention_nhd_backward=12,
                          flash_xl_attention_lse=3, flash_xl_attention_backward=3)


def pmam_checkpoint(cfg_path, path):
    """The seeded post-pretrain PaSST_CNN of ``cfg_path`` (``init_weights_``
    at STAGE_SEED, the LoRA factors redrawn N(0, PMAM_LORA_STD)), saved as a
    port checkpoint at ``path``: the stand-in for the MLM stage's best
    student. Returns its state dict."""
    import torch

    from transformer4sed_tpu_torch.models.lora import is_lora_factor
    from transformer4sed_tpu_torch.recipes import cli
    from transformer4sed_tpu_torch.utils.checkpoint import save_params
    from transformer4sed_tpu_torch.utils.config import load_yaml_with_include
    from transformer4sed_tpu_torch.utils.weights import init_weights_

    model, _ = cli.build_model(load_yaml_with_include(cfg_path), torch.device("cpu"))
    init_weights_(model, seed=STAGE_SEED)
    gen = torch.Generator().manual_seed(STAGE_SEED + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if is_lora_factor(name):
                p.copy_(torch.randn(p.shape, generator=gen) * PMAM_LORA_STD)
    sd = model.state_dict()
    save_params(path, sd)
    return sd


def pmam_post_trainer(config, state_dict, gmm_means, device, dtype, cut=False):
    """A ``PMAMTrainer`` over the post-pretrain model of ``config`` with
    ``state_dict``, the CNN's dropout, the shift and the views off: the
    config's temperature, w_AT and param groups, clip 20. ``cut``: the
    backbone cut to PARITY_CUT, its first blocks' weights from ``state_dict``."""
    import torch

    from transformer4sed_tpu_torch.frontend.mel import PasstFrontend
    from transformer4sed_tpu_torch.models.passt_cnn import PaSST_CNN
    from transformer4sed_tpu_torch.pmam.train import PMAMConfig, PMAMTrainer
    from transformer4sed_tpu_torch.recipes import cli, common

    kwargs = cli._upstream_names(common.model_init_kwargs(config, "PaSST_CNN"))
    kwargs["cnn_param"] = dict(kwargs["cnn_param"], conv_dropout=0.0)
    model = PaSST_CNN(**{**kwargs, **(PARITY_CUT if cut else {})}, dtype=dtype, device="cpu")
    model.load_state_dict({k: state_dict[k] for k in model.state_dict()})
    pg, _, _ = common.optimizer_from_config(config, 1)
    cfg = PMAMConfig(temperature=config["pmam"]["temperature"], w_at=config["training"]["w_AT"],
                     max_shift_frame=0, transform_choice=(0, 0, 0, 0))
    return PMAMTrainer(model.to(device), PasstFrontend(device=device), gmm_means, cfg, pg)


def read_pseudo_label(path):
    """(header, [T, 2 + K] table) of a pseudo-label TSV."""
    import numpy as np

    with open(path) as f:
        header = f.readline().rstrip("\n")
    return header, np.loadtxt(path, delimiter="\t", skiprows=1, ndmin=2)


def pmam_stages(device="cuda"):
    """PMAM's chain (``exps/pmam/train.sh``) through ``recipes.cli.main`` on
    the card: the tokenizer (``pmam_extract``, ``pmam_gmm``,
    ``pmam_pseudo_labels``) and the post-pretraining (``pmam_train``) on the
    shipped ``config/pmam/post_pretrain.yaml`` at full width and depth, then
    ``matsed_finetune`` on ``config/pmam/finetune1.yaml`` and
    ``finetune2.yaml`` and ``matsed_test``; checks (a) to (g)."""
    import re
    import tempfile

    import numpy as np
    import torch
    from scipy.io import wavfile

    from transformer4sed_tpu_torch.models.lora import is_lora_factor, lora_modules
    from transformer4sed_tpu_torch.pmam.features import draw_offsets, sample_features
    from transformer4sed_tpu_torch.pmam.gmm import GaussianMixture
    from transformer4sed_tpu_torch.recipes import cli, common
    from transformer4sed_tpu_torch.utils.checkpoint import restore_params
    from transformer4sed_tpu_torch.utils.config import load_yaml_with_include

    card = card_line()
    dev = torch.device(device)
    seed = str(STAGE_SEED)
    with without_tensorflow(), tempfile.TemporaryDirectory(prefix="t4s_pmam_") as tmp:
        root = Path(tmp)
        codec = common.codec_from_config(
            load_yaml_with_include(str(ROOT / "config" / "pmam" / "finetune1.yaml")))
        t0 = time.perf_counter()
        write_stage_split(root, codec)
        folder = root / "pmam_unlabeled"
        folder.mkdir()
        for i, wav in enumerate(synthetic_clips(PMAM_STAGE_CLIPS, PMAM_STAGE_SEED)):
            wavfile.write(folder / f"u{i:03d}.wav", SR,
                          (np.clip(wav / 4.0, -1.0, 1.0) * 32767).astype(np.int16))
        epoch1 = {"training.scheduler.n_epochs": 1, "training.scheduler.n_epochs_cut": 1}
        # config/pmam/post_pretrain.yaml's MLM head predicts out_dim 768 while its
        # transformer_0 tap, which the GMM's means are made of, is 384 wide:
        # prototype_predictions cannot compare the two, in either package
        # (ROADMAP.md queue 3, "In the reference"), so the head is made 384 wide
        post_cfg = stage_config(root, "post_pretrain", "post_pretrain", {
            **epoch1, "dataset.unlabeled_folder": str(folder),
            "PaSST_CNN.init_kwargs.mlm_dict.out_dim": PMAM_TOKEN_DIM}, family="pmam")
        ft1_cfg = stage_config(root, "finetune1", "pmam_finetune1", epoch1, family="pmam")
        ft2_cfg = stage_config(root, "finetune2", "pmam_finetune2", epoch1, family="pmam")
        mlm_ckpt = str(root / "mlm" / "best_student")
        start = pmam_checkpoint(post_cfg, mlm_ckpt)
        log(f"pmam_stages: mini DESED, {PMAM_STAGE_CLIPS} unlabeled clips and the seeded "
            f"post-pretrain checkpoint ({sum(v.numel() for v in start.values())} values, LoRA "
            f"factors N(0, {PMAM_LORA_STD})) written in {time.perf_counter() - t0:.1f} s")
        tok, post, ft1, ft2 = (root / n for n in ("tokenizer", "post_pretrain", "finetune1",
                                                 "finetune2"))
        runs = [
            ("pmam_extract", post_cfg, tok, ["--pretrained_ckpt", mlm_ckpt]),
            ("pmam_gmm", post_cfg, tok, []),
            ("pmam_pseudo_labels", post_cfg, tok, ["--pretrained_ckpt", mlm_ckpt]),
            ("pmam_train", post_cfg, post, [
                "--gmm_means_path", str(tok / "gmm_means.npy"),
                "--pseudo_label_dir", str(tok / "pseudo_labels"), "--pretrained_ckpt", mlm_ckpt]),
            ("matsed_finetune", ft1_cfg, ft1,
             ["--pretrained_ckpt", str(post / "best" / "best_student")]),
            ("matsed_finetune (finetune2.yaml)", ft2_cfg, ft2,
             ["--pretrained_ckpt", str(ft1 / "best" / "best_student")]),
            ("matsed_test", ft2_cfg, ft2, ["--resume_ckpt", "auto"]),
        ]
        results = {}
        for what, cfg, out, extra in runs:
            reset_launches()
            t0 = time.perf_counter()
            rc = cli.main([what.split()[0], "--config_dir", cfg, "--save_folder", str(out),
                           "--random_seed", seed, *extra])
            torch.cuda.synchronize()
            results[what] = dict(rc=rc, seconds=time.perf_counter() - t0, launches=read_launches())
            log(f"pmam_stages: {what} returned {rc} in {results[what]['seconds']:.1f} s")
        check(all(r["rc"] == 0 for r in results.values()), "a PMAM stage returned non-zero")
        n_batches = -(-PMAM_STAGE_CLIPS // PMAM_STAGE_BATCH)
        for what, per, times in (("pmam_extract", PMAM_TAP_LAUNCHES, n_batches),
                                 ("pmam_pseudo_labels", PMAM_TAP_LAUNCHES, n_batches),
                                 ("pmam_train", with_bwd_passes(PMAM_POST_LAUNCHES), n_batches)):
            got = results[what]["launches"]
            want = {name: 0 for name in got}
            want.update({k: n * times for k, n in per.items()})
            log(f"pmam_stages: {what}: launches {({k: v for k, v in got.items() if v})}, "
                f"predicted {per} a {'step' if what == 'pmam_train' else 'batch'} x {times}")
            check(got == want, f"{what}: launches {got}, expected {want}")

        # (a) the tap: features.npy, and the card's bf16 tap against the CPU's f32 one
        feats = np.load(tok / "features.npy")
        rows = n_batches * -(-PMAM_STAGE_BATCH * 1000 // 4)
        check(feats.shape == (rows, PMAM_TOKEN_DIM) and np.isfinite(feats).all(),
              f"(a) features.npy is {feats.shape}, expected ({rows}, {PMAM_TOKEN_DIM}), finite")
        st = cli.setup(["pmam_pseudo_labels", "--config_dir", post_cfg, "--save_folder",
                        str(root / "check_card"), "--random_seed", seed,
                        "--pretrained_ckpt", mlm_ckpt])
        st.logger.close()
        model = st.model.eval()
        mel, names = next(iter(cli._mels(st, cli._unlabeled_loader(st, True))))
        cpu = cli.setup(["pmam_pseudo_labels", "--config_dir", post_cfg, "--save_folder",
                         str(root / "check_cpu"), "--random_seed", seed, "--device", "cpu",
                         "--pretrained_ckpt", mlm_ckpt])
        cpu.logger.close()
        gen = torch.Generator().manual_seed(7)
        draws = model.masker.draw(gen, 2, 1000)  # the decoder's 1000 frames a clip
        offsets = draw_offsets(gen, 2 * 1000, 4)
        layer = load_yaml_with_include(post_cfg)["pmam"]["feature_layer"]

        def tap(m, x):
            f = m.tap(x, layer, mlm_draws=draws)
            return sample_features(f.reshape(-1, f.shape[-1]), 4, offsets=offsets).float().cpu()

        ref = tap(cpu.model.eval(), mel[:2].float().cpu())
        del cpu

        def tap_error():
            got = tap(model, mel[:2])
            return float((got - ref).norm() / ref.norm()), float((got - ref).abs().max())

        rel, mx = tap_error()
        log(f"pmam_stages (a): features.npy {feats.shape}, finite; the card's bf16 "
            f"{layer} tap of 2 clips against the CPU f32 one (same mask and offsets, "
            f"{tuple(ref.shape)}): relative Frobenius error {rel:.5f} (limit {PMAM_TAP_REL}), "
            f"max |err| {mx:.4f} of max |ref| {float(ref.abs().max()):.3f}")
        check(rel < PMAM_TAP_REL, "(a) the card's tap leaves the CPU's")
        layers = lora_modules(model).values()
        for m in layers:
            m.scale = m.alpha
        rel_fault, _ = tap_error()
        for m in layers:
            m.scale = m.alpha / m.rank
        log(f"pmam_stages (g): LoRA's scale taken as alpha, not alpha / r, in {len(layers)} "
            f"layers: the tap's relative error {rel_fault:.5f} (limit {PMAM_TAP_REL}): "
            f"{'within' if rel_fault < PMAM_TAP_REL else 'OUTSIDE'}")
        check(rel_fault >= PMAM_TAP_REL, "(g) the tap check let the LoRA scale fault through")

        # (b) the GMM
        t0 = time.perf_counter()
        gmm = GaussianMixture(PMAM_TOKENS, "full", n_iter=50, device=dev).fit(feats)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        stage_means = np.load(tok / "gmm_means.npy")
        check(np.array_equal(gmm.means, stage_means),
              "(b) the refit's means differ from the stage's gmm_means.npy")
        ll = np.array(gmm.log_likelihoods)
        falls = ll[:-1] - ll[1:]
        slack = PMAM_LOGLIK_SLACK * (1 + np.abs(ll[:-1]))
        covs = torch.from_numpy(gmm.covariances).to(dev)
        info = torch.linalg.cholesky_ex(covs).info.cpu()
        wsum = float(np.sum(gmm.weights, dtype=np.float64))
        log(f"pmam_stages (b): GMM of {PMAM_TOKENS} full covariances over {feats.shape[0]} "
            f"rows x {feats.shape[1]}, 50 EM iterations ({gmm.rows_per_chunk} rows a chunk) "
            f"({card}): the stage {results['pmam_gmm']['seconds']:.2f} s with its loads and "
            f"model-free setup; the fit {fit_s:.3f} s, {feats.shape[0] * 50 / fit_s:.0f} "
            f"rows/s over the iterations; mean log-likelihood {ll[0]:.4f} -> {ll[-1]:.4f}, "
            f"largest fall {falls.max():.3e}, at most {(falls / slack).max():.3f} of its "
            f"slack {PMAM_LOGLIK_SLACK:g} (1 + |ll|); weights sum to "
            f"{wsum:.8f}; Cholesky failures {int((info != 0).sum())}")
        check(np.all(falls <= slack), "(b) the mean log-likelihood fell across an iteration")
        check(abs(wsum - 1.0) < 1e-5 and bool((info == 0).all()),
              "(b) the weights do not sum to 1 or a covariance does not factor")
        init = gmm.initial_state(feats)
        got = GaussianMixture(PMAM_TOKENS, "full", device=dev).em_step(
            torch.from_numpy(feats).to(dev), *init)
        want = GaussianMixture(PMAM_TOKENS, "full", device="cpu", dtype=torch.float64).em_step(
            feats, *init)
        errs = {name: float((g.double().cpu() - w).abs().max() / w.abs().max())
                for name, g, w in zip(("means", "covariances", "weights"), got[:3], want[:3])}
        log(f"pmam_stages (b): one EM iteration from the KMeans start, card f32 against CPU "
            f"f64: relative max error {errs} (limit {PMAM_EM_REL}); mean log-likelihood "
            f"{float(got[3]):.6f} vs {float(want[3]):.6f}")
        check(all(v < PMAM_EM_REL for v in errs.values()), "(b) the card's EM step leaves f64")

        # (c) the pseudo-labels
        tsvs = sorted((tok / "pseudo_labels").glob("*.tsv"))
        header = "onset\toffset\t" + "\t".join(f"proto_{i}" for i in range(PMAM_TOKENS))
        worst = 0.0
        tables = {}
        for path in tsvs:
            head, table = read_pseudo_label(path)
            check(head == header and table.shape == (1000, 2 + PMAM_TOKENS),
                  f"(c) {path.name}: header or shape {table.shape}")
            worst = max(worst, float(np.abs(table[:, 2:].sum(1) - 1.0).max()))
            tables[path.stem] = table
        check(len(tsvs) == PMAM_STAGE_CLIPS and worst <= PMAM_PROB_SUM_TOL,
              f"(c) {len(tsvs)} TSVs, probability sums off by {worst}")
        stage_gmm = cli.load_gmm(str(tok), dev)
        gen = torch.Generator().manual_seed(STAGE_SEED)
        tapped = model.tap(mel, layer, gen)
        stems = [Path(n).stem for n in names[:2]]

        def label_error(g):
            probs = g.predict_proba(tapped[:2].reshape(-1, tapped.shape[-1]).float())
            probs = probs.reshape(2, -1, PMAM_TOKENS).cpu().numpy()
            return max(float(np.abs(probs[j] - tables[s][:, 2:]).max())
                       for j, s in enumerate(stems))

        err = label_error(stage_gmm)
        log(f"pmam_stages (c): {len(tsvs)} TSVs of 1000 x (2 + {PMAM_TOKENS}), probability "
            f"sums within {worst:.2e} of 1 (limit {PMAM_PROB_SUM_TOL}); clips {stems}: the "
            f"TSVs against predict_proba of their tap computed apart, max |err| {err:.2e} "
            f"(limit {PMAM_PROB_TOL})")
        check(err <= PMAM_PROB_TOL, "(c) the TSVs are not the tap's posteriors")
        perm = np.roll(np.arange(PMAM_TOKENS), 1)
        stage_gmm.means = stage_gmm.means[perm]
        err_fault = label_error(stage_gmm)
        log(f"pmam_stages (g): the GMM's means permuted alone (covariances and weights kept): "
            f"max |err| {err_fault:.3e} (limit {PMAM_PROB_TOL}): "
            f"{'within' if err_fault <= PMAM_PROB_TOL else 'OUTSIDE'}")
        check(err_fault > PMAM_PROB_TOL, "(c) the check let the permuted means through")
        # (e)'s batch: phase pmam_train_parity's clips, labelled by the tokenizer
        parity_wav = synthetic_train_batch(PARITY_SPLIT, seed=13)["wav"]
        with torch.no_grad():
            pmel = st.frontend.normalize(st.frontend(torch.from_numpy(parity_wav).to(dev)))
            ptap = model.tap(pmel, layer, torch.Generator().manual_seed(STAGE_SEED))
            probs = cli.load_gmm(str(tok), dev).predict_proba(
                ptap.reshape(-1, PMAM_TOKEN_DIM).float())
        parity_batch = {"wav": parity_wav, "labels": probs.reshape(
            len(parity_wav), -1, PMAM_TOKENS).transpose(1, 2).cpu().numpy()}
        del st, model, tapped, ptap

        # (d) the post-pretraining
        text = read_log(post)
        nums = finite_log_numbers(text, r"INFO epoch \d+: loss")
        best = restore_params(str(post / "best" / "best_student"))
        lora = [k for k in start if is_lora_factor(k)]
        frozen = [k for k in start if k.startswith("backbone.") and k not in lora]
        learned = [k for k in start if k.startswith(("decoder.", "mlm_mlp."))]
        check(len(nums) == 3 and all(np.isfinite(nums)), f"(d) the train losses {nums}")
        check(len(lora) == 96 and all(not torch.equal(best[k], start[k]) for k in lora),
              "(d) a LoRA factor did not move")
        check(all(torch.equal(best[k], start[k]) for k in frozen),
              "(d) a frozen backbone param moved")
        still = [k for k in learned if torch.equal(best[k], start[k])]
        check(not still, f"(d) decoder or head params did not move: {still}")
        steps = n_batches
        per_step = {k: results["pmam_train"]["launches"][k] / steps for k in PMAM_POST_LAUNCHES}
        log(f"pmam_stages (d): one epoch, {steps} steps at B={PMAM_STAGE_BATCH}: "
            f"{re.search(r'epoch 1: (.*)', text).group(1)}; all {len(lora)} LoRA factors "
            f"moved, the other {len(frozen)} backbone tensors bitwise unchanged, all "
            f"{len(learned)} decoder and MLM-head tensors moved; best_student written; a step's "
            f"launches {per_step} (predicted {PMAM_POST_LAUNCHES}; row 8 launches: the LoRA "
            f"gradients cross the backbone); the stage {results['pmam_train']['seconds']:.1f} s "
            f"({card})")

        # (e) the prototype-BCE step, card bf16 against CPU f32
        post_config = load_yaml_with_include(post_cfg)

        def clips_batch(n):
            """The first n clips of the unlabeled folder and their pseudo-labels (the
            stage's TSVs)."""
            wavs = [wavfile.read(folder / f"u{i:03d}.wav")[1] / 32768.0 for i in range(n)]
            wav = np.stack([np.pad(w, (0, CLIP_SAMPLES - len(w))) for w in wavs])
            labels = np.stack([tables[f"u{i:03d}"][:, 2:].T for i in range(n)])
            return {"wav": wav.astype(np.float32), "labels": labels.astype(np.float32)}

        cpu_t = pmam_post_trainer(post_config, start, stage_means, "cpu", torch.float32, cut=True)
        card_t = pmam_post_trainer(post_config, start, stage_means, dev, torch.bfloat16, cut=True)
        trainer_parity("PMAM post-pretrain", cpu_t, card_t, parity_batch, PARITY_STEPS,
                       "loss_total", lambda t: (t.model,), trainable_only=True,
                       last_step_gradient=True)
        del cpu_t, card_t
        card_t = pmam_post_trainer(post_config, start, stage_means, dev, torch.bfloat16)
        time_training(card_t, clips_batch(PMAM_STAGE_BATCH), windows=2, per_window=3,
                      what="PMAM post-pretrain",
                      parts="frontend, masked forward, prototype BCE, backward through the "
                            "frozen backbone, clip, AdamW; no CNN dropout")
        del card_t

        # (f) the rest of the chain
        for what, out in (("matsed_finetune", ft1), ("matsed_finetune (finetune2.yaml)", ft2),
                          ("matsed_test", ft2)):
            text = read_log(out)
            nums = finite_log_numbers(text, r"INFO (epoch \d+: \w+=|val epoch|test \()")
            check(nums and all(np.isfinite(nums)), f"(f) {what}: a logged number is not finite")
        ft1_log = read_log(ft1)
        lacks = re.search(r"warm start: (\d+) checkpoint keys the model lacks, dropped: (.*)",
                          ft1_log)
        ft1_keys = restore_params(str(ft1 / "best" / "best_student"))
        want_lacks = [k for k in best if k not in ft1_keys]
        check(lacks is not None and int(lacks.group(1)) == len(want_lacks)
              and all(is_lora_factor(k) or k.startswith(
                  ("mlm_mlp.", "mask_token")) for k in want_lacks),
              f"(f) finetune1's log of the keys it dropped: {lacks and lacks.group(0)}")
        log(f"pmam_stages (f): finetune1 from the post-pretrained student dropped "
            f"{lacks.group(1)} keys the model lacks: {lacks.group(2)}; "
            + re.search(r"warm start: \d+ of \d+ keys loaded, dropped \[.*\]",
                        ft1_log).group(0)
            + f"; finetune2, test: {re.findall(r'test \(median\): (.*)', read_log(ft2))} "
            "(seeded weights); every logged number finite")
    for what, r in results.items():
        log(f"pmam_stages ({card}): {what}: {r['seconds']:.1f} s")

# -- phases 5 and 6: the train step ---------------------------------------------

TRAIN_SPLIT = (8, 8, 8)  # bench.py:measure_train: B=24, strong | weak | unlabeled
TRAIN_STEPS = 2
PARITY_SPLIT = (1, 1, 1)
PARITY_STEPS = 3
# The CPU f32 train parities of the earlier networks (phases 6, 6a's parity
# steps, 16, 18, 23 and check (e) of pmam_stages) run the PaSST backbone cut
# to PARITY_DEPTH of its 12 blocks, tapped at PARITY_TAP where the full nets
# tap at 10: the blocks past the tap still feed only the final-norm tokens.
# The CPU's f32 time there is mostly the backbone; the bounds are unchanged,
# and serving, training, timing and the profiles keep the full depth.
PARITY_DEPTH, PARITY_TAP = 4, 3
PARITY_CUT = dict(backbone_depth=PARITY_DEPTH, passt_feature_layer=PARITY_TAP)
# PMAM's freeze_layer (8 of 12 blocks) scaled to the cut backbone
PMAM_PARITY_FREEZE = round(8 * PARITY_DEPTH / 12)


def synthetic_train_batch(split, seed):
    """Learnable clips (as exps/precision_ab.py makes them): noise plus
    three tone bursts, a burst of class c at its own pitch 300 * 1.3^c Hz,
    in [strong | weak | unlabeled] order, with labels [B, 10, 1000] as the
    data layer lays them out (data/datasets.py:89): strong rows hold the
    bursts' frames (100 frames/s), weak rows their tags in frame 0,
    unlabeled rows nothing."""
    import numpy as np

    s, w, u = split
    rng = np.random.RandomState(seed)
    t = np.arange(CLIP_SAMPLES) / SR
    wav = np.zeros((s + w + u, CLIP_SAMPLES), np.float32)
    labels = np.zeros((s + w + u, 10, 1000), np.float32)
    for i in range(s + w + u):
        x = 0.05 * rng.randn(CLIP_SAMPLES)
        for _ in range(3):
            cls, on, dur = rng.randint(10), rng.uniform(0, 8), rng.uniform(0.3, 2.0)
            x += np.sin(2 * np.pi * 300 * 1.3 ** cls * t) * ((t >= on) & (t < on + dur))
            if i < s:
                labels[i, cls, int(on * 100):int((on + dur) * 100)] = 1.0
            elif i < s + w:
                labels[i, cls, 0] = 1.0
        wav[i] = x
    return {"wav": wav, "labels": labels}


def build_trainer(device, dtype, split, augment, state_dict=None, mesh=None, cut=False):
    """The flagship's mean-teacher trainer as bench.py:measure_train sets it:
    clip 20 then AdamW 1e-4 (optax.adamw's weight decay 1e-4) on every
    param, EMA 0.999; ``augment=False`` turns mixup, shift and views off.
    With a ``mesh``: the parallel layout, params sharded by
    ``parallel.shard_params`` and the step wrapped by
    ``parallel.shard_train_step``. ``cut``: the backbone cut to PARITY_CUT."""
    import torch

    from transformer4sed_tpu_torch.frontend.mel import PasstFrontend
    from transformer4sed_tpu_torch.models.passt_sed import PaSST_SED
    from transformer4sed_tpu_torch.parallel import shard_params, shard_train_step
    from transformer4sed_tpu_torch.train.mean_teacher import MeanTeacherConfig, MeanTeacherTrainer
    from transformer4sed_tpu_torch.train.optim import GroupSpec, ParamGroupConfig
    from transformer4sed_tpu_torch.utils.weights import init_weights_

    model = PaSST_SED(**{**FLAGSHIP, **(PARITY_CUT if cut else {})}, dtype=dtype, device="cpu")
    if state_dict is None:
        init_weights_(model, seed=0)
    else:
        model.load_state_dict(state_dict)
    model.to(device)
    if mesh is not None:
        shard_params(model, mesh)
    s, w, u = split
    off = {} if augment else dict(mixup_prob=0.0, max_shift_frame=0, n_transform=0)
    cfg = MeanTeacherConfig(strong_num=s, weak_num=w, unlabel_num=u, **off)
    spec = GroupSpec(lr=1e-4, weight_decay=1e-4)
    trainer = MeanTeacherTrainer(model, PasstFrontend(device=device), cfg,
                                 ParamGroupConfig(encoder=spec, decoder=spec, head=spec,
                                                  clip_grad=20.0))
    if mesh is not None:
        shard_train_step(trainer, mesh)
    return trainer


def finite_metrics(metrics):
    import math

    values = {k: float(v) for k, v in metrics.items()}
    check(all(math.isfinite(x) for x in values.values()), f"non-finite train metrics {values}")
    return values


def train(results):
    """Mean-teacher steps of the full-width flagship at B=24 with the
    default augmentation; returns (trainer, batch) for the timing phase."""
    import torch

    t0 = time.perf_counter()
    trainer = build_trainer("cuda", torch.bfloat16, TRAIN_SPLIT, augment=True)
    batch = synthetic_train_batch(TRAIN_SPLIT, seed=3)
    log(f"built the trainer in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(0)
    reset_launches()
    for i in range(TRAIN_STEPS):
        values = finite_metrics(trainer.step(batch, gen))
        log(f"train step {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in values.items()))
    torch.cuda.synchronize()
    launches = read_launches()
    per_step = dict(flash_attention_nhd=12, flash_xl_attention_nhd=3, flash_attention_nhd_lse=12,
                    flash_attention_nhd_backward=12, flash_xl_attention_nhd_lse=3,
                    flash_xl_attention_nhd_backward=3)
    want = {name: 0 for name in launches}
    want.update({k: n * TRAIN_STEPS for k, n in with_bwd_passes(per_step).items()})
    log(f"train launches over {TRAIN_STEPS} steps: {launches}")
    check(launches == want, f"kernel launches {launches} on the train path, expected {want}")
    for name in ("flash_attention_nhd_lse", "flash_attention_nhd_backward",
                 "flash_xl_attention_nhd_lse", "flash_xl_attention_nhd_backward",
                 "flash_bwd_prepass", "flash_bwd_postpass", "flash_xl_bwd_prepass",
                 "flash_xl_bwd_postpass"):
        results[name]["launches"] = launches[name]
    return trainer, batch


def trainer_parity(what, cpu, card, batch, steps, loss_key, modules, trainable_only=False,
                   last_step_gradient=False):
    """The same weights, ``steps`` steps on the CPU in f32 (plain versions)
    and on the card in bf16 (kernels), each step's draws from a generator
    seeded alike on both: loss trajectories, then the gradient at the CPU's
    end state in both, held to the JAX package's bf16-vs-f32 bounds.
    ``card`` may be a dict of named card trainers: each is held against the
    CPU and against the others with the same bounds. ``modules(trainer)``
    lists the modules that hold a trainer's state, the differentiated one
    first; params the loss does not read have no gradient on either side.
    ``trainable_only`` holds the gradients of the params the optimizer
    updates (its labels other than 'frozen') only. ``last_step_gradient``
    holds, in place of the end state's, the gradient that the CPU's last
    step computed (read before the clip) against the card's at the state
    that step started from, with its draws: the CPU then runs no fourth
    forward and backward."""
    import copy
    import itertools

    import numpy as np
    import torch

    cards = card if isinstance(card, dict) else {"card_bf16": card}
    sides = {"cpu_f32": cpu, **cards}
    pairs = [("cpu_f32", name) for name in cards] + list(itertools.combinations(cards, 2))

    def gradients(trainer):
        return {k: p.grad.detach().double().flatten().cpu()
                for k, p in modules(trainer)[0].named_parameters()
                if p.grad is not None and not (trainable_only and trainer.labels[k] == "frozen")}

    grads = {}
    losses = {name: [] for name in sides}
    for i in range(steps):
        if last_step_gradient and i == steps - 1:
            start = [copy.deepcopy(m.state_dict()) for m in modules(cpu)]
            start_count, seed = cpu.step_count, 10 + i
            forward_backward = cpu.forward_backward

            def keep_gradient(*args, **kwargs):
                metrics = forward_backward(*args, **kwargs)
                grads["cpu_f32"] = gradients(cpu)
                return metrics

            cpu.forward_backward = keep_gradient
        for name, trainer in sides.items():
            t0 = time.perf_counter()
            values = finite_metrics(trainer.step(batch, torch.Generator().manual_seed(10 + i)))
            losses[name].append(values[loss_key])
            log(f"{what} parity step {i} {name}: {loss_key} {values[loss_key]:.6f}, grad_norm "
                f"{values['grad_norm']:.4f} ({time.perf_counter() - t0:.1f} s)")
    if last_step_gradient:
        del cpu.forward_backward
    else:
        start = [m.state_dict() for m in modules(cpu)]
        start_count, seed = cpu.step_count, 20
    for a, b in pairs:
        ref, got = np.array(losses[a]), np.array(losses[b])
        rel = np.abs(ref - got) / np.maximum(np.abs(ref), 1e-9)
        log(f"{what} train parity {b} vs {a}: relative loss delta per step "
            f"{np.round(rel, 6).tolist()}, mean {rel.mean():.5f} (limit {TRAIN_LOSS_REL_MEAN}), "
            f"max {rel.max():.5f} (limit {TRAIN_LOSS_REL_MAX})")
        check(rel.mean() < TRAIN_LOSS_REL_MEAN and rel.max() < TRAIN_LOSS_REL_MAX,
              f"{what}: the {b} loss trajectory leaves the {a} one")

    for name, trainer in cards.items():
        for ours, theirs in zip(modules(trainer), start):
            ours.load_state_dict(theirs)
        trainer.step_count = start_count
    for name, trainer in sides.items():
        if name not in grads:
            trainer.forward_backward(batch, torch.Generator().manual_seed(seed))
            grads[name] = gradients(trainer)
    state = f"the f32 state of step {steps - 1}" if last_step_gradient else "the f32 end state"
    for a, b in pairs:
        check(grads[a].keys() == grads[b].keys() and grads[a],
              f"{what}: {a} and {b} give gradients to different params")
        g32, g16 = (torch.cat(list(grads[name].values())) for name in (a, b))
        cos = float(g32 @ g16 / (g32.norm() * g16.norm() + 1e-30))
        ratio = float(g16.norm() / (g32.norm() + 1e-30))
        log(f"{what} train parity {b} vs {a}: gradient at {state} over "
            f"{len(grads[a])} params, cosine {cos:.6f} (limit {TRAIN_GRAD_COS}), norm ratio "
            f"{ratio:.5f} (limits {TRAIN_GRAD_RATIO}), |g| {a} {float(g32.norm()):.5f}")
        if not (cos > TRAIN_GRAD_COS and TRAIN_GRAD_RATIO[0] < ratio < TRAIN_GRAD_RATIO[1]):
            # where the two gradients part: the params with the largest share
            # of |g_b - g_a|^2, each with its own norms
            diff = {k: float((grads[b][k] - grads[a][k]).square().sum()) for k in grads[a]}
            total = sum(diff.values()) or 1.0
            for k in sorted(diff, key=diff.get, reverse=True)[:12]:
                log(f"{what} train parity {b} vs {a}: {k}: {diff[k] / total:.1%} of the "
                    f"squared difference, |g| {a} {float(grads[a][k].norm()):.5f}, "
                    f"{b} {float(grads[b][k].norm()):.5f}")
        check(cos > TRAIN_GRAD_COS and TRAIN_GRAD_RATIO[0] < ratio < TRAIN_GRAD_RATIO[1],
              f"{what}: the {b} gradient disagrees with the {a} one")


def train_parity(mesh=None):
    """The flagship's mean-teacher step: PARITY_STEPS steps at B=3 without
    augmentation, CPU f32 against card bf16 (:func:`trainer_parity`). With a
    ``mesh``, the parallel layout's trainer on the card steps alongside and is
    held against both (one CPU f32 trajectory serves the two card paths)."""
    import torch

    cpu = build_trainer("cpu", torch.float32, PARITY_SPLIT, augment=False, cut=True)
    state = cpu.student.state_dict()
    cards = {"card_bf16": build_trainer("cuda", torch.bfloat16, PARITY_SPLIT, augment=False,
                                        state_dict=state, cut=True)}
    if mesh is not None:
        cards["card_parallel_bf16"] = build_trainer("cuda", torch.bfloat16, PARITY_SPLIT,
                                                    augment=False, state_dict=state, mesh=mesh,
                                                    cut=True)
    params = list(cpu.student.parameters())
    trainer_parity("flagship", cpu, cards, synthetic_train_batch(PARITY_SPLIT, seed=4),
                   PARITY_STEPS, "loss_total", lambda t: (t.student, t.teacher))
    check(all(p.grad is not None for p in params), "flagship: a param got no gradient")


# -- the parallel layout: the flagship's step through torch.distributed ----------------

PARALLEL_LAUNCHES = dict(flash_attention=12, flash_attention_lse=12, flash_attention_backward=12,
                         flash_xl_attention_nhd=3, flash_xl_attention_nhd_lse=3,
                         flash_xl_attention_nhd_backward=3)


def parallel_init():
    """One NCCL rank on localhost, through ``parallel.maybe_initialize``
    (``env://``: MASTER_ADDR 127.0.0.1, a free port); the ``data`` x ``model``
    mesh of 1 x 1 over it. Fails if NCCL does not come up: nothing runs the
    phase without a process group."""
    import os
    import socket

    import torch.distributed as dist

    from transformer4sed_tpu_torch.parallel import make_2d_mesh, maybe_initialize

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0", WORLD_SIZE="1")
    check(maybe_initialize(backend="nccl", timeout_s=300.0) and dist.get_backend() == "nccl",
          "the NCCL process group did not come up")
    mesh = make_2d_mesh(1, model_parallel=1)
    log(f"process group: {dist.get_backend()}, world {dist.get_world_size()}, mesh {mesh.shape} "
        f"on {mesh.device}")
    return mesh


def parallel_train(results, mesh):
    """Mean-teacher steps of the full-width flagship at B=24 (8 | 8 | 8), default
    augmentation, through ``shard_params`` and the parallel step over the 1 x 1
    mesh: finite losses and, per step, the teacher's 12 row-3 launches, the
    student's 12 row-5 and 12 row-6 launches, none of rows 1, 7 and 8, and the
    XL kernels as in phase 5. Returns (trainer, batch) for the timing phase."""
    import torch

    from transformer4sed_tpu_torch.parallel.partition import ColumnParallelDense

    t0 = time.perf_counter()
    trainer = build_trainer("cuda", torch.bfloat16, TRAIN_SPLIT, augment=True, mesh=mesh)
    attn = trainer.student.backbone.blocks[0].attn
    check(isinstance(attn.qkv, ColumnParallelDense) and attn.tp is not None
          and trainer.teacher.backbone.blocks[0].attn.tp is not None,
          "shard_params left the flagship's blocks unsharded")
    batch = synthetic_train_batch(TRAIN_SPLIT, seed=3)
    log(f"built the sharded trainer in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(0)
    reset_launches()
    for i in range(TRAIN_STEPS):
        values = finite_metrics(trainer.step(batch, gen))
        log(f"parallel train step {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in values.items()))
    torch.cuda.synchronize()
    launches = read_launches()
    want = {name: 0 for name in launches}
    want.update({k: n * TRAIN_STEPS for k, n in with_bwd_passes(PARALLEL_LAUNCHES).items()})
    log(f"parallel train launches over {TRAIN_STEPS} steps: {launches}")
    check(launches == want, f"kernel launches {launches} on the parallel train path, expected "
                            f"{want}")
    for name in ("flash_attention", "flash_attention_lse", "flash_attention_backward"):
        results[name]["launches"] = launches[name]
    return trainer, batch


def multichip_dryrun():
    """``dryrun_multichip(2)`` and ``dryrun_multichip(4)`` on the CPU, from one
    launch of four gloo ranks on localhost (the 2-rank layouts on the first
    two): both phases at the JAX harness's tolerances; prints each layout's
    trajectories."""
    from transformer4sed_tpu_torch.parallel.dryrun import print_report, run_layouts

    reports = run_layouts((2, 4))
    for n, report in reports.items():
        print_report(n, report)


# -- the HTSAT_CNN family: serving and the supervised train step -------------------

# config/audioset_strong/htsat_cnn.yaml (PyYAML is absent on the card's
# machine, so its values stand here): HTSAT_CNN.init_kwargs, val_kwargs and
# train_kwargs, training.batch_size(_val) and median_window, class_loss, opt
HTSAT_CNN_CFG = dict(
    class_num=447, decoder_dim=768, num_heads=12, decoder="transformerXL", decoder_layer_num=3,
    decoder_pos_emd_len=1000, backbone_upsample_ratio=10, htsat_config="tiny",
    cnn_param=dict(
        nb_filters=[16, 16, 32, 32, 64, 64, 128, 128, 256, 384], kernel_size=[3] * 10,
        padding=[1] * 10, stride=[1] * 10,
        pooling=[[2, 2], [1, 1], [2, 2], [1, 1], [1, 2], [1, 2], [1, 2], [1, 2], [1, 1], [1, 1]],
        conv_dropout=0.5, activation="cg"),
)
HTSAT_FRAMES = 320       # feature.pred_len: 32 latent frames x 10
HTSAT_NET_POOLING = 3.125  # feature.net_subsample: 1000 / 320
HTSAT_MEDIAN = 7
HTSAT_VAL_KWARGS = {"temp_w": 0.5}
HTSAT_TRAIN_KWARGS = {"temp_w": 1}
HTSAT_LOSS = dict(loss_name="AslLoss", loss_kwargs={"rp": 0, "rn": 4, "margin": 0.05})
HTSAT_OPT = dict(encoder=dict(lr=1.0e-5, weight_decay=1.0e-4, freeze_layer=0, step_lr=4),
                 decoder=dict(lr=2.0e-4, weight_decay=1.0e-4),
                 head=dict(lr=2.0e-4, weight_decay=1.0e-4))
HTSAT_CLIP_GRAD = 20.0   # training.clip_grad: true (recipes/common.py:455)
HTSAT_TRAIN_STEPS = 3
HTSAT_PARITY_BATCH, HTSAT_PARITY_STEPS = 4, 3
# launches per served batch / per train step: 12 Swin blocks, 3 XL blocks
HTSAT_SERVE_LAUNCHES = dict(window_attention=12, flash_xl_attention_nhd=3)
HTSAT_TRAIN_LAUNCHES = dict(window_attention=12, window_attention_backward=12,
                            flash_xl_attention_nhd_lse=3, flash_xl_attention_nhd_backward=3)


def audioset_labels():
    with open(ROOT / "meta" / "audioset_strong" / "labeldict_audioset_strong.json") as f:
        table = json.load(f)
    return [name for name, _ in sorted(table.items(), key=lambda kv: kv[1])]


def build_htsat_model(device, dtype, state_dict=None, **overrides):
    from transformer4sed_tpu_torch.models.htsat_heads import HTSAT_CNN
    from transformer4sed_tpu_torch.utils.weights import init_weights_

    cfg = dict(HTSAT_CNN_CFG)
    cfg["cnn_param"] = dict(cfg["cnn_param"], **overrides)
    model = HTSAT_CNN(**cfg, dtype=dtype, device="cpu")
    if state_dict is None:
        init_weights_(model, seed=0)
    else:
        model.load_state_dict(state_dict)
    return model.to(device)


def build_htsat_engine(device, dtype, state_dict=None, batch_size=HTSAT_BATCH):
    from transformer4sed_tpu_torch.core.codec import LabelCodec
    from transformer4sed_tpu_torch.models.htsat import HTSATFrontend
    from transformer4sed_tpu_torch.recipes.serve import InferenceEngine

    codec = LabelCodec(audioset_labels(), audio_len=10.0, frame_len=1024, frame_hop=320,
                       net_pooling=HTSAT_NET_POOLING, sr=SR)
    check(codec.n_frames == HTSAT_FRAMES and codec.n_classes == 447,
          f"codec of {codec.n_frames} frames and {codec.n_classes} classes")
    model = build_htsat_model(device, dtype, state_dict)
    return InferenceEngine(model.eval(), HTSATFrontend(device=device), codec, HTSAT_MEDIAN,
                           batch_size=batch_size, threshold=0.5, model_kwargs=HTSAT_VAL_KWARGS,
                           device=device)


def htsat_serve(engine, results):
    """Two full batches of 64 synthetic 10-s clips and a ragged one of 20
    through ``InferenceEngine``: shapes, finiteness, events, launch counts."""
    import numpy as np

    clips = synthetic_clips(2 * HTSAT_BATCH + 20, seed=7)
    batches = make_batches(clips, engine.codec, HTSAT_BATCH)
    check([len(b["filename"]) for b in batches] == [64, 64, 20], "batches of 64, 64 and 20 clips")
    reset_launches()
    served = list(engine.score_batches(batches))
    launches = read_launches()
    log(f"HTSAT_CNN served {sum(len(n) for n, _, _ in served)} clips in {len(served)} batches; "
        f"launches {launches}")
    want = {name: 0 for name in launches}
    want.update({k: n * len(batches) for k, n in HTSAT_SERVE_LAUNCHES.items()})
    check(launches == want, f"kernel launches {launches} on the HTSAT_CNN served path, expected "
                            f"{want} (12 window and 3 XL per batch)")
    results["window_attention"]["launches"] = launches["window_attention"]
    n_events = 0
    for (names, scores, weak), batch in zip(served, batches):
        check(names == batch["filename"], "results come back in order")
        check(scores.shape == (len(names), HTSAT_FRAMES, 447) and weak.shape == (len(names), 447),
              f"output shapes {scores.shape}, {weak.shape}")
        check(np.all(np.isfinite(scores)) and np.all(np.isfinite(weak)), "finite outputs")
        check(np.all((scores > 0) & (scores <= 1)) and np.all((weak > 0) & (weak <= 1)),
              "probabilities in (0, 1]")
        for i in range(len(names)):
            for label, onset, offset in engine.decode(scores[i]):
                check(label in engine.codec.labels and 0.0 <= onset < offset <= 10.0,
                      f"event {label, onset, offset}")
                n_events += 1
    short = served[0][1][5]  # 6.5-s clip: frames from 208 are padding, clipped to 1e-7
    check(np.all(short[208 + HTSAT_MEDIAN // 2:] <= 1.0001e-7), "padded frames are at the floor")
    log(f"decoded {n_events} events; scores finite in (0, 1]; padded frames at the 1e-7 floor")
    return batches


def htsat_parity(card_engine, batches):
    """The same weights on 2 clips in eval mode: CPU f32 (plain versions)
    against the card's bf16 (kernels), on probabilities."""
    import numpy as np
    import torch

    state = {k: v.detach().cpu() for k, v in card_engine.model.state_dict().items()}
    cpu_engine = build_htsat_engine("cpu", torch.float32, state_dict=state, batch_size=2)
    wav = torch.from_numpy(batches[0]["wav"][4:6].copy())  # clip 5 is the short one
    pm = torch.from_numpy(batches[0]["pad_mask"][4:6].copy())
    outs = {}
    for name, engine in (("cpu_f32", cpu_engine), ("card_bf16", card_engine)):
        with torch.no_grad():
            mel = engine.frontend.normalize(engine.frontend(wav.to(engine.device)))
            out = engine.model(mel, pad_mask=pm.to(engine.device), **HTSAT_VAL_KWARGS)
        outs[name] = {k: getattr(out, k).float().cpu().numpy() for k in ("strong", "weak")}
    worst = 0.0
    for key in ("strong", "weak"):
        diff = float(np.abs(outs["cpu_f32"][key] - outs["card_bf16"][key]).max())
        worst = max(worst, diff)
        log(f"HTSAT_CNN card bf16 vs CPU f32 {key}: max_abs_diff {diff:.4e} (tol {DTYPE_MAX_ABS}); "
            f"CPU {key} spans {outs['cpu_f32'][key].min():.3e} .. {outs['cpu_f32'][key].max():.3e}")
    check(worst <= DTYPE_MAX_ABS, "HTSAT_CNN: the card's path disagrees with the CPU f32 path")


def synthetic_audioset_batch(b, seed, frames=HTSAT_FRAMES):
    """Learnable clips for the 447 classes: noise plus three tone bursts, a
    burst of class c at its own pitch 150 * 2^(c / 70) Hz, with strong labels
    [B, 447, frames] on the model's grid (HTSAT_CNN's 32 frames/s, DASM's 100)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    t = np.arange(CLIP_SAMPLES) / SR
    fps = frames / 10
    wav = np.zeros((b, CLIP_SAMPLES), np.float32)
    labels = np.zeros((b, 447, frames), np.float32)
    for i in range(b):
        x = 0.05 * rng.randn(CLIP_SAMPLES)
        for _ in range(3):
            cls, on, dur = rng.randint(447), rng.uniform(0, 8), rng.uniform(0.3, 2.0)
            x += np.sin(2 * np.pi * 150 * 2 ** (cls / 70) * t) * ((t >= on) & (t < on + dur))
            labels[i, cls, int(on * fps):int((on + dur) * fps)] = 1.0
        wav[i] = x
    return {"wav": wav, "labels": labels}


def build_supervised(device, dtype, augment, dropout, state_dict=None):
    """The recipe's supervised step: AslLoss, the config's param groups,
    clip 20; ``augment=False`` turns shift, mixup and filt_aug off,
    ``dropout=False`` the CNN's conv_dropout."""
    from transformer4sed_tpu_torch.models.htsat import HTSATFrontend
    from transformer4sed_tpu_torch.recipes.audioset_strong import SupervisedConfig, SupervisedStep
    from transformer4sed_tpu_torch.train.optim import GroupSpec, ParamGroupConfig

    overrides = {} if dropout else {"conv_dropout": 0.0}
    model = build_htsat_model(device, dtype, state_dict, **overrides)
    off = {} if augment else dict(mixup_prob=0.0, max_shift_frame=0,
                                  transform_choice=(0, 0, 0, 0))
    cfg = SupervisedConfig(**HTSAT_LOSS, model_kwargs=HTSAT_TRAIN_KWARGS, **off)
    groups = {k: GroupSpec(**v) for k, v in HTSAT_OPT.items()}
    return SupervisedStep(model, HTSATFrontend(device=device), cfg,
                          ParamGroupConfig(**groups, clip_grad=HTSAT_CLIP_GRAD))


def htsat_train(results):
    """Supervised steps of the full-width HTSAT_CNN at B=64 with the
    recipe's augmentation and dropout; returns (stepper, batch)."""
    import torch

    t0 = time.perf_counter()
    stepper = build_supervised("cuda", torch.bfloat16, augment=True, dropout=True)
    batch = synthetic_audioset_batch(HTSAT_BATCH, seed=8)
    log(f"built the HTSAT_CNN supervised step in {time.perf_counter() - t0:.1f} s; param groups "
        f"{sorted(set(stepper.labels.values()))}")
    stats = {k: v.clone() for k, v in stepper.model.state_dict().items() if "running_" in k}
    gen = torch.Generator().manual_seed(0)
    reset_launches()
    for i in range(HTSAT_TRAIN_STEPS):
        values = finite_metrics(stepper.step(batch, gen))
        log(f"HTSAT_CNN train step {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in values.items()))
    torch.cuda.synchronize()
    launches = read_launches()
    want = {name: 0 for name in launches}
    want.update({k: n * HTSAT_TRAIN_STEPS
                 for k, n in with_bwd_passes(HTSAT_TRAIN_LAUNCHES).items()})
    log(f"HTSAT_CNN train launches over {HTSAT_TRAIN_STEPS} steps: {launches}")
    check(launches == want, f"kernel launches {launches} on the HTSAT_CNN train path, expected "
                            f"{want}")
    results["window_attention_backward"]["launches"] = launches["window_attention_backward"]
    now = stepper.model.state_dict()
    check(len(stats) == 22 and all(not torch.equal(now[k], v) for k, v in stats.items()),
          "a BatchNorm running statistic did not move")
    check(int(now["backbone.bn0.num_batches_tracked"]) == HTSAT_TRAIN_STEPS,
          "bn0 did not count its batches")
    log(f"all {len(stats)} running statistics moved over the steps")
    return stepper, batch


def htsat_train_parity():
    """HTSAT_CNN's supervised step: HTSAT_PARITY_STEPS steps at B=4 with
    augmentation and dropout off, CPU f32 against card bf16
    (:func:`trainer_parity`)."""
    import torch

    cpu = build_supervised("cpu", torch.float32, augment=False, dropout=False)
    card = build_supervised("cuda", torch.bfloat16, augment=False, dropout=False,
                            state_dict=cpu.model.state_dict())
    trainer_parity("HTSAT_CNN", cpu, card, synthetic_audioset_batch(HTSAT_PARITY_BATCH, seed=9),
                   HTSAT_PARITY_STEPS, "loss_class_strong", lambda t: (t.model,))
    check(all(p.grad is not None for p in cpu.model.parameters()),
          "HTSAT_CNN: a param got no gradient")


# -- the PMAM network (PaSST_CNN): serving and the mean-teacher step ------------------

# config/pmam/finetune1.yaml (PyYAML is absent on the card's machine, so its
# values stand here): PaSST_CNN.init_kwargs (the loader drops f_pool_heads and
# renames cnn_param's kernel / pad), training.*, test_kwargs, opt.param_groups
PMAM_CFG = dict(
    class_num=10, passt_feature_layer=10, f_pool="attention", at_adapter=True,
    decoder="transformerXL", decoder_layer_num=3, decoder_pos_emd_len=1000, decoder_dim=384,
    cnn_name="base",
    cnn_param=dict(
        activation="cg", conv_dropout=0.5, kernel_size=[3] * 10, padding=[1] * 10,
        stride=[1] * 10, nb_filters=[16, 16, 32, 32, 64, 64, 128, 128, 256, 384],
        pooling=[[2, 2], [1, 1], [2, 2], [1, 1], [1, 2], [1, 2], [1, 2], [1, 2], [1, 2], [1, 1]]),
)
PMAM_TEST_KWARGS = {"temp_w": 0.5}
# training.batch_size [4, 2, 6, 6] = strong, synth, weak, unlabeled; the recipe
# folds synth into strong (recipes/matsed.py:79-81): strong 6 | weak 6 | unlabeled 6
PMAM_SPLIT = (6, 6, 6)
PMAM_MT = dict(
    w_weak=0.5, w_weak_cons=0.5, w_at=2.0, w_cons_max=2.0, w_cons_min=0.0,
    cons_scheduler="Linear", ema_factor=0.999, n_transform=2, transform_choice=(1, 0, 0, 1),
    filter_db_range=(-26, 26), filter_bands=(2, 5), filter_minimum_bandwidth=4,
    filter_type="step", self_loss_warmup_steps=8 * 100,  # self_loss_warmup epochs x steps
    stu_kwargs={"temp_w": 1}, tch_kwargs={"temp_w": 1})
PMAM_OPT = dict(encoder=dict(lr=5.0e-6, weight_decay=1.0e-4, freeze_layer=8, step_lr=0),
                decoder=dict(lr=1.5e-4, weight_decay=1.0e-4),
                head=dict(lr=2.0e-4, weight_decay=1.0e-4))
PMAM_TRAIN_STEPS = 2
# launches per served batch: 12 backbone blocks, 3 decoder blocks of 12 heads of 32
PMAM_SERVE_LAUNCHES = dict(flash_attention_nhd=12, flash_xl_attention=3)
# per train step: the teacher's forwards as served; the student's LSE forwards
# and backwards. freeze_layer 8 leaves blocks 0..7 out of the optimizer, but the
# port, like the JAX step, differentiates all twelve and drops their gradients
PMAM_TRAIN_LAUNCHES = dict(flash_attention_nhd=12, flash_xl_attention=3,
                           flash_attention_nhd_lse=12, flash_attention_nhd_backward=12,
                           flash_xl_attention_lse=3, flash_xl_attention_backward=3)


def build_pmam_model(device, dtype, state_dict=None, cut=False, **cnn_overrides):
    from transformer4sed_tpu_torch.models.passt_cnn import PaSST_CNN
    from transformer4sed_tpu_torch.utils.weights import init_weights_

    cfg = {**PMAM_CFG, **(PARITY_CUT if cut else {})}
    cfg["cnn_param"] = dict(cfg["cnn_param"], **cnn_overrides)
    model = PaSST_CNN(**cfg, dtype=dtype, device="cpu")
    if state_dict is None:
        init_weights_(model, seed=0)
    else:
        model.load_state_dict(state_dict)
    return model.to(device)


def build_pmam_engine(device, dtype, state_dict=None):
    from transformer4sed_tpu_torch.core.codec import LabelCodec
    from transformer4sed_tpu_torch.frontend.mel import PasstFrontend
    from transformer4sed_tpu_torch.recipes.serve import InferenceEngine

    codec = LabelCodec(desed_labels(), audio_len=10.0, frame_len=1024, frame_hop=320,
                       net_pooling=1, sr=SR)
    model = build_pmam_model(device, dtype, state_dict)
    check(model.decoder.encoder_blocks[0].attn.pos_bias_u.shape == (12, 32),
          "PMAM's decoder has 12 heads of 32")
    widths = [int(w / 156 * codec.n_frames) for w in MEDIAN_WINDOW]
    return InferenceEngine(model.eval(), PasstFrontend(device=device), codec, widths,
                           batch_size=8, threshold=0.5, model_kwargs=PMAM_TEST_KWARGS,
                           device=device)


def pmam_serve(engine, results):
    """20 synthetic 10-s clips (8, 8 and a ragged 4) through ``InferenceEngine``
    with the full-width PaSST_CNN: shapes, finiteness, events, launch counts."""
    import numpy as np

    batches = make_batches(synthetic_clips(20, seed=11), engine.codec, 8)
    reset_launches()
    served = list(engine.score_batches(batches))
    launches = read_launches()
    log(f"PMAM served {sum(len(n) for n, _, _ in served)} clips in {len(served)} batches; "
        f"launches {launches}")
    want = {name: 0 for name in launches}
    want.update({k: n * len(batches) for k, n in PMAM_SERVE_LAUNCHES.items()})
    check(launches == want, f"kernel launches {launches} on the PMAM served path, expected "
                            f"{want} (12 flash and 3 head-major XL per batch, no d=64 XL)")
    results["flash_xl_attention"]["launches"] = launches["flash_xl_attention"]
    n_events = 0
    for (names, scores, weak), batch in zip(served, batches):
        check(names == batch["filename"], "results come back in order")
        check(scores.shape == (len(names), 1000, 10) and weak.shape == (len(names), 10),
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
    log(f"PMAM decoded {n_events} events; scores finite in [0, 1]; padded frames zero")
    return batches


def build_pmam_trainer(device, dtype, split, augment, dropout, state_dict=None,
                       tch_kwargs=None, cut=False):
    """The recipe's mean-teacher trainer over PaSST_CNN: the config's loss
    weights, transform and param groups, clip 20; ``augment=False`` turns mixup,
    shift and views off, ``dropout=False`` the CNN's conv_dropout; ``tch_kwargs``
    replaces the teacher's forward kwargs; ``cut``: the backbone cut to
    PARITY_CUT, PMAM_PARITY_FREEZE of its blocks frozen."""
    from transformer4sed_tpu_torch.frontend.mel import PasstFrontend
    from transformer4sed_tpu_torch.train.mean_teacher import MeanTeacherConfig, MeanTeacherTrainer
    from transformer4sed_tpu_torch.train.optim import GroupSpec, ParamGroupConfig

    model = build_pmam_model(device, dtype, state_dict, cut,
                             **({} if dropout else {"conv_dropout": 0.0}))
    s, w, u = split
    off = {} if augment else dict(mixup_prob=0.0, max_shift_frame=0, n_transform=0)
    cfg = MeanTeacherConfig(strong_num=s, weak_num=w, unlabel_num=u, **{**PMAM_MT, **off})
    if tch_kwargs is not None:
        cfg = dataclasses.replace(cfg, tch_kwargs=dict(tch_kwargs))
    groups = {k: GroupSpec(**v) for k, v in PMAM_OPT.items()}
    if cut:
        groups["encoder"] = dataclasses.replace(groups["encoder"],
                                                freeze_layer=PMAM_PARITY_FREEZE)
    return MeanTeacherTrainer(model, PasstFrontend(device=device), cfg,
                              ParamGroupConfig(**groups, clip_grad=20.0))


def running_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}


def pmam_train(results):
    """Mean-teacher steps of the full-width PaSST_CNN at the config's batch
    (B=18) with its augmentation and CNN dropout; returns (trainer, batch)."""
    import torch

    t0 = time.perf_counter()
    trainer = build_pmam_trainer("cuda", torch.bfloat16, PMAM_SPLIT, augment=True, dropout=True)
    batch = synthetic_train_batch(PMAM_SPLIT, seed=12)
    groups = sorted(set(trainer.labels.values()))
    frozen = sum(v == "frozen" for v in trainer.labels.values())
    log(f"built the PMAM trainer in {time.perf_counter() - t0:.1f} s; param groups {groups}, "
        f"{frozen} of {len(trainer.labels)} params frozen")
    check(groups == ["decoder", "encoder_low", "frozen", "head"], f"PMAM param groups {groups}")
    before = [running_stats(m) for m in (trainer.student, trainer.teacher)]
    gen = torch.Generator().manual_seed(0)
    reset_launches()
    for i in range(PMAM_TRAIN_STEPS):
        values = finite_metrics(trainer.step(batch, gen))
        log(f"PMAM train step {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in values.items()))
    torch.cuda.synchronize()
    launches = read_launches()
    want = {name: 0 for name in launches}
    want.update({k: n * PMAM_TRAIN_STEPS
                 for k, n in with_bwd_passes(PMAM_TRAIN_LAUNCHES).items()})
    log(f"PMAM train launches over {PMAM_TRAIN_STEPS} steps: {launches}")
    check(launches == want, f"kernel launches {launches} on the PMAM train path, expected {want}")
    results["flash_xl_attention_lse"]["launches"] = launches["flash_xl_attention_lse"]
    results["flash_xl_attention_backward"]["launches"] = launches["flash_xl_attention_backward"]
    for who, model, was in zip(("student", "teacher"), (trainer.student, trainer.teacher), before):
        now = running_stats(model)
        check(len(was) == 20 and all(not torch.equal(now[k], v) for k, v in was.items()),
              f"a BatchNorm running statistic of the {who} did not move")
    stu, tch = (running_stats(m) for m in (trainer.student, trainer.teacher))
    check(any(not torch.equal(stu[k], tch[k]) for k in stu),
          "the teacher's running statistics are the student's")
    log("all 20 running statistics of the student and of the teacher moved, each model's own")
    return trainer, batch


def pmam_train_parity():
    """PMAM's mean-teacher step: PARITY_STEPS steps at B=3 with augmentation
    and dropout off, CPU f32 against card bf16 (:func:`trainer_parity`)."""
    import torch

    cpu = build_pmam_trainer("cpu", torch.float32, PARITY_SPLIT, augment=False, dropout=False,
                             cut=True)
    card = build_pmam_trainer("cuda", torch.bfloat16, PARITY_SPLIT, augment=False, dropout=False,
                              state_dict=cpu.student.state_dict(), cut=True)
    trainer_parity("PMAM", cpu, card, synthetic_train_batch(PARITY_SPLIT, seed=13), PARITY_STEPS,
                   "loss_total", lambda t: (t.student, t.teacher))
    check(all(p.grad is not None for p in cpu.student.parameters()),
          "PMAM: a param got no gradient")


# -- the MLM pretrain step of the flagship ---------------------------------------------

# config/mat-sed/pretrain.yaml: PaSST_SED.init_kwargs, training.batch_size
# [4, 4, 16] (three unlabeled-style sources, B=24), training.transform, opt
MLM_CFG = dict(FLAGSHIP, at_adapter=False, mlm=True,
               mlm_dict=dict(mask_rate=0.75, mask_style=(0.8, 0.1, 0.1), strategy="block",
                             block_width=10, out_dim=768))
MLM_BATCH = 24
MLM_TRANSFORM = dict(transform_choice=(1, 0, 0, 0), filter_db_range=(-26, 26),
                     filter_bands=(2, 5), filter_minimum_bandwidth=4, filter_type="step")
MLM_OPT = dict(encoder=dict(lr=0.0, weight_decay=1.0e-4, freeze_layer=0, step_lr=0),
               decoder=dict(lr=2.0e-4, weight_decay=1.0e-4),
               head=dict(lr=2.0e-4, weight_decay=1.0e-4))
MLM_TRAIN_STEPS = 2
# block masking of 1000 frames: int(100 * 0.75) + 1 = 76 of the 100 segments
MLM_MASKED_SHARE = 0.76
# per step: the decoder's d=64 LSE forwards and backwards (rows 12, 13). The
# encoder group is frozen (lr 0), but the target is not detached and the port,
# like the JAX step, differentiates the backbone: every block runs its LSE
# forward, and the ten blocks up to the tap run their backward (blocks 11 and
# 12 feed only the final-norm tokens, which no MLM output reads)
MLM_TRAIN_LAUNCHES = dict(flash_attention_nhd_lse=12, flash_attention_nhd_backward=10,
                          flash_xl_attention_nhd_lse=3, flash_xl_attention_nhd_backward=3)


def build_mlm_trainer(device, dtype, augment, state_dict=None, cut=False):
    from transformer4sed_tpu_torch.frontend.mel import PasstFrontend
    from transformer4sed_tpu_torch.models.passt_sed import PaSST_SED
    from transformer4sed_tpu_torch.train.mlm import MLMConfig, MLMTrainer
    from transformer4sed_tpu_torch.train.optim import GroupSpec, ParamGroupConfig
    from transformer4sed_tpu_torch.utils.weights import init_weights_

    model = PaSST_SED(**{**MLM_CFG, **(PARITY_CUT if cut else {})}, dtype=dtype, device="cpu")
    if state_dict is None:
        init_weights_(model, seed=0)
    else:
        model.load_state_dict(state_dict)
    model.to(device)
    off = {} if augment else dict(max_shift_frame=0, transform_choice=(0, 0, 0, 0))
    groups = {k: GroupSpec(**v) for k, v in MLM_OPT.items()}
    return MLMTrainer(model, PasstFrontend(device=device), MLMConfig(**{**MLM_TRANSFORM, **off}),
                      ParamGroupConfig(**groups, clip_grad=20.0))


def mlm_train():
    """MLM pretrain steps of the full-width flagship at B=24 with the
    config's transform and the frozen encoder; returns (trainer, batch)."""
    import torch

    t0 = time.perf_counter()
    trainer = build_mlm_trainer("cuda", torch.bfloat16, augment=True)
    batch = {"wav": synthetic_train_batch((0, 0, MLM_BATCH), seed=14)["wav"]}
    log(f"built the MLM trainer in {time.perf_counter() - t0:.1f} s; param groups "
        f"{sorted(set(trainer.labels.values()))}")
    encoder = {k: v.clone() for k, v in trainer.model.backbone.state_dict().items()}
    head = trainer.model.mlm_mlp[2].weight.detach().clone()
    gen = torch.Generator().manual_seed(0)
    reset_launches()
    for i in range(MLM_TRAIN_STEPS):
        values = finite_metrics(trainer.step(batch, gen))
        log(f"MLM train step {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in values.items()))
        check(values["loss_mlm"] > 0, "the MLM loss is zero")
        check(abs(values["masked_share"] - MLM_MASKED_SHARE) < 1e-6,
              f"masked share {values['masked_share']}, expected {MLM_MASKED_SHARE}")
    torch.cuda.synchronize()
    launches = read_launches()
    want = {name: 0 for name in launches}
    want.update({k: n * MLM_TRAIN_STEPS for k, n in with_bwd_passes(MLM_TRAIN_LAUNCHES).items()})
    log(f"MLM train launches over {MLM_TRAIN_STEPS} steps: {launches}")
    check(launches == want, f"kernel launches {launches} on the MLM train path, expected {want}")
    now = trainer.model.backbone.state_dict()
    check(all(torch.equal(now[k], v) for k, v in encoder.items()),
          "a param of the frozen encoder moved")
    check(not torch.equal(trainer.model.mlm_mlp[2].weight, head), "the MLM head did not move")
    log("the frozen encoder kept its weights; the decoder and the MLM head moved")
    return trainer, batch


def mlm_train_parity():
    """The MLM step: PARITY_STEPS steps at B=3 with shift and views off, the
    mask drawn from generators seeded alike, CPU f32 against card bf16
    (:func:`trainer_parity`)."""
    import torch

    cpu = build_mlm_trainer("cpu", torch.float32, augment=False, cut=True)
    card = build_mlm_trainer("cuda", torch.bfloat16, augment=False,
                             state_dict=cpu.model.state_dict(), cut=True)
    batch = {"wav": synthetic_train_batch((0, 0, 3), seed=15)["wav"]}
    trainer_parity("MLM", cpu, card, batch, PARITY_STEPS, "loss_mlm", lambda t: (t.model,))


# -- row 4: flash attention with an additive score bias -------------------------------

BIAS_HEADS, BIAS_T = 12, 1000
# the masked and the band-width decoder, both bf16, compute one function
# through two kernels that differ only in f32 sums; an output's bf16 rounding
# can flip, and each of the three blocks carries its residual on: 8 ulps of
# the largest output
MASKED_OUT_REL = 2.0 ** -5
# the same two decoders' gradients over the input and every param: one
# function through two bf16 kernels read cosine 0.999986 and norm ratio
# 0.99996 on the card (PERF.md section 2); the limits sit between that and the
# planted faults' readings
MASKED_GRAD_COS = 0.9999
MASKED_GRAD_RATIO_TOL = 1e-3
# per-head band widths of the masked-decoder phase (no shipped config sets
# decoder_win_len): narrow to wider than the sequence
DECODER_BANDS = (8, 16, 32, 48, 64, 96, 128, 200, 256, 400, 640, 2000)
MASKED_BATCH = 8


def bias_inputs(b, t, h, d, seed, expand_batch=False):
    """(q, k, v, bias, mask) as the XL attention's masked branch hands them
    to row 4: q, k, v [B, H, T, d] strided views of a [B, T, 3*H*d]
    projection, and an f32 bias [B, H, T, T] of position-like scores with
    -1e30 where blocked. Blocked: a per-head band, the last keys of batch 0
    (a key mask), and every key of row 3 (a fully masked row). With
    ``expand_batch`` the bias is one batch's expanded (batch stride 0)."""
    import torch

    from transformer4sed_tpu_torch.models.xl import build_band_mask

    q, k, v = flash_hm_inputs(b, t, h, d, seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    widths = [DECODER_BANDS[i % len(DECODER_BANDS)] for i in range(h)]
    mask = torch.as_tensor(build_band_mask(t, widths), device="cuda")[None].repeat(b, 1, 1, 1)
    mask[0, :, :, t - t // 8:] = True
    mask[:, :, 3, :] = True
    scores = torch.randn(1 if expand_batch else b, h, t, t, generator=gen, device="cuda")
    bias = torch.where(mask[:1] if expand_batch else mask, -1e30, scores)
    if expand_batch:
        bias, mask = bias.expand(b, h, t, t), mask[:1].expand(b, h, t, t)
    return q, k, v, bias, mask


def check_bias_kernels(results, rejected):
    """Row 4 against its plain version in f32 on the same bf16 inputs: the
    masked decoder's [8, 12, 1000, 64] (main path) and PMAM's [8, 12, 1000,
    32], ragged T = 37 and 130 (the latter with a batch-expanded bias); a
    per-head band, a key mask and a fully masked row in each; scales -0.125
    and 0 at B=2, T=77. Then five planted faults: the bias dropped, the bias
    read transposed, the last key tile dropped, the last key tile left
    unmasked (TMA's zero keys counted), -inf in place of -1e30. Then the
    autograd Function's gradients against autograd of the plain version."""
    import torch

    from transformer4sed_tpu_torch.kernels.flash_attention import (
        _bias_kernel,
        flash_attention_bias,
        flash_attention_bias_reference,
    )

    cases = [  # (b, h, t, d, expand the batch?, main path?)
        (MASKED_BATCH, BIAS_HEADS, BIAS_T, 64, False, True),
        (MASKED_BATCH, BIAS_HEADS, BIAS_T, 32, False, False),
        (2, 4, 37, 64, False, False),
        (3, 2, 130, 32, True, False),
    ]
    for b, h, t, d, expand, main in cases:
        tag = f"B={b} H={h} T={t} d={d}{' batch-expanded bias' if expand else ''}"
        q, k, v, bias, mask = bias_inputs(b, t, h, d, seed=t + d, expand_batch=expand)
        scale = d ** -0.5
        qf, kf, vf = q.float(), k.float(), v.float()
        ref = flash_attention_bias_reference(qf, kf, vf, bias, scale)
        ref_abs_v = flash_attention_bias_reference(qf, kf, vf.abs(), bias, scale)
        out = flash_attention_bias(q, k, v, bias, scale)
        check(out.shape == q.shape, "flash_attention_bias keeps the shape")
        ok, mx = held(f"kernel flash_attention_bias {tag}", out, ref, ref_abs_v)
        check(ok, "flash_attention_bias disagrees with its plain version")
        if main:
            results["flash_attention_bias"]["max_abs_err"] = mx
            out = flash_attention_bias(q, k, v, torch.zeros_like(bias), scale)
            rejected.append(held("planted fault: bias dropped", out, ref, ref_abs_v)[0])
            out = flash_attention_bias(q, k, v, bias.transpose(-1, -2).contiguous(), scale)
            rejected.append(held("planted fault: bias read transposed", out, ref,
                                 ref_abs_v)[0])
            m = t // 64 * 64  # a kernel that skipped the ragged last key tile
            out = flash_attention_bias(q[:, :, :m], k[:, :, :m], v[:, :, :m],
                                       bias[:, :, :m, :m], scale)
            rejected.append(held(f"planted fault: last {t - m} keys dropped", out,
                                 ref[:, :, :m], ref_abs_v[:, :, :m])[0])
            out = _bias_kernel(q, k, v, bias, scale, skip_tail_mask=1)
            rejected.append(held("planted fault: the last key tile unmasked (zero keys counted)",
                                 out, ref, ref_abs_v)[0])
            out = flash_attention_bias(q, k, v, bias.masked_fill(mask, float("-inf")), scale)
            rejected.append(held("planted fault: -inf in place of -1e30 (the fully masked row)",
                                 out, ref, ref_abs_v)[0])
        del ref, ref_abs_v, out
        torch.cuda.empty_cache()
    # any scale the reference takes: zero and negative too
    q, k, v, bias, _ = bias_inputs(2, 77, 12, 64, seed=79)
    qf, kf, vf = q.float(), k.float(), v.float()
    for scale in (-0.125, 0.0):
        ref = flash_attention_bias_reference(qf, kf, vf, bias, scale)
        ref_abs_v = flash_attention_bias_reference(qf, kf, vf.abs(), bias, scale)
        ok, _ = held(f"kernel flash_attention_bias B=2 H=12 T=77 d=64 scale={scale}",
                     flash_attention_bias(q, k, v, bias, scale), ref, ref_abs_v)
        check(ok, f"flash_attention_bias disagrees with its plain version at scale {scale}")

    # the backward: the Function's gradients against autograd of the plain version
    b, h, t, d = 2, 4, 130, 64
    q, k, v, bias, _ = bias_inputs(b, t, h, d, seed=5)
    do = grad_output((b, h, t, d), seed=6)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v, bias)]
    flash_attention_bias(*leaves, d ** -0.5).backward(do)
    got = [x.grad for x in leaves]
    plain = [x.detach().clone().requires_grad_() for x in (q, k, v, bias)]
    flash_attention_bias_reference(*plain, d ** -0.5).backward(do)
    for name, g, x, want in zip(("dq", "dk", "dv", "dbias"), got, leaves, plain):
        diff = float((g.float() - want.grad.float()).abs().max())
        log(f"FlashAttentionBias backward {name} ({g.dtype}) against autograd of the plain "
            f"version: max_abs_diff {diff:.3e}")
        check(g.dtype == x.dtype and diff == 0.0,
              f"FlashAttentionBias's {name} differs from the plain version's gradient")


# -- row 16: the flash variants' experiment ---------------------------------------------

VARIANT_SHAPE = (64, 12, 1190, 64)  # exps/flash_variants.py's default


def check_variant_kernels(results, rejected):
    """Row 16, variants A and B, against the plain version in f32 on the
    same bf16 inputs, at the entry point's VARIANT_SHAPE [64, 12, 1190, 64]
    (main path; the plain version's f32 scores take 4.4 GB) and ragged T = 37
    and 130, and at scales -0.125 and 0 (B=2, T=77); three planted faults at
    the main shape: the zero keys of the padded tail counted in the row sum
    (the inputs padded to whole tiles), and in each variant the last key tile
    left unmasked (TMA's zero keys counted). Then the experiment's entry
    point at its default [64, 12, 1190, 64]; its launches are the path's
    count."""
    import torch
    import torch.nn.functional as F

    from transformer4sed_tpu_torch.exps import flash_variants as fv
    from transformer4sed_tpu_torch.kernels.flash_attention import flash_attention_reference

    cases = [(*VARIANT_SHAPE, True), (2, 4, 37, 64, False), (2, 2, 130, 32, False)]
    for b, h, t, d, main in cases:
        q, k, v = flash_hm_inputs(b, t, h, d, seed=t + d + 2, strided=False)
        scale = d ** -0.5
        qf, kf, vf = q.float(), k.float(), v.float()
        ref = flash_attention_reference(qf, kf, vf, scale)
        ref_abs_v = flash_attention_reference(qf, kf, vf.abs(), scale)
        for use_exp2 in (False, True):
            tag = f"{'B tail+exp2' if use_exp2 else 'A tail-mask'} B={b} H={h} T={t} d={d}"
            out = fv.flash_a(q, k, v, scale, use_exp2)
            ok, mx = held(f"kernel flash_a {tag}", out, ref, ref_abs_v)
            check(ok, "flash_a disagrees with its plain version")
            if main:
                r = results["flash_a"]
                r["max_abs_err"] = max(r.get("max_abs_err", 0.0), mx)
                out = fv._variant_kernel(q, k, v, scale, use_exp2, skip_tail_mask=1)
                rejected.append(held(f"planted fault: {tag[:11]} with the last key tile "
                                     f"unmasked (zero keys counted)", out, ref, ref_abs_v)[0])
        if main:
            pad = (0, 0, 0, -t % 64)
            out = fv.flash_a(*(F.pad(x, pad) for x in (q, k, v)), scale)[:, :, :t]
            rejected.append(held("planted fault: the padded tail's zero keys counted", out, ref,
                                 ref_abs_v)[0])
        del ref, ref_abs_v, out
        torch.cuda.empty_cache()
    # any scale the reference takes: zero and negative too
    q, k, v = flash_hm_inputs(2, 77, 4, 64, seed=80, strided=False)
    qf, kf, vf = q.float(), k.float(), v.float()
    for scale in (-0.125, 0.0):
        ref = flash_attention_reference(qf, kf, vf, scale)
        ref_abs_v = flash_attention_reference(qf, kf, vf.abs(), scale)
        for use_exp2 in (False, True):
            ok, _ = held(f"kernel flash_a {'B' if use_exp2 else 'A'} B=2 H=4 T=77 d=64 "
                         f"scale={scale}", fv.flash_a(q, k, v, scale, use_exp2), ref, ref_abs_v)
            check(ok, f"flash_a disagrees with its plain version at scale {scale}")
    reset_launches()
    fv.main([str(VARIANT_SHAPE[0]), str(VARIANT_SHAPE[2])])
    launches = read_launches()
    log(f"flash_variants main launches: {launches}")
    check(launches["flash_a"] > 0 and launches["flash_attention"] > 0,
          "the experiment's entry point did not launch row 16 and row 3")
    results["flash_a"]["launches"] = launches["flash_a"]


def masked_decoder(results):
    """The flagship's 3-layer XL decoder at full width (B=8, T=1000, 12 heads
    of 64), bf16, with the per-head band DECODER_BANDS given two ways: as
    band widths (row 2 without gradients, rows 12 and 13 with) and as an
    explicit [H, T, T] mask through the masked branch (row 4, its backward
    by recompute). Outputs and gradients (input and every param) agree
    within MASKED_OUT_REL, MASKED_GRAD_COS and MASKED_GRAD_RATIO_TOL; the
    launch counters show which kernel ran. Then three planted faults in the
    masked path must each fall outside one of those limits: the position
    scores one key off (rel_shift rolled), pos_bias_u and pos_bias_v swapped,
    the gradients 5 % large."""
    import contextlib

    import torch

    from transformer4sed_tpu_torch.models import xl
    from transformer4sed_tpu_torch.models.xl import TransformerXLDecoder, build_band_mask
    from transformer4sed_tpu_torch.utils.weights import init_weights_

    b, t, c, h = MASKED_BATCH, BIAS_T, 768, BIAS_HEADS
    dec = init_weights_(TransformerXLDecoder(c, 3, h, 1000, window_len=DECODER_BANDS,
                                             dtype=torch.bfloat16), seed=3).cuda()
    mask = torch.as_tensor(build_band_mask(t, list(DECODER_BANDS)), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(b, t, c, generator=gen, device="cuda")
    g = torch.randn(b, t, c, generator=gen, device="cuda")
    n_params = len(list(dec.parameters()))

    def masked(inp):  # the decoder's forward, the band handed in as a mask
        pos_emb = dec.pos_emb(t)
        inp = inp * c ** 0.5
        for blk in dec.encoder_blocks:
            inp = blk(inp, pos_emb, mask=mask)
        return inp

    def run(name, fn):
        """(output f32, gradient over input and params as one f64 vector);
        logs and returns the launches without and with gradients."""
        reset_launches()
        with torch.no_grad():
            out = fn(x).float()
        torch.cuda.synchronize()
        fwd = read_launches()
        xi = x.clone().requires_grad_()
        dec.zero_grad(set_to_none=True)
        fn(xi).float().backward(g)
        grad = torch.cat([xi.grad.flatten().double()]
                         + [p.grad.flatten().double() for p in dec.parameters()])
        torch.cuda.synchronize()
        train = {k: n - fwd[k] for k, n in read_launches().items()}
        log(f"masked decoder, {name}: launches without grad {fwd}, with grad {train}")
        return out, grad, fwd, train

    def agree(what, a, ga, m, gm):
        rel = float((a - m).abs().max() / a.abs().max())
        cos = float(ga @ gm / (ga.norm() * gm.norm()))
        ratio = float(gm.norm() / ga.norm())
        ok = (rel <= MASKED_OUT_REL and cos > MASKED_GRAD_COS
              and abs(ratio - 1.0) <= MASKED_GRAD_RATIO_TOL)
        log(f"{what}: output max_abs_diff / max|out| {rel:.4e} (limit {MASKED_OUT_REL}); "
            f"gradient over input and {n_params} params cosine {cos:.6f} (limit "
            f"{MASKED_GRAD_COS}), norm ratio {ratio:.6f} (limit 1 +- {MASKED_GRAD_RATIO_TOL}): "
            f"{'within' if ok else 'OUTSIDE'}")
        return ok

    @contextlib.contextmanager
    def planted(attr, fn):  # the masked branch with one of its helpers replaced
        orig = getattr(xl, attr)
        setattr(xl, attr, fn(orig))
        try:
            yield
        finally:
            setattr(xl, attr, orig)

    a, ga, band_fwd, band_train = run("band widths", dec)
    m, gm, mask_fwd, mask_train = run("explicit mask", masked)
    want = {k: 0 for k in band_fwd}
    check(band_fwd == dict(want, flash_xl_attention_nhd=3)
          and band_train == dict(want, **with_bwd_passes(dict(
              flash_xl_attention_nhd_lse=3, flash_xl_attention_nhd_backward=3)))
          and mask_fwd == dict(want, flash_attention_bias=3)
          and mask_train == dict(want, flash_attention_bias=3),
          "the masked decoder's paths launched other kernels than rows 2 / 12, 13 / 4")
    results["flash_attention_bias"]["launches"] = mask_fwd["flash_attention_bias"]
    check(agree("masked decoder: explicit mask vs band widths", a, ga, m, gm),
          "the masked decoder disagrees with the band-width decoder")

    rejected = []
    with planted("rel_shift", lambda f: lambda s: f(s).roll(1, dims=-1)):
        fm, fgm = run("planted fault: position scores one key off", masked)[:2]
    rejected.append(agree("planted fault: position scores one key off", a, ga, fm, fgm))
    with planted("add_pos_bias", lambda f: lambda q, u, v, heads: f(q, u, v, heads)[::-1]):
        fm, fgm = run("planted fault: pos_bias_u and pos_bias_v swapped", masked)[:2]
    rejected.append(agree("planted fault: pos_bias_u and pos_bias_v swapped", a, ga, fm, fgm))
    rejected.append(agree("planted fault: the masked path's gradients 5 % large", a, ga, m,
                          gm * 1.05))
    check(not any(rejected), "the masked-decoder check let a planted fault through")
    log(f"all {len(rejected)} masked-decoder planted faults fall outside the limits")


# -- finetune2: the sliding-window encoder ------------------------------------------

# the blocks a window group's backbone call runs: it stops at the tap layer
# (PaSST 768/12/12 tapped at layer 10, the flagship's and PMAM's)
TAP = FLAGSHIP["passt_feature_layer"]
# config/mat-sed/finetune2.yaml: train_stu_kwargs, train_tch_kwargs, test_kwargs
FT2 = dict(encoder_win=True, win_param=(512, 31), mix_rate=0.5)
# training.batch_size [3, 1, 4, 4] (finetune1's): strong 3 + synth 1 | weak 4 | unlabeled 4
FT2_SPLIT = (4, 4, 4)
FT2_TRAIN_STEPS = 2
# the CPU f32 parity windows 512 frames at a step of 490: two windows a clip
# (512 and a ragged 511, two width groups) where the config's step of 31
# makes 17; each step's CPU time stays near twice the plain flagship's
FT2_PARITY = dict(FT2, win_param=(512, 490))
FT2_PARITY_STEPS = 2
# config/pmam/finetune2.yaml: the teacher windowed at [512, 49], the student not;
# training.batch_size [4, 2, 6, 6]: strong 6 | weak 6 | unlabeled 6
PMAM_FT2_TCH = dict(encoder_win=True, win_param=(512, 49), mix_rate=0.5, temp_w=1)
PMAM_FT2_SPLIT = (6, 6, 6)
MEL_FRAMES = 1001  # PasstFrontend: 10-s clips at hop 320, centred


def window_groups(win_param):
    """The number of backbone calls a clip's windows take (width groups)."""
    from transformer4sed_tpu_torch.models.slide import width_groups

    return len(width_groups(MEL_FRAMES, *win_param))


def build_ft2_engine(device, dtype, state_dict=None):
    engine = build_engine(device, dtype, state_dict)
    engine.model_kwargs.update(FT2)
    return engine


def finetune2_serve(results):
    """The flagship served with finetune2's windows (B=8; 20 clips, 8, 8 and a
    ragged 4): shapes, finiteness, events, and per batch row 1 in each of the
    clip's 12 blocks and in each window group's blocks up to the tap layer
    (TAP), row 2 three times."""
    import torch

    t0 = time.perf_counter()
    engine = build_ft2_engine("cuda", torch.bfloat16)
    per_batch = dict(flash_attention_nhd=12 + TAP * window_groups(FT2["win_param"]),
                     flash_xl_attention_nhd=3)
    batches = serve(engine, results, per_batch=per_batch,
                    what="finetune2 served")
    log(f"finetune2 serve phase {time.perf_counter() - t0:.1f} s")
    return engine, batches


def build_ft2_trainer(device, dtype, split, augment, state_dict=None, kwargs=FT2, cut=False):
    trainer = build_trainer(device, dtype, split, augment, state_dict, cut=cut)
    trainer.cfg = dataclasses.replace(trainer.cfg, stu_kwargs=dict(kwargs),
                                      tch_kwargs=dict(kwargs))
    return trainer


def finetune2_train(results):
    """Mean-teacher steps of the full-width flagship with finetune2's windows
    for student and teacher at the shipped batch (4 | 4 | 4), default
    augmentation; per step row 1 (the teacher) and row 7 in each of the
    clip's 12 blocks and each window group's TAP blocks (a window's backbone
    call stops at the tap layer), row 8 in the blocks that feed an output
    (the clip's 12, each window group's TAP), rows 2, 12, 13 three times;
    then PMAM's finetune2 step (teacher windowed at [512, 49], student not) at
    6 | 6 | 6. Returns both (trainer, batch) pairs for the timing phase."""
    import torch

    n_win = window_groups(FT2["win_param"])
    t0 = time.perf_counter()
    trainer = build_ft2_trainer("cuda", torch.bfloat16, FT2_SPLIT, augment=True)
    batch = synthetic_train_batch(FT2_SPLIT, seed=16)
    gen = torch.Generator().manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for i in range(FT2_TRAIN_STEPS):
        values = finite_metrics(trainer.step(batch, gen))
        log(f"finetune2 train step {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in values.items()))
    torch.cuda.synchronize()
    launches = read_launches()
    per_step = dict(flash_attention_nhd=12 + TAP * n_win, flash_xl_attention_nhd=3,
                    flash_attention_nhd_lse=12 + TAP * n_win,
                    flash_attention_nhd_backward=12 + TAP * n_win,
                    flash_xl_attention_nhd_lse=3, flash_xl_attention_nhd_backward=3)
    want = {name: 0 for name in launches}
    want.update({k: n * FT2_TRAIN_STEPS for k, n in with_bwd_passes(per_step).items()})
    log(f"finetune2 train launches over {FT2_TRAIN_STEPS} steps: {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check(launches == want, f"kernel launches {launches} on the finetune2 path, expected {want}")
    log(f"finetune2 train phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    p_trainer = build_pmam_trainer("cuda", torch.bfloat16, PMAM_FT2_SPLIT, augment=True,
                                   dropout=True, tch_kwargs=PMAM_FT2_TCH)
    p_batch = synthetic_train_batch(PMAM_FT2_SPLIT, seed=17)
    reset_launches()
    for i in range(FT2_TRAIN_STEPS):
        values = finite_metrics(p_trainer.step(p_batch, gen))
        log(f"PMAM finetune2 train step {i}: "
            + ", ".join(f"{k} {v:.5f}" for k, v in values.items()))
    torch.cuda.synchronize()
    launches = read_launches()
    per_step = dict(PMAM_TRAIN_LAUNCHES, flash_attention_nhd=(
        PMAM_TRAIN_LAUNCHES["flash_attention_nhd"]
        + TAP * window_groups(PMAM_FT2_TCH["win_param"])))
    want = {name: 0 for name in launches}
    want.update({k: n * FT2_TRAIN_STEPS for k, n in with_bwd_passes(per_step).items()})
    log(f"PMAM finetune2 train launches over {FT2_TRAIN_STEPS} steps: {launches}")
    check(launches == want, f"kernel launches {launches} on PMAM's finetune2 path, expected {want}")
    log(f"PMAM finetune2 train phase {time.perf_counter() - t0:.1f} s")
    return (trainer, batch), (p_trainer, p_batch)


def finetune2_train_parity():
    """Both finetune2 steps, FT2_PARITY_STEPS steps at B=3 (1 | 1 | 1) without
    augmentation (and PMAM without dropout), CPU f32 against card bf16
    (:func:`trainer_parity`), windowed as FT2_PARITY says: the flagship's
    student and teacher, PMAM's teacher."""
    import torch

    cpu = build_ft2_trainer("cpu", torch.float32, PARITY_SPLIT, augment=False,
                            kwargs=FT2_PARITY, cut=True)
    card = build_ft2_trainer("cuda", torch.bfloat16, PARITY_SPLIT, augment=False,
                             state_dict=cpu.student.state_dict(), kwargs=FT2_PARITY, cut=True)
    trainer_parity("finetune2", cpu, card, synthetic_train_batch(PARITY_SPLIT, seed=18),
                   FT2_PARITY_STEPS, "loss_total", lambda t: (t.student, t.teacher))
    del cpu, card
    tch = dict(PMAM_FT2_TCH, win_param=FT2_PARITY["win_param"])
    cpu = build_pmam_trainer("cpu", torch.float32, PARITY_SPLIT, augment=False, dropout=False,
                             tch_kwargs=tch, cut=True)
    card = build_pmam_trainer("cuda", torch.bfloat16, PARITY_SPLIT, augment=False,
                              dropout=False, state_dict=cpu.student.state_dict(), tch_kwargs=tch,
                              cut=True)
    trainer_parity("PMAM finetune2", cpu, card, synthetic_train_batch(PARITY_SPLIT, seed=19),
                   FT2_PARITY_STEPS, "loss_total", lambda t: (t.student, t.teacher))


# -- DASM (config/dasm/*.yaml): serving, the closed-set step and the AudioSet stages ------

DASM_BATCH = 8           # served, as the flagship
DASM_TRAIN_BATCH = 48    # training.batch_size of both DASM configs
DASM_TRAIN_STEPS = 2
DASM_PARITY_BATCH, DASM_PARITY_STEPS = 2, 2
DASM_SEED = 23           # the seeded weights and query banks
DASM_FRAMES = 1000       # feature.pred_len
DASM_QUERY_DIMS = (512, 768)  # query_dim: [text, audio]
# launches per served batch / per train step: 12 backbone blocks, 3 XL blocks; the
# AT decoder's attention (447 queries over 1188 tokens) is plain PyTorch, as the
# JAX package computes it outside any kernel. A step differentiates every
# backbone block: at_projector reads the final-norm tokens
DASM_SERVE_LAUNCHES = dict(flash_attention_nhd=12, flash_xl_attention_nhd=3)
DASM_TRAIN_LAUNCHES = dict(flash_attention_nhd_lse=12, flash_attention_nhd_backward=12,
                           flash_xl_attention_nhd_lse=3, flash_xl_attention_nhd_backward=3)


def dasm_yaml(name="closed_set"):
    """The shipped ``config/dasm/<name>.yaml``, read by the port's YAML reader."""
    from transformer4sed_tpu_torch.utils.config import load_yaml_with_include

    return load_yaml_with_include(str(ROOT / "config" / "dasm" / f"{name}.yaml"))


def dasm_banks(n=447, seed=DASM_SEED):
    """Seeded stand-ins for the query banks (MGA-CLAP text [n, 512], HTSAT
    audio prototypes [n, 768]): N(0, 1) rows."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return [rng.randn(n, d).astype(np.float32) for d in DASM_QUERY_DIMS]


def build_dasm_model(device, state_dict=None, name="closed_set", dtype=None):
    """The network of ``config/dasm/<name>.yaml`` as ``recipes.cli.build_model``
    builds it (bf16 compute on the card, f32 on the CPU, unless ``dtype``),
    seeded or given ``state_dict``."""
    import torch

    from transformer4sed_tpu_torch.models.dasm import DASM
    from transformer4sed_tpu_torch.recipes import cli, common
    from transformer4sed_tpu_torch.utils.weights import init_weights_

    if dtype is None:
        model, _ = cli.build_model(dasm_yaml(name), torch.device(device))
    else:
        model = DASM(**common.model_init_kwargs(dasm_yaml(name), "DASM"), dtype=dtype,
                     device="cpu")
    if state_dict is None:
        init_weights_(model, seed=DASM_SEED)
    else:
        model.load_state_dict(state_dict)
    return model.to(device)


def build_dasm_engine(device, state_dict=None, dtype=None):
    """closed_set.yaml's DASM served as ``recipes.serve --query <text bank>
    --query_type text`` serves it: the 447 AudioSet-strong classes at B=8, the
    config's val_kwargs and median window, bf16 on the card, f32 on the CPU
    (unless ``dtype``)."""
    import torch

    from transformer4sed_tpu_torch.frontend.mel import PasstFrontend
    from transformer4sed_tpu_torch.recipes import common
    from transformer4sed_tpu_torch.recipes.serve import InferenceEngine

    config = dasm_yaml()
    codec = common.codec_from_config(config, labels=audioset_labels())
    check(codec.n_frames == DASM_FRAMES and codec.n_classes == 447,
          f"codec of {codec.n_frames} frames and {codec.n_classes} classes")
    model = build_dasm_model(device, state_dict, dtype=dtype)
    kwargs = dict(config["DASM"]["val_kwargs"], query_type="text",
                  query=torch.from_numpy(dasm_banks()[0]).to(device))
    return InferenceEngine(model.eval(), PasstFrontend(device=device), codec,
                           common.median_filter_from_config(config, codec),
                           batch_size=DASM_BATCH, threshold=0.5, model_kwargs=kwargs,
                           device=device)


def dasm_serve(results):
    """closed_set.yaml's DASM (PaSST 768/12/12 tapped at 10, the attention
    f-pool, 3 XL blocks at T=1000, two projectors of the [447, 512] text and
    [447, 768] audio banks, 2 AT-decoder layers, the 448-way logit head),
    seeded, bf16, serving the 20 clips of phase 3 with the text bank (8, 8 and
    a ragged 4): shapes, finiteness, events, the padded frames at the floor,
    and per batch 12 and 3 launches of rows 1 and 2. Returns (engine, batches)."""
    import numpy as np

    t0 = time.perf_counter()
    engine = build_dasm_engine("cuda")
    log(f"built the DASM engine in {time.perf_counter() - t0:.1f} s")
    clips = synthetic_clips(20, seed=1)
    batches = make_batches(clips, engine.codec, DASM_BATCH)
    reset_launches()
    served = list(engine.score_batches(batches))
    launches = read_launches()
    log(f"DASM served {sum(len(n) for n, _, _ in served)} clips in {len(served)} batches; "
        f"launches {launches}")
    want = {name: 0 for name in launches}
    want.update({k: n * len(batches) for k, n in DASM_SERVE_LAUNCHES.items()})
    check(launches == want, f"kernel launches {launches} on the DASM served path, expected {want}")
    n_events = 0
    for (names, scores, weak), batch in zip(served, batches):
        check(names == batch["filename"], "results come back in order")
        check(scores.shape == (len(names), DASM_FRAMES, 447) and weak.shape == (len(names), 447),
              f"output shapes {scores.shape}, {weak.shape}")
        check(np.all(np.isfinite(scores)) and np.all(np.isfinite(weak)), "finite outputs")
        check(np.all((scores > 0) & (scores <= 1)) and np.all((weak > 0) & (weak <= 1)),
              "probabilities in (0, 1]")
        for i in range(len(names)):
            for label, onset, offset in engine.decode(scores[i]):
                check(label in engine.codec.labels and 0.0 <= onset < offset <= 10.0,
                      f"event {label, onset, offset}")
                n_events += 1
    short = served[0][1][5]  # 6.5-s clip: frames from 650 are padding, clipped to 1e-7
    check(np.all(short[650 + max(engine.median_filter) // 2:] <= 1.0001e-7),
          "padded frames are at the floor")
    top = max(float(s.max()) for _, s, _ in served)
    log(f"decoded {n_events} events; scores finite in (0, 1]; padded frames at the 1e-7 floor; "
        f"scores span {min(float(s.min()) for _, s, _ in served):.3e} .. {top:.3e}")
    # the seeded prior keeps every score far under 0.5; the 447-class decode is
    # also driven at half the largest score, where events fire
    engine.threshold, low = top / 2, []
    try:
        for names, scores, _ in served:
            for i in range(len(names)):
                low += [(names[i], e) for e in engine.decode(scores[i])]
    finally:
        engine.threshold = 0.5
    short_name = served[0][0][5]
    for name, (label, onset, offset) in low:
        check(label in engine.codec.labels and 0.0 <= onset < offset <= 10.0,
              f"event {label, onset, offset}")
        check(name != short_name or onset < (650 + max(engine.median_filter) // 2) / 100,
              f"an event in the short clip's padding at {onset} s")
    check(len(low) > 0, "no event at half the largest score")
    log(f"decoded at the threshold {top / 2:.3e}: {len(low)} events of "
        f"{len({e[1][0] for e in low})} classes in {len({e[0] for e in low})} clips")
    return engine, batches


def dasm_capture(engine, wav, pad_mask):
    """One eval forward of ``engine``'s DASM on ``wav`` with its served kwargs,
    in f64 on the CPU: strong, weak and the AT head's 448-way logits as the
    model gave them; the logits ``z`` = einsum(mask embedding, frames) /
    temp_w recomputed from the two tensors the model's einsum read (forward
    hooks on ``mask_embedding_layer`` and ``sed_head``); the clip prior (the
    diagonal of the 448-way softmax); and ``tail``, strong recomputed from z
    and the prior: where(pad, 0, sigmoid(z) * prior) clamped to [1e-7, 1]."""
    import torch

    from transformer4sed_tpu_torch.models.dasm import multi_class_to_multi_label

    model, seen = engine.model, {}
    hooks = [model.mask_embedding_layer.register_forward_hook(
                 lambda mod, args, out: seen.__setitem__("mask_embedding", out)),
             model.sed_head.register_forward_hook(
                 lambda mod, args, out: seen.__setitem__("frames", out))]
    try:
        with torch.no_grad():
            mel = engine.frontend.normalize(engine.frontend(wav.to(engine.device)))
            out = model(mel, pad_mask=pad_mask.to(engine.device), **engine.model_kwargs)
    finally:
        for h in hooks:
            h.remove()

    def f64(t):
        return t.detach().to("cpu", torch.float64)

    temp_w = engine.model_kwargs.get("temp_w", 0.1)
    z = torch.einsum("bqc,btc->btq", f64(seen["mask_embedding"]), f64(seen["frames"])) / temp_w
    at_out = f64(out.at_out)
    prior = multi_class_to_multi_label(torch.softmax(at_out, dim=-1))
    return {"strong": f64(out.strong), "weak": f64(out.weak), "at_out": at_out, "z": z,
            "prior": prior, "temp_w": temp_w, "pad": pad_mask.cpu(),
            "tail": dasm_tail(z, prior, pad_mask.cpu())}


def dasm_tail(z, prior, pad):
    """DASM's tail in f64: where(pad, 0, sigmoid(z) * prior) clamped to
    [1e-7, 1], as [B, Q, T]."""
    import torch

    sed = torch.where(pad[:, :, None], 0.0, torch.sigmoid(z) * prior[:, None, :])
    return sed.clamp(1e-7, 1.0).transpose(1, 2)


def dasm_tail_error(c, strong=None):
    """max |strong - tail| / max |tail| of a capture (``strong``: in place of
    the model's)."""
    strong = c["strong"] if strong is None else strong
    return float((strong - c["tail"]).abs().max() / c["tail"].abs().max())


def dasm_tail_faults(c):
    """Check (a)'s planted faults: a capture's strong recomputed with temp_w
    dropped, with the prior dropped, and with the einsum's output rounded to
    bf16."""
    import torch

    z, prior, pad, temp_w = c["z"], c["prior"], c["pad"], c["temp_w"]
    return {"temp_w dropped": dasm_tail(z * temp_w, prior, pad),
            "the prior dropped": dasm_tail(z, torch.ones_like(prior), pad),
            "the einsum's output rounded to bf16": dasm_tail(
                (z * temp_w).to(torch.bfloat16).double() / temp_w, prior, pad)}


def dasm_gaps(other, ref):
    """Relative L2 errors ||other - ref|| / ||ref|| of z, the AT head's
    logits, the prior, strong and weak; and where the sigmoid factor
    sigmoid(z) parts most, its gap and the z of both sides there."""
    import torch

    gaps = {k: float((other[k] - ref[k]).norm() / ref[k].norm())
            for k in ("z", "at_out", "prior", "strong", "weak")}
    sig = (torch.sigmoid(other["z"]) - torch.sigmoid(ref["z"])).abs()
    at = sig.argmax()
    gaps.update(sigmoid_gap=float(sig.max()), z_there=(float(other["z"].flatten()[at]),
                                                       float(ref["z"].flatten()[at])),
                z_max_abs_gap=float((other["z"] - ref["z"]).abs().max()),
                z_abs_q=[float(q) for q in torch.quantile(
                    ref["z"].abs().flatten(), torch.tensor([0.5, 0.99, 1.0],
                                                           dtype=torch.float64))])
    return gaps


def dasm_parity_clips(batches):
    """Phase dasm_parity's two clips (clip 5 is the short one) and their pad mask."""
    import torch

    return (torch.from_numpy(batches[0]["wav"][4:6].copy()),
            torch.from_numpy(batches[0]["pad_mask"][4:6].copy()))


def log_dasm_gaps(what, gaps):
    log(f"{what}: relative L2 error of z = logits / temp_w {gaps['z']:.4e}, of the AT head's "
        f"448-way logits {gaps['at_out']:.4e}, of the prior {gaps['prior']:.4e}, of strong "
        f"{gaps['strong']:.4e}, of weak {gaps['weak']:.4e} (limit {DASM_REL_L2}); |z| median "
        f"{gaps['z_abs_q'][0]:.3f}, 99th percentile {gaps['z_abs_q'][1]:.3f}, max "
        f"{gaps['z_abs_q'][2]:.3f}; max |dz| {gaps['z_max_abs_gap']:.4f}; the sigmoid factor "
        f"parts most by {gaps['sigmoid_gap']:.4f}, at z {gaps['z_there'][0]:.4f} against "
        f"{gaps['z_there'][1]:.4f}")


def dasm_parity(card_engine, batches):
    """The same weights and text bank on 2 clips in eval mode, each quantity
    on its own scale (a seeded DASM's probabilities are small: the 448-way
    prior is near 1/448). (a) The card's tail: its strong against the same
    tail in f64 from the card's own mask embedding, frames and AT logits
    (the f32 einsum, / temp_w, sigmoid, prior, pad, clamp), within
    DASM_TAIL_RTOL; three planted faults (temp_w dropped, the prior dropped,
    the einsum's output rounded to bf16) fall outside. (b) Card bf16
    (kernels) against CPU f32 (plain versions): the relative L2 errors of
    z, the AT head's logits, the prior, strong and weak within DASM_REL_L2;
    two planted faults (the queries' order rolled by one; the sigmoid of the
    diagonal logit as the prior) fall outside."""
    import torch

    state = {k: v.detach().cpu() for k, v in card_engine.model.state_dict().items()}
    cpu_engine = build_dasm_engine("cpu", state_dict=state)
    wav, pm = dasm_parity_clips(batches)
    card, cpu = dasm_capture(card_engine, wav, pm), dasm_capture(cpu_engine, wav, pm)
    for name, c in (("CPU f32", cpu), ("card bf16", card)):
        log(f"DASM {name}: strong spans {float(c['strong'].min()):.3e} .. "
            f"{float(c['strong'].max()):.3e}, the prior {float(c['prior'].min()):.3e} .. "
            f"{float(c['prior'].max()):.3e}; its tail against f64 of its own tensors "
            f"{dasm_tail_error(c):.3e} (limit {DASM_TAIL_RTOL})")
    check(dasm_tail_error(card) <= DASM_TAIL_RTOL and dasm_tail_error(cpu) <= DASM_TAIL_RTOL,
          "DASM (a): the tail (f32 einsum, / temp_w, sigmoid, prior, pad, clamp) is not "
          "the model's")
    for what, strong in dasm_tail_faults(card).items():
        err = dasm_tail_error(card, strong)
        log(f"DASM (a) planted fault, {what}: {err:.3e} (limit {DASM_TAIL_RTOL}): "
            f"{'within' if err <= DASM_TAIL_RTOL else 'OUTSIDE'}")
        check(err > DASM_TAIL_RTOL, f"DASM (a): the tail check let '{what}' through")
    gaps = dasm_gaps(card, cpu)
    log_dasm_gaps("DASM (b) card bf16 vs CPU f32", gaps)
    check(max(gaps[k] for k in ("z", "at_out", "prior", "strong", "weak")) <= DASM_REL_L2,
          "DASM (b): the card's path disagrees with the CPU f32 path")
    rolled = dict(card, z=card["z"].roll(1, dims=2))
    diag = torch.diagonal(card["at_out"][:, :, :-1], dim1=1, dim2=2)
    sigmoid_prior = dict(card, prior=torch.sigmoid(diag))
    sigmoid_prior["strong"] = dasm_tail(card["z"], sigmoid_prior["prior"], card["pad"])
    for what, fault, key in (("the queries' order rolled by one", rolled, "z"),
                             ("the sigmoid of the diagonal logit as the prior", sigmoid_prior,
                              "prior")):
        err = dasm_gaps(fault, cpu)[key]
        log(f"DASM (b) planted fault, {what}: relative L2 error of {key} {err:.4e} (limit "
            f"{DASM_REL_L2}): {'within' if err <= DASM_REL_L2 else 'OUTSIDE'}")
        check(err > DASM_REL_L2, f"DASM (b): the parity check let '{what}' through")


def build_dasm_step(device, augment, dropout=True, state_dict=None):
    """closed_set.yaml's train step (``DASMTrainer``'s ``DASMStep``): the
    (C+1)-way CE at w_AT 1, temp_w 0.1, both seeded banks (one modality drawn
    per query each step), the config's param groups, clip 20;
    ``augment=False`` turns shift, mixup and filt_aug off, ``dropout=False``
    the AT decoder's dropout."""
    import torch

    from transformer4sed_tpu_torch.frontend.mel import PasstFrontend
    from transformer4sed_tpu_torch.recipes import common
    from transformer4sed_tpu_torch.recipes.dasm_recipe import DASMStep, DASMTrainConfig

    config = dasm_yaml()
    model = build_dasm_model(device, state_dict)
    if not dropout:
        model.at_dropout = 0.0
    off = {} if augment else dict(mixup_prob=0.0, max_shift_frame=0)
    tr = config["training"]
    cfg = DASMTrainConfig(
        out_type=config["DASM"]["at_param"]["out_type"], w_at=tr["w_AT"],
        transform_choice=tuple(tr["transform"]["choice"]) if augment else (0, 0, 0, 0),
        model_kwargs=config["DASM"]["train_kwargs"], **off)
    pg, _, _ = common.optimizer_from_config(config, 1)
    banks = [torch.from_numpy(b).to(device) for b in dasm_banks()]
    return DASMStep(model, PasstFrontend(device=device), cfg, pg, query=banks)


def dasm_train(results):
    """closed_set.yaml's step at the shipped B=48 with its augmentation and
    the AT decoder's dropout: finite losses and per step rows 7, 8, 12 and 13
    at 12, 12, 3 and 3 (and the backwards' passes), nothing else; then three
    windows of four steps (steps/s, clips/s, peak device memory)."""
    import torch

    t0 = time.perf_counter()
    stepper = build_dasm_step("cuda", augment=True)
    batch = synthetic_audioset_batch(DASM_TRAIN_BATCH, seed=24, frames=DASM_FRAMES)
    log(f"built the DASM step in {time.perf_counter() - t0:.1f} s; param groups "
        f"{sorted(set(stepper.labels.values()))}")
    gen = torch.Generator().manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for i in range(DASM_TRAIN_STEPS):
        values = finite_metrics(stepper.step(batch, gen))
        log(f"DASM train step {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in values.items()))
    torch.cuda.synchronize()
    launches = read_launches()
    want = {name: 0 for name in launches}
    want.update({k: n * DASM_TRAIN_STEPS
                 for k, n in with_bwd_passes(DASM_TRAIN_LAUNCHES).items()})
    log(f"DASM train launches over {DASM_TRAIN_STEPS} steps: {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check(launches == want, f"kernel launches {launches} on the DASM train path, expected {want}")
    step_ms = time_training(stepper, batch, windows=3, per_window=4, what="DASM train",
                            parts="frontend, shift, mixup, filt_aug, forward with the AT "
                                  "decoder's dropout and a modality a query, strong BCE + CE, "
                                  "backward, clip, AdamW")
    return stepper, batch, step_ms


def dasm_train_parity():
    """closed_set.yaml's step at full width and depth, DASM_PARITY_STEPS
    steps at B=2 without augmentation or dropout (the modality picks drawn
    alike), CPU f32 against card bf16 (:func:`trainer_parity`)."""
    import torch

    cpu = build_dasm_step("cpu", augment=False, dropout=False)
    card = build_dasm_step("cuda", augment=False, dropout=False,
                           state_dict=cpu.model.state_dict())
    batch = synthetic_audioset_batch(DASM_PARITY_BATCH, seed=25, frames=DASM_FRAMES)
    trainer_parity("DASM", cpu, card, batch, DASM_PARITY_STEPS, "loss_total",
                   lambda t: (t.model,))
    check(all(p.grad is not None for p in cpu.model.parameters()), "DASM: a param got no gradient")


# the mini AudioSet-strong tree of phase audioset_stages: clips of
# synthetic_bursts, each burst a class of the vendored 447 in turn
AS_TRAIN_CLIPS = 64   # one step of htsat_cnn.yaml's B=64 and of the DASM configs' B=48
AS_VAL_CLIPS = 16
AS_SEED = 31


def write_audioset_split(root, labels, novel):
    """Train and val clips under ``root`` (16-bit WAV at 32 kHz) with their
    strong-label TSVs on the 447 classes, the val durations, and the open-set
    table: the val clips with every third event relabelled by a novel class
    (``openset.tsv``). Returns {split: number of events}."""
    import numpy as np
    from scipy.io import wavfile

    from transformer4sed_tpu_torch.data.tsv import write_tsv

    events = ["filename", "onset", "offset", "event_label"]
    counts = {}
    k = 0
    for split, n, seed in (("train", AS_TRAIN_CLIPS, AS_SEED), ("val", AS_VAL_CLIPS, AS_SEED + 1)):
        (root / split).mkdir(parents=True)
        clips, bursts = synthetic_bursts(n, seed)
        rows, open_rows, durs = [], [], []
        for i, (wav, clip_bursts) in enumerate(zip(clips, bursts)):
            fname = f"{split}{i:03d}.wav"
            wavfile.write(root / split / fname, SR,
                          (np.clip(wav / 4.0, -1.0, 1.0) * 32767).astype(np.int16))
            dur = len(wav) / SR
            durs.append((fname, dur))
            for j, (on, off) in enumerate(clip_bursts):
                if on >= dur:
                    continue
                label = labels[(7 * k) % len(labels)]
                k += 1
                rows.append((fname, float(on), float(min(off, dur)), label))
                open_rows.append(rows[-1] if j % 3 else (fname, float(on), float(min(off, dur)),
                                                         novel[i % len(novel)]))
        write_tsv(str(root / f"{split}.tsv"), events, rows)
        write_tsv(str(root / f"{split}_dur.tsv"), ["filename", "duration"], durs)
        if split == "val":
            write_tsv(str(root / "openset.tsv"), events, open_rows)
        counts[split] = len(rows)
    return counts


def audioset_stage_config(root, family, name, tag, overrides):
    """The shipped ``config/<family>/<name>.yaml`` with ``overrides``
    ({"section.key": value}, each logged), written as ``root/<tag>.yaml``."""
    from transformer4sed_tpu_torch.utils.config import load_yaml_with_include
    from transformer4sed_tpu_torch.utils.yamlio import safe_dump

    cfg = load_yaml_with_include(str(ROOT / "config" / family / f"{name}.yaml"))
    for key, value in overrides.items():
        *parents, leaf = key.split(".")
        node = cfg
        for part in parents:
            node = node.setdefault(part, {})
        log(f"audioset_stages: {family}/{name}.yaml -> {tag}.yaml: {key} = {value!r} (shipped "
            f"{node.get(leaf)!r})")
        node[leaf] = value
    out = root / f"{tag}.yaml"
    out.write_text(safe_dump(cfg))
    return str(out)


def audioset_stages(device="cuda"):
    """The AudioSet-strong stages as a user runs them, through
    ``recipes.cli.main`` on the card at full width from a mini 447-class tree
    (the vendored label dict, type map and novel labels; AS_TRAIN_CLIPS train
    and AS_VAL_CLIPS val clips of ``synthetic_bursts``): ``audioset_supervised``
    on ``config/audioset_strong/htsat_cnn.yaml``, ``dasm_train`` on
    ``config/dasm/closed_set.yaml`` with the seeded banks, ``dasm_ov`` on
    ``open_vocab.yaml`` from its best student, then ``openset_eval`` with the
    34 novel labels (seeded text queries); only the dataset paths and the
    epochs changed, plus ``query_type: text`` in the DASM forward kwargs of
    open_vocab.yaml (the reference's one bank with two projectors); checks:
    (a) every stage returns 0 and writes its files, finite logged numbers;
    (b) rows 1, 2, 7, 8, 12, 13 (HTSAT_CNN: 14, 15, 12, 13) launched by each
    stage, each train step at least once each; (c) dasm_ov's warm start
    loaded every key of the closed-set student but the AT head; (d)
    ``recipes.serve --query <text bank>`` on the closed-set student equals,
    bitwise, the engine with that bank, and ``recipes.infer --query`` equals
    the engine at B=1."""
    import io
    import tempfile
    import unittest.mock

    import numpy as np
    import torch

    from transformer4sed_tpu_torch.data.datasets import UnlabeledDataset
    from transformer4sed_tpu_torch.data.loader import DataLoader
    from transformer4sed_tpu_torch.recipes import audioset_strong, cli, infer
    from transformer4sed_tpu_torch.utils.config import load_yaml_with_include

    card = card_line()
    dev = torch.device(device)
    on = [] if dev.type == "cuda" else ["--device", device]  # the entry points' default: the card
    labels = audioset_labels()
    meta = ROOT / "meta" / "audioset_strong"
    with open(meta / "hierarchical" / "openset_label.json") as f:
        novel = json.load(f)
    with without_tensorflow(), tempfile.TemporaryDirectory(prefix="t4s_audioset_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        counts = write_audioset_split(root, labels, novel)
        text, audio = dasm_banks()
        np.save(root / "text.npy", text)
        np.save(root / "audio.npy", audio)
        np.save(root / "novel_text.npy", dasm_banks(len(novel), seed=DASM_SEED + 1)[0])
        log(f"audioset_stages: mini tree written in {time.perf_counter() - t0:.1f} s: "
            f"{AS_TRAIN_CLIPS} train clips ({counts['train']} events), {AS_VAL_CLIPS} val "
            f"({counts['val']}), {len(novel)} novel labels")
        paths = {"dataset.train_folder": f"{root}/train", "dataset.train_tsv": f"{root}/train.tsv",
                 "dataset.val_folder": f"{root}/val", "dataset.val_tsv": f"{root}/val.tsv",
                 "dataset.val_dur": f"{root}/val_dur.tsv", "training.scheduler.n_epochs": 1}
        sup_cfg = audioset_stage_config(root, "audioset_strong", "htsat_cnn", "supervised", {
            **paths, "dataset.weight_tsv": None})
        banks = {"dataset.text_query": f"{root}/text.npy",
                 "dataset.audio_query": f"{root}/audio.npy"}
        closed_cfg = audioset_stage_config(root, "dasm", "closed_set", "closed",
                                           {**paths, **banks})
        text_kw = {"temp_w": 0.1, "query_type": "text"}
        ov_cfg = audioset_stage_config(root, "dasm", "open_vocab", "open_vocab", {
            **paths, **banks, "DASM.train_kwargs": text_kw, "DASM.val_kwargs": text_kw,
            "DASM.test_kwargs": text_kw,
            "dataset.openset_label": str(meta / "hierarchical" / "openset_label.json"),
            "dataset.openset_embedding": f"{root}/novel_text.npy",
            "dataset.query_bank": f"{root}/text.npy", "dataset.openset_tsv": f"{root}/openset.tsv",
            "dataset.openset_dur": f"{root}/val_dur.tsv", "dataset.openset_folder": f"{root}/val"})
        closed_best = root / "closed" / "best" / "best_student"
        runs = [("audioset_supervised", sup_cfg, root / "supervised", []),
                ("dasm_train", closed_cfg, root / "closed", []),
                ("dasm_ov", ov_cfg, root / "open_vocab", ["--pretrained_ckpt", str(closed_best)]),
                ("openset_eval", ov_cfg, root / "openset",
                 ["--pretrained_ckpt", str(root / "open_vocab" / "best" / "best_student")])]
        steps = collections.Counter()
        step = audioset_strong.SupervisedStep.step

        def counted_step(self, *a, **k):
            steps[type(self).__name__] += 1
            return step(self, *a, **k)

        for stage, cfg, folder, extra in runs:
            t0 = time.perf_counter()
            reset_launches()
            before = dict(steps)
            with unittest.mock.patch.object(audioset_strong.SupervisedStep, "step", counted_step):
                rc = cli.main([stage, "--config_dir", cfg, "--save_folder", str(folder),
                               "--random_seed", str(STAGE_SEED), *extra, *on])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_launches()
            n_steps = sum(steps.values()) - sum(before.values())
            text_log = read_log(folder)
            check(rc == 0, f"(a) {stage} returned {rc}")
            nums = finite_log_numbers(text_log, r"INFO (epoch \d+: train|openset psds)")
            check(nums and all(np.isfinite(nums)), f"(a) {stage}: a logged number is not finite")
            want_files = (["single_psds.json"] if stage == "openset_eval" else
                          ["best/best_student", "best/best_metric.json", "best/last_state"])
            check(all((folder / f).exists() for f in want_files), f"(a) {stage}: files {want_files}")
            rows = (("window_attention", "window_attention_backward") if stage ==
                    "audioset_supervised" else ("flash_attention_nhd_lse",
                                                "flash_attention_nhd_backward"))
            rows += ("flash_xl_attention_nhd_lse", "flash_xl_attention_nhd_backward")
            served = ("window_attention",) if stage == "audioset_supervised" else (
                "flash_attention_nhd",)
            fired = {k: v for k, v in launches.items() if v}
            ok = all(launches[r] >= n_steps > 0 for r in rows) if stage != "openset_eval" else (
                not any(launches[r] for r in rows[:2]))
            check(ok and launches[served[0]] > 0 and launches["flash_xl_attention_nhd"] > 0,
                  f"(b) {stage}: {n_steps} train steps, launches {fired}")
            line = re.findall(r"INFO (epoch 1: .*|openset psds=.*)", text_log)[-1]
            log(f"audioset_stages {stage}: rc 0 in {seconds:.1f} s, {n_steps} train steps, "
                f"launches {fired}; {line[:400]}")
        ov_log = read_log(root / "open_vocab")
        warm = re.search(r"warm start: (\d+) of (\d+) keys loaded, dropped \[.*\]", ov_log)
        closed_sd = torch.load(closed_best, map_location="cpu", weights_only=True)
        at_head = [k for k in closed_sd if k.startswith("at_head.layers.1.")]
        check(warm is not None and int(warm.group(1)) == len(closed_sd) - len(at_head)
              and int(warm.group(2)) == len(closed_sd),
              f"(c) dasm_ov's warm start: {warm and warm.group(0)}")
        log(f"audioset_stages (c): dasm_ov {warm.group(0)} (the 448-way head's last layer, "
            f"{len(at_head)} tensors, has the sigmoid head's shape there)")

        # (d) serving with queries on the closed-set student
        config = load_yaml_with_include(closed_cfg)
        query = torch.from_numpy(text).to(dev)
        engine = cli.serving_engine(config, str(closed_best), dev, DASM_BATCH,
                                    model_kwargs={"query": query, "query_type": "text"})
        ref, _ = engine_pass(engine, root / "val", DASM_BATCH)
        n_batches = -(-AS_VAL_CLIPS // DASM_BATCH)
        line, _ = run_serve_main(
            ["--config_dir", closed_cfg, "--ckpt", str(closed_best), "--wav_dir",
             str(root / "val"), "--batch_size", str(DASM_BATCH), "--query", str(root / "text.npy"),
             "--query_type", "text", *on], root / "served",
            {k: n * n_batches for k, n in DASM_SERVE_LAUNCHES.items()})
        check(served_as(root / "served", ref), "(d) serve --query differs from the engine")
        one = cli.serving_engine(config, str(closed_best), dev, 1,
                                 model_kwargs={"query": query, "query_type": "text"})
        first = next(iter(DataLoader(UnlabeledDataset(str(root / "val"), True, one.codec),
                                     batch_size=1, drop_last=False, num_workers=1)))
        name0 = first["filename"][0]
        _, s1, w1 = next(one.score_batches([first]))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = infer.main(["--config_dir", closed_cfg, "--ckpt", str(closed_best), "--wav",
                             str(root / "val" / name0), "--query", str(root / "text.npy"),
                             "--query_type", "text", *on])
        got = json.loads(buf.getvalue())
        ok = (rc == 0 and [tuple(e) for e in got["events"]] == [tuple(e) for e in one.decode(s1[0])]
              and np.array_equal(np.asarray(got["weak"], np.float32), w1[0]))
        log(f"audioset_stages (d): {line}; its TSVs and events equal the engine's with the same "
            f"bank, bitwise; infer --query on {name0}: {len(got['events'])} events and the weak "
            f"scores against the engine at B=1: {'equal' if ok else 'OUTSIDE'} ({card})")
        check(ok, "(d) infer --query differs from the engine")


def at_decoder_ms(model, run, backward=False):
    """ms of the AT decoder alone (plain PyTorch: projections, matmuls,
    softmax) on the inputs it took in ``run()``, forward or forward and
    backward, by CUDA events."""
    import torch

    seen = []
    handle = model.at_decoder.register_forward_hook(
        lambda mod, args, out: seen.append([a.detach() if torch.is_tensor(a) else a
                                            for a in args]))
    try:
        run()
    finally:
        handle.remove()
    feat, queries, mask, masks = (seen[0] + [None, None])[:4]

    def once():
        if not backward:
            with torch.no_grad():
                return model.at_decoder(feat, queries, mask, masks)
        f, q = feat.clone().requires_grad_(), queries.clone().requires_grad_()
        model.at_decoder(f, q, mask, masks).float().square().mean().backward()

    return cuda_ms(once, iters=10, warmup=2)


# -- phase 7: timing ------------------------------------------------------------

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
    # row 2 as the mean teacher runs it in the train step (B=24); logged, the
    # record keeps the served batch's
    bt = sum(TRAIN_SPLIT)
    q, k, v, bu, bv, p = xl_inputs(bt, t, c, h, seed=1)
    ms = cuda_ms(lambda: flash_xl_attention_nhd(q, k, v, bu, bv, p, h, d ** -0.5))
    t_bound = max(6.0 * bt * h * t * t * d / PEAK_BF16_FLOPS,
                  (4.0 * bt * t * c * 2 + h * (2 * t - 1) * d * 2 + 2 * h * d * 4) / PEAK_BYTES)
    log(f"time flash_xl_attention_nhd at the teacher's shape [{bt}, {t}, {c}]: {ms:.4f} ms, "
        f"bound {t_bound * 1e3:.4f} ms")
    del q, k, v, bu, bv, p
    time_train_kernels(results)
    time_window_kernels(results)
    time_hm_kernels(results)
    time_flash_hm_kernels(results)
    time_bias_kernels(results)
    time_variant_kernels(results)
    time_window_shape_kernels()
    for name, r in results.items():
        log(f"time {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms), "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({r['flops'] / 1e9:.1f} GFLOP, {r['bytes'] / 1e6:.1f} MB)")


def time_train_kernels(results):
    """Rows 7, 8, 12, 13 at the train step's shapes (B=24), each wrapper as
    the autograd Functions call it (the backwards with delta, workspace
    zeroing and casts); the library yardsticks are SDPA's forward and its
    backward through autograd."""
    import torch
    import torch.nn.functional as F

    from transformer4sed_tpu_torch.kernels.flash_attention import (
        flash_attention_nhd_backward,
        flash_attention_nhd_backward_reference,
        flash_attention_nhd_lse,
        flash_attention_nhd_lse_reference,
    )
    from transformer4sed_tpu_torch.kernels.xl_attention import (
        flash_xl_attention_nhd_backward,
        flash_xl_attention_nhd_lse,
        xl_attention_nhd_backward_reference,
        xl_attention_nhd_lse_reference,
    )

    b, n, c, h = sum(TRAIN_SPLIT), 1190, 768, 12
    d = c // h
    q, k, v = flash_inputs(b, n, c, seed=0)
    do = grad_output((b, n, c), seed=1)
    heads = lambda x: x.reshape(b, x.shape[1], h, d).transpose(1, 2)  # noqa: E731
    r = results["flash_attention_nhd_lse"]
    r["ms"] = cuda_ms(lambda: flash_attention_nhd_lse(q, k, v, h))
    r["plain_ms"] = cuda_ms(lambda: flash_attention_nhd_lse_reference(q, k, v, h), iters=3)
    r["library_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)))
    bound(r, 4.0 * b * h * n * n * d, 4.0 * b * n * c * 2 + b * h * n * 4)
    o, lse = flash_attention_nhd_lse(q, k, v, h)
    r = results["flash_attention_nhd_backward"]
    r["ms"] = cuda_ms(lambda: flash_attention_nhd_backward(q, k, v, o, lse, do, h))
    r["plain_ms"] = cuda_ms(
        lambda: flash_attention_nhd_backward_reference(q, k, v, o, lse, do, h), iters=3)
    qh, kh, vh = (heads(x).detach().requires_grad_() for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qh, kh, vh)
    r["library_ms"] = cuda_ms(
        lambda: torch.autograd.grad(sdpa, (qh, kh, vh), heads(do), retain_graph=True))
    # five products (S, dO V^T, dV, dK, dQ); q, k, v, o, dO and lse in, dq, dk, dv out
    bound(r, 10.0 * b * h * n * n * d, 8.0 * b * n * c * 2 + b * h * n * 4)
    time_bwd_parts("flash_attention_nhd_backward", q, k, v, o, lse, do, h, results)
    del o, lse, sdpa, qh, kh, vh
    torch.cuda.empty_cache()

    t = 1000
    q, k, v, bu, bv, p = xl_inputs(b, t, c, h, seed=0)
    do = grad_output((b, t, c), seed=2)
    scale = d ** -0.5
    r = results["flash_xl_attention_nhd_lse"]
    r["ms"] = cuda_ms(lambda: flash_xl_attention_nhd_lse(q, k, v, bu, bv, p, h, scale))
    r["plain_ms"] = cuda_ms(
        lambda: xl_attention_nhd_lse_reference(q, k, v, bu, bv, p, h, scale), iters=3)
    r["library_ms"] = None  # no one PyTorch call computes rel-position attention
    bound(r, 6.0 * b * h * t * t * d,
          4.0 * b * t * c * 2 + h * (2 * t - 1) * d * 2 + 2 * h * d * 4 + b * h * t * 4)
    o, lse = flash_xl_attention_nhd_lse(q, k, v, bu, bv, p, h, scale)
    r = results["flash_xl_attention_nhd_backward"]
    r["ms"] = cuda_ms(
        lambda: flash_xl_attention_nhd_backward(q, k, v, bu, bv, p, o, lse, do, h, scale))
    r["plain_ms"] = cuda_ms(
        lambda: xl_attention_nhd_backward_reference(q, k, v, bu, bv, p, o, lse, do, h, scale),
        iters=3)
    r["library_ms"] = None
    # eight products (content and position scores, dO V^T, dV, dK, dQu, dQv,
    # dP); q, k, v, o, dO, P, biases, lse in, dq, dk, dv, dP, dbu, dbv out
    bound(r, 16.0 * b * h * t * t * d,
          8.0 * b * t * c * 2 + 2 * h * (2 * t - 1) * d * 2 + 4 * h * d * 4 + b * h * t * 4)
    time_xl_bwd_parts("flash_xl_attention_nhd_backward", k, v, p, o, lse, do, scale, h=h, q=q,
                      bu=bu, bv=bv, results=results)
    del o, lse
    torch.cuda.empty_cache()


def time_window_kernels(results):
    """Rows 14 and 15 at the four HTSAT stage shapes at B=64, unshifted and,
    where the stage shifts, shifted, each wrapper as the autograd Function
    calls it (the backward with its zeroed dbias / dshift); the plain
    versions; and SDPA on the same [B*nW, H, 64, 24] problem with bias and
    shift mask folded into one ``attn_mask``, forward and backward through
    autograd (dq, dk, dv only: it has no reduced bias gradient). Device
    times (``queued_ms``): past stage 0 a launch takes the host longer than
    the card. Each wrapper's host time a call is logged beside them, and
    its time by back-to-back events as the other rows are timed (the host's
    and the card's, whichever is longer). Then every time and bound summed
    over an HTSAT_CNN step's launches (HTSAT_STAGE_BLOCKS: 12 of each
    kernel). The record keeps the stage-0 shifted shape, the step's
    costliest launch."""
    import torch
    import torch.nn.functional as F

    from transformer4sed_tpu_torch.kernels.window_attention import (
        window_attention,
        window_attention_backward,
        window_attention_backward_plain,
        window_attention_plain,
    )

    scale = 24 ** -0.5
    keys = ("ms", "host_ms", "event_ms", "plain_ms", "library_ms", "bound_ms")
    step = {name: dict.fromkeys(keys, 0.0)
            for name in ("window_attention", "window_attention_backward")}
    for stage, (h, nw) in enumerate(HTSAT_STAGES):
        for shifted, blocks in zip((False, True), HTSAT_STAGE_BLOCKS[stage]):
            if not blocks:
                continue
            _, q, k, v, bias, mask = window_inputs(HTSAT_BATCH, h, nw, shifted, seed=stage)
            bnw = q.shape[0]
            g = grad_output(tuple(q.shape), seed=stage + 1)
            out = window_attention(q, k, v, bias, mask, nw, scale)
            fwd, bwd = {}, {}
            for r, fn in ((fwd, lambda: window_attention(q, k, v, bias, mask, nw, scale)),
                          (bwd, lambda: window_attention_backward(q, k, v, out, g, bias, mask,
                                                                  nw, scale))):
                r["ms"], r["host_ms"] = queued_ms(fn)
                r["event_ms"] = cuda_ms(fn)
            fwd["plain_ms"] = cuda_ms(
                lambda: window_attention_plain(q, k, v, bias, mask, nw, scale), iters=5,
                queued=True)
            bwd["plain_ms"] = cuda_ms(lambda: window_attention_backward_plain(
                q, k, v, out, g, bias, mask, nw, scale), iters=3, queued=True)
            heads = lambda x: x.permute(0, 2, 1, 3)  # noqa: E731  [B*nW, H, 64, 24] views
            am = bias[None].expand(bnw, -1, -1, -1)
            if mask is not None:
                am = am + mask[torch.arange(bnw, device="cuda") % nw][:, None]
            am = am.to(torch.bfloat16).contiguous()
            fwd["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                heads(q), heads(k), heads(v), attn_mask=am, scale=scale), queued=True)
            qh, kh, vh = (heads(x).detach().requires_grad_() for x in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am, scale=scale)
            bwd["library_ms"] = cuda_ms(
                lambda: torch.autograd.grad(sdpa, (qh, kh, vh), heads(g), retain_graph=True),
                queued=True)
            pairs, side = bnw * h, (h + (nw if shifted else 0)) * 64 * 64 * 4
            # two products of 2 * 64 * 64 * 24; q, k, v in, o out, bias and shift in
            bound(fwd, 2 * 2.0 * 64 * 64 * 24 * pairs, 4.0 * pairs * 64 * 24 * 2 + side)
            # five products (S, G V^T, dV, dQ, dK); q, k, v, o, g in, dq, dk, dv out,
            # bias and shift in, dbias and dshift out
            bound(bwd, 5 * 2.0 * 64 * 64 * 24 * pairs, 8.0 * pairs * 64 * 24 * 2 + 2 * side)
            tag = (f"stage {stage} B={HTSAT_BATCH} nW={nw} H={h} "
                   f"{'shifted' if shifted else 'plain'}")
            for name, r in (("window_attention", fwd), ("window_attention_backward", bwd)):
                log(f"time {name} {tag}: {r['ms']:.4f} ms on the device, {r['host_ms']:.4f} ms "
                    f"of host a call, {r['event_ms']:.4f} ms back to back (plain "
                    f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms), bound "
                    f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['flops'] / 1e9:.2f} GFLOP, "
                    f"{r['bytes'] / 1e6:.1f} MB), {blocks} a step")
                for key in keys:
                    step[name][key] += blocks * r[key]
                if stage == 0 and shifted:
                    results[name].update(r)
            del out, sdpa, qh, kh, vh, am
            torch.cuda.empty_cache()
    launches = sum(map(sum, HTSAT_STAGE_BLOCKS))
    for name, r in step.items():
        log(f"time {name} summed over an HTSAT_CNN step's {launches} launches (B={HTSAT_BATCH}): "
            f"{r['ms']:.4f} ms on the device, {r['host_ms']:.4f} ms of host, "
            f"{r['event_ms']:.4f} ms back to back (plain {r['plain_ms']:.4f} ms, SDPA "
            f"{r['library_ms']:.4f} ms), bound {r['bound_ms']:.4f} ms, "
            f"{r['ms'] / r['bound_ms']:.2f}x the bound")


def time_hm_kernels(results):
    """Rows 9, 10 and 11 at PMAM's decoder shapes (row 9 at the served B=8,
    rows 10 and 11 at the trained B=18), operands as the dispatch hands them
    over (strided views), the backward as the autograd Function calls it
    (with delta, workspace zeroing and casts); their plain versions. No one
    PyTorch call computes relative-position attention: no library time.
    Rows 9 and 10 are logged beside their bound with the ex2 floor: one
    ex2 a score at the MUFU's 16 a clock an SM, at the card's highest SM
    clock."""
    import torch

    from transformer4sed_tpu_torch.kernels.xl_attention import (
        flash_xl_attention,
        flash_xl_attention_backward,
        flash_xl_attention_backward_reference,
        flash_xl_attention_lse,
        flash_xl_attention_lse_reference,
        flash_xl_attention_reference,
    )

    h, d, t = PMAM_HEADS, PMAM_HEAD_DIM, 1000
    scale = d ** -0.5
    p_bytes = h * (2 * t - 1) * d * 2
    b = PMAM_SERVE_BATCH
    qu, qv, k, v, p = hm_inputs(b, t, h, d, seed=0)
    r = results["flash_xl_attention"]
    r["ms"] = cuda_ms(lambda: flash_xl_attention(qu, qv, k, v, p, scale))
    r["plain_ms"] = cuda_ms(lambda: flash_xl_attention_reference(qu, qv, k, v, p, scale), iters=5)
    r["library_ms"] = None
    # content qu K^T, qv P^T at the T^2 needed offsets, A V; qu, qv, k, v, P in, o out
    bound(r, 6.0 * b * h * t * t * d, 5.0 * b * h * t * d * 2 + p_bytes)
    ex2_floor("flash_xl_attention", r, b * h * t * t)

    b = PMAM_TRAIN_BATCH
    qu, qv, k, v, p = hm_inputs(b, t, h, d, seed=1)
    do = grad_output((b, t, h, d), seed=2).permute(0, 2, 1, 3)
    r = results["flash_xl_attention_lse"]
    r["ms"] = cuda_ms(lambda: flash_xl_attention_lse(qu, qv, k, v, p, scale))
    r["plain_ms"] = cuda_ms(lambda: flash_xl_attention_lse_reference(qu, qv, k, v, p, scale),
                            iters=3)
    r["library_ms"] = None
    bound(r, 6.0 * b * h * t * t * d, 5.0 * b * h * t * d * 2 + p_bytes + b * h * t * 4)
    ex2_floor("flash_xl_attention_lse", r, b * h * t * t)
    o, lse = flash_xl_attention_lse(qu, qv, k, v, p, scale)
    r = results["flash_xl_attention_backward"]
    r["ms"] = cuda_ms(lambda: flash_xl_attention_backward(qu, qv, k, v, p, o, lse, do, scale))
    r["plain_ms"] = cuda_ms(
        lambda: flash_xl_attention_backward_reference(qu, qv, k, v, p, o, lse, do, scale),
        iters=3)
    r["library_ms"] = None
    # eight products (content and position scores, dO V^T, dV, dK, dQu, dQv,
    # dP); qu, qv, k, v, o, dO, P, lse in, dqu, dqv, dk, dv, dP out
    bound(r, 16.0 * b * h * t * t * d, 10.0 * b * h * t * d * 2 + 2 * p_bytes + b * h * t * 4)
    time_xl_bwd_parts("flash_xl_attention_backward", k, v, p, o, lse, do, scale, qu=qu, qv=qv)
    del o, lse
    torch.cuda.empty_cache()


def ex2_floor(name, r, scores):
    """Log a kernel's time beside its bound and the MUFU's floor: one ex2 a
    score, 16 a clock on each SM, at the highest SM clock nvidia-smi gives."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    floor = scores / (sms * 16 * mhz * 1e6) * 1e3
    log(f"time {name}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
        f"ex2 floor {floor:.4f} ms ({scores / 1e6:.0f} M scores, {sms} SMs x 16 a clock at "
        f"{mhz:.0f} MHz)")


def time_flash_hm_kernels(results):
    """Rows 3, 5 and 6 at the shape the parallel train step gives them (B=24:
    the sharded teacher's forward, the student's LSE forward and backward),
    q/k/v strided views of [B, 1190, 2304] projections as the sharded blocks
    hand them over, the backward as the autograd Function calls it (with
    delta, workspace zeroing and casts); their plain versions; SDPA forward,
    and its backward through autograd, on the same views. The bounds are
    rows 7 and 8's at the same shape (row 3's equals row 5's without the LSE)."""
    import torch
    import torch.nn.functional as F

    from transformer4sed_tpu_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_backward,
        flash_attention_backward_reference,
        flash_attention_lse,
        flash_attention_lse_reference,
        flash_attention_reference,
    )

    h, d, n = FLASH_HM_HEADS, FLASH_HM_DIM, FLASH_HM_T
    c = h * d
    b = sum(TRAIN_SPLIT)
    q, k, v = flash_hm_inputs(b, n, h, d, seed=0)
    r = results["flash_attention"]
    r["ms"] = cuda_ms(lambda: flash_attention(q, k, v))
    r["plain_ms"] = cuda_ms(lambda: flash_attention_reference(q, k, v), iters=3)
    r["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    bound(r, 4.0 * b * h * n * n * d, 4.0 * b * n * c * 2)

    q, k, v = flash_hm_inputs(b, n, h, d, seed=1)
    do = hm_grad_output(b, n, h, d, seed=2)
    r = results["flash_attention_lse"]
    r["ms"] = cuda_ms(lambda: flash_attention_lse(q, k, v))
    r["plain_ms"] = cuda_ms(lambda: flash_attention_lse_reference(q, k, v), iters=3)
    r["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    bound(r, 4.0 * b * h * n * n * d, 4.0 * b * n * c * 2 + b * h * n * 4)
    o, lse = flash_attention_lse(q, k, v)
    r = results["flash_attention_backward"]
    r["ms"] = cuda_ms(lambda: flash_attention_backward(q, k, v, o, lse, do))
    r["plain_ms"] = cuda_ms(lambda: flash_attention_backward_reference(q, k, v, o, lse, do),
                            iters=3)
    qh, kh, vh = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qh, kh, vh)
    r["library_ms"] = cuda_ms(
        lambda: torch.autograd.grad(sdpa, (qh, kh, vh), do, retain_graph=True))
    # five products (S, dO V^T, dV, dK, dQ); q, k, v, o, dO and lse in, dq, dk, dv out
    bound(r, 10.0 * b * h * n * n * d, 8.0 * b * n * c * 2 + b * h * n * 4)
    time_bwd_parts("flash_attention_backward", q, k, v, o, lse, do, h)
    del o, lse, sdpa, qh, kh, vh
    torch.cuda.empty_cache()


def time_bwd_parts(what, q, k, v, o, lse, do, h, results=None):
    """A flash backward's three launches timed apart, on the wrapper's own
    operands: the pre-pass, the main kernel alone (fed the pre-pass's side
    rows and workspace) and the post-pass. With ``results`` (row 8's shape),
    the passes' records: time, plain time, bound by bytes (O, dO, lse in,
    side rows and workspace out; the workspace's T rows in, dq out). The
    post-pass's library call is ``torch.mul`` into the bf16 dq view; the
    pre-pass has none (delta, L*log2(e) and the zeroed workspace are three
    results of different ops)."""
    import torch

    from transformer4sed_tpu_torch.kernels.flash_attention import (
        _split_heads,
        bwd_padded_rows,
        flash_bwd_postpass,
        flash_bwd_postpass_reference,
        flash_bwd_prepass,
        flash_bwd_prepass_reference,
        hm_backward_kernel,
        nhd_backward_kernel,
    )

    lanes = q.dim() == 3  # row 8's [B, N, H*d]; row 6 takes [B, H, T, d]
    oh, doh = (_split_heads(o, h), _split_heads(do, h)) if lanes else (o, do)
    b, _, t, d = oh.shape
    scale = d ** -0.5
    side, work = flash_bwd_prepass(oh, doh, lse)
    pre_ms = cuda_ms(lambda: flash_bwd_prepass(oh, doh, lse, dq_acc=work))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if lanes:
        main_ms = cuda_ms(lambda: nhd_backward_kernel(q, k, v, do, side, work, dk, dv, h, scale))
        dq = _split_heads(dq, h)
    else:
        main_ms = cuda_ms(lambda: hm_backward_kernel(q, k, v, do, side, work, dk, dv, scale))
    post_ms = cuda_ms(lambda: flash_bwd_postpass(work, dq, scale))
    log(f"time {what} parts: pre-pass {pre_ms:.4f} ms, kernel {main_ms:.4f} ms, post-pass "
        f"{post_ms:.4f} ms")
    if results is None:
        return
    tp = bwd_padded_rows(t)
    r = results["flash_bwd_prepass"]
    r["ms"] = pre_ms
    r["plain_ms"] = cuda_ms(lambda: flash_bwd_prepass_reference(oh, doh, lse), iters=3)
    r["library_ms"] = None  # no one PyTorch call computes delta, L*log2(e) and a zeroed workspace
    bound(r, 2.0 * b * h * t * d,
          2.0 * b * h * t * d * 2 + b * h * t * 4 + b * h * tp * (2 + d) * 4)
    r = results["flash_bwd_postpass"]
    r["ms"] = post_ms
    scratch = torch.empty_like(dq)
    r["plain_ms"] = cuda_ms(lambda: flash_bwd_postpass_reference(work, scratch, scale), iters=3)
    r["library_ms"] = cuda_ms(lambda: torch.mul(work[:, :, :t], scale, out=scratch))
    bound(r, 1.0 * b * h * t * d, b * h * t * d * (4.0 + 2.0))


def time_xl_bwd_parts(what, k, v, p, o, lse, do, scale, h=None, q=None, bu=None, bv=None,
                      qu=None, qv=None, results=None):
    """An XL backward's three launches timed apart, on the wrapper's own
    operands: the pre-pass, the main kernel alone (fed the pre-pass's side
    rows, qu, qv and workspaces) and the post-pass; row 13 given q, the
    biases and the head count (k, v, o, dO as [B, T, H*d]), row 11 given qu
    and qv ([B, H, T, d] views). With ``results`` (row 13's shape), the
    passes' records: time, plain time, bound by bytes (O, dO, q, lse, biases
    in, side rows, qu, qv and the zeroed workspaces out; the workspaces' T
    rows and the column sums in, dq, dP and the bias gradients out). Neither
    pass has a one-call library equivalent."""
    import torch

    from transformer4sed_tpu_torch.kernels.flash_attention import _split_heads, bwd_padded_rows
    from transformer4sed_tpu_torch.kernels.xl_attention import (
        XB_KEYS,
        flash_xl_bwd_postpass,
        flash_xl_bwd_postpass_reference,
        flash_xl_bwd_prepass,
        flash_xl_bwd_prepass_reference,
        xl_backward_kernel,
        xl_bwd_dp_rows,
    )

    lanes = q is not None
    heads = (lambda x: _split_heads(x, h)) if lanes else (lambda x: x)  # noqa: E731
    oh, doh, kh, vh, qh = heads(o), heads(do), heads(k), heads(v), heads(q) if lanes else None
    b, hh, t, d = oh.shape
    cols, tp, n_kt = (d if lanes else 2 * d), bwd_padded_rows(t), -(-t // XB_KEYS)
    f32 = dict(dtype=torch.float32, device="cuda")
    ws = torch.empty(b * hh * tp * cols + hh * xl_bwd_dp_rows(t) * d, **f32)
    side, dq_acc, dp_acc, pu, pv = flash_xl_bwd_prepass(oh, doh, lse, cols, qh, bu, bv, ws=ws)
    pre_ms = cuda_ms(lambda: flash_xl_bwd_prepass(oh, doh, lse, cols, qh, bu, bv, ws=ws))
    if lanes:
        qu, qv = pu, pv
    colsum = torch.empty(b, hh, n_kt, 2, d, **f32) if lanes else None
    dk, dv, dq, dqv = (torch.empty(b, t, hh, d, dtype=torch.bfloat16, device="cuda")
                       .permute(0, 2, 1, 3) for _ in range(4))
    dp = torch.empty(p.shape, dtype=p.dtype, device="cuda")
    main_ms = cuda_ms(lambda: xl_backward_kernel(qu, qv, kh, vh, doh, p, None, side, dq_acc,
                                                 dp_acc, colsum, dk, dv, scale))
    dqv = None if lanes else dqv
    post_ms = cuda_ms(lambda: flash_xl_bwd_postpass(dq_acc, dp_acc, colsum, scale, dq, dqv, dp))
    log(f"time {what} parts: pre-pass {pre_ms:.4f} ms, kernel {main_ms:.4f} ms, post-pass "
        f"{post_ms:.4f} ms")
    if results is None:
        return
    n_rows, n_pos = b * hh * t, hh * (2 * t - 1)
    r = results["flash_xl_bwd_prepass"]
    r["ms"] = pre_ms
    r["plain_ms"] = cuda_ms(
        lambda: flash_xl_bwd_prepass_reference(oh, doh, lse, cols, qh, bu, bv), iters=3)
    r["library_ms"] = None  # no one PyTorch call computes delta, qu, qv and zeroed workspaces
    bound(r, 4.0 * n_rows * d, 5.0 * n_rows * d * 2 + n_rows * 4 + 2 * hh * d * 4
          + b * hh * tp * 2 * 4 + ws.numel() * 4)
    r = results["flash_xl_bwd_postpass"]
    r["ms"] = post_ms
    scratch = [torch.empty(x.shape, **f32) for x in (dq, dp)]
    r["plain_ms"] = cuda_ms(lambda: flash_xl_bwd_postpass_reference(
        dq_acc, dp_acc, colsum, scale, scratch[0], None, scratch[1]), iters=3)
    r["library_ms"] = None  # no one PyTorch call writes dq, dP and the bias gradients
    bound(r, 1.0 * (n_rows + n_pos) * d + colsum.numel(),
          (n_rows + n_pos) * d * (4.0 + 2.0) + colsum.numel() * 4 + 2 * hh * d * 4)


def time_bias_kernels(results):
    """Row 4 at the masked decoder's shape (B=8, 12 heads, T=1000, d=64) with
    its banded, key-masked bias; its plain version; SDPA with the bias as a
    float ``attn_mask`` (in q's dtype, as SDPA takes it)."""
    import torch.nn.functional as F

    from transformer4sed_tpu_torch.kernels.flash_attention import (
        flash_attention_bias,
        flash_attention_bias_reference,
    )

    b, h, t, d = MASKED_BATCH, BIAS_HEADS, BIAS_T, 64
    q, k, v, bias, _ = bias_inputs(b, t, h, d, seed=0)
    scale = d ** -0.5
    r = results["flash_attention_bias"]
    r["ms"] = cuda_ms(lambda: flash_attention_bias(q, k, v, bias, scale))
    r["plain_ms"] = cuda_ms(lambda: flash_attention_bias_reference(q, k, v, bias, scale), iters=3)
    mask = bias.to(q.dtype)
    r["library_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale))
    # q, k, v, the f32 bias in, o out
    bound(r, 4.0 * b * h * t * t * d, 4.0 * b * h * t * d * 2 + b * h * t * t * 4)


def time_variant_kernels(results):
    """Row 16 at the experiment's [64, 12, 1190, 64] bf16: variants A (its
    ``ms``) and B, beside their plain version and plain SDPA on the same
    inputs."""
    import torch
    import torch.nn.functional as F

    from transformer4sed_tpu_torch.exps.flash_variants import flash_a, flash_a_reference

    b, h, n, d = VARIANT_SHAPE
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, h, n, d, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    r = results["flash_a"]
    r["ms"] = cuda_ms(lambda: flash_a(q, k, v, scale))
    ms_b = cuda_ms(lambda: flash_a(q, k, v, scale, use_exp2=True))
    r["plain_ms"] = cuda_ms(lambda: flash_a_reference(q, k, v, scale), iters=3, warmup=1)
    r["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    bound(r, 4.0 * b * h * n * n * d, 4.0 * b * h * n * d * 2)
    log(f"time flash_a at {list(VARIANT_SHAPE)}: A tail-mask {r['ms']:.4f} ms, B tail+exp2 "
        f"{ms_b:.4f} ms, SDPA {r['library_ms']:.4f} ms")
    del q, k, v
    torch.cuda.empty_cache()


def time_window_shape_kernels():
    """Rows 1, 7 and 8 at the shapes finetune2's window groups give them: the
    served batch's 16 windows of 512 frames (B=8: 128 images of 602 tokens)
    for row 1, the train step's (12 clips: 192 images) for rows 7 and 8;
    logged beside their bounds and SDPA's time on the same operands (forward;
    for row 8 its backward through autograd), which the port never calls
    (the record keeps the clip's shapes)."""
    import torch
    import torch.nn.functional as F

    from transformer4sed_tpu_torch.kernels.flash_attention import (
        _split_heads,
        flash_attention_nhd,
        flash_attention_nhd_backward,
        flash_attention_nhd_lse,
    )

    n, c, h = 602, 768, 12
    d = c // h
    for b, name in ((8 * 16, "flash_attention_nhd"), (sum(FT2_SPLIT) * 16, "flash_attention_nhd_lse"),
                    (sum(FT2_SPLIT) * 16, "flash_attention_nhd_backward")):
        q, k, v = flash_inputs(b, n, c, seed=b)
        qh, kh, vh = (_split_heads(x, h) for x in (q, k, v))
        if name == "flash_attention_nhd":
            ms = cuda_ms(lambda: flash_attention_nhd(q, k, v, h))
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
            flops, nbytes = 4.0 * b * h * n * n * d, 4.0 * b * n * c * 2
        elif name == "flash_attention_nhd_lse":
            ms = cuda_ms(lambda: flash_attention_nhd_lse(q, k, v, h))
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
            flops, nbytes = 4.0 * b * h * n * n * d, 4.0 * b * n * c * 2 + b * h * n * 4
        else:
            o, lse = flash_attention_nhd_lse(q, k, v, h)
            do = grad_output((b, n, c), seed=b + 1)
            ms = cuda_ms(lambda: flash_attention_nhd_backward(q, k, v, o, lse, do, h))
            qg, kg, vg = (x.detach().requires_grad_() for x in (qh, kh, vh))
            sdpa = F.scaled_dot_product_attention(qg, kg, vg)
            doh = _split_heads(do, h)
            sdpa_ms = cuda_ms(
                lambda: torch.autograd.grad(sdpa, (qg, kg, vg), doh, retain_graph=True))
            flops, nbytes = 10.0 * b * h * n * n * d, 8.0 * b * n * c * 2 + b * h * n * 4
            del o, lse, do, sdpa, qg, kg, vg
        t_bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        log(f"time {name} at the window shape [{b}, {n}, {c}]: {ms:.4f} ms, bound "
            f"{t_bound:.4f} ms, SDPA {sdpa_ms:.4f} ms")
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()


def bound(r, flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    r["bound_ms"] = max(t_ops, t_bytes)
    r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    r["flops"], r["bytes"] = flops, nbytes


def time_serving(engine, batches, windows=3, per_window=160, what="served"):
    """Served clips/s over ``windows`` back-to-back windows of ``per_window``
    batches of the engine's size (the full host batches replayed, a few
    seconds each); log each window's rate and return the median window's ms
    per batch."""
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
        log(f"{what} window {w}: {n} clips at B={engine.batch_size} in {dt:.3f} s: "
            f"{n / dt:.2f} clips/s (host batches to decoded-ready scores, frontend and "
            "median filter included)")
    mid = sorted(rates)[len(rates) // 2]
    log(f"{what} clips/s over {windows} windows: median {mid:.2f}, min {min(rates):.2f}, "
        f"max {max(rates):.2f}, spread {(max(rates) - min(rates)) / mid:.1%} of the median")
    return engine.batch_size / mid * 1e3


def time_training(trainer, batch, windows=3, per_window=4, what="train",
                  parts="frontend, augmentation, teacher, student forward and backward, clip, "
                        "AdamW, EMA"):
    """Train steps/s and clips/s over ``windows`` windows of ``per_window``
    steps (host batch in, updated model and optimizer state out); log each
    window, the spread and the peak device memory; return the median
    window's ms per step."""
    import torch

    gen = torch.Generator().manual_seed(5)
    trainer.step(batch, gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    b = len(batch["wav"])
    rates = []
    for w in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(per_window):
            trainer.step(batch, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append(per_window / dt)
        log(f"{what} window {w}: {per_window} steps at B={b} in {dt:.3f} s: "
            f"{per_window / dt:.4f} steps/s, {b * per_window / dt:.2f} clips/s, "
            f"{dt / per_window * 1e3:.1f} ms/step ({parts})")
    mid = sorted(rates)[len(rates) // 2]
    log(f"{what} steps/s over {windows} windows: median {mid:.4f} ({b * mid:.2f} clips/s), min "
        f"{min(rates):.4f}, max {max(rates):.4f}, spread {(max(rates) - min(rates)) / mid:.1%} "
        "of the median")
    log(f"{what} peak device memory (max_memory_allocated over the windows): "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return 1e3 / mid


def device_kernels(prof):
    """The device-side events of a profile, without the user annotations
    (e.g. ``Optimizer.step#AdamW.step``) that would count their kernels twice."""
    import torch

    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profile_training(trainer, batch, step_ms, top=20, what="train"):
    """Device time by kernel over one train step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(6)
    trainer.step(batch, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.step(batch, gen)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    check(kernels, "the profiler recorded no CUDA kernels")
    ms = lambda e: e.self_device_time_total / 1e3  # noqa: E731
    device_ms = sum(ms(e) for e in kernels)
    log(f"profile: {device_ms:.3f} ms of device time per {what} step at B={len(batch['wav'])} "
        f"against {step_ms:.3f} ms per step unprofiled: device busy {device_ms / step_ms:.1%}")
    for e in sorted(kernels, key=ms, reverse=True)[:top]:
        log(f"  {ms(e):9.3f} ms {ms(e) / device_ms:6.1%} x{e.count:5d}  {e.key[:90]}")


def profile_serving(engine, batches, batch_ms, top=15, what="served"):
    """Device time by kernel over the full served batches given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    full = [b for b in batches if len(b["filename"]) == engine.batch_size]
    list(engine.score_batches(full))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        list(engine.score_batches(full))
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    check(kernels, "the profiler recorded no CUDA kernels")
    per_batch = lambda e: e.self_device_time_total / 1e3 / len(full)  # noqa: E731
    device_ms = sum(per_batch(e) for e in kernels)
    log(f"profile: {device_ms:.3f} ms of device time per {what} batch of {engine.batch_size} against "
        f"{batch_ms:.3f} ms per batch unprofiled: device busy {device_ms / batch_ms:.1%}")
    for e in sorted(kernels, key=per_batch, reverse=True)[:top]:
        log(f"  {per_batch(e):8.3f} ms {per_batch(e) / device_ms:6.1%} x{e.count // len(full):4d}  "
            f"{e.key[:90]}")


def cuobjdump(path, flag):
    """``cuobjdump <flag>`` of a built library, from the toolkit that built it."""
    from transformer4sed_tpu_torch.kernels import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    return subprocess.run([str(tool), flag, str(path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout


def resource_usage(path):
    """{kernel symbol: (registers, stack bytes, local bytes)} from
    ``cuobjdump -res-usage`` of a built library; a spill lives in the stack
    frame, so no stack and no local memory means no spill."""
    report, entry = {}, None
    for line in cuobjdump(path, "-res-usage").splitlines():
        m = re.search(r"Function ([^\s:]+)\s*:", line)
        if m:
            entry = m.group(1)
        m = re.search(r"REG:(\d+)\s+STACK:(\d+).*LOCAL:(\d+)", line)
        if m and entry is not None:
            report[entry] = tuple(int(g) for g in m.groups())
            entry = None
    return report


def sass_opcodes(path):
    """{kernel symbol: how often each opcode (up to its first dot) appears in
    its SASS}, from ``cuobjdump -sass`` of a built library."""
    counts, entry = {}, None
    for line in cuobjdump(path, "-sass").splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            entry = counts.setdefault(m.group(1), collections.Counter())
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if entry is not None and m:
            entry[m.group(1)] += 1
    return counts


def check_build(paths):
    """From the built libraries, whether built by this process or before it:
    no kernel of the port spills (no stack frame, no local memory and no
    LDL or STL in the SASS); the flash forward's kernels (rows 1, 3, 4, 5,
    7, 16) and the XL forward's (rows 2, 12 heads in lanes, rows 9, 10 head
    major: one body) run warpgroup products (HGMMA) on TMA loads (UTMALDG)
    and no ``mma.sync`` (HMMA), row 4's with the bias copied by cp.async
    (LDGSTS); the flash and XL backwards' main kernels (rows 6, 8, 11, 13)
    run HGMMA, UTMALDG and TMA reductions (UTMAREDG: dQ, and dP in XL) and
    no atomic. The Swin window forward and backward (rows 14, 15) are held
    as the flash family: no spill, HGMMA on TMA loads, no HMMA, and the
    backward's sums by UTMAREDG, no atomic."""
    for name in paths:  # every source of the port
        usage, sass = resource_usage(paths[name]), sass_opcodes(paths[name])
        check(usage and usage.keys() == sass.keys(),
              f"{name}: cuobjdump names kernels {sorted(usage)} and SASS {sorted(sass)}")
        for sym, (regs, stack, local) in usage.items():
            ops = sass[sym]
            spilled = stack or local or ops["LDL"] or ops["STL"]
            log(f"  {name} {sym}: {regs} registers, stack {stack} B, local {local} B, "
                f"LDL {ops['LDL']}, STL {ops['STL']}")
            check(not spilled, f"{name} {sym} spills")
        kernel = ("xl_fwd_kernel" if name in ("xl_attention", "xl_attention_hm") else
                  "window_fwd_kernel" if name == "window_attention" else
                  "window_bwd_kernel" if name == "window_attention_bwd" else
                  "xl_bwd_kernel" if name.startswith("xl") else
                  "flash_bwd_kernel" if name.endswith("_bwd") else "flash_fwd_kernel")
        main = [sym for sym in sass if kernel in sym]
        check(main, f"{name}: no {kernel} in the library")
        for sym in main:
            ops = sass[sym]
            shown = {op: ops[op] for op in ("HGMMA", "HMMA", "UTMALDG", "UBLKCP", "UTMAREDG",
                                            "UTMASTG",
                                            "LDGSTS", "RED", "REDG", "ATOM", "ATOMG", "STS",
                                            "STSM", "BAR", "MUFU")}
            log(f"  {name} SASS of {sym}: {shown}")
            check(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0 and not ops["HMMA"],
                  f"{name}: the SASS of {kernel} lacks HGMMA or UTMALDG, or runs HMMA")
            if name == "flash_attention_bias":
                check(ops["LDGSTS"] > 0, f"{name}: the bias is not copied by cp.async")
            if kernel.endswith("bwd_kernel"):
                check(ops["UTMAREDG"] > 0, f"{name}: the backward's SASS lacks UTMAREDG")
                check(not any(ops[op] for op in ("RED", "REDG", "ATOM", "ATOMG")),
                      f"{name}: an atomic in the backward's SASS (dQ, dP, dbias and dshift go "
                      "by TMA reductions)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma list of {PHASES} (default: all)")
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES + SUB_PHASES):
        parser.error(f"unknown phases {sorted(phases - set(PHASES + SUB_PHASES))}")

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
            if "registers" in line or "spill" in line or "(C7" in line:  # C7xxx: wgmma advisories
                log(f"  ptxas {name}: {line.strip()}")
    if "build" in phases:
        check_build(paths)

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
        "flash_attention_nhd_lse": {
            "name": "flash_attention_nhd_lse", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/flash_attention.cu",
            "replaces": "transformer4sed_tpu/kernels/flash_attention.py:579",
        },
        "flash_attention_nhd_backward": {
            "name": "flash_attention_nhd_backward", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": "transformer4sed_tpu/kernels/flash_attention.py:670",
        },
        "flash_xl_attention_nhd_lse": {
            "name": "flash_xl_attention_nhd_lse", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/xl_attention.cu",
            "replaces": "transformer4sed_tpu/kernels/xl_attention.py:734",
        },
        "flash_xl_attention_nhd_backward": {
            "name": "flash_xl_attention_nhd_backward", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/xl_attention_bwd.cu",
            "replaces": "transformer4sed_tpu/kernels/xl_attention.py:886",
        },
        "window_attention": {
            "name": "window_attention", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/window_attention.cu",
            "replaces": "transformer4sed_tpu/kernels/window_attention.py:145",
        },
        "window_attention_backward": {
            "name": "window_attention_backward", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/window_attention_bwd.cu",
            "replaces": "transformer4sed_tpu/kernels/window_attention.py:260",
        },
        "flash_xl_attention": {
            "name": "flash_xl_attention", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/xl_attention_hm.cu",
            "replaces": "transformer4sed_tpu/kernels/xl_attention.py:340",
        },
        "flash_xl_attention_lse": {
            "name": "flash_xl_attention_lse", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/xl_attention_hm.cu",
            "replaces": "transformer4sed_tpu/kernels/xl_attention.py:410",
        },
        "flash_xl_attention_backward": {
            "name": "flash_xl_attention_backward", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/xl_attention_bwd.cu",
            "replaces": "transformer4sed_tpu/kernels/xl_attention.py:458",
        },
        "flash_attention": {
            "name": "flash_attention", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/flash_attention_hm.cu",
            "replaces": "transformer4sed_tpu/kernels/flash_attention.py:96",
        },
        "flash_attention_lse": {
            "name": "flash_attention_lse", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/flash_attention_hm.cu",
            "replaces": "transformer4sed_tpu/kernels/flash_attention.py:368",
        },
        "flash_attention_backward": {
            "name": "flash_attention_backward", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/flash_attention_hm_bwd.cu",
            "replaces": "transformer4sed_tpu/kernels/flash_attention.py:401",
        },
        "flash_attention_bias": {
            "name": "flash_attention_bias", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/flash_attention_bias.cu",
            "replaces": "transformer4sed_tpu/kernels/flash_attention.py:183",
        },
        "flash_a": {
            "name": "flash_a", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/flash_variants.cu",
            "replaces": "exps/flash_variants.py:62",
        },
        "flash_bwd_prepass": {
            "name": "flash_bwd_prepass", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": "transformer4sed_tpu/kernels/flash_attention.py:686",
        },
        "flash_bwd_postpass": {
            "name": "flash_bwd_postpass", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": "transformer4sed_tpu/kernels/flash_attention.py:720",
        },
        "flash_xl_bwd_prepass": {
            "name": "flash_xl_bwd_prepass", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/xl_attention_bwd.cu",
            "replaces": "transformer4sed_tpu/kernels/xl_attention.py:912",
        },
        "flash_xl_bwd_postpass": {
            "name": "flash_xl_bwd_postpass", "route": "cuda",
            "source": "transformer4sed_tpu_torch/csrc/xl_attention_bwd.cu",
            "replaces": "transformer4sed_tpu/kernels/xl_attention.py:978",
        },
    }
    if "kernels" in phases:
        t0 = time.perf_counter()
        check_kernels(results)
        torch.cuda.empty_cache()
        log(f"kernel check phase {time.perf_counter() - t0:.1f} s")
    elif phases & {"window_kernels", "hm_kernels", "flash_hm_kernels", "bias_kernels",
                   "variant_kernels"}:
        rejected = []
        if "window_kernels" in phases:
            check_window_kernels(results, rejected)
        if "hm_kernels" in phases:
            check_hm_kernels(results, rejected)
        if "flash_hm_kernels" in phases:
            check_flash_hm_kernels(results, rejected)
        if "bias_kernels" in phases:
            check_bias_kernels(results, rejected)
        if "variant_kernels" in phases:
            check_variant_kernels(results, rejected)
        check(not any(rejected), "the kernel check let a planted fault through")
        log(f"all {len(rejected)} planted faults fall outside the bound")
    if "masked_decoder" in phases:
        t0 = time.perf_counter()
        masked_decoder(results)
        torch.cuda.empty_cache()
        log(f"masked decoder phase {time.perf_counter() - t0:.1f} s")
    if "kernel_timing" in phases and "timing" not in phases:
        t0 = time.perf_counter()
        time_kernels(results)
        torch.cuda.empty_cache()
        log(f"kernel timing phase {time.perf_counter() - t0:.1f} s")
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
    if phases & {"score", "serving"}:
        import tempfile

        engine = engine if engine is not None else build_engine("cuda", torch.bfloat16)
        with tempfile.TemporaryDirectory(prefix="t4s_score_") as split:
            if "score" in phases:
                t0 = time.perf_counter()
                score(engine, Path(split))
                torch.cuda.empty_cache()
                log(f"score phase {time.perf_counter() - t0:.1f} s")
            else:
                write_score_split(Path(split), engine.codec)
            if "serving" in phases:
                t0 = time.perf_counter()
                serving(engine, Path(split))
                torch.cuda.empty_cache()
                log(f"serving phase {time.perf_counter() - t0:.1f} s")
    if "stages" in phases:
        t0 = time.perf_counter()
        stages()
        torch.cuda.empty_cache()
        log(f"stages phase {time.perf_counter() - t0:.1f} s")
    if "pmam_stages" in phases:
        t0 = time.perf_counter()
        pmam_stages()
        torch.cuda.empty_cache()
        log(f"pmam_stages phase {time.perf_counter() - t0:.1f} s")
    trainer = train_batch = None
    if phases & {"train", "timing", "profile"}:
        t0 = time.perf_counter()
        trainer, train_batch = train(results)
        log(f"train phase {time.perf_counter() - t0:.1f} s")
    if "timing" in phases:
        # the single-device paths are timed before the process group and the
        # sharded trainer exist, as in the runs before the parallel layout
        t0 = time.perf_counter()
        time_kernels(results)
        batch_ms = time_serving(engine, batches, per_window=40)
        step_ms = time_training(trainer, train_batch)
        log(f"flagship timing phase {time.perf_counter() - t0:.1f} s")
        if "profile" in phases:
            profile_serving(engine, batches, batch_ms)
            profile_training(trainer, train_batch, step_ms)
    del engine, trainer
    torch.cuda.empty_cache()

    mesh = parallel_init() if phases & {"parallel_train", "timing"} else None
    if phases & {"train_parity", "parallel_train"}:
        # one CPU f32 trajectory holds the single-device and the parallel card paths
        t0 = time.perf_counter()
        train_parity(mesh if "parallel_train" in phases else None)
        torch.cuda.empty_cache()
        log(f"train parity phase {time.perf_counter() - t0:.1f} s")
    par_trainer = par_batch = None
    if mesh is not None:
        t0 = time.perf_counter()
        par_trainer, par_batch = parallel_train(results, mesh)
        log(f"parallel train phase {time.perf_counter() - t0:.1f} s")
    if "multichip_dryrun" in phases:
        t0 = time.perf_counter()
        multichip_dryrun()
        log(f"multichip dry-run phase {time.perf_counter() - t0:.1f} s")
    if "timing" in phases:
        t0 = time.perf_counter()
        par_step_ms = time_training(
            par_trainer, par_batch, what="parallel-layout train",
            parts="frontend, augmentation, teacher, student forward and backward on the 1 x 1 "
                  "mesh, gradient all-reduce, clip, AdamW, EMA")
        log(f"parallel-layout timing phase {time.perf_counter() - t0:.1f} s")
        if "profile" in phases:
            profile_training(par_trainer, par_batch, par_step_ms, what="parallel-layout train")
    del par_trainer
    torch.cuda.empty_cache()
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()

    h_engine = h_batches = None
    if phases & {"htsat_serve", "htsat_parity", "timing", "profile", "htsat_timing"}:
        t0 = time.perf_counter()
        h_engine = build_htsat_engine("cuda", torch.bfloat16)
        h_batches = htsat_serve(h_engine, results)
        log(f"HTSAT_CNN serve phase {time.perf_counter() - t0:.1f} s")
    if "htsat_parity" in phases:
        t0 = time.perf_counter()
        htsat_parity(h_engine, h_batches)
        log(f"HTSAT_CNN parity phase {time.perf_counter() - t0:.1f} s")
    stepper = h_train_batch = None
    if phases & {"htsat_train", "timing", "profile", "htsat_timing"}:
        t0 = time.perf_counter()
        stepper, h_train_batch = htsat_train(results)
        log(f"HTSAT_CNN train phase {time.perf_counter() - t0:.1f} s")
    if "htsat_train_parity" in phases:
        t0 = time.perf_counter()
        htsat_train_parity()
        torch.cuda.empty_cache()
        log(f"HTSAT_CNN train parity phase {time.perf_counter() - t0:.1f} s")
    if phases & {"timing", "htsat_timing"}:
        t0 = time.perf_counter()
        if "timing" not in phases:
            time_window_kernels(results)
        h_batch_ms = time_serving(h_engine, h_batches, per_window=20, what="HTSAT_CNN served")
        h_step_ms = time_training(
            stepper, h_train_batch, what="HTSAT_CNN train",
            parts="frontend, augmentation, forward and backward, clip, AdamW")
        log(f"HTSAT_CNN timing phase {time.perf_counter() - t0:.1f} s")
        if phases & {"profile", "htsat_timing"}:
            profile_serving(h_engine, h_batches, h_batch_ms, what="HTSAT_CNN served")
            profile_training(stepper, h_train_batch, h_step_ms, what="HTSAT_CNN train")
    del h_engine, stepper
    torch.cuda.empty_cache()

    p_engine = p_batches = None
    if phases & {"pmam_serve", "pmam_parity", "timing", "profile", "pmam_timing"}:
        t0 = time.perf_counter()
        p_engine = build_pmam_engine("cuda", torch.bfloat16)
        p_batches = pmam_serve(p_engine, results)
        log(f"PMAM serve phase {time.perf_counter() - t0:.1f} s")
    if "pmam_parity" in phases:
        t0 = time.perf_counter()
        parity(p_engine, p_batches, build_pmam_engine, what="PMAM")
        log(f"PMAM parity phase {time.perf_counter() - t0:.1f} s")
    p_trainer = p_train_batch = None
    if phases & {"pmam_train", "timing", "profile", "pmam_timing"}:
        t0 = time.perf_counter()
        p_trainer, p_train_batch = pmam_train(results)
        log(f"PMAM train phase {time.perf_counter() - t0:.1f} s")
    if "pmam_train_parity" in phases:
        t0 = time.perf_counter()
        pmam_train_parity()
        torch.cuda.empty_cache()
        log(f"PMAM train parity phase {time.perf_counter() - t0:.1f} s")
    m_trainer = m_batch = None
    if phases & {"mlm_train", "timing", "profile", "pmam_timing"}:
        t0 = time.perf_counter()
        m_trainer, m_batch = mlm_train()
        log(f"MLM train phase {time.perf_counter() - t0:.1f} s")
    if "mlm_train_parity" in phases:
        t0 = time.perf_counter()
        mlm_train_parity()
        torch.cuda.empty_cache()
        log(f"MLM train parity phase {time.perf_counter() - t0:.1f} s")
    if phases & {"timing", "pmam_timing"}:
        t0 = time.perf_counter()
        if "timing" not in phases:
            time_hm_kernels(results)
        p_batch_ms = time_serving(p_engine, p_batches, per_window=40, what="PMAM served")
        p_step_ms = time_training(p_trainer, p_train_batch, what="PMAM train")
        m_step_ms = time_training(
            m_trainer, m_batch, what="MLM train",
            parts="frontend, augmentation, masked forward and backward, clip, AdamW")
        log(f"PMAM and MLM timing phase {time.perf_counter() - t0:.1f} s")
        if phases & {"profile", "pmam_timing"}:
            profile_serving(p_engine, p_batches, p_batch_ms, what="PMAM served")
            profile_training(p_trainer, p_train_batch, p_step_ms, what="PMAM train")
            profile_training(m_trainer, m_batch, m_step_ms, what="MLM train")
    del p_engine, p_trainer, m_trainer
    torch.cuda.empty_cache()

    f_engine = f_batches = None
    if phases & {"finetune2_serve", "finetune2_parity", "timing", "profile"}:
        f_engine, f_batches = finetune2_serve(results)
    if "finetune2_parity" in phases:
        t0 = time.perf_counter()
        parity(f_engine, f_batches, build_ft2_engine, what="finetune2", clips=slice(5, 6))
        log(f"finetune2 parity phase {time.perf_counter() - t0:.1f} s")
    if phases & {"timing", "profile"}:
        f_batch_ms = time_serving(f_engine, f_batches, per_window=16, what="finetune2 served")
        if "profile" in phases:
            profile_serving(f_engine, f_batches, f_batch_ms, what="finetune2 served")
    del f_engine
    torch.cuda.empty_cache()
    if phases & {"finetune2_train", "timing", "profile"}:
        (f_trainer, f_batch), (pf_trainer, pf_batch) = finetune2_train(results)
        if phases & {"timing", "profile"}:
            f_step_ms = time_training(f_trainer, f_batch, what="finetune2 train")
            pf_step_ms = time_training(pf_trainer, pf_batch, what="PMAM finetune2 train")
            if "profile" in phases:
                profile_training(f_trainer, f_batch, f_step_ms, what="finetune2 train")
                profile_training(pf_trainer, pf_batch, pf_step_ms, what="PMAM finetune2 train")
        del f_trainer, pf_trainer
        torch.cuda.empty_cache()
    if "finetune2_train_parity" in phases:
        t0 = time.perf_counter()
        finetune2_train_parity()
        torch.cuda.empty_cache()
        log(f"finetune2 train parity phase {time.perf_counter() - t0:.1f} s")
    d_engine = d_batches = None
    if phases & {"dasm_serve", "dasm_parity", "timing", "profile"}:
        t0 = time.perf_counter()
        d_engine, d_batches = dasm_serve(results)
        d_batch_ms = time_serving(d_engine, d_batches, per_window=40, what="DASM served")
        at_ms = at_decoder_ms(d_engine.model, lambda: d_engine.forward(*d_engine._put(
            d_batches[0])[1:]))
        log(f"DASM served: the AT decoder's forward (2 layers, 447 queries over 1188 tokens, "
            f"plain PyTorch) {at_ms:.3f} ms of {d_batch_ms:.3f} ms a batch of {DASM_BATCH} "
            f"({at_ms / d_batch_ms:.1%}; {card})")
        if "profile" in phases:
            profile_serving(d_engine, d_batches, d_batch_ms, what="DASM served")
        log(f"DASM serve phase {time.perf_counter() - t0:.1f} s")
    if "dasm_parity" in phases:
        t0 = time.perf_counter()
        dasm_parity(d_engine, d_batches)
        log(f"DASM parity phase {time.perf_counter() - t0:.1f} s")
    del d_engine
    torch.cuda.empty_cache()
    if phases & {"dasm_train", "timing", "profile"}:
        t0 = time.perf_counter()
        d_step, d_batch, d_step_ms = dasm_train(results)
        gen = torch.Generator().manual_seed(6)
        at_ms = at_decoder_ms(d_step.model, lambda: d_step.step(d_batch, gen), backward=True)
        log(f"DASM train: the AT decoder's forward and backward {at_ms:.3f} ms of "
            f"{d_step_ms:.1f} ms a step at B={DASM_TRAIN_BATCH} ({at_ms / d_step_ms:.1%}; {card})")
        if "profile" in phases:
            profile_training(d_step, d_batch, d_step_ms, what="DASM train")
        del d_step
        torch.cuda.empty_cache()
        log(f"DASM train phase {time.perf_counter() - t0:.1f} s")
    if "dasm_train_parity" in phases:
        t0 = time.perf_counter()
        dasm_train_parity()
        torch.cuda.empty_cache()
        log(f"DASM train parity phase {time.perf_counter() - t0:.1f} s")
    if "audioset_stages" in phases:
        t0 = time.perf_counter()
        audioset_stages()
        torch.cuda.empty_cache()
        log(f"audioset_stages phase {time.perf_counter() - t0:.1f} s")
    log(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all ({card})")
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
