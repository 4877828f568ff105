"""Where the card's bf16 post-pretrain gradient parts from the CPU's f32 one.

    python transformer4sed_tpu_torch/exps/pmam_parity_probe.py [--lora-std 0.1]
        [--batch parity|unlabeled] [--plain-bf16]

runs ``chip_smoke.py``'s phase ``pmam_stages`` (the PMAM chain through
``recipes.cli.main`` on the card, the post-pretrain checkpoint's LoRA
factors seeded N(0, ``--lora-std``)) up to its check (e), and there, in
place of the parity check, takes the prototype-BCE step of the CPU's f32
trainer and the card's bf16 one apart at three states: the initial
weights, the CPU's state before its last step and its end state (the
CPU's weights loaded into the card's trainer each time, the same draws).
``--batch`` picks (e)'s batch: phase ``pmam_train_parity``'s three clips
labelled by the tokenizer (``parity``), or the unlabeled folder's first
three clips with their pseudo-label TSVs (``unlabeled``). At each state it
prints, card against CPU as (cosine, norm ratio, relative difference):

  * the gradient of the trainable params, and of ``mlm_pred`` and
    ``at_out``, the two outputs the loss reads;
  * the head alone (``prototype_predictions`` and ``masked_bce`` in f32 on
    the CPU) on the card's ``mlm_pred`` against the CPU's, on the CPU's
    ``mlm_pred`` with random noise of the card's size, and the same head
    in f64 with the BCE written as ``softplus(z) - y z`` (no clamp);
  * the card's backward fed the CPU's gradients of ``mlm_pred`` and
    ``at_out``;
  * the head's operating point on the masked frames: the logits z =
    (2 leaky_relu(sim, 0.2) - 1) / T, the share of non-target elements
    whose f32 ``sigmoid(z)`` is exactly 1 (where ``safe_log(1 - p)`` is
    the constant -100 and has no gradient) on each side, the share and
    count that cross that cutoff between them beside the count of
    non-target elements that carry gradient, the targets within the
    card's error of the leaky ReLU's kink and across it, and the card's
    logit error;

and with ``--plain-bf16``, at the end state, the port's plain path in bf16
on the CPU (the kernels' plain versions, the card's dtype) against f32.
The script stops after the end state; it prints nothing for the other
checks of the phase. Needs a card, like ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


class _Done(Exception):
    pass


def log(text: str) -> None:
    print("probe: " + text, flush=True)


def cmp(a, b):
    """(cosine, |b| / |a|, |b - a| / |a|) of two tensors, in f64."""
    a, b = a.double().flatten(), b.double().flatten()
    return tuple(round(v, 6) for v in (float(a @ b / (a.norm() * b.norm() + 1e-30)),
                                       float(b.norm() / (a.norm() + 1e-30)),
                                       float((b - a).norm() / (a.norm() + 1e-30))))


def quantiles(v):
    import torch

    qs = torch.quantile(v.flatten().float(), torch.tensor([0.0, 0.1, 0.5, 0.9, 1.0]))
    return [round(float(x), 4) for x in qs]


def forward_backward(trainer, state, batch, seed, keep, retain=False):
    """The trainer's loss at ``state`` with the draws of ``seed``, as
    ``PMAMTrainer.forward_backward`` computes it, with the two outputs the
    loss reads kept: their values and gradients, and the params' gradients."""
    import torch

    from transformer4sed_tpu_torch.core import losses as L
    from transformer4sed_tpu_torch.pmam.train import (masked_bce, preprocess,
                                                      prototype_predictions)

    trainer.model.load_state_dict(state)
    gen = torch.Generator().manual_seed(seed)
    mel, labels = preprocess(trainer.frontend, trainer.cfg, batch, gen, trainer.device)
    out = trainer.model(mel, train=True, generator=gen)
    mp, at = out.mlm_pred, out.at_out
    mp.retain_grad()
    at.retain_grad()
    pred = prototype_predictions(mp, trainer.gmm_means, trainer.cfg.temperature)
    strong = masked_bce(pred, labels.transpose(1, 2), out.mask_id_seq)
    weak = L.bce(at.float(), (labels.sum(-1) >= 1).float())
    trainer.model.zero_grad(set_to_none=True)
    (strong + trainer.cfg.w_at * weak).backward(retain_graph=retain)
    return dict(
        strong=float(strong.detach()), mp=mp.detach().float().cpu(),
        g_mp=mp.grad.float().cpu(), at=at.detach().float().cpu(), g_at=at.grad.float().cpu(),
        mask=out.mask_id_seq.cpu(), labels=labels.transpose(1, 2).float().cpu(), out=(mp, at),
        grads=torch.cat([p.grad.double().flatten().cpu()
                         for k, p in trainer.model.named_parameters()
                         if p.grad is not None and keep(k)]))


def head_gradient(mp, labels, mask, means, temperature, exact=False):
    """(loss, d loss / d mlm_pred) of the head alone: the trainer's f32
    head, or with ``exact`` the same function in f64 with the BCE as
    softplus(z) - y z."""
    import torch
    import torch.nn.functional as F

    from transformer4sed_tpu_torch.pmam.train import masked_bce, prototype_predictions

    x = mp.clone().double().requires_grad_(True)
    if exact:
        n = x / x.norm(dim=-1, keepdim=True)
        z = (F.leaky_relu(n @ means.double().T, 0.2) * 2 - 1) / temperature
        per = (F.softplus(z) - labels.double() * z).mean(-1)
        m = mask.double()
        loss = (per * m).sum() / m.sum().clamp_min(1.0)
    else:
        loss = masked_bce(prototype_predictions(x, means, temperature), labels, mask)
    loss.backward()
    return float(loss.detach()), x.grad.float()


def diagnose(tag, cpu, card, state, batch, seed):
    import torch
    import torch.nn.functional as F

    keep = lambda k: cpu.labels[k] != "frozen"  # noqa: E731
    c = forward_backward(cpu, state, batch, seed, keep)
    d = forward_backward(card, state, batch, seed, keep, retain=True)
    means, temp = cpu.gmm_means.double().cpu(), cpu.cfg.temperature
    log(f"[{tag}] loss_strong cpu {c['strong']:.6f}, card {d['strong']:.6f}; trainable "
        f"gradients {cmp(c['grads'], d['grads'])}; mlm_pred {cmp(c['mp'], d['mp'])}; "
        f"d loss/d mlm_pred {cmp(c['g_mp'], d['g_mp'])}; d loss/d at_out "
        f"{cmp(c['g_at'], d['g_at'])}")
    args = (c["labels"], c["mask"], means, temp)
    _, own = head_gradient(c["mp"], *args)
    _, theirs = head_gradient(d["mp"], *args)
    _, own64 = head_gradient(c["mp"], *args, exact=True)
    _, theirs64 = head_gradient(d["mp"], *args, exact=True)
    rel = cmp(c["mp"], d["mp"])[2]
    noisy = []
    for k in range(3):
        noise = torch.randn(c["mp"].shape, generator=torch.Generator().manual_seed(100 + k))
        _, g = head_gradient(c["mp"] + noise * (rel * c["mp"].norm() / noise.norm()), *args)
        noisy.append(cmp(own, g))
    log(f"[{tag}] the head alone on the card's mlm_pred: f32 {cmp(own, theirs)}, f64 without "
        f"the clamp {cmp(own64, theirs64)}; on the CPU's with random noise of relative size "
        f"{rel:.4f}: {noisy}")
    card.model.zero_grad(set_to_none=True)
    mp_out, at_out = d["out"]
    torch.autograd.backward([mp_out, at_out], [c["g_mp"].to(card.device, mp_out.dtype),
                                               c["g_at"].to(card.device, at_out.dtype)])
    fed = torch.cat([p.grad.double().flatten().cpu() for k, p in card.model.named_parameters()
                     if p.grad is not None and keep(k)])
    log(f"[{tag}] the card's backward fed the CPU's d loss/d (mlm_pred, at_out): trainable "
        f"gradients {cmp(c['grads'], fed)}")
    m = c["mask"].bool()
    y = c["labels"][m].double()
    sims = []
    for side in (c, d):
        x = side["mp"][m].double()
        sims.append((x / x.norm(dim=-1, keepdim=True)) @ means.T)
    z = [(F.leaky_relu(s, 0.2) * 2 - 1) / temp for s in sims]
    probs = [torch.sigmoid(v.float()) for v in z]
    ones = [v == 1 for v in probs]
    neg, pos = y < 0.5, y > 0.5
    carrying = (probs[0] > 1e-3) & (probs[0] < 1)
    err = float((sims[1] - sims[0]).abs().max())
    log(f"[{tag}] masked frames {int(m.sum())}: z {quantiles(z[0])}, card - cpu "
        f"{quantiles(z[1] - z[0])}; non-target elements at f32 sigmoid == 1: cpu "
        f"{float(ones[0][neg].double().mean()):.4f}, card {float(ones[1][neg].double().mean()):.4f}, "
        f"crossing between the two {float((ones[0] != ones[1])[neg].double().mean()):.4f} "
        f"({int((ones[0] != ones[1])[neg].sum())} elements; {int(carrying[neg].sum())} non-target "
        f"elements carry gradient on the CPU, 1e-3 < p < 1); targets "
        f"within the card's largest sim error {err:.3f} of the kink "
        f"{float((sims[0][pos].abs() < err).double().mean()):.4f}, across it on the card "
        f"{float(((sims[0] > 0) != (sims[1] > 0))[pos].double().mean()):.4f}; |mu_k| "
        f"{quantiles(means.norm(dim=-1))}")
    return c


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--lora-std", type=float, default=0.1)
    parser.add_argument("--batch", choices=("parity", "unlabeled"), default="parity")
    parser.add_argument("--plain-bf16", action="store_true")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    cs.PMAM_LORA_STD = args.lora_std
    configs = []
    build_trainer, parity = cs.pmam_post_trainer, cs.trainer_parity

    def post_trainer(config, *a, **k):
        configs[:] = [config]
        return build_trainer(config, *a, **k)

    def probe(what, cpu, card, batch, steps, loss_key, modules, trainable_only=False):
        import numpy as np
        import torch
        from scipy.io import wavfile

        if not what.startswith("PMAM post"):
            return parity(what, cpu, card, batch, steps, loss_key, modules, trainable_only)
        if args.batch == "unlabeled":
            folder = Path(configs[0]["dataset"]["unlabeled_folder"])
            tsv = folder.parent / "tokenizer" / "pseudo_labels"
            wavs = [wavfile.read(folder / f"u{i:03d}.wav")[1] / 32768.0 for i in range(3)]
            batch = {"wav": np.stack([np.pad(w, (0, cs.CLIP_SAMPLES - len(w)))
                                      for w in wavs]).astype(np.float32),
                     "labels": np.stack([cs.read_pseudo_label(tsv / f"u{i:03d}.tsv")[1][:, 2:].T
                                         for i in range(3)]).astype(np.float32)}
        log(f"LoRA factors N(0, {args.lora_std}), batch {args.batch}")
        start = copy.deepcopy(cpu.model.state_dict())
        diagnose("initial", cpu, card, start, batch, 20)
        cpu.model.load_state_dict(start)
        card.model.load_state_dict(start)
        for i in range(steps):
            if i == steps - 1:
                before, count = copy.deepcopy(cpu.model.state_dict()), cpu.step_count
            for name, t in (("cpu", cpu), ("card", card)):
                v = cs.finite_metrics(t.step(batch, torch.Generator().manual_seed(10 + i)))
                log(f"step {i} {name}: {loss_key} {v[loss_key]:.6f}, grad_norm "
                    f"{v['grad_norm']:.4f}")
        end, end_count = copy.deepcopy(cpu.model.state_dict()), cpu.step_count
        cpu.step_count = card.step_count = count
        diagnose("before the last step", cpu, card, before, batch, 10 + steps - 1)
        cpu.step_count = card.step_count = end_count
        c = diagnose("end", cpu, card, end, batch, 20)
        if args.plain_bf16:
            plain = build_trainer(configs[0], end, cpu.gmm_means.cpu().numpy(), "cpu",
                                  torch.bfloat16)
            b = forward_backward(plain, end, batch, 20, lambda k: cpu.labels[k] != "frozen")
            log(f"[end] the plain path in bf16 on the CPU: loss_strong {b['strong']:.6f}; "
                f"trainable gradients {cmp(c['grads'], b['grads'])}; mlm_pred "
                f"{cmp(c['mp'], b['mp'])}; d loss/d mlm_pred {cmp(c['g_mp'], b['g_mp'])}")
        raise _Done()

    cs.pmam_post_trainer, cs.trainer_parity = post_trainer, probe
    try:
        return cs.main(["--phases", "pmam_stages"])
    except _Done:
        return 0


if __name__ == "__main__":
    sys.exit(main())
