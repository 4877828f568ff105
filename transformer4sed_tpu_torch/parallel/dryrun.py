"""The multi-rank dry run (port of ``__graft_entry__.py:dryrun_multichip``).

Steps the same batch and the same draws on one rank, on data parallel over
``n`` ranks, and on dp(n/2) x tp2 when ``n`` is even, and requires the
trajectories to agree: sharding may change the order of sums, never the
math.

  * Phase 1, the mean teacher: the tiny PaSST_SED of the JAX harness, 3 steps
    with the default augmentation; the loss trajectory (``rtol 2e-3, atol
    1e-5``) and the student, teacher and optimizer-state norms after them
    (``rtol 2e-3``).
  * Phase 2, BatchNorm: the tiny HTSAT_CNN supervised step (Swin ``bn0`` and
    the CNN branch's BatchNorm), 3 steps; the losses (``rtol 2e-3, atol
    1e-5``), the running-statistics norm after each step (``rtol 1e-4``),
    every statistic after step 1 (``rtol 1e-4, atol 1e-5``: same params in
    every layout, so only the order of sums differs, where per-replica
    statistics would differ at the activations' RMS) and after step 3 (within
    10 % of its RMS).

:func:`launch` starts the ranks itself with ``torch.multiprocessing``
(spawn) on localhost: gloo on the CPU, no network. Every rank has its own
process-group timeout and the launcher a deadline, so a hung collective
fails the run instead of hanging it. The weights are random, made from a
seed, and the same on every rank; each layout builds its model afresh.
"""

from __future__ import annotations

import datetime
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from transformer4sed_tpu_torch.parallel.mesh import (
    Mesh,
    build_mesh,
    make_2d_mesh,
    make_mesh,
    shard_train_step,
)
from transformer4sed_tpu_torch.parallel.partition import (
    gather_state_dict,
    shard_params,
    sharded_params,
    tp_flash_attention,
)

N_STEPS = 3
LOSS_RTOL, LOSS_ATOL = 2e-3, 1e-5  # the JAX harness's bounds
NORM_RTOL = 2e-3
BN_NORM_RTOL = 1e-4
STAT1_RTOL, STAT1_ATOL = 1e-4, 1e-5
FINAL_STAT_RMS = 0.10


# -- launching ranks -------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, world: int, port: int, fn: Callable, args: tuple, results,
                timeout_s: float) -> None:
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the launcher, which raises
        results.put((rank, False, traceback.format_exc()))


def launch(world: int, fn: Callable, args: Sequence = (), timeout_s: float = 300.0) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes (one
    thread each) joined by a gloo process group on localhost; returns the
    ranks' results in rank order. Raises if a rank raises, or when the
    deadline passes (the ranks are then killed)."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world, port, fn, tuple(args), results, timeout_s))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s + 60.0
    got: Dict[int, Any] = {}
    errors = []
    try:
        while len(got) + len(errors) < world:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"{world - len(got)} of {world} ranks did not finish in "
                                   f"{timeout_s + 60.0:.0f} s")
            try:
                rank, ok, out = results.get(timeout=min(remaining, 5.0))
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and len(got) + len(errors) < world:
                    time.sleep(1.0)  # a crashed rank may still be flushing its report
                    if results.empty():
                        raise RuntimeError(f"rank process exited with {dead[0].exitcode}")
                continue
            if ok:
                got[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


# -- the two phases' setups (the JAX harness's configurations) -------------------------


def mean_teacher_setup(n_devices: int) -> Dict[str, Any]:
    """Tiny PaSST_SED, its mean-teacher config, param groups, schedule and the
    batch (per-source ``n_devices`` rows) of the JAX harness's first phase."""
    from transformer4sed_tpu_torch.core import schedules
    from transformer4sed_tpu_torch.frontend.mel import PasstFrontend
    from transformer4sed_tpu_torch.train.mean_teacher import MeanTeacherConfig
    from transformer4sed_tpu_torch.train.optim import GroupSpec, ParamGroupConfig

    per_source = n_devices
    cfg = MeanTeacherConfig(strong_num=per_source, weak_num=per_source,
                            unlabel_num=per_source, net_pooling=1, self_loss_warmup_steps=10)
    t_mel = 120
    n_samples = (t_mel - 1) * 320 + 1
    batch = per_source * 3
    t_out = (((t_mel - 16) // 10 + 1) + 1) * 10
    labels = np.zeros((batch, 3, t_out), np.float32)
    rng = np.random.RandomState(1)
    labels[:per_source] = (rng.rand(per_source, 3, t_out) > 0.8).astype(np.float32)
    labels[per_source:2 * per_source, :, 0] = (rng.rand(per_source, 3) > 0.5).astype(np.float32)
    wav = np.random.RandomState(0).randn(batch, n_samples).astype(np.float32)
    pg = ParamGroupConfig(encoder=GroupSpec(lr=1e-4, step_lr=1), decoder=GroupSpec(lr=1e-3),
                          head=GroupSpec(lr=1e-3), backbone_depth=2)
    return dict(cfg=cfg, pg=pg, schedule=schedules.exponential_down(50, 100),
                frontend=PasstFrontend(device="cpu"),
                batch={"wav": torch.from_numpy(wav), "labels": torch.from_numpy(labels)})


def mean_teacher_model():
    from transformer4sed_tpu_torch.models.passt_sed import PaSST_SED
    from transformer4sed_tpu_torch.utils.weights import init_weights_

    model = PaSST_SED(class_num=3, embed_dim=32, decoder_dim=32, backbone_depth=2,
                      backbone_num_heads=4, decoder_num_heads=4, at_adapter_heads=4,
                      passt_feature_layer=2, decoder="transformerXL", decoder_layer_num=1,
                      decoder_pos_emd_len=120, at_adapter=True, device="cpu")
    return init_weights_(model, seed=0)


MLM_DROP = 0.1  # the check's dropout, DropPath and token-dropout rate
MLM_STEPS = 2


def mlm_setup() -> Dict[str, Any]:
    """The MLM check's frontend, param groups (all live, clip 20) and a
    batch of 4 clips."""
    from transformer4sed_tpu_torch.frontend.mel import PasstFrontend
    from transformer4sed_tpu_torch.train.optim import GroupSpec, ParamGroupConfig

    wav = np.random.RandomState(4).randn(4, 119 * 320 + 1).astype(np.float32)
    spec = GroupSpec(lr=1e-3, weight_decay=1e-4)
    return dict(frontend=PasstFrontend(device="cpu"), batch={"wav": torch.from_numpy(wav)},
                pg=ParamGroupConfig(encoder=spec, decoder=spec, head=spec, backbone_depth=2))


def mlm_model():
    """The tiny PaSST_SED in MLM mode (block masking) with dropout, DropPath
    and token dropout at ``MLM_DROP`` in every backbone block."""
    from transformer4sed_tpu_torch.models.passt_sed import PaSST_SED
    from transformer4sed_tpu_torch.models.vit import Block
    from transformer4sed_tpu_torch.utils.weights import init_weights_

    model = PaSST_SED(class_num=3, embed_dim=32, decoder_dim=32, backbone_depth=2,
                      backbone_num_heads=4, decoder_num_heads=4, passt_feature_layer=2,
                      decoder="transformerXL", decoder_layer_num=1, decoder_pos_emd_len=120,
                      mlm=True, mlm_dict={"block_width": 4, "out_dim": 32}, device="cpu")
    model.backbone.drop_rate = MLM_DROP
    for blk in model.backbone.modules():
        if isinstance(blk, Block):
            blk.drop_path = blk.attn.proj_drop = blk.mlp.drop = MLM_DROP
    return init_weights_(model, seed=3)


def run_mlm_layout(mesh: Mesh, setup: Dict[str, Any]) -> Dict[str, Any]:
    """``MLM_STEPS`` MLM steps on ``mesh`` (the masker, dropout and DropPath
    drawing): the loss trajectory and the param norm after them."""
    from transformer4sed_tpu_torch.train.mlm import MLMTrainer

    trainer = MLMTrainer(mlm_model(), setup["frontend"], optim_cfg=setup["pg"])
    step = shard_train_step(trainer, mesh)
    losses = [float(step(setup["batch"], step_generator(3, s))["loss_mlm"])
              for s in range(MLM_STEPS)]
    return {"losses": losses, "p_norm": _norm(trainer.model.parameters(), mesh, frozenset())}


def step_generator(phase_seed: int, step: int) -> torch.Generator:
    """The draws of one step: the same on every rank and in every layout."""
    return torch.Generator().manual_seed(phase_seed * 1000 + step)


def bn_setup(n_devices: int) -> Dict[str, Any]:
    """Tiny HTSAT_CNN, frontend, supervised config and batch (2 rows per rank
    of the widest layout, 1-s clips) of the JAX harness's second phase."""
    from transformer4sed_tpu_torch.models.htsat import HTSATFrontend
    from transformer4sed_tpu_torch.recipes.audioset_strong import SupervisedConfig
    from transformer4sed_tpu_torch.train.optim import GroupSpec, ParamGroupConfig

    frontend = HTSATFrontend(n_mels=32, device="cpu")
    batch_size = 2 * n_devices
    rng = np.random.RandomState(2)
    wav = rng.randn(batch_size, 32000).astype(np.float32) * 0.1
    model = bn_model()
    model.eval()
    with torch.no_grad():
        t_out = int(model(frontend.normalize(frontend(torch.from_numpy(wav[:1])))).strong.shape[-1])
    labels = (rng.rand(batch_size, 3, t_out) > 0.8).astype(np.float32)
    adamw = GroupSpec(lr=1e-3, weight_decay=1e-4)  # optax.adamw(1e-3), no clipping
    pg = ParamGroupConfig(encoder=adamw, decoder=adamw, head=adamw, clip_grad=0.0)
    return dict(cfg=SupervisedConfig(), pg=pg, frontend=frontend,
                batch={"wav": torch.from_numpy(wav), "labels": torch.from_numpy(labels)})


def bn_model():
    from transformer4sed_tpu_torch.models.htsat_heads import HTSAT_CNN
    from transformer4sed_tpu_torch.utils.weights import init_weights_

    model = HTSAT_CNN(
        class_num=3, decoder_dim=32, num_heads=4, decoder="transformerXL", decoder_layer_num=1,
        decoder_pos_emd_len=256, htsat_config="tiny",
        htsat_kwargs=dict(spec_size=128, patch_size=4, patch_stride=(4, 4), num_classes=3,
                          embed_dim=32, depths=(1, 1, 2, 1), num_heads=(2, 2, 4, 4),
                          window_size=2, mel_bins=32),
        cnn_param=dict(nb_filters=[8, 8], pooling=[[1, 8], [1, 4]], normalization="batch",
                       activation="glu"),
        device="cpu")
    return init_weights_(model, seed=1)


# -- one layout --------------------------------------------------------------------------


def _norm(tensors, mesh, sharded_ids) -> float:
    from transformer4sed_tpu_torch.train.optim import tensor_norm

    return float(tensor_norm(tensors, mesh, sharded_ids))


def _opt_norm(optimizer, mesh, sharded_ids) -> float:
    """Norm of AdamW's moments (the float leaves of the optax state; the step
    counter is an int there)."""
    tensors, ids = [], set()
    for p, st in optimizer.state.items():
        for key in ("exp_avg", "exp_avg_sq"):
            tensors.append(st[key])
            if id(p) in sharded_ids:
                ids.add(id(st[key]))
    return _norm(tensors, mesh, ids)


def run_mean_teacher_layout(mesh: Mesh, use_tp: bool, setup: Dict[str, Any]) -> Dict[str, Any]:
    """``N_STEPS`` mean-teacher steps on ``mesh``: the loss trajectory and the
    student, teacher and optimizer-state norms after them."""
    from transformer4sed_tpu_torch.train.mean_teacher import MeanTeacherTrainer

    model = mean_teacher_model()
    if use_tp:
        shard_params(model, mesh)
    trainer = MeanTeacherTrainer(model, setup["frontend"], setup["cfg"], setup["pg"],
                                 setup["schedule"])
    step = shard_train_step(trainer, mesh)
    losses = []
    for s in range(N_STEPS):
        metrics = step(setup["batch"], step_generator(1, s))
        loss = float(metrics["loss_total"])
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite loss {loss} at step {s}")
        losses.append(loss)
    sharded = trainer.sharded
    if use_tp:
        qkv = trainer.student.backbone.blocks[0].attn.qkv
        if qkv.weight.shape[0] != 3 * 32 // mesh.model:
            raise AssertionError(f"qkv not sharded: {tuple(qkv.weight.shape)}")
    return {
        "losses": losses,
        "p_norm": _norm(trainer.student.parameters(), mesh, sharded),
        "t_norm": _norm(trainer.teacher.parameters(), mesh,
                        frozenset(id(p) for _, p in sharded_params(trainer.teacher).values())),
        "opt_norm": _opt_norm(trainer.optimizer, mesh, sharded),
    }


def _bn_stats(model) -> Dict[str, np.ndarray]:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def run_bn_layout(mesh: Mesh, use_tp: bool, setup: Dict[str, Any]) -> Dict[str, Any]:
    """``N_STEPS`` supervised HTSAT_CNN steps on ``mesh``: losses, the
    running-statistics norm after each step, the statistics after the first
    step and after the last."""
    from transformer4sed_tpu_torch.recipes.audioset_strong import SupervisedStep

    model = bn_model()
    if use_tp:
        shard_params(model, mesh)
    trainer = SupervisedStep(model, setup["frontend"], setup["cfg"], setup["pg"])
    step = shard_train_step(trainer, mesh)
    losses, bn_norms, stats1 = [], [], None
    for i in range(N_STEPS):
        metrics = step(setup["batch"], step_generator(2, i))
        loss = float(metrics["loss_class_strong"])
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite supervised loss at step {i}")
        losses.append(loss)
        stats = _bn_stats(trainer.model)
        bn_norms.append(float(np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64)))
                                          for v in stats.values()))))
        if i == 0:
            stats1 = stats
    return {"losses": losses, "bn_norms": bn_norms, "stats1": stats1,
            "stats": _bn_stats(trainer.model)}


def layouts(n_devices: int):
    """(name, data, model) of the layouts: one rank, dp=n, and dp(n/2) x tp2
    when n is even and above one."""
    out = [("1dev", 1, 1), (f"dp{n_devices}", n_devices, 1)]
    if n_devices % 2 == 0 and n_devices > 1:
        out.append((f"dp{n_devices // 2}xtp2", n_devices // 2, 2))
    return out


def _mesh(data: int, model: int) -> Mesh:
    """The layout's mesh over the first ranks; the one-rank layout runs on
    every rank at once (each its own mesh: the same work, and every process
    pays its first-call costs there, side by side) and rank 0's is read."""
    if data * model > 1:
        return make_mesh(data) if model == 1 else make_2d_mesh(data * model, model)
    own = [build_mesh(1, 1, first_rank=r) for r in range(dist.get_world_size())]
    return own[dist.get_rank()]


# -- the checks the CPU tests read ----------------------------------------------------


def _gather_heads(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.model)]
    dist.all_gather(parts, x.detach().contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim=1)


def check_tp_flash_attention(mesh: Mesh, shape=(2, 4, 37, 16)) -> Dict[str, np.ndarray]:
    """Head-sharded attention on ``mesh``'s model axis: full q, k, v and a
    cotangent from a seed, this rank's heads through
    :func:`tp_flash_attention` and backward, then the output and the three
    gradients gathered over the heads. Returns them with the inputs."""
    gen = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(shape, generator=gen) for _ in range(4))
    h = shape[1] // mesh.model
    sl = slice(mesh.model_index * h, (mesh.model_index + 1) * h)
    local = [x[:, sl].clone().requires_grad_() for x in (q, k, v)]
    out = tp_flash_attention(*local, mesh)
    (out * do[:, sl]).sum().backward()
    gathered = [_gather_heads(t, mesh) for t in (out, *(x.grad for x in local))]
    return {name: t.numpy() for name, t in zip(
        ("q", "k", "v", "do", "out", "dq", "dk", "dv"), (q, k, v, do, *gathered))}


def check_batch_norm(mesh: Mesh, rows: int = 256, channels: int = 16) -> Dict[str, np.ndarray]:
    """Global-batch BatchNorm statistics on inputs far from zero: every
    channel's |mean| / std is about 10, as in bn0's log-mel bins. Each rank
    normalises its equal share of one seeded [rows, channels] batch in
    training mode; returns the batch and the running mean and variance after
    one update (the batch statistics at momentum 1)."""
    from transformer4sed_tpu_torch.models.norm import RefBatchNorm

    rng = np.random.RandomState(7)
    std = rng.uniform(0.5, 2.0, channels)
    x = (rng.randn(rows, channels) * std
         + 10.0 * std * rng.choice([-1.0, 1.0], channels)).astype(np.float32)
    share = rows // mesh.data
    bn = RefBatchNorm(channels, momentum=1.0)
    bn.mesh = mesh
    bn.train()(torch.from_numpy(x[mesh.data_index * share:(mesh.data_index + 1) * share]))
    return {"x": x, "mean": bn.running_mean.numpy().copy(), "var": bn.running_var.numpy().copy()}


def check_state_dict(mesh: Mesh) -> Dict[str, Any]:
    """The tiny PaSST_SED's state dict before :func:`shard_params` against
    :func:`gather_state_dict` after it, key by key, and the sharded names."""
    model = mean_teacher_model()
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    shard_params(model, mesh)
    after = gather_state_dict(model, mesh)
    return {
        "keys_equal": sorted(before) == sorted(after),
        "mismatched": sorted(k for k in before if k not in after
                             or before[k].shape != after[k].shape
                             or not torch.equal(before[k], after[k])),
        "sharded": sorted(sharded_params(model)),
    }


# -- the ranks' body, the comparison, the entry point ----------------------------------


def _gather_to_rank0(result):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, result)
    return out[0]


def dryrun_rank(rank: int, world: int, sizes: Sequence[int] = (), checks: bool = False
                ) -> Optional[Dict[int, Dict[str, Any]]]:
    """One rank of the dry runs over the first ``n`` ranks, for each ``n`` in
    ``sizes`` (default: the world): both phases in every layout (and, with
    ``checks``, the head-parallel attention and the state-dict round trip on
    the widest layout, the BatchNorm statistics over dp=n and, at n = 2, the
    MLM step on one rank and over dp2). Ranks past
    ``n`` take part in building the groups only. Rank 0 returns the reports,
    by ``n``."""
    reports: Dict[int, Dict[str, Any]] = {}
    for n in sizes or (world,):
        report: Dict[str, Any] = {"layouts": layouts(n)}
        for phase, setup_fn, run in (
                ("mean_teacher", mean_teacher_setup, run_mean_teacher_layout),
                ("bn", bn_setup, run_bn_layout)):
            setup = setup_fn(n)
            report[phase] = {}
            for name, data, model in layouts(n):
                mesh = _mesh(data, model)
                res = run(mesh, model > 1, setup) if mesh.member else None
                report[phase][name] = _gather_to_rank0(res)
        if checks:
            name, data, model = layouts(n)[-1]
            mesh = _mesh(data, model)
            report["tp_flash"] = _gather_to_rank0(
                check_tp_flash_attention(mesh) if mesh.member else None)
            report["state_dict"] = _gather_to_rank0(
                check_state_dict(mesh) if mesh.member else None)
            name, data, model = layouts(n)[1]  # dp over every rank
            mesh = _mesh(data, model)
            report["batch_norm"] = _gather_to_rank0(
                check_batch_norm(mesh) if mesh.member else None)
            if n == 2:  # the MLM step on one rank and over dp2
                setup = mlm_setup()
                report["mlm"] = {}
                for name, data, model in layouts(n)[:2]:
                    mesh = _mesh(data, model)
                    report["mlm"][name] = _gather_to_rank0(
                        run_mlm_layout(mesh, setup) if mesh.member else None)
        reports[n] = report
    return reports if rank == 0 else None


def compare_layouts(report: Dict[str, Any]) -> List[str]:
    """Hold every layout of both phases to the one-rank layout at the JAX
    harness's tolerances (raises AssertionError); returns one summary line
    per phase with the trajectories."""
    mt = report["mean_teacher"]
    base = mt["1dev"]
    for name, r in mt.items():
        np.testing.assert_allclose(
            r["losses"], base["losses"], rtol=LOSS_RTOL, atol=LOSS_ATOL,
            err_msg=f"{name}: cross-layout loss trajectory diverged")
        for k in ("p_norm", "t_norm", "opt_norm"):
            np.testing.assert_allclose(
                r[k], base[k], rtol=NORM_RTOL,
                err_msg=f"{name}: {k} diverged after {N_STEPS} steps")
    bn = report["bn"]
    bbase = bn["1dev"]
    for name, r in bn.items():
        np.testing.assert_allclose(r["losses"], bbase["losses"], rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=f"BN phase {name}: loss trajectory diverged")
        np.testing.assert_allclose(
            r["bn_norms"], bbase["bn_norms"], rtol=BN_NORM_RTOL,
            err_msg=f"BN phase {name}: running-statistics norms diverged (not global-batch)")
        if r["stats1"].keys() != bbase["stats1"].keys() or r["stats"].keys() != bbase["stats"].keys():
            raise AssertionError(f"BN phase {name}: statistics keys differ")
        for k, val in r["stats1"].items():
            np.testing.assert_allclose(
                val, bbase["stats1"][k], rtol=STAT1_RTOL, atol=STAT1_ATOL,
                err_msg=f"BN phase {name}: step-1 running stat {k} diverged (not global-batch)")
        for k, val in r["stats"].items():
            rms = float(np.sqrt(np.mean(np.square(bbase["stats"][k])))) or 1.0
            np.testing.assert_allclose(
                val, bbase["stats"][k], rtol=0.0, atol=max(FINAL_STAT_RMS * rms, 1e-6),
                err_msg=f"BN phase {name}: final running stat {k} diverged")
    return [
        "mean teacher (PaSST_SED): " + ", ".join(
            f"{k}: losses={['%.6f' % v for v in r['losses']]} p={r['p_norm']:.6f} "
            f"t={r['t_norm']:.6f} o={r['opt_norm']:.6f}" for k, r in mt.items()),
        "BN supervised (HTSAT_CNN): " + ", ".join(
            f"{k}: losses={['%.6f' % v for v in r['losses']]} "
            f"bn_norms={['%.6f' % v for v in r['bn_norms']]}" for k, r in bn.items()),
    ]


def run_layouts(sizes: Sequence[int], checks: bool = False,
                timeout_s: float = 300.0) -> Dict[int, Dict[str, Any]]:
    """Launch ``max(sizes)`` gloo ranks on the CPU once and run the dry run
    over the first ``n`` of them for each ``n`` in ``sizes``; returns the
    reports by ``n``."""
    return launch(max(sizes), dryrun_rank, (tuple(sizes), checks), timeout_s=timeout_s)[0]


def dryrun_multichip(n_devices: int, backend: str = "gloo", timeout_s: float = 300.0) -> Dict:
    """Run both phases over ``n_devices`` ranks (gloo on the CPU; the only
    backend a one-card machine can give several ranks) and hold every layout
    to the one-rank one; prints the trajectories and returns the report."""
    if backend != "gloo":
        raise ValueError(f"the dry run launches CPU ranks: backend must be gloo, got {backend!r}")
    report = run_layouts((n_devices,), timeout_s=timeout_s)[n_devices]
    print_report(n_devices, report)
    return report


def print_report(n_devices: int, report: Dict[str, Any]) -> None:
    """:func:`compare_layouts` on the report of a dry run over ``n_devices``
    ranks, then the trajectories, one line per phase."""
    lines = compare_layouts(report)
    shape = dict(zip(("data", "model"), report["layouts"][-1][1:]))
    print(f"dryrun_multichip({n_devices}) OK: mesh={shape} {N_STEPS}-step trajectories",
          flush=True)
    for line in lines:
        print("  " + line, flush=True)


if __name__ == "__main__":
    for n in (2, 4):
        dryrun_multichip(n)
