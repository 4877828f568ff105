"""The port's multi-rank layouts and its head-major flash attention, held
against the JAX package on the CPU.

  * The head-major plain versions (rows 3, 5 and 6 of the kernel table)
    against ``_flash_forward``, ``_flash_forward_lse`` and ``_flash_backward``
    in interpret mode, and ``flash_attention_nhd`` at head dim 32 against the
    JAX one.
  * What ``shard_params`` shards against what the JAX ``partition_specs``
    shards, and the per-process batch and eval splits against the JAX ones.
  * One launch of four gloo ranks on localhost, started when the module
    starts and read by the tests that need it: ``dryrun_multichip``'s two
    phases over 2 ranks (1 / dp2 / dp1 x tp2) and over 4 (1 / dp4 /
    dp2 x tp2) at the JAX harness's tolerances, head-parallel attention
    gathered over the heads, the state dict gathered after ``shard_params``,
    global-batch BatchNorm statistics against the JAX ``RefBatchNorm``, the
    one-rank trajectory against the port's plain ``MeanTeacherTrainer``, and
    the MLM step over dp2 against one rank.

Inputs come from numpy or torch with a seed; everything is float32.
"""

import concurrent.futures
import importlib

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer4sed_tpu.models.norm import RefBatchNorm as JaxRefBatchNorm
from transformer4sed_tpu.parallel import multihost as jax_multihost
from transformer4sed_tpu.parallel.partition import partition_specs as jax_partition_specs
from transformer4sed_tpu.utils.torch_import import convert_torch_checkpoint
from transformer4sed_tpu_torch.kernels import _build
from transformer4sed_tpu_torch.kernels import flash_attention as port_flash
from transformer4sed_tpu_torch.models.cnn import BatchRows, draw_dropout
from transformer4sed_tpu_torch.models.mlm import MLMMasker
from transformer4sed_tpu_torch.models.vit import Block
from transformer4sed_tpu_torch.parallel import Mesh, device_prefetch, dryrun, multihost, put_batch
from transformer4sed_tpu_torch.parallel.mesh import shard_train_step
from transformer4sed_tpu_torch.parallel.partition import partition_specs
from transformer4sed_tpu_torch.train.mean_teacher import MeanTeacherTrainer
from transformer4sed_tpu_torch.utils.weights import jax_params_to_state_dict
from tests.torch_port_jax import interpret0, jit0

jax_flash = importlib.import_module("transformer4sed_tpu.kernels.flash_attention")

# f32 on both sides, the sums in another order (a blocked online softmax in
# interpret mode, one matmul here): 1e-5 relative, and 1e-6 absolute for the
# entries near zero (a few f32 ulps of the O(1) values beside them)
RTOL, ATOL = 1e-5, 1e-6
# the gradients sum T products of O(1) terms: a few ulps of that sum
ATOL_GRAD = 1e-5
# the one-rank layout runs the plain trainer's code with one-rank collectives
RTOL_SAME_CODE = 1e-6
# the MLM step over dp2 against one rank: the same draws and math, the loss's
# and the gradients' sums split over two ranks (a few f32 ulps a step)
MLM_DP_RTOL = 1e-5
# BatchNorm statistics, two-pass f32 on both sides, the sums split over ranks
# here: a few ulps. On inputs with |mean| / std near 10 the one-pass
# E[x^2] - E[x]^2 misses the variance by 1.7e-5 to 1.9e-5 relative (dp2, dp4)
BN_STAT_RTOL = 2e-6


@pytest.fixture(scope="module", autouse=True)
def ranks():
    """Four gloo ranks, launched once when the module starts: the dry runs
    over the first 2 and over all 4, with the extra checks. Tests read the
    reports by rank count; the launcher's deadline bounds a hung collective."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(dryrun.run_layouts, (2, 4), True, 240.0)
    yield future
    pool.shutdown(wait=True)
    torch.set_num_threads(old)


# -- rows 3, 5 and 6: the head-major plain versions against Pallas -------------------


def _hm(b, h, t, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, t, d).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("t", [37, 130])
@pytest.mark.parametrize("h,d", [(4, 16), (2, 32), (2, 64)])
def test_head_major_plain_versions_match_pallas(t, h, d):
    """Plain forward, LSE forward and backward against ``_flash_forward``,
    ``_flash_forward_lse`` and ``_flash_backward`` in interpret mode, ragged
    T, the backward fed the JAX forward's own o and lse."""
    q, k, v, g = _hm(2, h, t, d, seed=t + d)
    scale = d ** -0.5
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))

    def kernels(q_, k_, v_, g_, interpret):  # the three kernels in one program: one compile
        ref_ = jax_flash._flash_forward(q_, k_, v_, sm_scale=scale, interpret=interpret)
        o_, lse_ = jax_flash._flash_forward_lse(q_, k_, v_, sm_scale=scale, block_q=128,
                                                interpret=interpret)
        return ref_, o_, lse_, jax_flash._flash_backward(q_, k_, v_, o_, lse_, g_, sm_scale=scale,
                                                         block_q=128, interpret=interpret)

    ref, o, lse, grads = interpret0(kernels, jq, jk, jv, jg)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    np.testing.assert_allclose(port_flash.flash_attention_reference(tq, tk, tv).numpy(),
                               np.asarray(ref), rtol=RTOL, atol=ATOL)
    ours_o, ours_lse = port_flash.flash_attention_lse(tq, tk, tv, scale)
    np.testing.assert_allclose(ours_o.numpy(), np.asarray(o), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours_lse.numpy(), np.asarray(lse)[..., :t], rtol=RTOL, atol=ATOL)
    to = torch.from_numpy(np.array(o))
    tlse = torch.from_numpy(np.array(lse)[..., :t])
    ours = port_flash.flash_attention_backward(tq, tk, tv, to, tlse, tg, scale)
    for name, a, want in zip(("dq", "dk", "dv"), ours, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL_GRAD,
                                   err_msg=name)


def test_flash_attention_nhd_at_head_dim_32_takes_the_head_major_family():
    """At head dim 32, ``flash_attention_nhd`` matches the JAX one (forward
    and gradients) through strided head-major views, and launches nothing
    on the CPU."""
    b, t, h, d = 2, 37, 4, 32
    qkv = np.random.RandomState(32).randn(b, t, 3 * h * d).astype(np.float32)
    g = np.random.RandomState(33).randn(b, t, h * d).astype(np.float32)
    c = h * d

    def jax_loss(x):
        out = jax_flash.flash_attention_nhd(x[..., :c], x[..., c:2 * c], x[..., 2 * c:], h)
        return jnp.sum(out * g), out

    (_, want), want_grad = jit0(jax.value_and_grad(jax_loss, has_aux=True))(jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_()
    before = [f.launches for f in (port_flash.flash_attention, port_flash.flash_attention_lse,
                                   port_flash.flash_attention_nhd)]
    out = port_flash.flash_attention_nhd(x[..., :c], x[..., c:2 * c], x[..., 2 * c:], h)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=ATOL_GRAD)
    assert before == [f.launches for f in (port_flash.flash_attention,
                                           port_flash.flash_attention_lse,
                                           port_flash.flash_attention_nhd)]
    k = port_flash._split_heads(x.detach()[..., c:2 * c], h)
    assert k.data_ptr() == x.data_ptr() + c * 4 and k.stride() == (t * 3 * c, d, 3 * c, 1)


def test_head_major_kernel_sources_name_their_tpu_kernels():
    for name, tpu_fns in (("flash_attention_hm", ("_flash_forward", "_flash_forward_lse")),
                          ("flash_attention_hm_bwd", ("_flash_backward",))):
        src = (_build.CSRC_DIR / f"{name}.cu").read_text()
        assert all(f in src for f in tpu_fns) and "What bounds it" in src and 'extern "C"' in src
    with pytest.raises(ValueError, match="no kernel for device"):
        port_flash._check_hm("flash_attention", *(torch.zeros(1, 2, 8, 32) for _ in range(3)))


# -- what the rules shard, and the per-process splits ---------------------------------

TINY = dict(class_num=3, embed_dim=32, decoder_dim=32, backbone_depth=2, backbone_num_heads=4,
            decoder_num_heads=4, at_adapter_heads=4, passt_feature_layer=2,
            decoder="transformerXL", decoder_layer_num=1, decoder_pos_emd_len=120,
            at_adapter=True)


def _jax_sharded_names(kwargs):
    """Port names of the params the JAX ``partition_specs`` shards on the
    PaSST_SED of ``kwargs``, by ``load_jax_params``' name mapping."""
    from transformer4sed_tpu_torch.models.passt_sed import PaSST_SED

    port = PaSST_SED(**kwargs, device="cpu")
    # the JAX model's param tree, by the JAX package's own checkpoint import
    tree, _ = convert_torch_checkpoint({k: v.numpy() for k, v in port.state_dict().items()},
                                       "PaSST_SED", init_kwargs=kwargs)
    specs = flax.traverse_util.flatten_dict(jax_partition_specs(tree))
    flat = flax.traverse_util.flatten_dict(tree)
    jax_sharded = set()
    for path, spec in specs.items():
        if tuple(spec):  # one leaf at a time, through the same name mapping
            jax_sharded |= set(jax_params_to_state_dict(
                flax.traverse_util.unflatten_dict({path: flat[path]})))
    assert jax_sharded and jax_sharded <= set(jax_params_to_state_dict(tree)) == set(
        port.state_dict())
    return port, jax_sharded


def test_port_rules_shard_what_the_jax_rules_shard():
    """On a tiny PaSST_SED with the AT adapter and the attention f-pool, the
    port's rules mark exactly the params the JAX ``partition_specs`` shards;
    torch's MultiheadAttention names (``in_proj_weight``, ``out_proj``) in
    those two modules are not matched."""
    # the f-pool attention has 6 heads: a width they divide
    port, jax_sharded = _jax_sharded_names({**TINY, "embed_dim": 48, "decoder_dim": 48,
                                             "f_pool": "attention"})
    assert {n for n, s in partition_specs(port).items() if s} == jax_sharded
    assert any("f_pool_module" in n for n in port.state_dict())
    assert not any("frequency_att" in n for n in jax_sharded)


def test_batch_and_eval_splits_match_jax():
    from transformer4sed_tpu.data.sampler import ConcatBatchSampler, RandomSampler

    batch = list(range(12))
    for pc in (1, 2, 4):
        for pi in range(pc):
            assert multihost.shard_batch_indices(batch, pi, pc) == \
                jax_multihost.shard_batch_indices(batch, pi, pc)
            assert multihost.shard_eval_items(batch[:11], pi, pc) == \
                jax_multihost.shard_eval_items(batch[:11], pi, pc)
    with pytest.raises(ValueError, match="not divisible"):
        multihost.shard_batch_indices(list(range(10)), 0, 4)

    def base():
        return ConcatBatchSampler([RandomSampler(8, 0), RandomSampler(8, 1)], [2, 2])

    for pi in range(2):
        ours = multihost.ProcessShardedBatchSampler(base(), pi=pi, pc=2)
        theirs = jax_multihost.ProcessShardedBatchSampler(base(), pi=pi, pc=2)
        assert len(ours) == len(theirs) and list(ours) == list(theirs)
    # one process: no process group, identity splits and gathers
    assert multihost.process_count() == 1 and multihost.is_primary()
    assert multihost.gather_objects({"a": 1}) == [{"a": 1}]
    assert multihost.gather_clip_scores({"x": 2}) == {"x": 2}
    assert multihost.maybe_initialize() is False


def test_batch_rows_give_every_rank_an_equal_share_of_each_subset():
    """``Mesh.batch_rows`` on rank (data 1 of 2) of a [strong 4 | weak 2 |
    unlabeled 2] batch, ``put_batch`` keeping the rank's contiguous share, and
    ``device_prefetch`` keeping order and rows; the mesh is built by hand (the
    row selection needs no process group)."""
    mesh = Mesh(data=2, model=1, member=True, data_index=1, model_index=0, world_group=None,
                data_group=None, model_group=None, device=torch.device("cpu"))
    assert mesh.batch_rows((4, 2, 2)).tolist() == [2, 3, 5, 7]
    batch = {"wav": torch.arange(8.0)[:, None].expand(8, 3), "labels": [np.arange(8)]}
    got = put_batch(batch, mesh)
    assert got["wav"][:, 0].tolist() == [4.0, 5.0, 6.0, 7.0]
    assert got["labels"][0].tolist() == [4, 5, 6, 7]
    assert mesh.batch_rows((8,)).tolist() == [4, 5, 6, 7]
    assert mesh.local_sizes((4, 2, 2)) == [2, 1, 1]
    with pytest.raises(ValueError, match="does not split"):
        mesh.batch_rows((3,))
    stream = [torch.full((4, 2), float(i)) for i in range(5)]
    out = list(device_prefetch(iter(stream), mesh, size=2))
    assert [x[:, 0].tolist() for x in out] == [[float(i)] * 2 for i in range(5)]


def test_dropout_masks_follow_the_global_batch_only_where_drawn_for_it():
    """A CNN dropout mask drawn with this rank's ``BatchRows`` is those rows
    of the global batch's mask; a mask that does not lead with those rows
    raises; a ViT block's dropout and DropPath and the MLM masker's draws
    given the rows are those rows of the global batch's draws (the masker's
    random tokens index the global batch); ``shard_train_step`` takes a
    model with such draws over one data rank and over two."""
    rows = BatchRows(torch.tensor([2, 3, 5, 7]), 8)
    whole = draw_dropout(torch.Generator().manual_seed(0), (8, 5, 3), 0.5, "cpu")
    part = draw_dropout(torch.Generator().manual_seed(0), (4, 5, 3), 0.5, "cpu", rows)
    assert torch.equal(part, whole[rows.index])
    with pytest.raises(ValueError, match="rows of the global batch"):
        draw_dropout(torch.Generator().manual_seed(0), (5, 4, 3), 0.5, "cpu", rows)
    block = Block(8, 2, drop=0.3, drop_path=0.5).train()
    x = torch.randn(8, 6, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full = block(x, True, torch.Generator().manual_seed(2))
        mine = block(x[rows.index], True, torch.Generator().manual_seed(2), rows)
    assert torch.equal(mine, full[rows.index])
    masker = MLMMasker(block_width=2)
    full_draws = masker.draw(torch.Generator().manual_seed(3), 8, 6)
    my_draws = masker.draw(torch.Generator().manual_seed(3), 4, 6, rows)
    for a, b in zip((full_draws.noise, full_draws.probs, full_draws.rand_src),
                    (my_draws.noise, my_draws.probs, my_draws.rand_src)):
        assert torch.equal(b, a[rows.index])

    class Trainer:
        def __init__(self, model):
            self.model, self.mesh = model, None

        def models(self):
            return (self.model,)

        def step(self):
            pass

    def mesh(data):
        return Mesh(data=data, model=1, member=True, data_index=0, model_index=0,
                    world_group=None, data_group=None, model_group=None,
                    device=torch.device("cpu"))

    for data in (1, 2):
        trainer = Trainer(block)
        assert shard_train_step(trainer, mesh(data)) == trainer.step and trainer.mesh.data == data


# -- the gloo ranks ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_layouts_agree_at_the_jax_tolerances(ranks, n):
    """Both phases of ``dryrun_multichip(n)``: every layout's losses and
    norms (mean teacher) and BatchNorm statistics (HTSAT_CNN) against the
    one-rank layout."""
    report = ranks.result()[n]
    names = [name for name, _, _ in report["layouts"]]
    assert names == ["1dev", f"dp{n}", f"dp{n // 2}xtp2"]
    assert set(report["mean_teacher"]) == set(report["bn"]) == set(names)
    dryrun.compare_layouts(report)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_flash_attention_gathers_to_flash_attention(ranks, n):
    """Each rank's heads through ``tp_flash_attention`` and backward, gathered
    over the ``model`` group: the output and the three gradients equal
    ``flash_attention`` on all heads."""
    r = ranks.result()[n]["tp_flash"]
    q, k, v = (torch.from_numpy(r[x]).requires_grad_() for x in ("q", "k", "v"))
    out = port_flash.flash_attention(q, k, v)
    (out * torch.from_numpy(r["do"])).sum().backward()
    for name, want in (("out", out.detach()), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        np.testing.assert_allclose(r[name], want.numpy(), rtol=RTOL, atol=ATOL_GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_gathered_state_dict_equals_the_unsharded_one(ranks, n):
    """After ``shard_params`` on the dry run's tiny PaSST_SED, the shards hold
    exactly the params the JAX ``partition_specs`` shards, and the state dict
    gathered over the ``model`` group equals the unsharded one, key by key."""
    r = ranks.result()[n]["state_dict"]
    assert set(r["sharded"]) == _jax_sharded_names(TINY)[1]
    assert r["keys_equal"] and r["mismatched"] == []


def test_one_rank_trajectory_equals_the_plain_trainer(ranks):
    """The one-rank layout (the parallel step over one gloo rank) against
    the port's plain ``MeanTeacherTrainer`` on the same model, batch and
    draws; that trainer is held against JAX in test_torch_port_train.py."""
    setup = dryrun.mean_teacher_setup(2)
    trainer = MeanTeacherTrainer(dryrun.mean_teacher_model(), setup["frontend"], setup["cfg"],
                                 setup["pg"], setup["schedule"])
    losses = [float(trainer.step(setup["batch"], dryrun.step_generator(1, s))["loss_total"])
              for s in range(dryrun.N_STEPS)]
    params = torch.cat([p.detach().reshape(-1) for p in trainer.student.parameters()])
    got = ranks.result()[2]["mean_teacher"]["1dev"]
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL_SAME_CODE)
    np.testing.assert_allclose(got["p_norm"], float(params.norm()), rtol=RTOL_SAME_CODE)


def test_mlm_step_over_two_data_ranks_equals_one_rank(ranks):
    """The MLM step with the masker, dropout, DropPath and token dropout
    drawing (``dryrun.mlm_model``): over dp2 (each rank its rows, the draws
    for the global batch, the masker's random tokens gathered from both
    ranks) against one rank on the same global batch and generators, two
    steps: losses and the param norm after them."""
    r = ranks.result()[2]["mlm"]
    one, dp2 = r["1dev"], r["dp2"]
    np.testing.assert_allclose(dp2["losses"], one["losses"], rtol=MLM_DP_RTOL)
    np.testing.assert_allclose(dp2["p_norm"], one["p_norm"], rtol=MLM_DP_RTOL)
    assert one["losses"][0] != one["losses"][1]


@pytest.mark.parametrize("n", [2, 4])
def test_global_batch_norm_statistics_match_jax_far_from_zero(ranks, n):
    """RefBatchNorm over dp=n ranks, each with its share of a batch whose
    channels have |mean| / std near 10: the global mean and biased variance
    (the running statistics at momentum 1, the variance made unbiased)
    against the JAX ``RefBatchNorm``'s two-pass batch statistics."""
    r = ranks.result()[n]["batch_norm"]
    x = r["x"]
    _, state = JaxRefBatchNorm(use_running_average=False, momentum=1.0).apply(
        {"params": {"scale": jnp.ones(x.shape[1]), "bias": jnp.zeros(x.shape[1])},
         "batch_stats": {"mean": jnp.zeros(x.shape[1]), "var": jnp.ones(x.shape[1])}},
        jnp.asarray(x), mutable=["batch_stats"])
    np.testing.assert_allclose(r["mean"], np.asarray(state["batch_stats"]["mean"]),
                               rtol=BN_STAT_RTOL)
    np.testing.assert_allclose(r["var"], np.asarray(state["batch_stats"]["var"]),
                               rtol=BN_STAT_RTOL)
