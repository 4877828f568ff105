"""The port's attention kernels, held against the JAX package's Pallas
kernels run in interpret mode on the CPU.

On the CPU the port's wrappers take their plain PyTorch versions (the
CUDA kernels run only on the card; ``chip_smoke.py`` holds them against
the same plain versions there). Inputs come from numpy with a seed and
are compared in float32. The slowest Pallas programs (the XL LSE forward
and backward, the head-major XL family, the window kernels) run in four
worker processes started with the module (``tests/torch_port_kernels_jax.py``,
which imports no torch), while the tests before them run.
"""

import concurrent.futures
import functools
import importlib
import multiprocessing
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer4sed_tpu.kernels.flash_attention import _flash_nhd_forward
from transformer4sed_tpu.kernels.xl_attention import _xl_nhd_forward
from transformer4sed_tpu_torch.kernels import flash_attention as port_flash
from transformer4sed_tpu_torch.kernels import window_attention as port_window
from transformer4sed_tpu_torch.kernels import xl_attention as port_xl
from tests import torch_port_kernels_jax as kernels_jax
from tests.torch_port_jax import interpret0, jit0
from tests.torch_port_kernels_jax import HM_CASES, WINDOW_CASES, XL_LSE_CASES, window_cotangent
from tests.torch_port_kernels_jax import hm_data as _hm_data
from tests.torch_port_kernels_jax import window_data as _window_data
from tests.torch_port_kernels_jax import xl_data as _xl_data

# the modules themselves (the package re-exports functions of the same names)
jax_flash = importlib.import_module("transformer4sed_tpu.kernels.flash_attention")
jax_xl = importlib.import_module("transformer4sed_tpu.kernels.xl_attention")
jax_window = importlib.import_module("transformer4sed_tpu.kernels.window_attention")

# f32 on both sides; the sums run in another order (blocked online
# softmax in the Pallas kernel, one matmul here): a few f32 ulps of O(1)
ATOL = 3e-5
# the JAX package's own bounds for the same kernels in interpret mode
# (tests/test_kernels.py:560-600 and :719-732): the log-sum-exp, the flash
# cotangents, and the XL cotangents, whose dP and bias gradients sum over
# batch and time
ATOL_LSE = 2e-5
ATOL_FLASH_GRAD = 3e-5
ATOL_XL_GRAD = 1e-4
# the window kernels in interpret mode against their XLA reference
# (tests/test_kernels.py:365 and :437): forward, and the cotangents, whose
# dbias and dshift sum over windows and heads
ATOL_WINDOW = 2e-5
ATOL_WINDOW_GRAD = 3e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module", autouse=True)
def jax_side():
    """The slowest Pallas programs in four worker processes started with the
    module (their tracing would hold this process's GIL): the XL LSE forward
    and backward, the head-major XL family in two shares, the window
    kernels."""
    pool = concurrent.futures.ProcessPoolExecutor(4, mp_context=multiprocessing.get_context(
        "spawn"))
    futures = {"xl": pool.submit(kernels_jax.xl_lse_backward),
               "hm": [pool.submit(kernels_jax.head_major, HM_CASES[:3]),
                      pool.submit(kernels_jax.head_major, HM_CASES[3:])],
               "window": pool.submit(kernels_jax.window)}
    yield futures
    pool.shutdown(wait=True)


def _qkv(b, t, c, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, c).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("t", [64, 190])
@pytest.mark.parametrize("h,d", [(4, 16), (2, 64)])
def test_flash_plain_matches_pallas(t, h, d):
    q, k, v = _qkv(2, t, h * d, seed=t + d)
    scale = d ** -0.5
    ref = interpret0(_flash_nhd_forward, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     heads=h, sm_scale=scale)
    ours = port_flash.flash_attention_nhd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h, scale)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("band", [None, (6, 10)])
def test_xl_plain_matches_pallas(band):
    # four heads unbanded, so that heads beyond the second are held too; the
    # banded case at two (a band a head), since the Pallas body unrolls its
    # heads as it traces
    b, t, h, d = 2, 200, 4 if band is None else len(band), 32
    arrays = _xl_data(b, t, h, d)
    scale = d ** -0.5
    ref = interpret0(_xl_nhd_forward, *map(jnp.asarray, arrays), num_heads=h, sm_scale=scale,
                     block_q=128, band_widths=band)
    ours = port_xl.xl_attention_nhd_reference(*map(torch.from_numpy, arrays), h, scale, band)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


def test_rel_shift_is_the_transformer_xl_shift():
    t = 7
    x = torch.arange(3 * t * (2 * t - 1), dtype=torch.float32).reshape(3, t, 2 * t - 1)
    out = port_xl.rel_shift(x)
    i, j = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
    np.testing.assert_array_equal(out.numpy(), x.numpy()[:, i, (t - 1) - i + j])


def test_cpu_wrappers_take_the_plain_versions_and_launch_nothing():
    q, k, v, bu, bv, p = map(torch.from_numpy, _xl_data(1, 40, 2, 16, seed=3))
    counted = (port_flash.flash_attention_nhd, port_xl.flash_xl_attention_nhd,
               port_flash.flash_bwd_prepass, port_flash.flash_bwd_postpass,
               port_xl.flash_xl_bwd_prepass, port_xl.flash_xl_bwd_postpass)
    before = [f.launches for f in counted]
    torch.testing.assert_close(port_flash.flash_attention_nhd(q, k, v, 2),
                               port_flash.flash_attention_nhd_reference(q, k, v, 2))
    torch.testing.assert_close(
        port_xl.flash_xl_attention_nhd(q, k, v, bu, bv, p, 2, 0.25, (8, 12)),
        port_xl.xl_attention_nhd_reference(q, k, v, bu, bv, p, 2, 0.25, (8, 12)))
    # the flash backwards' passes on [B, H, T, d] views: T = 40 pads to 64 rows
    o, do = (port_flash._split_heads(x, 2) for x in (q, k))
    lse = torch.from_numpy(np.random.RandomState(4).randn(1, 2, 40).astype(np.float32))
    lse[0, 1, 7] = -np.inf
    side, work = port_flash.flash_bwd_prepass(o, do, lse)
    assert side.shape == (1, 2, 64, 2) and work.shape == (1, 2, 64, 16) and not work.any()
    torch.testing.assert_close(side[..., :40, 1], (o * do).sum(-1))
    torch.testing.assert_close(side[..., :40, 0][lse.isfinite()],
                               lse[lse.isfinite()] * port_flash.LOG2E)
    assert side[0, 1, 7, 0] == np.inf and (side[..., 40:, 0] == np.inf).all()
    assert not side[..., 40:, 1].any()
    work = torch.from_numpy(np.random.RandomState(5).randn(1, 2, 64, 16).astype(np.float32))
    out = port_flash.flash_bwd_postpass(work, torch.empty(1, 2, 40, 16), 0.25)
    torch.testing.assert_close(out, work[:, :, :40] * 0.25)
    # the XL backwards' passes: the same side rows, both workspaces zeroed
    xside, dq_acc, dp_acc, qu, qv = port_xl.flash_xl_bwd_prepass(o, do, lse, 32)
    torch.testing.assert_close(xside, side)
    assert qu is None and qv is None and dq_acc.shape == (1, 2, 64, 32)
    assert dp_acc.shape == (2, 336, 16)
    assert not dq_acc.any() and not dp_acc.any()
    dq, dqv, dp = torch.empty(1, 2, 40, 16), torch.empty(1, 2, 40, 16), torch.empty(2, 79, 16)
    port_xl.flash_xl_bwd_postpass(dq_acc + 1, dp_acc + 2, None, 0.25, dq, dqv, dp)
    assert (dq == 0.25).all() and (dqv == 0.25).all() and (dp == 0.5).all()
    assert [f.launches for f in counted] == before


def test_kernel_sources_name_their_tpu_kernels():
    """Each CUDA source carries the note of what it replaces."""
    from transformer4sed_tpu_torch.kernels import _build

    for name, tpu_fns in (("flash_attention", ("_flash_nhd_forward", "_flash_nhd_forward_lse")),
                          ("flash_attention_bwd", ("_flash_nhd_backward",)),
                          ("xl_attention", ("_xl_nhd_forward", "_xl_nhd_forward_lse")),
                          ("xl_attention_bwd", ("_xl_nhd_backward", "_xl_backward")),
                          ("xl_attention_hm", ("_xl_forward", "_xl_forward_lse")),
                          ("window_attention", ("_window_forward",)),
                          ("window_attention_bwd", ("_window_backward",)),
                          ("flash_attention_bias", ("_flash_bias_forward",)),
                          ("flash_variants", ("flash_a",))):
        src = (_build.CSRC_DIR / f"{name}.cu").read_text()
        assert all(f in src for f in tpu_fns) and "What bounds it" in src and 'extern "C"' in src
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC_DIR.glob("*.cu")}
    # the device bodies that the entry points share name the kernels they replace too
    for name, tpu_fns in (("xl_fwd", ("_xl_nhd_forward", "_xl_nhd_forward_lse", "_xl_forward",
                                      "_xl_forward_lse")),):
        src = (_build.CSRC_DIR / f"{name}.cuh").read_text()
        assert all(f in src for f in tpu_fns) and "What bounds it" in src
    # the four XL forwards share xl_fwd.cuh: xl.cuh's mma.sync body is gone, and
    # no body of the port holds an mma.sync product or its helpers
    assert not (_build.CSRC_DIR / "xl.cuh").exists()
    users = {p.stem for p in _build.CSRC_DIR.glob("*.cu*") if '"xl.cuh"' in p.read_text()}
    assert users == set()
    gone = ("mma_16816(", "mma.sync", "ld_b32", "load_rows")
    mma_sync = {p.name for p in _build.CSRC_DIR.glob("*.cu*")
                if any(w in p.read_text() for w in gone)}
    assert mma_sync == set()


@pytest.mark.parametrize("header,enum,table,name", [
    ("xl_fwd", "XfFault", "XF_FAULTS", name) for name in port_xl.XF_FAULTS] + [
    ("xl_bwd", "XbFault", "XB_FAULTS", name) for name in port_xl.XB_FAULTS] + [
    ("window", "WaFault", "WA_FAULTS", name) for name in port_window.WA_FAULTS])
def test_planted_fault_numbers_match_the_kernel_enums(header, enum, table, name):
    """The number a wrapper passes for each planted fault is that fault's
    value in the device body's enum, so ``chip_smoke.py`` plants the fault it
    names; 0 is no fault."""
    src = (port_xl._build.CSRC_DIR / f"{header}.cuh").read_text()
    body = re.search(r"enum %s \{([^}]*)\}" % enum, src).group(1)
    members = [m.split("=")[0].strip() for m in body.split(",")]
    prefix = enum[:2].upper() + "_FAULT_"
    assert members[0] == prefix + "NONE" and "= 0" in body.split(",")[0]
    module = port_window if table == "WA_FAULTS" else port_xl
    assert members.index(prefix + name.upper()) == getattr(module, table)[name]


def test_cuda_operand_checks_reject_what_the_kernels_do_not_take():
    """The checks the wrappers run before handing pointers to a kernel:
    bf16 only (no silent cast) and 16-byte aligned rows; operands that
    require grad are taken (the autograd path launches the kernels too)."""
    good = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    port_flash.check_cuda_operands("k", good, good[..., :32], good[..., 32:])
    with pytest.raises(TypeError, match="bfloat16"):
        port_flash.check_cuda_operands("k", good, good.float())
    with pytest.raises(ValueError, match="aligned"):
        port_flash.check_cuda_operands("k", good[..., 1:33])
    with pytest.raises(ValueError, match="aligned"):
        port_flash.check_cuda_operands("k", good.transpose(1, 2))
    # TMA reads every operand: strides that are multiples of 8 elements (16
    # bytes) and a 16-byte aligned base; P as the decoder makes it, a
    # [2T-1, H*d] projection viewed as [H, 2T-1, d], is taken
    with pytest.raises(ValueError, match="aligned"):
        port_flash.check_cuda_operands("k", torch.zeros(2, 8, 68, dtype=torch.bfloat16)[..., :64])
    p = torch.zeros(15, 4 * 64, dtype=torch.bfloat16).reshape(15, 4, 64).transpose(0, 1)
    port_flash.check_cuda_operands("k", p)
    with pytest.raises(ValueError, match="aligned"):
        port_flash.check_cuda_operands(
            "k", torch.zeros(15 * 256 + 4, dtype=torch.bfloat16)[4:].view(15, 4, 64))
    port_flash.check_cuda_operands("k", good.clone().requires_grad_())
    with pytest.raises(ValueError, match="float32"):
        port_flash.check_f32_rows("lse", torch.zeros(2, 4, 8).transpose(1, 2), (2, 8, 4))


# -- training kernels: LSE forwards and saved-O/LSE backwards ------------------------


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("t", [190])
def test_flash_lse_and_backward_plain_match_pallas(t):
    """The plain LSE forward and the plain backward against
    ``_flash_nhd_forward_lse`` / ``_flash_nhd_backward`` in interpret mode
    (sizes of tests/test_kernels.py:567-600), the backward fed the JAX
    forward's own o and lse."""
    b, h, d = 2, 4, 16
    q, k, v = _qkv(b, t, h * d, seed=3)
    g = np.random.RandomState(t).randn(b, t, h * d).astype(np.float32)
    scale = d ** -0.5
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    kw = dict(heads=h, sm_scale=scale, block_q=128)

    def fwd_bwd(q_, k_, v_, g_, interpret):  # both kernels in one program: one compile
        o_, lse_ = jax_flash._flash_nhd_forward_lse(q_, k_, v_, interpret=interpret, **kw)
        return o_, lse_, jax_flash._flash_nhd_backward(q_, k_, v_, o_, lse_, g_,
                                                       interpret=interpret, **kw)

    o, lse, grads = interpret0(fwd_bwd, jq, jk, jv, jg)
    tq, tk, tv, tg = _t(q, k, v, g)
    ours_o, ours_lse = port_flash.flash_attention_nhd_lse(tq, tk, tv, h, scale)
    np.testing.assert_allclose(ours_o.numpy(), np.asarray(o), atol=ATOL)
    np.testing.assert_allclose(ours_lse.numpy(), np.asarray(lse)[:, :, :t], atol=ATOL_LSE)
    to, tlse = _t(o, np.asarray(lse)[:, :, :t])
    ours = port_flash.flash_attention_nhd_backward(tq, tk, tv, to, tlse, tg, h, scale)
    for name, a, want in zip(("dq", "dk", "dv"), ours, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(want), atol=ATOL_FLASH_GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("t,band", XL_LSE_CASES)
def test_xl_lse_and_backward_plain_match_pallas(jax_side, t, band):
    """The plain XL LSE forward and backward against ``_xl_nhd_forward_lse``
    / ``_xl_nhd_backward`` in interpret mode (tests/test_kernels.py:689-732):
    a ragged T, and a banded case (a band a head); all six cotangents. Two
    heads: the Pallas body unrolls its heads, and tracing them is the
    case's cost."""
    b, h, d = 2, 2, 16
    arrays = _xl_data(b, t, h, d, seed=3)
    g = np.random.RandomState(4).randn(b, t, h * d).astype(np.float32)
    scale = d ** -0.5
    o, lse, grads = jax_side["xl"].result()[(t, band)]
    tarr = _t(*arrays)
    ours_o, ours_lse = port_xl.flash_xl_attention_nhd_lse(*tarr, h, scale, band)
    np.testing.assert_allclose(ours_o.numpy(), np.asarray(o), atol=ATOL)
    np.testing.assert_allclose(ours_lse.numpy(), np.asarray(lse)[:, :, :t], atol=ATOL_LSE)
    to, tlse, tg = _t(o, np.asarray(lse)[:, :, :t], g)
    ours = port_xl.flash_xl_attention_nhd_backward(*tarr, to, tlse, tg, h, scale, band)
    for name, a, want in zip(("dq", "dk", "dv", "dbu", "dbv", "dp"), ours, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(want), atol=ATOL_XL_GRAD,
                                   err_msg=f"T={t} band={band} {name}")


@pytest.mark.parametrize("kind", ["flash", "xl"])
def test_autograd_functions_match_jax_vjp(kind):
    """torch.autograd through FlashAttentionNHD / XLAttentionNHD (plain LSE
    forward, plain backward on the CPU) against jax.vjp of the JAX
    package's differentiable flash_attention_nhd / flash_xl_attention_nhd."""
    b, t, h, d = 2, 40, 2, 64  # head dim 64: the heads-in-lanes Functions
    arrays = _xl_data(b, t, h, d, seed=5)
    n_in = 3 if kind == "flash" else 6
    g = np.random.RandomState(6).randn(b, t, h * d).astype(np.float32)
    scale = d ** -0.5
    if kind == "flash":
        jfn = lambda *x: jax_flash.flash_attention_nhd(*x, h, scale)  # noqa: E731
        tfn = lambda *x: port_flash.flash_attention_nhd(*x, h, scale)  # noqa: E731
    else:
        jfn = lambda *x: jax_xl.flash_xl_attention_nhd(*x, h, scale, (9, 14))  # noqa: E731
        tfn = lambda *x: port_xl.flash_xl_attention_nhd(*x, h, scale, (9, 14))  # noqa: E731
    out, want = jit0(lambda g_, *x: (lambda o, f: (o, f(g_)))(*jax.vjp(jfn, *x)))(
        jnp.asarray(g), *map(jnp.asarray, arrays[:n_in]))
    leaves = [x.requires_grad_() for x in _t(*arrays[:n_in])]
    ours = tfn(*leaves)
    assert ours.grad_fn is not None and "NHD" in type(ours.grad_fn).__name__
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(out), atol=ATOL)
    got = torch.autograd.grad(ours, leaves, torch.from_numpy(g))
    for i, (a, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL_XL_GRAD, err_msg=str(i))


def test_bf16_qkv_split_cotangents_keep_their_dtypes():
    """bf16 primals give bf16 cotangents, so the backward of the caller's
    qkv split accepts them (the JAX test_bf16_cotangent_dtypes_match_primals
    regression); the f32 position biases get f32 gradients."""
    b, t, h, d = 1, 24, 2, 16
    arrays = _xl_data(b, t, h, d, seed=7)
    qkv = torch.from_numpy(np.concatenate(arrays[:3], -1)).bfloat16().requires_grad_()
    bu, bv = (torch.from_numpy(a).requires_grad_() for a in arrays[3:5])
    p = torch.from_numpy(arrays[5]).bfloat16().requires_grad_()
    c = h * d
    out = port_xl.flash_xl_attention_nhd(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                                         bu, bv, p, h, d ** -0.5)
    out = out + port_flash.flash_attention_nhd(qkv[..., :c], qkv[..., c:2 * c],
                                               qkv[..., 2 * c:], h)
    out.float().square().sum().backward()
    assert qkv.grad.dtype == p.grad.dtype == torch.bfloat16
    assert bu.grad.dtype == bv.grad.dtype == torch.float32
    assert all(torch.isfinite(x.grad.float()).all() for x in (qkv, bu, bv, p))


def test_rel_unshift_is_the_adjoint_of_rel_shift():
    t = 9
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(2, t, 2 * t - 1))
    y = torch.from_numpy(rng.randn(2, t, t))
    torch.testing.assert_close((port_xl.rel_shift(x) * y).sum(),
                               (x * port_xl.rel_unshift(y)).sum())


def test_cpu_training_path_launches_no_kernel():
    """With grad on the CPU the Functions take the plain LSE forward and
    backward; no kernel counter moves, and no-grad calls keep the plain
    forward."""
    counters = (port_flash.flash_attention_nhd, port_flash.flash_attention_nhd_lse,
                port_flash.flash_attention_nhd_backward, port_xl.flash_xl_attention_nhd,
                port_xl.flash_xl_attention_nhd_lse, port_xl.flash_xl_attention_nhd_backward,
                port_xl.flash_xl_attention, port_xl.flash_xl_attention_lse,
                port_xl.flash_xl_attention_backward, port_xl.flash_xl_bwd_prepass,
                port_xl.flash_xl_bwd_postpass,
                port_window.window_attention, port_window.window_attention_backward)
    before = [f.launches for f in counters]
    for d in (16, 64):  # the head-major and the heads-in-lanes XL families
        q, k, v, bu, bv, p = (x.requires_grad_() for x in _t(*_xl_data(1, 20, 2, d, seed=9)))
        out = port_flash.flash_attention_nhd(q, k, v, 2) + port_xl.flash_xl_attention_nhd(
            q, k, v, bu, bv, p, 2, 0.25)
        out.sum().backward()
        with torch.no_grad():
            port_xl.flash_xl_attention_nhd(q, k, v, bu, bv, p, 2, 0.25)
    wq, wk, wv, bias, _ = (x.requires_grad_() for x in _t(*_window_data(2, 16, 2, 8, 1, False, 9)))
    port_window.swin_window_attention(wq, wk, wv, bias, None, 1, 0.3).sum().backward()
    assert [f.launches for f in counters] == before


# -- the XL backwards' passes against the JAX wrappers' XLA code --------------------------


@pytest.mark.parametrize("lanes", [True, False])
def test_xl_bwd_prepass_plain_matches_the_jax_wrappers_xla_code(lanes):
    """The plain pre-pass against the XLA code it takes over, on the same
    seeded inputs: delta of ``_xl_nhd_backward`` (xl_attention.py:912-916;
    row 13) or of ``_xl_backward`` (:476; row 11), zero past T; for row 13
    also qu and qv in bf16 as the JAX dispatch forms them (:1043-1044)."""
    b, t, h, d = 2, 70, 4, 16
    rng = np.random.RandomState(11)
    q, o, g = (rng.randn(b, t, h * d).astype(np.float32) for _ in range(3))
    lse = rng.randn(b, h, t).astype(np.float32)
    bu, bv = ((rng.randn(h, d) * 0.1).astype(np.float32) for _ in range(2))
    t_pad = 128  # more rows than the port's 64-row padding, as the JAX wrappers pad
    pad = lambda x: jnp.pad(x, ((0, 0), (0, t_pad - t), (0, 0)))  # noqa: E731
    split = lambda x: x.reshape(b, -1, h, d).transpose(0, 2, 1, 3)  # noqa: E731

    def xla(q, o, g, bu, bv):
        f32 = jnp.float32
        if lanes:
            delta = jnp.transpose(
                (pad(g).astype(f32) * pad(o).astype(f32)).reshape(b, t_pad, h, d).sum(-1),
                (0, 2, 1))
        else:
            delta = jnp.sum(split(pad(g)).astype(f32) * split(pad(o)).astype(f32), axis=-1)
        qh = split(q)
        return (delta, (qh.astype(f32) + bu[None, :, None]).astype(q.dtype),
                (qh.astype(f32) + bv[None, :, None]).astype(q.dtype))

    jq = jnp.asarray(q).astype(jnp.bfloat16)
    delta, qu, qv = jit0(xla)(jq, *map(jnp.asarray, (o, g, bu, bv)))
    tq = torch.from_numpy(q).bfloat16()
    to, tg = (port_flash._split_heads(torch.from_numpy(x), h) for x in (o, g))
    args = (port_flash._split_heads(tq, h), torch.from_numpy(bu), torch.from_numpy(bv))
    side, dq_acc, dp_acc, ours_u, ours_v = port_xl.flash_xl_bwd_prepass(
        to, tg, torch.from_numpy(lse), d if lanes else 2 * d, *(args if lanes else ()))
    np.testing.assert_allclose(side[..., 1].numpy(), np.asarray(delta)[:, :, :side.shape[2]],
                               atol=1e-5)
    assert not dq_acc.any() and not dp_acc.any()
    if lanes:
        for ours, want in ((ours_u, qu), (ours_v, qv)):
            assert ours.dtype == torch.bfloat16
            np.testing.assert_array_equal(ours.float().numpy(),
                                          np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("lanes", [True, False])
def test_xl_bwd_postpass_plain_matches_the_jax_wrappers_xla_code(lanes):
    """The plain post-pass against the XLA code it takes over, on the same
    seeded partial sums: for row 13 ``_xl_nhd_backward``'s dq = dQu + dQv,
    dbu and dbv as their (b, t) sums and the dP slice (xl_attention.py:
    978-983); for row 11 ``_xl_backward``'s unpadded dqu, dqv and dP slice
    (:524-527). The port's workspaces hold the same numbers in its own
    layout: dQ head major, the column sums split over 128-row tiles, P row m
    of the dP workspace at row 64 + m."""
    b, t, h, d, scale = 2, 150, 4, 16, 0.25
    t_pad, pad_lo, _ = jax_xl._geometry(t, 512, 256)
    rng = np.random.RandomState(12)
    dqu, dqv = (rng.randn(b, t_pad, h, d).astype(np.float32) for _ in range(2))
    dp_full = rng.randn(h, pad_lo + 2 * t - 1 + 7, d).astype(np.float32)

    def xla(dqu, dqv, dp_full):  # fed the scaled partial sums, as the TPU kernels return them
        dp_out = dp_full[:, pad_lo:pad_lo + 2 * t - 1]
        if not lanes:
            return dqu[:, :t], dqv[:, :t], dp_out
        dqu_f, dqv_f = dqu[:, :t], dqv[:, :t]
        return dqu_f + dqv_f, dqu_f.sum((0, 1)), dqv_f.sum((0, 1)), dp_out

    want = jit0(xla)(*(jnp.asarray(x * scale) for x in (dqu, dqv)), jnp.asarray(dp_full * scale))
    tp, n_kt = port_flash.bwd_padded_rows(t), -(-t // port_xl.XB_KEYS)
    hm = lambda x: torch.from_numpy(x[:, :tp]).transpose(1, 2)  # noqa: E731  [B, H, T_pad, d]
    dq_acc = hm(dqu + dqv) if lanes else torch.cat([hm(dqu), hm(dqv)], -1)
    colsum = None
    if lanes:
        tiles = np.stack([np.stack([x[:, k * 128:min(t, (k + 1) * 128)].sum(1) for x in (dqu, dqv)],
                                   2) for k in range(n_kt)], 1)  # [B, n_kt, H, 2, d]
        colsum = torch.from_numpy(tiles).permute(0, 2, 1, 3, 4)
    dp_acc = torch.from_numpy(rng.randn(h, port_xl.xl_bwd_dp_rows(t), d).astype(np.float32))
    dp_acc[:, port_xl.XB_PAD:port_xl.XB_PAD + 2 * t - 1] = torch.from_numpy(
        dp_full[:, pad_lo:pad_lo + 2 * t - 1])
    dq, dqv_out, dp = torch.empty(b, h, t, d), torch.empty(b, h, t, d), torch.empty(h, 2 * t - 1, d)
    dq, dqv_out, dp, dbias = port_xl.flash_xl_bwd_postpass(
        dq_acc.contiguous(), dp_acc, colsum, scale, dq, None if lanes else dqv_out, dp)
    merge = lambda x: x.transpose(1, 2).numpy()  # noqa: E731  [B, T, H, d]
    if lanes:
        got = (merge(dq), dbias[0].numpy(), dbias[1].numpy(), dp.numpy())
    else:
        got = (merge(dq), merge(dqv_out), dp.numpy())
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(w).reshape(a.shape), atol=1e-5)


# -- head-major XL attention (rows 9, 10 and 11 of the kernel table) -------------------

# the JAX package's own bounds for these kernels in interpret mode against
# their XLA reference (tests/test_kernels.py:172, :207, :263 and :283): the
# forward, the log-sum-exp and the five cotangents
ATOL_HM_LSE = 1e-4
ATOL_HM_GRAD = 5e-6


@pytest.mark.parametrize("t,d,band", HM_CASES)
def test_xl_head_major_plain_versions_match_pallas(jax_side, t, d, band):
    """The plain forward, LSE forward and backward of the head-major family
    against ``_xl_forward`` (its row body), ``_xl_forward_lse`` and
    ``_xl_backward`` in interpret mode at small blocks
    (tests/test_kernels.py:164-321): ragged T, with and without a band, the
    backward fed the JAX forward's own o and lse; all five cotangents."""
    b, h = 2, 3
    *arrays, g = _hm_data(b, h, t, d, seed=t + d)
    share = jax_side["hm"][HM_CASES.index((t, d, band)) >= 3]
    fwd, o, lse, grads = share.result()[(t, d, band)]
    tarr = _t(*arrays)
    ours = port_xl.flash_xl_attention(*tarr, 0.25, band)
    np.testing.assert_allclose(ours.numpy(), np.asarray(fwd), atol=ATOL)
    ours_o, ours_lse = port_xl.flash_xl_attention_lse(*tarr, 0.25, band)
    np.testing.assert_allclose(ours_o.numpy(), np.asarray(o), atol=ATOL)
    np.testing.assert_allclose(ours_lse.numpy(), np.asarray(lse)[:, :, 0, :t], atol=ATOL_HM_LSE)
    to, tlse, tg = _t(o, np.asarray(lse)[:, :, 0, :t], g)
    got = port_xl.flash_xl_attention_backward(*tarr, to, tlse, tg, 0.25, band)
    for name, a, want in zip(("dqu", "dqv", "dk", "dv", "dp"), got, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(want), atol=ATOL_HM_GRAD,
                                   err_msg=f"T={t} d={d} band={band} {name}")


def test_xl_head_major_plain_forward_matches_the_blocked_pallas_body():
    """``_xl_forward`` takes its blocked online-softmax body (``_xl_kernel``,
    the long-T one) when ``group`` does not divide ``block_q``; the port's one
    forward covers it too."""
    *arrays, _ = _hm_data(2, 2, 100, 16, seed=11)
    jarr = [jnp.asarray(a) for a in arrays]
    blocked = interpret0(jax_xl._xl_forward, *jarr, sm_scale=0.25, block_q=32, block_k=32,
                         group=128)
    ours = port_xl.flash_xl_attention(*_t(*arrays), 0.25)
    np.testing.assert_allclose(ours.numpy(), np.asarray(blocked), atol=ATOL)


@pytest.mark.parametrize("band", [None, (9, 14, 40)])
def test_xl_head_major_function_matches_jax_vjp(band):
    """torch.autograd through XLAttention (plain LSE forward and backward on
    the CPU) against jax.vjp of the JAX package's ``flash_xl_attention``: the
    value and all five cotangents."""
    *arrays, g = _hm_data(2, 3, 40, 16, seed=12)
    jfn = lambda *x: jax_xl.flash_xl_attention(*x, 0.25, band)  # noqa: E731
    out, want = jit0(lambda g_, *x: (lambda o, f: (o, f(g_)))(*jax.vjp(jfn, *x)))(
        jnp.asarray(g), *map(jnp.asarray, arrays))
    leaves = [x.requires_grad_() for x in _t(*arrays)]
    ours = port_xl.flash_xl_attention(*leaves, 0.25, band)
    assert type(ours.grad_fn).__name__.startswith("XLAttentionBackward")
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(out), atol=ATOL)
    got = torch.autograd.grad(ours, leaves, torch.from_numpy(g))
    for name, a, w in zip(("dqu", "dqv", "dk", "dv", "dp"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL_XL_GRAD, err_msg=name)


def test_xl_head_major_cotangents_keep_their_primals_dtypes():
    """Each gradient of XLAttention comes back in its primal's dtype: f32 qu
    and qv (as the pos-bias adds leave them in an f32 model) beside bf16 k, v
    and p, and the reverse."""
    *arrays, g = _hm_data(1, 2, 24, 16, seed=13)
    for lo in ((2, 3, 4), (0, 1)):
        leaves = [(x.bfloat16() if i in lo else x).requires_grad_()
                  for i, x in enumerate(_t(*arrays))]
        out = port_xl.flash_xl_attention(*leaves, 0.25)
        got = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(out.dtype))
        assert [a.dtype for a in got] == [x.dtype for x in leaves]
        assert all(torch.isfinite(a.float()).all() for a in got)


@pytest.mark.parametrize("band", [None, (6, 10, 6, 10)])
def test_xl_dispatch_at_head_dim_32_matches_jax(band):
    """``flash_xl_attention_nhd`` at head dim 32 (the PMAM decoder's): the
    port sends it through strided head-major views to ``flash_xl_attention``,
    as the JAX package's fall-back does; the value and all six gradients
    against jax.vjp of the JAX ``flash_xl_attention_nhd``."""
    b, t, h, d = 2, 50, 4, 32
    arrays = _xl_data(b, t, h, d, seed=14)
    g = np.random.RandomState(15).randn(b, t, h * d).astype(np.float32)
    scale = d ** -0.5
    jfn = lambda *x: jax_xl.flash_xl_attention_nhd(*x, h, scale, band)  # noqa: E731
    out, want = jit0(lambda g_, *x: (lambda o, f: (o, f(g_)))(*jax.vjp(jfn, *x)))(
        jnp.asarray(g), *map(jnp.asarray, arrays))
    qkv = torch.from_numpy(np.concatenate(arrays[:3], -1)).requires_grad_()
    bu, bv, p = (x.requires_grad_() for x in _t(*arrays[3:]))
    c = h * d
    ours = port_xl.flash_xl_attention_nhd(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                                          bu, bv, p, h, scale, band)
    assert ours.shape == (b, t, c)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(out), atol=ATOL)
    dqkv, dbu, dbv, dp = torch.autograd.grad(ours, (qkv, bu, bv, p), torch.from_numpy(g))
    got = (dqkv[..., :c], dqkv[..., c:2 * c], dqkv[..., 2 * c:], dbu, dbv, dp)
    for name, a, w in zip(("dq", "dk", "dv", "dbu", "dbv", "dp"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL_XL_GRAD, err_msg=name)
    with torch.no_grad():  # the no-grad call takes the plain forward, the same value
        again = port_xl.flash_xl_attention_nhd(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                                               bu, bv, p, h, scale, band)
    np.testing.assert_allclose(again.numpy(), np.asarray(out), atol=ATOL)


def test_xl_head_major_takes_strided_views_without_a_copy():
    """The head-major entry point reads [B, T, H*d] projection slices as
    [B, H, T, d] views and returns a [B, H, T, d] view of a [B, T, H, d]
    buffer, so merging the heads is a reshape; the kernels' operand check
    takes such views at head dim 32 (16-byte aligned rows)."""
    b, t, h, d = 2, 16, 12, 32
    qkv = torch.from_numpy(np.random.RandomState(16).randn(b, t, 3 * h * d).astype(np.float32))
    q, k, v = (port_flash._split_heads(qkv[..., i * h * d:(i + 1) * h * d], h) for i in range(3))
    assert k.data_ptr() == qkv.data_ptr() + h * d * 4 and k.stride() == (t * 3 * h * d, d,
                                                                         3 * h * d, 1)
    port_flash.check_cuda_operands("k", *(x.bfloat16() for x in (q, k, v)))
    p = torch.zeros(h, 2 * t - 1, d)
    out = port_xl.flash_xl_attention(q, q, k, v, p, d ** -0.5)
    ref = port_xl.flash_xl_attention_reference(q.contiguous(), q.contiguous(), k.contiguous(),
                                               v.contiguous(), p, d ** -0.5)
    torch.testing.assert_close(out, ref)
    buf = port_flash.hm_empty((b, h, t, d), torch.float32, "cpu")
    assert port_flash._merge_heads(buf).data_ptr() == buf.data_ptr()
    with pytest.raises(ValueError, match="no kernel for device"):
        port_xl._check_hm("flash_xl_attention", q, q, k, v, p)


# -- Swin window attention (rows 14 and 15 of the kernel table) ------------------------


@pytest.mark.parametrize("bnw,n,h,d,n_windows,shifted", WINDOW_CASES)
def test_window_plain_versions_match_pallas(jax_side, bnw, n, h, d, n_windows, shifted):
    """The plain forward against ``_window_forward`` and the plain backward
    against ``_window_backward``, both in interpret mode, the backward fed
    the JAX forward's own output: dq, dk, dv, dbias and dshift."""
    q, k, v, bias, shift = _window_data(bnw, n, h, d, n_windows, shifted, seed=n + shifted)
    g = window_cotangent(bnw, n, h, d)
    scale = d ** -0.5
    out, want = jax_side["window"].result()[(bnw, n, h, d, n_windows, shifted)]
    tq, tk, tv, tbias, tg, tout = _t(q, k, v, bias, g, out)
    tshift = torch.from_numpy(shift) if shifted else None
    ours = port_window.window_attention(tq, tk, tv, tbias, tshift, n_windows, scale)
    np.testing.assert_allclose(ours.numpy(), np.asarray(out), atol=ATOL_WINDOW)
    got = port_window.window_attention_backward(tq, tk, tv, tout, tg, tbias, tshift, n_windows,
                                                scale)
    for name, a, w in zip(("dq", "dk", "dv", "dbias", "dshift"), got, want):
        if w is None:
            assert a is None and not shifted, name
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL_WINDOW_GRAD, err_msg=name)


def test_window_function_matches_jax_vjp_with_mask_gradient():
    """The autograd Function against ``jax.vjp`` of ``_xla_window_attention``
    on q, k, v, bias and the shift mask; a mask that asks for no gradient
    gets none."""
    bnw, n, h, d, n_windows = 8, 16, 2, 8, 4
    arrays = _window_data(bnw, n, h, d, n_windows, True, seed=5)
    g = np.random.RandomState(6).randn(bnw, n, h, d).astype(np.float32)
    scale = d ** -0.5
    fn = lambda *x: jax_window._xla_window_attention(*x, n_windows, scale)  # noqa: E731
    out, want = jit0(lambda g_, *x: (lambda o, f: (o, f(g_)))(*jax.vjp(fn, *x)))(
        jnp.asarray(g), *map(jnp.asarray, arrays))
    leaves = [x.requires_grad_() for x in _t(*arrays)]
    ours = port_window.swin_window_attention(*leaves, n_windows, scale)
    assert type(ours.grad_fn).__name__.startswith("SwinWindowAttention")
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(out), atol=ATOL_WINDOW)
    got = torch.autograd.grad(ours, leaves, torch.from_numpy(g))
    assert float(got[4].abs().max()) > 0  # softmax(s + mask) does depend on the mask
    for i, (a, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL_WINDOW_GRAD,
                                   err_msg=str(i))
    leaves[4] = leaves[4].detach()  # a constant buffer, as in the model
    ours = port_window.swin_window_attention(*leaves, n_windows, scale)
    ours.backward(torch.from_numpy(g))
    assert leaves[4].grad is None
    np.testing.assert_allclose(leaves[3].grad.numpy(), np.asarray(want[3]), atol=ATOL_WINDOW_GRAD)


def test_window_bf16_cotangents_keep_their_dtypes_and_bad_periods_raise():
    """bf16 q, k, v from one qkv projection give bf16 cotangents through the
    unbind, the f32 bias an f32 one (the JAX
    test_pallas_backward_bf16_dtypes); a window count that does not divide
    bnw raises as ``_window_forward`` does."""
    bnw, n, h, d, n_windows = 8, 16, 2, 8, 4
    q, k, v, bias, shift = _window_data(bnw, n, h, d, n_windows, True, seed=7)
    qkv = torch.from_numpy(np.stack([q, k, v], 2)).bfloat16().requires_grad_()
    tbias = torch.from_numpy(bias).requires_grad_()
    tq, tk, tv = qkv.unbind(2)
    out = port_window.swin_window_attention(tq, tk, tv, tbias, torch.from_numpy(shift),
                                            n_windows, d ** -0.5)
    assert out.dtype == torch.bfloat16
    out.float().square().sum().backward()
    assert qkv.grad.dtype == torch.bfloat16 and tbias.grad.dtype == torch.float32
    assert torch.isfinite(qkv.grad.float()).all() and torch.isfinite(tbias.grad).all()
    with pytest.raises(ValueError, match="multiple of n_windows"):
        port_window.window_attention(tq[:6], tk[:6], tv[:6], tbias, torch.from_numpy(shift),
                                     n_windows, d ** -0.5)
    with pytest.raises(ValueError, match="multiple of n_windows"):
        jax_window._window_forward(*map(jnp.asarray, (q[:6], k[:6], v[:6], bias, shift)),
                                   n_windows, d ** -0.5, interpret=True)


# -- row 4: flash attention with an additive score bias ---------------------------------


def _bias_data(b, h, t, d, seed):
    """q, k, v [B, H, T, d] and an f32 bias [B, H, T, T] with -1e30 where
    blocked: a per-head band, the last keys of batch 0 and every key of row 1
    (a fully masked row attends every real key alike)."""
    from transformer4sed_tpu.models.xl import build_band_mask

    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(3))
    bias = rng.randn(b, h, t, t).astype(np.float32)
    mask = np.broadcast_to(build_band_mask(t, [3, 9, 1, 40][:h]), bias.shape).copy()
    mask[0, :, :, t - 5:] = True
    mask[:, :, 1, :] = True
    return q, k, v, np.where(mask, np.float32(-1e30), bias)


@pytest.mark.parametrize("t", [37, 130])
def test_bias_plain_matches_pallas_and_xla(t):
    """Row 4's plain version against the reference's ``_xla_attention_bias``
    and against ``_flash_bias_forward`` in interpret mode (T padded to its
    blocks, three key blocks at T=130). A fully masked row (row 1, and the
    narrow bands' last rows in batch 0) attends its T keys alike, as
    ``_xla_attention_bias`` and the JAX backward have it; the Pallas kernel
    masks its padded keys with the same -1e30 as a blocked one
    (``_NEG_INF``), so there it averages over T_pad keys, the pad's V rows
    zero: T / T_pad times the row's mean of V."""
    arrays = _bias_data(2, 4, t, 16, seed=t)
    scale = 16 ** -0.5
    pallas = np.asarray(interpret0(jax_flash._flash_bias_forward, *map(jnp.asarray, arrays),
                                   sm_scale=scale, block_q=64, block_k=64))
    xla = jit0(lambda *x: jax_flash._xla_attention_bias(*x, scale))(*map(jnp.asarray, arrays))
    ours = port_flash.flash_attention_bias_reference(*map(torch.from_numpy, arrays), scale)
    np.testing.assert_allclose(ours.numpy(), np.asarray(xla), atol=ATOL)
    full = (arrays[3] <= -1e30).all(-1)  # row 1, and narrow bands in batch 0's masked tail
    t_pad = -(-t // 64) * 64
    want = np.where(full[..., None], pallas * t_pad / t, pallas)
    np.testing.assert_allclose(ours.numpy(), want, atol=ATOL)
    q, k, v, bias = map(torch.from_numpy, arrays)
    before = port_flash.flash_attention_bias.launches
    torch.testing.assert_close(port_flash.flash_attention_bias(q, k, v, bias, scale), ours)
    assert port_flash.flash_attention_bias.launches == before  # CPU tensors: no kernel


def test_bias_autograd_matches_jax_vjp():
    """:class:`FlashAttentionBias` (the plain forward on the CPU, the backward
    by recompute) against ``jax.vjp`` of ``flash_attention_bias``: dq, dk, dv
    and dbias, zero where the bias blocks (but in a fully masked row, whose
    keys all take part)."""
    arrays = _bias_data(2, 4, 37, 16, seed=3)
    g = np.random.RandomState(4).randn(2, 4, 37, 16).astype(np.float32)
    scale = 16 ** -0.5
    want = jit0(lambda g_, *x: jax.vjp(
        lambda q, k, v, b: jax_flash.flash_attention_bias(q, k, v, b, scale), *x)[1](g_))(
            jnp.asarray(g), *map(jnp.asarray, arrays))
    leaves = [torch.from_numpy(x).requires_grad_() for x in arrays]
    port_flash.flash_attention_bias(*leaves, scale).backward(torch.from_numpy(g))
    for name, leaf, w in zip(("dq", "dk", "dv", "dbias"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=ATOL_FLASH_GRAD,
                                   err_msg=name)
    blocked = arrays[3] <= -1e30
    blocked &= ~blocked.all(-1, keepdims=True)
    assert float(leaves[3].grad[blocked].abs().max()) == 0.0


# -- row 16: the flash variants' experiment ---------------------------------------------


class _InterpretPallas:
    """``exps/flash_variants.py``'s ``pl`` with every ``pallas_call`` in
    interpret mode (``flash_a`` takes no ``interpret`` argument)."""

    def __init__(self, pl):
        self.BlockSpec = pl.BlockSpec
        self.pallas_call = functools.partial(pl.pallas_call, interpret=True)


@pytest.mark.parametrize("use_exp2", [False, True])
def test_flash_variant_plain_matches_pallas(use_exp2, monkeypatch):
    """Row 16's plain version against ``flash_a`` (variant A, and B with exp2)
    run in interpret mode through a ``pl`` stand-in, at a T whose tail crosses
    a 128-lane group."""
    import importlib.util
    from pathlib import Path

    from transformer4sed_tpu_torch.exps import flash_variants as port_variants

    path = Path(__file__).resolve().parents[1] / "exps" / "flash_variants.py"
    spec = importlib.util.spec_from_file_location("jax_flash_variants", path)
    jax_variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_variants)
    monkeypatch.setattr(jax_variants, "pl", _InterpretPallas(jax_variants.pl))
    q, k, v = (np.random.RandomState(9 + i).randn(1, 2, 150, 16).astype(np.float32)
               for i in range(3))
    scale = 16 ** -0.5
    want = jit0(functools.partial(jax_variants.flash_a, sm_scale=scale,
                                     use_exp2=use_exp2))(*map(jnp.asarray, (q, k, v)))
    ours = port_variants.flash_a(*map(torch.from_numpy, (q, k, v)), scale, use_exp2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), atol=ATOL)
    assert port_variants.flash_a.launches == 0
