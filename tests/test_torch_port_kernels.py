"""The port's attention kernels, held against the JAX package's Pallas
kernels run in interpret mode on the CPU.

On the CPU the port's wrappers take their plain PyTorch versions (the
CUDA kernels run only on the card; ``chip_smoke.py`` holds them against
the same plain versions there). Inputs come from numpy with a seed and
are compared in float32.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer4sed_tpu.kernels.flash_attention import _flash_nhd_forward
from transformer4sed_tpu.kernels.xl_attention import _xl_nhd_forward
from transformer4sed_tpu.models.htsat import _shift_attn_mask
from transformer4sed_tpu_torch.kernels import flash_attention as port_flash
from transformer4sed_tpu_torch.kernels import window_attention as port_window
from transformer4sed_tpu_torch.kernels import xl_attention as port_xl

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


def _qkv(b, t, c, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, c).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("t", [64, 190])
@pytest.mark.parametrize("h,d", [(4, 16), (2, 64)])
def test_flash_plain_matches_pallas(t, h, d):
    q, k, v = _qkv(2, t, h * d, seed=t + d)
    scale = d ** -0.5
    ref = _flash_nhd_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, scale,
                             interpret=True)
    ours = port_flash.flash_attention_nhd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h, scale)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


def _xl_data(b, t, h, d, seed=0):
    rng = np.random.RandomState(seed)
    c = h * d
    q, k, v = (rng.randn(b, t, c).astype(np.float32) for _ in range(3))
    bu = (rng.randn(h, d) * 0.1).astype(np.float32)
    bv = (rng.randn(h, d) * 0.1).astype(np.float32)
    p = (rng.randn(h, 2 * t - 1, d) * 0.1).astype(np.float32)
    return q, k, v, bu, bv, p


@pytest.mark.parametrize("band", [None, (6, 10, 6, 10)])
def test_xl_plain_matches_pallas(band):
    b, t, h, d = 2, 200, 4, 32
    arrays = _xl_data(b, t, h, d)
    scale = d ** -0.5
    ref = _xl_nhd_forward(*map(jnp.asarray, arrays), h, scale, block_q=128,
                          band_widths=band, interpret=True)
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
    before = (port_flash.flash_attention_nhd.launches, port_xl.flash_xl_attention_nhd.launches)
    torch.testing.assert_close(port_flash.flash_attention_nhd(q, k, v, 2),
                               port_flash.flash_attention_nhd_reference(q, k, v, 2))
    torch.testing.assert_close(
        port_xl.flash_xl_attention_nhd(q, k, v, bu, bv, p, 2, 0.25, (8, 12)),
        port_xl.xl_attention_nhd_reference(q, k, v, bu, bv, p, 2, 0.25, (8, 12)))
    assert (port_flash.flash_attention_nhd.launches,
            port_xl.flash_xl_attention_nhd.launches) == before


def test_kernel_sources_name_their_tpu_kernels():
    """Each CUDA source carries the note of what it replaces."""
    from transformer4sed_tpu_torch.kernels import _build

    for name, tpu_fns in (("flash_attention", ("_flash_nhd_forward", "_flash_nhd_forward_lse")),
                          ("flash_attention_bwd", ("_flash_nhd_backward",)),
                          ("xl_attention", ("_xl_nhd_forward", "_xl_nhd_forward_lse")),
                          ("xl_attention_bwd", ("_xl_nhd_backward",)),
                          ("window_attention", ("_window_forward",)),
                          ("window_attention_bwd", ("_window_backward",))):
        src = (_build.CSRC_DIR / f"{name}.cu").read_text()
        assert all(f in src for f in tpu_fns) and "What bounds it" in src and 'extern "C"' in src
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC_DIR.glob("*.cu")}


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
    o, lse = jax_flash._flash_nhd_forward_lse(jq, jk, jv, h, scale, block_q=128, interpret=True)
    grads = jax_flash._flash_nhd_backward(jq, jk, jv, o, lse, jg, h, scale, block_q=128,
                                          interpret=True)
    tq, tk, tv, tg = _t(q, k, v, g)
    ours_o, ours_lse = port_flash.flash_attention_nhd_lse(tq, tk, tv, h, scale)
    np.testing.assert_allclose(ours_o.numpy(), np.asarray(o), atol=ATOL)
    np.testing.assert_allclose(ours_lse.numpy(), np.asarray(lse)[:, :, :t], atol=ATOL_LSE)
    to, tlse = _t(o, np.asarray(lse)[:, :, :t])
    ours = port_flash.flash_attention_nhd_backward(tq, tk, tv, to, tlse, tg, h, scale)
    for name, a, want in zip(("dq", "dk", "dv"), ours, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(want), atol=ATOL_FLASH_GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("t,band", [(100, None), (130, (6, 10, 6, 10))])
def test_xl_lse_and_backward_plain_match_pallas(t, band):
    """The plain XL LSE forward and backward against ``_xl_nhd_forward_lse``
    / ``_xl_nhd_backward`` in interpret mode (tests/test_kernels.py:689-732):
    a ragged T, and a banded case; all six cotangents."""
    b, h, d = 2, 4, 16
    arrays = _xl_data(b, t, h, d, seed=3)
    g = np.random.RandomState(4).randn(b, t, h * d).astype(np.float32)
    scale = d ** -0.5
    jarr = [jnp.asarray(a) for a in arrays]
    o, lse = jax_xl._xl_nhd_forward_lse(*jarr, h, scale, block_q=32, group=8, band_widths=band,
                                        interpret=True)
    grads = jax_xl._xl_nhd_backward(*jarr, o, lse, jnp.asarray(g), h, scale, block_q=32, group=8,
                                    band_widths=band, interpret=True)
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
    b, t, h, d = 2, 40, 2, 16
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
    out, want = jax.jit(lambda g_, *x: (lambda o, f: (o, f(g_)))(*jax.vjp(jfn, *x)))(
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
                port_window.window_attention, port_window.window_attention_backward)
    before = [f.launches for f in counters]
    q, k, v, bu, bv, p = (x.requires_grad_() for x in _t(*_xl_data(1, 20, 2, 16, seed=9)))
    out = port_flash.flash_attention_nhd(q, k, v, 2) + port_xl.flash_xl_attention_nhd(
        q, k, v, bu, bv, p, 2, 0.25)
    out.sum().backward()
    wq, wk, wv, bias, _ = (x.requires_grad_() for x in _t(*_window_data(2, 16, 2, 8, 1, False, 9)))
    port_window.swin_window_attention(wq, wk, wv, bias, None, 1, 0.3).sum().backward()
    assert [f.launches for f in counters] == before


# -- Swin window attention (rows 14 and 15 of the kernel table) ------------------------


def _window_data(bnw, n, h, d, n_windows, shifted, seed):
    """q, k, v [bnw, n, h, d], bias [h, n, n] and the 0 / -100 shift mask of
    a square grid of ``n_windows`` windows (zeros of a scalar when not
    shifted), as tests/test_kernels.py:_data makes them."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(bnw, n, h, d).astype(np.float32) for _ in range(3))
    bias = (rng.randn(h, n, n) * 0.3).astype(np.float32)
    shift = np.zeros((), np.float32)
    if shifted:
        w = int(np.sqrt(n))
        grid = int(np.sqrt(n_windows)) * w
        shift = _shift_attn_mask(grid, grid, w, w // 2)
    return q, k, v, bias, shift


WINDOW_CASES = [
    (8, 64, 4, 24, 4, False),  # the card's window and head dim, plain
    (8, 64, 4, 24, 4, True),   # shifted windows, two images
    (6, 16, 2, 8, 1, False),   # the tiny test model's shapes
]


@pytest.mark.parametrize("bnw,n,h,d,n_windows,shifted", WINDOW_CASES)
def test_window_plain_versions_match_pallas(bnw, n, h, d, n_windows, shifted):
    """The plain forward against ``_window_forward`` and the plain backward
    against ``_window_backward``, both in interpret mode, the backward fed
    the JAX forward's own output: dq, dk, dv, dbias and dshift."""
    q, k, v, bias, shift = _window_data(bnw, n, h, d, n_windows, shifted, seed=n + shifted)
    g = (np.random.RandomState(3).randn(bnw, n, h, d) * 0.1).astype(np.float32)
    scale = d ** -0.5
    jshift = jnp.asarray(shift) if shifted else None
    jq, jk, jv, jbias, jg = map(jnp.asarray, (q, k, v, bias, g))
    out = jax_window._window_forward(jq, jk, jv, jbias, jshift, n_windows, scale, interpret=True)
    want = jax_window._window_backward(jq, jk, jv, out, jg, jbias, jshift, n_windows, scale,
                                       interpret=True)
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
    out, want = jax.jit(lambda g_, *x: (lambda o, f: (o, f(g_)))(*jax.vjp(fn, *x)))(
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
