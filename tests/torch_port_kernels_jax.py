"""The JAX side of the slowest cases of ``tests/test_torch_port_kernels.py``,
run in worker processes.

The Pallas kernels in interpret mode (the XL LSE forward and backward, the
head-major XL family, the Swin window forward and backward) on inputs made
from numpy with a seed. It imports JAX, numpy and the JAX package only (no
torch and nothing of the port), so that a spawned worker starts in about
half the time; each function returns numpy. The data helpers live here,
where both sides read them.
"""

import importlib

import jax
import numpy as np

from transformer4sed_tpu.models.htsat import _shift_attn_mask
from tests.torch_port_jax import interpret0

jax_xl = importlib.import_module("transformer4sed_tpu.kernels.xl_attention")
jax_window = importlib.import_module("transformer4sed_tpu.kernels.window_attention")

XL_LSE_CASES = [(100, None), (130, (6, 10))]  # (T, band) at B=2, H=2, d=16
HM_CASES = [(37, 16, None), (96, 16, (10, 20, 96)), (96, 32, None), (130, 32, (9, 1, 260)),
            (130, 16, None)]  # (T, d, band) at B=2, H=3
WINDOW_CASES = [
    (8, 64, 4, 24, 4, False),  # the card's window and head dim, plain
    (8, 64, 4, 24, 4, True),   # shifted windows, two images
    (6, 16, 2, 8, 1, False),   # the tiny test model's shapes
    # the heads of a rank under tensor parallelism at stage 0 (two of four,
    # one) over three images, an odd count of windows a position, and an
    # odd head count: the kernels' walks over two heads and over one
    (12, 64, 2, 24, 4, True), (12, 64, 1, 24, 4, True), (12, 64, 1, 24, 1, False),
    (8, 64, 3, 24, 4, True),
]


def xl_data(b, t, h, d, seed=0):
    rng = np.random.RandomState(seed)
    c = h * d
    q, k, v = (rng.randn(b, t, c).astype(np.float32) for _ in range(3))
    bu = (rng.randn(h, d) * 0.1).astype(np.float32)
    bv = (rng.randn(h, d) * 0.1).astype(np.float32)
    p = (rng.randn(h, 2 * t - 1, d) * 0.1).astype(np.float32)
    return q, k, v, bu, bv, p


def hm_data(b, h, t, d, seed):
    """qu, qv, k, v [B, H, T, d], p [H, 2T-1, d] and a cotangent g, as
    tests/test_kernels.py makes them (scaled by 0.3)."""
    rng = np.random.RandomState(seed)
    f = lambda *shape: (rng.randn(*shape) * 0.3).astype(np.float32)  # noqa: E731
    return [f(b, h, t, d) for _ in range(4)] + [f(h, 2 * t - 1, d), f(b, h, t, d)]


def window_data(bnw, n, h, d, n_windows, shifted, seed):
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


def window_cotangent(bnw, n, h, d):
    return (np.random.RandomState(3).randn(bnw, n, h, d) * 0.1).astype(np.float32)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def xl_lse_backward(cases=XL_LSE_CASES):
    """{(T, band): (o, lse, the six cotangents)} of ``_xl_nhd_forward_lse``
    and ``_xl_nhd_backward`` in interpret mode, the backward fed the
    forward's own o and lse."""
    out = {}
    for t, band in cases:
        b, h, d = 2, 2, 16
        arrays = xl_data(b, t, h, d, seed=3)
        g = np.random.RandomState(4).randn(b, t, h * d).astype(np.float32)
        kw = dict(num_heads=h, sm_scale=d ** -0.5, block_q=32, group=8, band_widths=band)

        def fwd_bwd(*args, interpret):  # both kernels in one program: one compile
            *x, g_ = args
            o, lse = jax_xl._xl_nhd_forward_lse(*x, interpret=interpret, **kw)
            return o, lse, jax_xl._xl_nhd_backward(*x, o, lse, g_, interpret=interpret, **kw)

        out[(t, band)] = _numpy(interpret0(fwd_bwd, *arrays, g))
    return out


def head_major(cases):
    """{(T, d, band): (forward, o, lse, the five cotangents)} of
    ``_xl_forward``, ``_xl_forward_lse`` and ``_xl_backward`` in interpret
    mode at small blocks, the backward fed the LSE forward's o and lse."""
    out = {}
    for t, d, band in cases:
        *arrays, g = hm_data(2, 3, t, d, seed=t + d)
        kw = dict(sm_scale=0.25, block_q=32, block_k=32, group=8, band_widths=band)

        def kernels(*args, interpret):  # the three kernels in one program: one compile
            *x, g_ = args
            o, lse = jax_xl._xl_forward_lse(*x, interpret=interpret, **kw)
            return (jax_xl._xl_forward(*x, interpret=interpret, **kw), o, lse,
                    jax_xl._xl_backward(*x, o, lse, g_, interpret=interpret, **kw))

        out[(t, d, band)] = _numpy(interpret0(kernels, *arrays, g))
    return out


def window(cases=WINDOW_CASES):
    """{case: (out, (dq, dk, dv, dbias, dshift))} of ``_window_forward`` and
    ``_window_backward`` in interpret mode, the backward fed the forward's
    own output (dshift None when not shifted)."""
    res = {}
    for case in cases:
        bnw, n, h, d, n_windows, shifted = case
        q, k, v, bias, shift = window_data(bnw, n, h, d, n_windows, shifted, seed=n + shifted)
        g = window_cotangent(bnw, n, h, d)
        kw = dict(n_windows=n_windows, sm_scale=d ** -0.5)

        def fwd_bwd(q_, k_, v_, g_, b_, s_, interpret):  # both kernels in one program
            o_ = jax_window._window_forward(q_, k_, v_, b_, s_, interpret=interpret, **kw)
            return o_, jax_window._window_backward(q_, k_, v_, o_, g_, b_, s_,
                                                   interpret=interpret, **kw)

        res[case] = _numpy(interpret0(fwd_bwd, q, k, v, g, bias, shift if shifted else None))
    return res
