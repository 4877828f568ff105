"""The port's attention kernels, held against the JAX package's Pallas
kernels run in interpret mode on the CPU.

On the CPU the port's wrappers take their plain PyTorch versions (the
CUDA kernels run only on the card; ``chip_smoke.py`` holds them against
the same plain versions there). Inputs come from numpy with a seed and
are compared in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer4sed_tpu.kernels.flash_attention import _flash_nhd_forward
from transformer4sed_tpu.kernels.xl_attention import _xl_nhd_forward
from transformer4sed_tpu_torch.kernels import flash_attention as port_flash
from transformer4sed_tpu_torch.kernels import xl_attention as port_xl

# f32 on both sides; the sums run in another order (blocked online
# softmax in the Pallas kernel, one matmul here): a few f32 ulps of O(1)
ATOL = 3e-5


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

    for name, tpu_fn in (("flash_attention", "_flash_nhd_forward"),
                         ("xl_attention", "_xl_nhd_forward")):
        src = (_build.CSRC_DIR / f"{name}.cu").read_text()
        assert tpu_fn in src and "What bounds it" in src and 'extern "C"' in src
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC_DIR.glob("*.cu")}


def test_cuda_operand_checks_reject_what_the_kernels_do_not_take():
    """The checks the wrappers run before handing pointers to a kernel:
    bf16 only (no silent cast), 16-byte aligned rows, forward only."""
    good = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    port_flash.check_cuda_operands("k", good, good[..., :32], good[..., 32:])
    with pytest.raises(TypeError, match="bfloat16"):
        port_flash.check_cuda_operands("k", good, good.float())
    with pytest.raises(ValueError, match="aligned"):
        port_flash.check_cuda_operands("k", good[..., 1:33])
    with pytest.raises(ValueError, match="aligned"):
        port_flash.check_cuda_operands("k", good.transpose(1, 2))
    with pytest.raises(NotImplementedError, match="training slice"):
        port_flash.check_cuda_operands("k", good.clone().requires_grad_())
    with torch.no_grad():
        port_flash.check_cuda_operands("k", good.clone().requires_grad_())
