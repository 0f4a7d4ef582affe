"""The port's kernels (repro_torch.kernels) against the JAX package's.

On this CPU host every wrapper takes its plain PyTorch version; they are
held against repro.kernels.ops' Pallas kernels in interpret mode, shape for
shape. test_torch_gpu.py holds each CUDA kernel against its plain
version on the card.

Tolerances: O and its sums are fp32 reassociations of the same terms -
rtol=1e-5, atol=1e-4*sqrt(K) for O, and for the epilogue partials the
1e-3*sqrt(K) of tests/test_kernels.py (a partial sums up to bm*bn
elements of O)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import checksums as JC  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import checksums as TC  # noqa: E402
from repro_torch.kernels import checksum_reduce as TCR  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from torch_parity import assert_close, normal  # noqa: E402

MM_SHAPES = [(64, 32, 48), (128, 128, 128), (256, 64, 512), (96, 160, 224),
             (512, 256, 128)]
MM_RAGGED = [(40, 24, 56), (100, 96, 136), (37, 19, 53)]
CR_SHAPES = [(64, 48), (512, 384), (128, 1024)]
CR_RAGGED = [(37, 53), (100, 260), (96, 100)]
CONV_VIEWS = [((8, 32, 8, 8), (8, 64)), ((4, 24, 15, 15), (8, 64)),
              # ragged M (20 -> edge tile of 8) and ragged P (196, 49)
              ((2, 20, 14, 14), None), ((2, 40, 7, 7), None)]


def _mm_operands(n, k, m, seed):
    return normal(seed, (n, k)), normal(seed + 1, (k, m))


@pytest.mark.parametrize("shape", MM_SHAPES + MM_RAGGED)
def test_abft_matmul_matches_jax(shape):
    n, k, m = shape
    d, w = _mm_operands(n, k, m, seed=n + m)
    o_j, parts_j = jops.abft_matmul(jnp.asarray(d), jnp.asarray(w),
                                    interpret=True)
    o_t, parts_t = tops.abft_matmul(torch.as_tensor(d), torch.as_tensor(w))
    assert parts_t[3:] == tuple(parts_j[3:]), (parts_t[3:], parts_j[3:])
    assert_close(o_t, o_j, 1e-5, 1e-4 * k ** 0.5, "O")
    for a, b, name in zip(parts_t[:3], parts_j[:3],
                          ("colsum", "rowsum", "sumsq")):
        assert tuple(a.shape) == tuple(b.shape), name
        assert_close(a, b, 1e-5, 1e-3 * k ** 0.5, name)


@pytest.mark.parametrize("shape", CR_SHAPES + CR_RAGGED)
def test_checksum_reduce_matches_jax(shape):
    o = normal(sum(shape), shape)
    got = tops.checksum_reduce(torch.as_tensor(o))
    want = jops.checksum_reduce(jnp.asarray(o), interpret=True)
    assert got[4:] == tuple(want[4:])
    for a, b, name in zip(got[:4], want[:4],
                          ("colsum", "rowsum", "sumsq", "wcolsum")):
        assert tuple(a.shape) == tuple(b.shape), name
        scale = float(np.max(np.abs(np.asarray(b)))) + 1.0
        assert_close(a, b, 1e-5, 1e-6 * scale, name)


@pytest.mark.parametrize("rb,cb", [(64, 64), (128, 256), (256, 128)])
def test_chunk_sums_from_partials_matches_jax(rb, cb):
    n, k, m = 256, 64, 512
    d, w = _mm_operands(n, k, m, seed=3)
    o_j, parts_j = jops.abft_matmul(jnp.asarray(d), jnp.asarray(w),
                                    interpret=True, bm=min(64, rb),
                                    bn=min(64, cb))
    o_t, parts_t = tops.abft_matmul(torch.as_tensor(d), torch.as_tensor(w),
                                    bm=min(64, rb), bn=min(64, cb))
    got = tops.chunk_sums_from_partials(parts_t, rb, cb)
    want = jops.chunk_sums_from_partials(parts_j, rb, cb)
    for a, b, name in zip(got, want, ("s5", "s6", "s7", "sumsq")):
        scale = float(np.max(np.abs(np.asarray(b)))) + 1.0
        assert_close(a, b, 0, 1e-4 * scale, name)


def test_chunk_sums_misaligned_needs_o():
    d, w = _mm_operands(96, 32, 160, seed=4)
    o, parts = tops.abft_matmul(torch.as_tensor(d), torch.as_tensor(w),
                                bm=32, bn=32)
    with pytest.raises(ValueError):
        tops.chunk_sums_from_partials(parts, 48, 32)
    got = tops.chunk_sums_from_partials(parts, 48, 32, o=o)
    want = tref.chunk_sums_ref(o, 48, 32)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("oshape,tiles", CONV_VIEWS)
def test_conv_detect_sums_matches_jax(oshape, tiles):
    o = normal(oshape[1], oshape)
    got = tops.conv_detect_sums(torch.as_tensor(o), tiles=tiles)
    want = jops.conv_detect_sums(jnp.asarray(o), interpret=True, tiles=tiles)
    assert got is not None and want is not None
    ref = JC.detect_sums(jnp.asarray(o), exact_order=True)
    for a, b, r, name in zip(got, want, ref, ("s5", "s6", "s7", "sumsq")):
        scale = float(np.max(np.abs(np.atleast_1d(np.asarray(r))))) + 1.0
        assert_close(a, b, 0, 1e-4 * scale, name)
        assert_close(a, r, 0, 1e-4 * scale, name + " vs exact order")


def test_conv_detect_sums_degenerate_view_matches_jax():
    o = normal(0, (2, 12, 7, 7))
    assert jops.conv_detect_sums(jnp.asarray(o), interpret=True) is None
    assert tops.conv_detect_sums(torch.as_tensor(o)) is None
    # detect_sums then takes the plain pass, as in the JAX package
    got = TC.detect_sums(torch.as_tensor(o), use_kernel=True)
    want = JC.detect_sums(jnp.asarray(o))
    for a, b in zip(got, want):
        assert_close(a, b, 1e-5, 1e-4)


@pytest.mark.parametrize("oshape", [(2, 12, 7, 7), (2, 61, 2, 2),
                                    (3, 5, 1, 1), (2, 20, 14, 14),
                                    (2, 8, 32, 32)])
def test_conv_tiles_on_card_cover_every_view(oshape):
    """On the card every conv view gets tiles, the ones the JAX rule finds
    degenerate included (the smallest power of two covering the axis), and
    the finished sums from partials at those tiles (computed here by the
    kernel's plain version) equal the JAX package's detection sums."""
    n, m, e1, e2 = oshape
    p = e1 * e2
    cpu = tops.conv_tiles(m, p)
    bm, bn = card = tops.conv_tiles(m, p, on_card=True)
    if cpu is not None:
        assert card == cpu
    for t in card:
        assert t & (t - 1) == 0 and 1 <= t <= 256
    o = normal(7, oshape)
    colsum, _, sumsq, wcolsum = TCR.checksum_reduce_plain(
        torch.as_tensor(o).reshape(n * m, p), bm, bn, segments=n,
        rowsum=False)
    got = tops.finish_conv_sums(colsum, sumsq, wcolsum, m, bm)
    want = JC.detect_sums(jnp.asarray(o), exact_order=True)
    for a, b, name in zip(got, want, ("s5", "s6", "s7", "sumsq")):
        scale = float(np.max(np.abs(np.atleast_1d(np.asarray(b))))) + 1.0
        assert_close(a, b, 0, 1e-4 * scale, name)


def test_checksum_reduce_segments_never_straddle():
    """A segmented view tiles each block of rows on its own: a ragged
    block ends in an edge tile instead of running into the next one."""
    o = torch.as_tensor(normal(5, (3 * 20, 50)))
    colsum, rowsum, sumsq, wcolsum = TCR.checksum_reduce(o, 8, 16,
                                                         segments=3)
    assert colsum.shape == (3 * 3, 50) and sumsq.shape == (9, 4)
    blocks = o.reshape(3, 20, 50)
    for s in range(3):
        for t in range(3):
            rows = blocks[s, t * 8:(t + 1) * 8]
            assert torch.allclose(colsum[s * 3 + t], rows.sum(0), atol=1e-5)
            wts = torch.arange(rows.shape[0], dtype=torch.float32)
            assert torch.allclose(wcolsum[s * 3 + t], wts @ rows, atol=1e-4)
    assert torch.allclose(rowsum.sum(1), o.sum(1), atol=1e-4)
    assert rowsum.shape == (60, 4)


@pytest.mark.parametrize("stride,padding,groups", [
    (1, "VALID", 1), (2, "SAME", 1), (1, 1, 2), (2, [(1, 1), (1, 1)], 1)])
def test_conv2d_ref_matches_jax_and_the_conv(stride, padding, groups):
    """The im2col oracle agrees with the JAX package's and with the conv
    the port protects (F.conv2d with the same padding rule)."""
    from repro.kernels import ref as jref
    d = normal(0, (2, 4, 9, 9))
    w = normal(1, (6, 4 // groups, 3, 3))
    got = tref.conv2d_ref(torch.as_tensor(d), torch.as_tensor(w), stride,
                          padding, groups)
    want = jax.jit(jref.conv2d_ref, static_argnums=(2, 3, 4))(
        jnp.asarray(d), jnp.asarray(w), stride,
        padding if not isinstance(padding, list) else 1, groups)
    assert_close(got, want, 1e-5, 1e-4, "vs JAX")
    conv = TC.conv2d(torch.as_tensor(d), torch.as_tensor(w), stride,
                     padding, groups)
    assert_close(got, conv, 1e-5, 1e-4, "vs F.conv2d")
