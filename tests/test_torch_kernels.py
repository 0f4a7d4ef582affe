"""The port's kernels (repro_torch.kernels) against the JAX package's:
abft_matmul, abft_matmul_detect and checksum_reduce.

On this CPU host every wrapper takes its plain PyTorch version; they are
held against repro.kernels.ops' Pallas kernels in interpret mode, shape for
shape. test_torch_gpu.py holds each CUDA kernel against its plain
version on the card.

Tolerances: O and its sums are fp32 reassociations of the same terms -
rtol=1e-5, atol=1e-4*sqrt(K) for O, and for the epilogue partials the
1e-3*sqrt(K) of tests/test_kernels.py (a partial sums up to bm*bn
elements of O). On bf16 operands (cast from the same fp32 numpy values on
both sides, so bit-identical) the sums stay fp32 with those tolerances,
and O is one rounding of two fp32 sums to bf16: rtol 2^-7 (one bf16 ulp)
beside the same atol."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import checksums as JC  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import checksums as TC  # noqa: E402
from repro_torch.kernels import abft_matmul as TAM  # noqa: E402
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


# (torch dtype, jax dtype, rtol of O) of the operand types the kernels take
DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -7)}


def _mm_operands(n, k, m, seed):
    return normal(seed, (n, k)), normal(seed + 1, (k, m))


def _both(x, dtype):
    """A numpy fp32 array as bit-identical (jax, torch) arrays of dtype."""
    t, j, _ = DTYPES[dtype]
    return jnp.asarray(x).astype(j), torch.as_tensor(x).to(t)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", MM_SHAPES + MM_RAGGED)
def test_abft_matmul_matches_jax(shape, dtype):
    n, k, m = shape
    d, w = _mm_operands(n, k, m, seed=n + m)
    (d_j, d_t), (w_j, w_t) = _both(d, dtype), _both(w, dtype)
    o_j, parts_j = jops.abft_matmul(d_j, w_j, interpret=True)
    o_t, parts_t = tops.abft_matmul(d_t, w_t)
    assert parts_t[3:] == tuple(parts_j[3:]), (parts_t[3:], parts_j[3:])
    assert o_t.dtype == DTYPES[dtype][0] and o_j.dtype == DTYPES[dtype][1]
    assert_close(o_t.float(), np.asarray(o_j, np.float32), DTYPES[dtype][2],
                 1e-4 * k ** 0.5, "O")
    for a, b, name in zip(parts_t[:3], parts_j[:3],
                          ("colsum", "rowsum", "sumsq")):
        assert tuple(a.shape) == tuple(b.shape), name
        assert_close(a, b, 1e-5, 1e-3 * k ** 0.5, name)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", CR_SHAPES + CR_RAGGED)
def test_checksum_reduce_matches_jax(shape, dtype):
    o_j, o_t = _both(normal(sum(shape), shape), dtype)
    got = tops.checksum_reduce(o_t)
    want = jops.checksum_reduce(o_j, interpret=True)
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
    got = TCR.finish_conv_sums(colsum, sumsq, wcolsum, m, bm)
    want = JC.detect_sums(jnp.asarray(o), exact_order=True)
    for a, b, name in zip(got, want, ("s5", "s6", "s7", "sumsq")):
        scale = float(np.max(np.abs(np.atleast_1d(np.asarray(b))))) + 1.0
        assert_close(a, b, 0, 1e-4 * scale, name)


# ResNet-18's five conv output views at batch 2, channels narrowed, and a
# degenerate one (2x2 maps: no tile of >= 8 fits P = 4)
RESNET_VIEWS = [(2, 8, 112, 112), (2, 8, 56, 56), (2, 16, 28, 28),
                (2, 32, 14, 14), (2, 64, 7, 7), (2, 61, 2, 2)]


@pytest.mark.parametrize("oshape", RESNET_VIEWS)
def test_conv_sums_plain_matches_jax(oshape):
    """The conv detection sums' plain version (what ops.conv_detect_sums
    runs on a CPU tensor, and what the CUDA kernel is held against on the
    card) against the JAX package's Pallas route in interpret mode; on the
    degenerate view both return None and both detect_sums take the plain
    pass. rtol 1e-5, atol 1e-4 * (max|ref| + 1): fp32 reassociation over
    up to N*M terms per payload position and N*M*P for the sum of
    squares."""
    o = normal(sum(oshape), oshape)
    got = tops.conv_detect_sums(torch.as_tensor(o))
    want = jops.conv_detect_sums(jnp.asarray(o), interpret=True)
    assert (got is None) == (want is None)
    if want is None:
        got = TC.detect_sums(torch.as_tensor(o), use_kernel=True)
        want = JC.detect_sums(jnp.asarray(o))
    for a, b, name in zip(got, want, ("s5", "s6", "s7", "sumsq")):
        assert tuple(a.shape) == tuple(np.shape(b)), name
        scale = float(np.max(np.abs(np.atleast_1d(np.asarray(b))))) + 1.0
        assert_close(a, b, 1e-5, 1e-4 * scale, name)


def test_counter_sets_by_stream_and_capture(monkeypatch):
    """The counter sets the kernels' last blocks meet on
    (kernels/_counters.py): one per (device, stream) for eager launches,
    one per graph capture, a capture's set dropped at the next eager
    launch, and a set that is too short replaced by a zeroed longer one."""
    from repro_torch.kernels import _counters as TK
    monkeypatch.setattr(TK, "_EAGER", {})
    monkeypatch.setattr(TK, "_CAPTURED", {})
    cpu = torch.device("cpu")
    a = TK.held(cpu, 1, None, 10)
    assert a.dtype == torch.int32 and a.numel() >= 10 and not a.any()
    assert TK.held(cpu, 1, None, 20) is a
    assert TK.held(cpu, 2, None, 10) is not a
    g = TK.held(cpu, 1, 7, 10)
    assert g is not a and TK.held(cpu, 1, 7, 10) is g
    assert TK.held(cpu, 1, 8, 10) is not g
    assert TK.held(cpu, 1, None, 10) is a      # the captures have ended
    assert TK.held(cpu, 1, 7, 10) is not g
    big = TK.held(cpu, 1, None, TK.MIN_COUNTERS + 1)
    assert big is not a and big.numel() == TK.MIN_COUNTERS + 1
    assert not big.any() and TK.held(cpu, 1, None, 10) is big


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


# --------------------------------------------------------------------------
# abft_matmul_detect: the GEMM with the CoC-D compare in its epilogue
# --------------------------------------------------------------------------

# tests/test_kernels.py's shape, then the smoke model's sites at a 16-row
# prefill: wq/wk (K 64 -> 96 / 32 columns, chunks 48 / 32), down (K 96)
# and the tied head (512 columns, chunk 64)
DETECT_SHAPES = [(32, 64, 96, 16, 48), (16, 64, 96, 16, 48),
                 (16, 64, 32, 16, 32), (16, 96, 64, 16, 64),
                 (16, 64, 512, 16, 64)]
DETECT_DTYPES = {"float32": (jnp.float32, torch.float32),
                 "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _detect_case(n, k, m, rb, cb, jdt):
    """Operands in the working type and their exact per-chunk checksums
    (tests/test_kernels.py's oracle, in numpy)."""
    d = jnp.asarray(normal(n + k, (n, k))).astype(jdt)
    w = jnp.asarray(normal(k + m, (k, m))).astype(jdt)
    d32 = np.asarray(d.astype(jnp.float32))
    w32 = np.asarray(w.astype(jnp.float32))
    oc = (d32 @ w32).reshape(n // rb, rb, m // cb, cb)
    c5 = oc.sum(axis=(1, 3))
    c6 = np.einsum("arbc,r->ab", oc, np.arange(rb, dtype=np.float32))
    c7 = np.einsum("arbc,c->ab", oc, np.arange(cb, dtype=np.float32))
    absdot = (np.abs(d32) @ np.abs(w32)).reshape(oc.shape).sum(axis=(1, 3))
    return d, w, [x.astype(np.float32) for x in (c5, c6, c7, absdot)]


def _to_torch(x):
    """A jax array as a torch tensor, bit for bit (bf16 through uint16)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()
                                ).view(torch.bfloat16)
    return torch.as_tensor(a.copy())


@pytest.mark.parametrize("dtype", list(DETECT_DTYPES))
@pytest.mark.parametrize("shape", DETECT_SHAPES)
def test_abft_matmul_detect_matches_jax(shape, dtype):
    """The plain version of the detect kernel against the JAX package's
    Pallas kernel in interpret mode: clean checksums (no flag) and c5 of
    one chunk shifted (that chunk alone flags). Flags exactly equal;
    scores and O within rtol 1e-5, atol 1e-4*sqrt(K) (bf16: O within one
    bf16 ulp)."""
    from repro.core import thresholds as JTH
    n, k, m, rb, cb = shape
    jdt, tdt = DETECT_DTYPES[dtype]
    d, w, cs = _detect_case(n, k, m, rb, cb, jdt)
    tau_a, tau_b = JTH.tau_scalar_coeffs(k, jdt, 64.0)
    for tamper in (0.0, 5e3):
        c5 = cs[0].copy()
        c5[n // rb - 1, 0] += tamper
        o_j, f_j, s_j = jops.abft_matmul_detect(
            d, w, jnp.asarray(c5), *map(jnp.asarray, cs[1:]), rb=rb, cb=cb,
            tau_a=tau_a, tau_b=tau_b, interpret=True)
        o_t, f_t, s_t = tops.abft_matmul_detect(
            _to_torch(d), _to_torch(w), torch.as_tensor(c5),
            *map(torch.as_tensor, cs[1:]), rb=rb, cb=cb, tau_a=tau_a,
            tau_b=tau_b)
        assert o_t.dtype == tdt
        np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
        assert int(f_t.sum()) == (1 if tamper else 0)
        if tamper:
            assert int(f_t[n // rb - 1, 0]) == 1
        assert_close(s_t, s_j, 1e-5, 1e-4 * k ** 0.5, "score")
        if tdt == torch.float32:
            assert_close(o_t, o_j, 1e-5, 1e-4 * k ** 0.5, "O")
        else:
            o_j32 = np.asarray(o_j.astype(jnp.float32))
            ulp = np.abs(o_j32) * 2.0 ** -7 + 1e-30
            assert np.all(np.abs(o_t.float().numpy() - o_j32) <= ulp)


@pytest.mark.parametrize("n,k,m,rb,cb", [
    (32, 64, 96, 4, 48),      # row chunk below the minimum tile
    (32, 64, 96, 16, 36),     # column chunk that is no Pallas tile
    (32, 12, 96, 16, 48),     # K tile below the minimum
    (8, 64, 96, 8, 48),       # decode: 8 rows, tiles at the minimum
    (2, 64, 96, 2, 48),       # the smoke session's 2-slot decode
    (16, 64, 32, 16, 32)])
def test_abft_matmul_detect_refusal_rule_matches_jax(n, k, m, rb, cb):
    """On the CPU the port hands the same chunkings to the partials route
    (None) as the JAX package does, shape for shape."""
    d = np.zeros((n, k), np.float32)
    w = np.zeros((k, m), np.float32)
    z = np.zeros((n // rb, m // cb), np.float32)
    got = tops.abft_matmul_detect(torch.as_tensor(d), torch.as_tensor(w),
                                  *[torch.as_tensor(z)] * 4, rb=rb, cb=cb,
                                  tau_a=1.0, tau_b=1.0)
    want = jops.abft_matmul_detect(jnp.asarray(d), jnp.asarray(w),
                                   *[jnp.asarray(z)] * 4, rb=rb, cb=cb,
                                   tau_a=1.0, tau_b=1.0, interpret=True)
    assert (got is None) == (want is None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_detect_reads_a_transposed_w_as_a_contiguous_one(dtype):
    """The tied head's weight is the transposed view of the embedding
    table: both kernels give the same results on it as on a contiguous
    copy, and both round O identically."""
    n, k, m, rb, cb = 16, 64, 512, 16, 64
    d = torch.as_tensor(normal(1, (n, k))).to(dtype)
    table = torch.as_tensor(normal(2, (m, k))).to(dtype)
    wt = table.T
    assert not wt.is_contiguous()
    cs = [torch.as_tensor(x) for x in _detect_case(
        n, k, m, rb, cb, jnp.float32)[2]]
    view = TAM.abft_matmul_detect(d, wt, *cs, rb, cb, 1e-3, 1e-6)
    copy = TAM.abft_matmul_detect(d, wt.contiguous(), *cs, rb, cb, 1e-3,
                                  1e-6)
    for a, b in zip(view, copy):
        assert torch.equal(a, b)
    o, _ = TAM.abft_matmul(d, wt, 16, 64)
    assert torch.equal(o, view[0])
