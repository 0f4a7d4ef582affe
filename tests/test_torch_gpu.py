"""The port on the card: each CUDA kernel against its plain PyTorch
version, and the reduced CNN, serving and training slices through the
kernels.
Every test here is marked `gpu` and skips on a host without a CUDA card;
the file needs no JAX, so it runs on the GPU host as it is:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances as in test_torch_kernels.py: rtol=1e-5, atol=1e-4*sqrt(K) for
O, 1e-3*sqrt(K) for the epilogue partials, 1e-5 of the output's scale for
checksum_reduce's partials and 1e-4 for the finished detection sums
(fp32 reassociation only)."""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import checksums as TC  # noqa: E402
from repro_torch.kernels import abft_matmul as TAM  # noqa: E402
from repro_torch.kernels import checksum_reduce as TCR  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from torch_parity import (assert_close, cuda_device, normal,  # noqa: E402,F401
                          to_np)

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("shape", [(8, 512, 1000), (37, 520, 1000),
                                   (256, 64, 512), (300, 96, 130)])
@pytest.mark.parametrize("tiles", [None, (128, 128)])
def test_abft_matmul_kernel_on_card(cuda_device, shape, tiles):
    n, k, m = shape
    dc = torch.as_tensor(normal(7, (n, k)), device=cuda_device)
    wc = torch.as_tensor(normal(8, (k, m)), device=cuda_device)
    gm, gn = tiles or tops._granularity(n, k, m, 256, 256, 256)
    before = TAM.LAUNCHES
    o, parts = TAM.abft_matmul(dc, wc, gm, gn)
    torch.cuda.synchronize()
    assert TAM.LAUNCHES == before + 1
    o_ref, parts_ref = tref.abft_matmul_ref(dc, wc, gm, gn)
    assert_close(o, o_ref, 1e-5, 1e-4 * k ** 0.5, "O")
    for a, b, name in zip(parts[:3], parts_ref[:3],
                          ("colsum", "rowsum", "sumsq")):
        assert a.shape == b.shape, name
        assert_close(a, b, 1e-5, 1e-3 * k ** 0.5, name)


@pytest.mark.parametrize("oshape", [(8, 64, 112, 112), (8, 128, 28, 28),
                                    (8, 256, 14, 14), (8, 512, 7, 7),
                                    (2, 20, 14, 14), (2, 61, 2, 2),
                                    (2, 5, 1, 1)])
def test_checksum_reduce_kernel_on_card(cuda_device, oshape):
    """At every conv view, the degenerate ones the JAX package hands to
    its plain pass (2x2 and 1x1 maps, 5 channels) included, the kernel
    runs and agrees with its plain version."""
    o = torch.as_tensor(normal(1, oshape), device=cuda_device)
    n, m, e1, e2 = oshape
    p = e1 * e2
    bm, bn = tops.conv_tiles(m, p, on_card=True)
    o2 = o.reshape(n * m, p)
    before = TCR.LAUNCHES
    got = TCR.checksum_reduce(o2, bm, bn, segments=n)
    torch.cuda.synchronize()
    assert TCR.LAUNCHES == before + 1
    want = TCR.checksum_reduce_plain(o2, bm, bn, segments=n)
    for a, b, name in zip(got, want, ("colsum", "rowsum", "sumsq",
                                      "wcolsum")):
        assert a.shape == b.shape, name
        assert_close(a, b, 1e-5, 1e-5 * (float(b.abs().max()) + 1), name)
    before = TCR.LAUNCHES
    got = TC.detect_sums(o, use_kernel=True)
    assert TCR.LAUNCHES == before + 1
    for a, b in zip(got, TC.detect_sums(o)):
        assert_close(a, b, 0, 1e-4 * (float(b.abs().max()) + 1))


CONV_VIEWS = [(8, 64, 112, 112), (8, 128, 28, 28), (8, 256, 14, 14),
              (8, 512, 7, 7), (2, 20, 14, 14), (2, 61, 2, 2), (2, 5, 1, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("oshape", CONV_VIEWS)
def test_conv_sums_kernel_on_card(cuda_device, oshape, dtype):
    """The conv detection sums in one launch, at every conv view (16-byte
    rows, 4-byte ones of P = 49, 196 and 4, one column) and both types of
    O, against their plain version at the tiles conv_tiles gives on the
    card, and against the plain detection pass on the same values: atol
    1e-4 * (max|ref| + 1), fp32 reassociation only."""
    o = torch.as_tensor(normal(2, oshape)).to(cuda_device, dtype)
    n, m, e1, e2 = oshape
    before = TCR.LAUNCHES
    got = TCR.conv_sums(o)
    torch.cuda.synchronize()
    assert TCR.LAUNCHES == before + 1
    want = TCR.conv_sums_plain(o, *tops.conv_tiles(m, e1 * e2, on_card=True))
    for ref in (want, TC.detect_sums(o.float())):
        for a, b, name in zip(got, ref, ("s5", "s6", "s7", "sumsq")):
            assert a.shape == b.shape and a.dtype == torch.float32, name
            assert_close(a, b, 1e-5, 1e-4 * (float(b.abs().max()) + 1), name)


def _device_kernels(fn):
    """The device kernels one call of fn launches, by name (torch.profiler,
    after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = {e.key: e.count for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("Activity Buffer")}
    assert kernels, "the profiler saw no device kernel:\n" + events.table(
        row_limit=20)
    return kernels


@pytest.mark.parametrize("oshape", [(8, 64, 112, 112), (8, 512, 7, 7)])
def test_conv_sums_repeat_bitwise_and_leave_no_state(cuda_device, oshape):
    """Without row groups (conv0's view) and with 32 of them (7x7): the
    sums are bitwise the same over launches and replays of a CUDA graph
    (every sum in a fixed order, no float atomics), the counters the last
    blocks met on are zero again, and each call is one device kernel."""
    from repro_torch.kernels import _counters as TK
    o = torch.as_tensor(normal(3, oshape), device=cuda_device)
    before = TCR.LAUNCHES
    first = TCR.conv_sums(o)
    again = TCR.conv_sums(o)
    torch.cuda.synchronize()
    assert TCR.LAUNCHES == before + 2
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = TCR.conv_sums(o)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b, c in zip(first, again, captured):
            assert torch.equal(a, b) and torch.equal(a, c)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    dev = o.device
    assert not TK._EAGER[(dev, stream)].any()
    kernels = _device_kernels(lambda: TCR.conv_sums(o))
    assert sum(kernels.values()) == 1, kernels
    assert "conv_sums_kernel" in next(iter(kernels)), kernels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_detect_is_one_kernel(cuda_device, dtype):
    """abft_matmul_detect is one device kernel per call in both types (the
    chunk compare runs in the GEMM's launch), at the fc's shape. (Kept
    beside the other profiler test: run after the GEMM tests further down
    this file, torch.profiler on the card recorded this cluster kernel's
    launch call but not the kernel; alone, and in chip_smoke.py, it
    records both.)"""
    n, k, m, rb, cb = 8, 512, 1000, 8, 1000
    d = torch.as_tensor(normal(1, (n, k))).to(cuda_device, dtype)
    w = torch.as_tensor(normal(2, (k, m)) * k ** -0.5).to(cuda_device, dtype)
    cs = _chunk_checksums(d, w, rb, cb)
    before = TAM.DETECT_LAUNCHES
    kernels = _device_kernels(lambda: TAM.abft_matmul_detect(
        d, w, *cs, rb, cb, 1e-3, 1e-3))
    assert TAM.DETECT_LAUNCHES == before + 2
    assert sum(kernels.values()) == 1, kernels
    assert "gemm_kernel" in next(iter(kernels)), kernels


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    o = torch.zeros((16, 16), device=cuda_device, dtype=torch.float16)
    with pytest.raises(NotImplementedError):
        TCR.checksum_reduce(o, 8, 8)
    with pytest.raises(ValueError):
        TCR.checksum_reduce(torch.zeros((16, 32), device=cuda_device).T,
                            8, 8)
    d = torch.zeros((8, 8), device=cuda_device)
    with pytest.raises(ValueError):
        TAM.abft_matmul(d, d, 6, 8)
    with pytest.raises(ValueError):
        TAM.abft_matmul(d, d.cpu(), 8, 8)
    # no element-resolution plain pass on the card
    dc = torch.as_tensor(normal(4, (96, 32)), device=cuda_device)
    wc = torch.as_tensor(normal(5, (32, 160)), device=cuda_device)
    o, parts = TAM.abft_matmul(dc, wc, 32, 32)
    with pytest.raises(ValueError):
        tops.chunk_sums_from_partials(parts, 48, 32, o=o)


def test_protected_matmul_on_card_recombines_from_partials(cuda_device):
    """Kernel tiles that do not divide the detection chunk: the CPU path
    recombines at element resolution as the JAX package does; on the card
    the partials are cut to divide the chunk, so the kernel's partials are
    used and no plain pass runs."""
    from repro_torch.core import protected as TP
    d = torch.as_tensor(normal(3, (48, 96)))
    w = torch.as_tensor(normal(4, (96, 40)))
    cfg = tcore.ProtectConfig(use_fused_kernel=True, row_chunk=24,
                              col_chunk=40, kernel_tiles=(16, 16, 16))
    want, rep_cpu = TP.protected_matmul(d, w, cfg=cfg)
    before = TAM.LAUNCHES
    got, rep = TP.protected_matmul(d.to(cuda_device), w.to(cuda_device),
                                   cfg=cfg)
    assert TAM.LAUNCHES == before + 1
    assert int(rep.detected) == int(rep_cpu.detected) == 0
    assert_close(got, want, 1e-5, 1e-4 * 96 ** 0.5, "O")


def test_slice_on_card(cuda_device):
    """Reduced ResNet-18 on the card: every conv's detection pass and the
    fc GEMM go through the kernels (17 + 1 launches), clean logits are
    bitwise equal across modes and allclose to the CPU run. At img 64 the
    last four convs' outputs are 2x2, a view the JAX package (and the
    port's CPU path) hands to the plain pass: on the card the kernel takes
    it all the same."""
    cfg = dataclasses.replace(tcnn.resnet18(0.12), img=64)
    tp = tcnn.init_cnn(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    x = torch.as_tensor(normal(1, (2, 3, 64, 64)))

    def pinned(plan):
        return tcore.ProtectionPlan(
            {n: dataclasses.replace(e, cfg=e.cfg.replace(
                use_fused_kernel=True)) for n, e in plan.entries.items()},
            plan.meta)

    plan = pinned(tcore.build_plan(tp, cfg, batch=2, device="cpu"))
    l_cpu, _ = tcnn.forward_cnn(tp, x, cfg, plan=plan, device="cpu")
    tpc = {k: {kk: vv.to(cuda_device) for kk, vv in v.items()}
           for k, v in tp.items()}
    planc = pinned(tcore.build_plan(tpc, cfg, batch=2))
    out = {}
    for mode in ("per_layer", "deferred"):
        TCR.LAUNCHES = TAM.LAUNCHES = 0
        lg, rep = tcnn.forward_cnn(tpc, x.to(cuda_device), cfg, plan=planc,
                                   correction=mode)
        assert (TCR.LAUNCHES, TAM.LAUNCHES) == (17, 1)
        assert int(rep.detected) == 0
        out[mode] = lg
    assert torch.equal(out["per_layer"], out["deferred"])
    ref = to_np(l_cpu)
    np.testing.assert_allclose(to_np(out["per_layer"]), ref, rtol=1e-4,
                               atol=1e-4 * (float(np.abs(ref).max()) + 1))


# --------------------------------------------------------------------------
# abft_matmul_detect and bf16 operands
# --------------------------------------------------------------------------

def _chunk_checksums(d, w, rb, cb):
    """Exact per-chunk c5/c6/c7/absdot of the raw product (fp32)."""
    d32, w32 = d.float(), w.float()
    return [*tref.chunk_sums_ref(d32 @ w32, rb, cb)[:3],
            tref.chunk_sums_ref(d32.abs() @ w32.abs(), rb, cb)[0]]


# the serving path's shapes (decode 8 rows, prefill 128; wq/wk, down and
# the tied head read in place), the smoke model's, and row chunks smaller
# than the 64-row block tile
DETECT_CASES = [(8, 960, 960, 8, 960, False), (8, 960, 320, 8, 320, False),
                (8, 2560, 960, 8, 960, False), (8, 960, 49152, 8, 1024, True),
                (128, 960, 2560, 128, 640, False),
                (128, 960, 49152, 128, 1024, True),
                (16, 64, 32, 16, 32, False), (2, 64, 96, 2, 48, False),
                (40, 72, 96, 8, 48, False), (96, 72, 80, 32, 16, True),
                # more chunks per block tile than the bf16 block has threads
                (128, 40, 64, 1, 8, False)]


def test_kernel_tiling_is_read_from_the_source(cuda_device):
    """The wrappers size their buffers from the CUDA source's own tiling
    rule (tm, tn, seg, splits), one rule for both types: O^T = W^T D^T in
    blocks of 64 columns by the smallest of 8-128 rows that holds N, K (in
    tiles of 128 bytes: 64 bf16, 32 f32) split over up to 8 blocks (one
    cluster) so that tiles x splits reaches about 132. The detect segment
    divides both the tile's width and cb."""
    f32, bf16 = torch.float32, torch.bfloat16
    # the fc: 16 tiles x 8 splits of 2 K tiles
    assert TAM.kernel_tiling(8, 512, 1000, f32) == (8, 64, 0, 8)
    assert TAM.kernel_tiling(16, 960, 960, f32, 960) == (16, 64, 64, 8)
    assert TAM.kernel_tiling(17, 520, 640, f32, 640) == (32, 64, 64, 6)
    assert TAM.kernel_tiling(128, 64, 48, f32, 48) == (128, 64, 16, 2)
    # decode: 15 tiles of a 960-wide site, 15 K tiles of 64 -> 8 splits
    assert TAM.kernel_tiling(8, 960, 960, bf16, 960) == (8, 64, 64, 8)
    assert TAM.kernel_tiling(8, 960, 320, bf16) == (8, 64, 0, 8)
    assert TAM.kernel_tiling(8, 2560, 960, bf16) == (8, 64, 0, 8)
    # the head's 768 tiles fill the card without a split
    assert TAM.kernel_tiling(8, 960, 49152, bf16, 1024) == (8, 64, 64, 1)
    assert TAM.kernel_tiling(128, 960, 2560, bf16, 640) == (128, 64, 64, 4)
    assert TAM.kernel_tiling(17, 1000, 48, bf16, 48) == (32, 64, 16, 8)
    assert TAM.kernel_tiling(300, 64, 48, bf16) == (128, 64, 0, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,m,rb,cb,transposed", DETECT_CASES)
def test_abft_matmul_detect_kernel_on_card(cuda_device, n, k, m, rb, cb,
                                           transposed, dtype):
    """Flags exactly equal to the plain version's, scores and O allclose,
    O bitwise equal to abft_matmul's, and a shifted c5 flags exactly its
    chunk. A score is |c - s| / tau: the two versions sum s in other
    orders, and the threshold model prices that reassociation noise at
    about tau / tau_factor, so clean scores agree to 1e-2 (the flags,
    which decide, agree exactly)."""
    from repro_torch.core import thresholds as TTH
    d = torch.as_tensor(normal(n, (n, k))).to(cuda_device, dtype)
    if transposed:
        w = torch.as_tensor(normal(m, (m, k)) * k ** -0.5).to(
            cuda_device, dtype).T
    else:
        w = torch.as_tensor(normal(m, (k, m)) * k ** -0.5).to(
            cuda_device, dtype)
    cs = _chunk_checksums(d, w, rb, cb)
    tau_a, tau_b = TTH.tau_scalar_coeffs(k, dtype, 32.0)
    o_p, _ = TAM.abft_matmul(d, w, 8, 8)
    for tamper in (False, True):
        c5 = cs[0].clone()
        if tamper:
            tau5 = tau_a * float(torch.sqrt((o_p.float() ** 2).reshape(
                n // rb, rb, m // cb, cb).sum(dim=(1, 3)))[-1, 0]) \
                + tau_b * float(cs[3][-1, 0])
            c5[-1, 0] += 10.0 * tau5
        before = TAM.DETECT_LAUNCHES
        o, flag, score = TAM.abft_matmul_detect(d, w, c5, *cs[1:], rb, cb,
                                                tau_a, tau_b)
        torch.cuda.synchronize()
        assert TAM.DETECT_LAUNCHES == before + 1
        o_r, flag_r, score_r = tref.abft_matmul_detect_ref(
            d, w, c5, *cs[1:], rb, cb, tau_a, tau_b)
        assert torch.equal(flag, flag_r)
        assert int(flag.sum()) == int(tamper)
        if tamper:
            assert int(flag[-1, 0]) == 1
        assert_close(score, score_r, 1e-4, 1e-2, "score")
        assert_close(o.float(), o_r.float(), 1e-2 if dtype != torch.float32
                     else 1e-5, 1e-4 * k ** 0.5, "O")
        assert torch.equal(o, o_p), "detect and partials kernels round O " \
            "differently"


def _mainloop_case(dev, dtype, n, transposed, k, m):
    """O bitwise equal between abft_matmul and abft_matmul_detect, bitwise
    equal O, flags and scores on a second call (the split-K sum is taken in
    a fixed order), flags equal to the plain version's and clear; returns
    the kernel's O and the plain version's."""
    from repro_torch.core import thresholds as TTH
    d = torch.as_tensor(normal(n, (n, k))).to(dev, dtype)
    if transposed:
        w = torch.as_tensor(normal(m, (m, k)) * k ** -0.5).to(dev, dtype).T
    else:
        w = torch.as_tensor(normal(m, (k, m)) * k ** -0.5).to(dev, dtype)
    assert TAM.kernel_tiling(n, k, m, dtype, m).splits > 1
    cs = _chunk_checksums(d, w, n, m)
    tau_a, tau_b = TTH.tau_scalar_coeffs(k, dtype, 32.0)
    runs = [TAM.abft_matmul_detect(d, w, *cs, n, m, tau_a, tau_b)
            for _ in range(2)]
    o_p, _ = TAM.abft_matmul(d, w, 8, 8)
    o_r, flag_r, _ = tref.abft_matmul_detect_ref(d, w, *cs, n, m, tau_a,
                                                  tau_b)
    torch.cuda.synchronize()
    (o, flag, score), again = runs
    for a, b in zip((o, flag, score), again):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert torch.equal(o, o_p), "detect and partials kernels round O " \
        "differently"
    assert torch.equal(flag, flag_r) and int(flag.sum()) == 0
    return o, o_r


MAINLOOP_CASES = [(n, transposed, k, m) for n in (1, 8, 16, 17, 32, 64, 128)
                  for transposed in (False, True)
                  for k, m in ((1000, 200), (997, 203))]


@pytest.mark.parametrize("n,transposed,k,m", MAINLOOP_CASES)
def test_bf16_mainloop_is_deterministic_and_shared(cuda_device, n,
                                                   transposed, k, m):
    """The bf16 wgmma mainloop at every row tile, both W layouts, a K that
    the 64-wide K tiles and the split leave ragged (1000: 16-byte rows,
    copied asynchronously; 997 x 203: rows that are not, loaded element
    by element): _mainloop_case's contracts, and O within one bf16 ulp of
    the plain version."""
    o, o_r = _mainloop_case(cuda_device, torch.bfloat16, n, transposed, k, m)
    ulp = o_r.float().abs() * 2.0 ** -7 + 1e-6
    assert bool(((o.float() - o_r.float()).abs() <= ulp).all())


@pytest.mark.parametrize("n,transposed,k,m", MAINLOOP_CASES)
def test_f32_mainloop_is_deterministic_and_shared(cuda_device, n,
                                                  transposed, k, m):
    """The f32 FMA mainloop at every row tile, both W layouts, a K that
    the 32-wide K tiles and the split leave ragged (1000: 16-byte rows;
    997 x 203: rows that are not): _mainloop_case's contracts, and O
    within fp32 reassociation of the plain version (rtol 1e-5, atol
    1e-4 * sqrt(K))."""
    o, o_r = _mainloop_case(cuda_device, torch.float32, n, transposed, k, m)
    assert_close(o, o_r, 1e-5, 1e-4 * k ** 0.5, "O")


def test_bf16_detect_keeps_no_state_between_launches(cuda_device):
    """The bf16 detect launch meets a chunk's tiles on counters that no
    other launch uses at the same time: launches issued on two streams at
    once, and two CUDA graphs captured one after the other, before an
    eager launch with more chunks and replayed in turns after it, each
    flag exactly the chunk its shifted c5 names, as the plain version
    does."""
    from repro_torch.core import thresholds as TTH
    bf16 = torch.bfloat16
    n, k, m, rb, cb = 8, 960, 2560, 8, 128
    tau_a, tau_b = TTH.tau_scalar_coeffs(k, bf16, 32.0)
    w = torch.as_tensor(normal(m, (k, m)) * k ** -0.5).to(cuda_device, bf16)

    def case(seed, j):
        d = torch.as_tensor(normal(seed, (n, k))).to(cuda_device, bf16)
        cs = _chunk_checksums(d, w, rb, cb)
        o = (d.float() @ w.float())[:, j * cb:(j + 1) * cb]
        cs[0][0, j] += 10.0 * (tau_a * float(o.norm())
                               + tau_b * float(cs[3][0, j]))
        args = (d, w, *cs, rb, cb, tau_a, tau_b)
        flag_r = tref.abft_matmul_detect_ref(*args)[1]
        assert int(flag_r.sum()) == 1 and int(flag_r[0, j]) == 1
        return args, flag_r

    cases = [case(1, 3), case(2, 17)]
    streams = [torch.cuda.Stream(cuda_device) for _ in cases]
    torch.cuda.synchronize()
    flags = [[], []]
    for _ in range(8):
        for i, (args, _) in enumerate(cases):
            with torch.cuda.stream(streams[i]):
                flags[i].append(TAM.abft_matmul_detect(*args)[1])
    torch.cuda.synchronize()
    for (_, flag_r), got in zip(cases, flags):
        assert all(torch.equal(f, flag_r) for f in got)

    graphs, captured = [], []
    for args, _ in cases:
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            captured.append(TAM.abft_matmul_detect(*args)[1])
    d = cases[1][0][0]
    more = TAM.abft_matmul_detect(d, w, *_chunk_checksums(d, w, 1, 32), 1,
                                  32, tau_a, tau_b)[1]
    for _ in range(2):
        for graph, flag, (_, flag_r) in zip(graphs, captured, cases):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(flag, flag_r)
    assert more.shape == (n, m // 32) and int(more.sum()) == 0


@pytest.mark.parametrize("transposed", [False, True])
def test_bf16_accumulation_keeps_fp32_rounding(cuda_device, transposed):
    """wgmma's accumulators truncate toward zero; summed over all of K they
    drift from IEEE fp32 accumulation, which the thresholds price. The
    mainloop adds each K stage's sum in fp32 registers instead, so the
    kernel's fp32 O (colsum at one-row tiles) stays as close to the exact
    product as cuBLAS's fp32 one: rms error and bias toward zero each at
    most cuBLAS's rms error times 2 and 1, at a K of 2560 on 132 tiles (no
    split). Summed by wgmma over all of K, both are an order of magnitude
    larger."""
    n, k, m = 16, 2560, 8448
    bf16 = torch.bfloat16
    d = torch.as_tensor(normal(1, (n, k))).to(cuda_device, bf16)
    if transposed:
        w = torch.as_tensor(normal(2, (m, k)) * k ** -0.5).to(
            cuda_device, bf16).T
    else:
        w = torch.as_tensor(normal(2, (k, m)) * k ** -0.5).to(
            cuda_device, bf16)
    assert TAM.kernel_tiling(n, k, m, bf16).splits == 1
    _, (o32, _, _, _, _) = TAM.abft_matmul(d, w, 1, 1)
    exact = d.double() @ w.double()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref32 = d.float() @ w.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    err = o32.double() - exact
    rms = float(err.pow(2).mean().sqrt())
    rms_ref = float((ref32.double() - exact).pow(2).mean().sqrt())
    bias = float((err * exact.sign()).mean())
    assert rms <= 2.0 * rms_ref, (rms, rms_ref)
    assert abs(bias) <= rms_ref, (bias, rms_ref)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("shape", [(8, 512, 1000), (16, 2560, 8448)])
def test_f32_accumulation_keeps_ieee_rounding(cuda_device, shape,
                                              transposed):
    """The f32 mainloop sums each element by fp32 FMA (IEEE, round to
    nearest), which the thresholds price: against the float64 product its
    O's rms error and bias toward zero are each at most cuBLAS's fp32 rms
    error times 2 and 1, at the fc's shape (8 splits) and at a K of 2560
    on 132 tiles (no split)."""
    n, k, m = shape
    f32 = torch.float32
    d = torch.as_tensor(normal(1, (n, k)), device=cuda_device)
    if transposed:
        w = torch.as_tensor(normal(2, (m, k)) * k ** -0.5,
                            device=cuda_device).T
    else:
        w = torch.as_tensor(normal(2, (k, m)) * k ** -0.5,
                            device=cuda_device)
    o, _ = TAM.abft_matmul(d, w, 1, 1)
    exact = d.double() @ w.double()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref32 = d @ w
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert o.dtype == f32
    err = o.double() - exact
    rms = float(err.pow(2).mean().sqrt())
    rms_ref = float((ref32.double() - exact).pow(2).mean().sqrt())
    bias = float((err * exact.sign()).mean())
    assert rms <= 2.0 * rms_ref, (rms, rms_ref)
    assert abs(bias) <= rms_ref, (bias, rms_ref)


@pytest.mark.parametrize("shape", [(8, 960, 2560), (128, 2560, 960),
                                   (37, 520, 1000)])
def test_abft_matmul_bf16_on_card(cuda_device, shape):
    n, k, m = shape
    d = torch.as_tensor(normal(1, (n, k))).to(cuda_device, torch.bfloat16)
    w = torch.as_tensor(normal(2, (k, m)) * k ** -0.5).to(
        cuda_device, torch.bfloat16)
    gm, gn = tops._tile(n, 256), tops._tile(m, 256)
    o, parts = TAM.abft_matmul(d, w, gm, gn)
    o_r, parts_r = tref.abft_matmul_ref(d, w, gm, gn)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16
    # one rounding of two fp32 sums that differ by reassociation only
    ulp = o_r.float().abs() * 2.0 ** -7 + 1e-6
    assert bool(((o.float() - o_r.float()).abs() <= ulp).all())
    for a, b, name in zip(parts[:3], parts_r[:3],
                          ("colsum", "rowsum", "sumsq")):
        assert a.shape == b.shape, name
        assert_close(a, b, 1e-5, 1e-3 * k ** 0.5, name)


def test_serving_slice_on_card(cuda_device):
    """A two-layer bf16 SmolLM-360M twin served on the card through the
    kernels: zero clean flags, every protected site of every deferred
    forward on abft_matmul_detect (15 per forward) and of every per_layer
    forward on abft_matmul, and the same tokens in both modes."""
    import repro_torch.configs as TCF
    from repro_torch.core import workflow as TW
    from repro_torch.models import transformer as TM
    from repro_torch.serving import ProtectedSession
    cfg = TCF.get("smollm-360m-smoke").replace(dtype="bfloat16")
    params = TM.init_params(cfg, device=cuda_device)
    plan = tcore.force_fused_matmul(tcore.build_plan(
        params, cfg, batch=4, seq=32, device=cuda_device))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 9, 12, 7)]
    tokens = {}
    for mode in ("deferred", "per_layer"):
        TAM.LAUNCHES = TAM.DETECT_LAUNCHES = TW.HOST_READS = 0
        sess = ProtectedSession(params, cfg, plan, slots=4, max_len=32,
                                correction=mode, device=cuda_device)
        rids = [sess.submit(p, max_new_tokens=6) for p in prompts]
        report = sess.run()
        c = report["counters"]
        forwards = c["prefills"] + c["decode_steps"]
        assert c["faults_detected"] == 0 and report["completed"] == 4
        if mode == "deferred":
            assert (TAM.DETECT_LAUNCHES, TAM.LAUNCHES) == (15 * forwards, 0)
            assert TW.HOST_READS == forwards
        else:
            assert (TAM.DETECT_LAUNCHES, TAM.LAUNCHES) == (0, 15 * forwards)
            assert TW.HOST_READS == 15 * forwards
        tokens[mode] = [sess.tokens_for(r) for r in rids]
    assert tokens["deferred"] == tokens["per_layer"]


# Mamba2-1.3B's GEMM sites (in_proj, out_proj and the untied head) at an
# exact-length prefill of 97 rows: a 97-row chunk with 1-row partial tiles,
# column chunks of 608, 1024 and 838 (2-wide partial tiles and detect
# segments at the head, whose last 64-wide block tile holds 40 columns)
MAMBA_SITES = [(2048, 8512), (4096, 2048), (2048, 50280)]


@pytest.mark.parametrize("k,m", MAMBA_SITES)
def test_kernels_at_mamba_shapes_on_card(cuda_device, k, m):
    """Both kernels at 97 rows against their plain versions: flags equal
    and clear, O within one bf16 ulp plus the fp32 summation noise and
    bitwise equal between the two kernels, the partials allclose and
    finished into chunk sums on the card; checksums predicting +1e4 at
    one element flag exactly that element's chunk."""
    from repro_torch.core.plan import calibrate_tau_factor
    from repro_torch.core.protected import pick_chunk
    from repro_torch.core import thresholds as TTH
    n, bf16 = 97, torch.bfloat16
    d = torch.as_tensor(normal(n, (n, k))).to(cuda_device, bf16)
    w = torch.as_tensor(normal(m, (k, m)) * k ** -0.5).to(cuda_device, bf16)
    rb, cb = pick_chunk(n, 1024), pick_chunk(m, 1024)
    bm, bn = tops._tile(rb, 256), tops._tile(cb, 256)
    assert (rb, bm) == (97, 1)
    tau_a, tau_b = TTH.tau_scalar_coeffs(k, bf16, calibrate_tau_factor(k))
    cs = _chunk_checksums(d, w, rb, cb)
    o, flag, score = TAM.abft_matmul_detect(d, w, *cs, rb, cb, tau_a, tau_b)
    o_r, flag_r, _ = tref.abft_matmul_detect_ref(d, w, *cs, rb, cb, tau_a,
                                                  tau_b)
    o_p, parts = TAM.abft_matmul(d, w, bm, bn)
    _, parts_r = tref.abft_matmul_ref(d, w, bm, bn)
    torch.cuda.synchronize()
    assert torch.equal(flag, flag_r) and int(flag.sum()) == 0
    assert torch.equal(o, o_p)
    absdot = d.float().abs() @ w.float().abs()
    tol = o_r.float().abs() * 2.0 ** -7 + 2.0 ** -21 * k ** 0.5 * absdot
    assert bool(((o.float() - o_r.float()).abs() <= tol).all())
    for a, b, name in zip(parts[:3], parts_r[:3],
                          ("colsum", "rowsum", "sumsq")):
        assert a.shape == b.shape, name
        assert_close(a, b, 1e-5, 1e-3 * k ** 0.5, name)
    for a, b in zip(tops.chunk_sums_from_partials(parts, rb, cb),
                    tops.chunk_sums_from_partials(parts_r, rb, cb)):
        assert_close(a, b, 1e-5, 1e-4 * float(b.abs().max()), "chunk sums")
    r, c = 41, m - 3
    p = d.float() @ w.float()
    p[r, c] += 1e4
    bad = [*tref.chunk_sums_ref(p, rb, cb)[:3], cs[3]]
    _, flag_t, _ = TAM.abft_matmul_detect(d, w, *bad, rb, cb, tau_a, tau_b)
    want = torch.zeros_like(flag_t)
    want[r // rb, c // cb] = 1
    assert torch.equal(flag_t, want)


def test_ssm_on_card_matches_cpu(cuda_device):
    """The reduced Mamba2-1.3B (fp32) on the card: the uncached forward,
    a prefill of 11 (the padding branch) and 3 decode steps agree with the
    same params on the CPU, logits and states, with the cache types of
    the CPU run."""
    import repro_torch.configs as TCF
    from repro_torch.models import transformer as TM
    cfg = TCF.get("mamba2-1.3b-smoke").replace(abft=False)
    p_cpu = TM.init_params(cfg, device="cpu")
    p_gpu = TM.init_params(cfg, device=cuda_device)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 11)))
    outs = {}
    for dev, params in (("cpu", p_cpu), ("gpu", p_gpu)):
        t = toks.to(params["embed"]["table"].device)
        full = TM.forward_train(params, t, cfg)[0]
        logits, _, caches = TM.prefill(params, t, cfg, 16)
        steps = [logits]
        for i in range(3):
            nxt = torch.argmax(steps[-1], dim=-1)
            logits, _, caches = TM.decode_step(params, nxt, caches, 11 + i,
                                               cfg)
            steps.append(logits)
        outs[dev] = (full, steps, caches["stages"]["b0_ssm"])
    (f_c, s_c, c_c), (f_g, s_g, c_g) = outs["cpu"], outs["gpu"]
    assert_close(f_g, f_c, 1e-4, 1e-4, "uncached forward")
    for i, (a, b) in enumerate(zip(s_g, s_c)):
        assert_close(a, b, 1e-4, 1e-4, f"logits {i}")
    for k in ("h", "conv"):
        assert c_g[k].dtype == c_c[k].dtype
        assert_close(c_g[k], c_c[k], 1e-4, 1e-4, k)


def test_ssm_serving_on_card(cuda_device):
    """A two-layer bf16 Mamba2-1.3B twin served on the card through the
    kernels: zero clean flags, every protected site of every deferred
    forward on abft_matmul_detect (5 per forward: 2 sites x 2 repeats +
    the head) and of every per_layer forward on abft_matmul, exact
    prefills of odd lengths, and the same tokens in both modes."""
    import repro_torch.configs as TCF
    from repro_torch.core import workflow as TW
    from repro_torch.models import transformer as TM
    from repro_torch.serving import ProtectedSession
    cfg = TCF.get("mamba2-1.3b-smoke").replace(dtype="bfloat16")
    params = TM.init_params(cfg, device=cuda_device)
    plan = tcore.force_fused_matmul(tcore.build_plan(
        params, cfg, batch=4, seq=32, device=cuda_device))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 9, 13, 7, 3)]
    tokens = {}
    for mode in ("deferred", "per_layer"):
        TAM.LAUNCHES = TAM.DETECT_LAUNCHES = TW.HOST_READS = 0
        sess = ProtectedSession(params, cfg, plan, slots=4, max_len=32,
                                correction=mode, device=cuda_device)
        rids = [sess.submit(p, max_new_tokens=6) for p in prompts]
        report = sess.run()
        c = report["counters"]
        forwards = c["prefills"] + c["decode_steps"]
        assert c["faults_detected"] == 0 and report["completed"] == 5
        if mode == "deferred":
            assert (TAM.DETECT_LAUNCHES, TAM.LAUNCHES) == (5 * forwards, 0)
            assert TW.HOST_READS == forwards
        else:
            assert (TAM.DETECT_LAUNCHES, TAM.LAUNCHES) == (0, 5 * forwards)
            assert TW.HOST_READS == 5 * forwards
        tokens[mode] = [sess.tokens_for(r) for r in rids]
    assert tokens["deferred"] == tokens["per_layer"]


def test_rglru_on_card_matches_cpu(cuda_device):
    """One RG-LRU block of the reduced RecurrentGemma-2B (fp32) on the
    card: the scan from a carried state (a prefill of 11) and the one-step
    decode update agree with the same params and inputs on the CPU,
    output and new state, in the CPU run's types."""
    import repro_torch.configs as TCF
    from repro_torch.layers import rglru as TR
    cfg = TCF.get("recurrentgemma-2b-smoke")
    p_cpu = TR.init_rglru(torch.Generator().manual_seed(0), cfg,
                          torch.float32, "cpu")
    p_gpu = {k: ({kk: t.to(cuda_device) for kk, t in v.items()}
                 if isinstance(v, dict) else v.to(cuda_device))
             for k, v in p_cpu.items()}
    state = TR.init_rglru_state(cfg, 2, "cpu")
    state["h"] = torch.as_tensor(normal(3, (2, cfg.lru_width), 0.3))
    for s in (11, 1):
        x = torch.as_tensor(normal(s, (2, s, cfg.d_model)))
        oc, _, nc = TR.apply_rglru(p_cpu, x, cfg, None, state)
        og, _, ng = TR.apply_rglru(
            p_gpu, x.to(cuda_device), cfg, None,
            {k: t.to(cuda_device) for k, t in state.items()})
        assert_close(og, oc, 1e-4, 1e-4, f"out at {s} rows")
        for k in ("h", "conv"):
            assert ng[k].dtype == nc[k].dtype, k
            assert_close(ng[k], nc[k], 1e-4, 1e-4, f"{k} at {s} rows")
        state = nc


def test_rglru_serving_on_card(cuda_device):
    """The reduced RecurrentGemma-2B at 5 layers in bf16 served on the
    card through the kernels: zero clean flags, every protected site of
    every deferred forward on abft_matmul_detect (40 per forward: 4 rec
    blocks x 5, one attn_swa x 4, 5 ffns x 3, the tied head) and of every
    per_layer forward on abft_matmul, exact prefills past the window of 8,
    and the same tokens in both modes."""
    import repro_torch.configs as TCF
    from repro_torch.core import workflow as TW
    from repro_torch.models import transformer as TM
    from repro_torch.serving import ProtectedSession
    cfg = TCF.get("recurrentgemma-2b-smoke").replace(dtype="bfloat16",
                                                      num_layers=5)
    params = TM.init_params(cfg, device=cuda_device)
    plan = tcore.force_fused_matmul(tcore.build_plan(
        params, cfg, batch=4, seq=32, device=cuda_device))
    assert len(plan) == 40
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n)
               for n in (10, 13, 9, 17, 3)]
    tokens = {}
    for mode in ("deferred", "per_layer"):
        TAM.LAUNCHES = TAM.DETECT_LAUNCHES = TW.HOST_READS = 0
        sess = ProtectedSession(params, cfg, plan, slots=4, max_len=32,
                                correction=mode, device=cuda_device)
        rids = [sess.submit(p, max_new_tokens=6) for p in prompts]
        report = sess.run()
        c = report["counters"]
        forwards = c["prefills"] + c["decode_steps"]
        assert c["faults_detected"] == 0 and report["completed"] == 5
        if mode == "deferred":
            assert (TAM.DETECT_LAUNCHES, TAM.LAUNCHES) == (40 * forwards, 0)
            assert TW.HOST_READS == forwards
        else:
            assert (TAM.DETECT_LAUNCHES, TAM.LAUNCHES) == (0, 40 * forwards)
            assert TW.HOST_READS == 40 * forwards
        tokens[mode] = [sess.tokens_for(r) for r in rids]
    assert tokens["deferred"] == tokens["per_layer"]


# MusicGen-large's GEMM sites (attention 2048 x 2048, gate/up and the
# 4-codebook head 2048 x 8192, down 8192 x 2048) at a decode step's 8 rows
# and a 128-row prefill bucket; 1024-wide column chunks
MUSICGEN_SITES = [(8, 2048, 2048), (8, 2048, 8192), (8, 8192, 2048),
                  (128, 2048, 2048), (128, 2048, 8192), (128, 8192, 2048)]


@pytest.mark.parametrize("n,k,m", MUSICGEN_SITES)
def test_detect_at_musicgen_shapes_on_card(cuda_device, n, k, m):
    """abft_matmul_detect at MusicGen-large's shapes against its plain
    version: flags equal and clear, O within one bf16 ulp plus the fp32
    summation noise and bitwise abft_matmul's; checksums predicting +1e4
    at one element flag exactly that element's chunk."""
    from repro_torch.core.plan import calibrate_tau_factor
    from repro_torch.core.protected import pick_chunk
    from repro_torch.core import thresholds as TTH
    bf16 = torch.bfloat16
    d = torch.as_tensor(normal(n, (n, k))).to(cuda_device, bf16)
    w = torch.as_tensor(normal(m, (k, m)) * k ** -0.5).to(cuda_device, bf16)
    rb, cb = pick_chunk(n, 1024), pick_chunk(m, 1024)
    tau_a, tau_b = TTH.tau_scalar_coeffs(k, bf16, calibrate_tau_factor(k))
    cs = _chunk_checksums(d, w, rb, cb)
    o, flag, _ = TAM.abft_matmul_detect(d, w, *cs, rb, cb, tau_a, tau_b)
    o_r, flag_r, _ = tref.abft_matmul_detect_ref(d, w, *cs, rb, cb, tau_a,
                                                  tau_b)
    o_p, _ = TAM.abft_matmul(d, w, tops._tile(rb, 256), tops._tile(cb, 256))
    torch.cuda.synchronize()
    assert torch.equal(flag, flag_r) and int(flag.sum()) == 0
    assert torch.equal(o, o_p)
    absdot = d.float().abs() @ w.float().abs()
    tol = o_r.float().abs() * 2.0 ** -7 + 2.0 ** -21 * k ** 0.5 * absdot
    assert bool(((o.float() - o_r.float()).abs() <= tol).all())
    r, c = n - 3, m - 5
    p = d.float() @ w.float()
    p[r, c] += 1e4
    bad = [*tref.chunk_sums_ref(p, rb, cb)[:3], cs[3]]
    _, flag_t, _ = TAM.abft_matmul_detect(d, w, *bad, rb, cb, tau_a, tau_b)
    want = torch.zeros_like(flag_t)
    want[r // rb, c // cb] = 1
    assert torch.equal(flag_t, want)


def test_musicgen_serving_on_card(cuda_device):
    """The reduced MusicGen-large in bf16 served on the card through the
    kernels with (S, 4) prompts: zero clean flags, every protected site of
    every deferred forward on abft_matmul_detect (15 per forward: 7 sites
    x 2 repeats + the K·V head) and of every per_layer forward on
    abft_matmul, K-list tokens, the same ones in both modes."""
    import repro_torch.configs as TCF
    from repro_torch.core import workflow as TW
    from repro_torch.models import transformer as TM
    from repro_torch.serving import ProtectedSession
    cfg = TCF.get("musicgen-large-smoke").replace(dtype="bfloat16")
    params = TM.init_params(cfg, device=cuda_device)
    plan = tcore.force_fused_matmul(tcore.build_plan(
        params, cfg, batch=4, seq=32, device=cuda_device))
    assert len(plan) == 8
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n, 4))
               for n in (5, 9, 13, 7, 3)]
    tokens = {}
    for mode in ("deferred", "per_layer"):
        TAM.LAUNCHES = TAM.DETECT_LAUNCHES = TW.HOST_READS = 0
        sess = ProtectedSession(params, cfg, plan, slots=4, max_len=32,
                                correction=mode, device=cuda_device)
        rids = [sess.submit(p, max_new_tokens=6) for p in prompts]
        report = sess.run()
        c = report["counters"]
        forwards = c["prefills"] + c["decode_steps"]
        assert c["faults_detected"] == 0 and report["completed"] == 5
        if mode == "deferred":
            assert (TAM.DETECT_LAUNCHES, TAM.LAUNCHES) == (15 * forwards, 0)
            assert TW.HOST_READS == forwards
        else:
            assert (TAM.DETECT_LAUNCHES, TAM.LAUNCHES) == (0, 15 * forwards)
            assert TW.HOST_READS == 15 * forwards
        tokens[mode] = [sess.tokens_for(r) for r in rids]
        assert all(len(t) == 6 and all(len(x) == 4 for x in t)
                   for t in tokens[mode])
    assert tokens["deferred"] == tokens["per_layer"]


@pytest.mark.parametrize("arch", ["musicgen-large-smoke",
                                  "kimi-k2-1t-a32b-smoke",
                                  "mamba2-1.3b-smoke",
                                  "recurrentgemma-2b-smoke"])
def test_init_draws_on_a_card_generator(cuda_device, arch):
    """init_params with a CUDA generator draws on its card: one seed gives
    the same params twice, every leaf on the card; a CPU generator still
    gives the host's draws, moved to the card bitwise."""
    import repro_torch.configs as TCF
    from repro_torch._tree import tree_leaves
    from repro_torch.models import transformer as TM
    cfg = TCF.get(arch)
    card = [TM.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0),
        device=cuda_device) for _ in range(2)]
    for x, y in zip(*map(tree_leaves, card)):
        assert x.device.type == "cuda" and torch.equal(x, y)
    host = [TM.init_params(cfg, torch.Generator().manual_seed(0),
                           device=dev) for dev in (cuda_device, "cpu")]
    for x, y in zip(*map(tree_leaves, host)):
        assert x.device.type == "cuda" and torch.equal(x.cpu(), y)


@pytest.mark.parametrize("layer", ["matmul", "conv", "transformer_gemm"])
def test_campaign_cell_per_layer_on_card(cuda_device, layer):
    """64 trials of every registered arm of one layer on the card, in the
    full and deferred schemes: every gate of the campaign's check holds,
    and deferred gives full's detection rate and scheme histogram."""
    from repro_torch.campaign import CampaignEngine, CampaignResult
    from repro_torch.campaign.run import check
    eng = CampaignEngine(device=cuda_device)
    res = eng.run([layer], ["full", "deferred"], trials=64, seed=0)
    assert check(res) == []
    assert res.meta["device"] == torch.cuda.get_device_name(cuda_device)
    for c in res.cells:
        if c.scheme == "deferred":
            f = res.cell(layer, "full", c.fault)
            assert c.detection_rate == f.detection_rate, c.fault
            assert c.corrected_by == f.corrected_by, c.fault
    assert isinstance(res, CampaignResult)


def test_weight_repair_on_card_matches_cpu(cuda_device):
    """The campaign's f32 repair and the audit's float64 repair on the
    card give the CPU's verdicts; the float64 repairs are bitwise the
    CPU's (and the clean weight), the f32 ones within the campaign's
    tolerance."""
    from repro_torch.core import weight_repair as WR
    from repro_torch.runtime import ft
    w = normal(2, (3, 96, 256))
    wlc = tcore.stacked_weight_locators_matmul(torch.as_tensor(w), 64)
    cases = []
    one = w.copy()
    one[1, 40, 70] += 977.0
    col = w.copy()
    col[2, :, 130] = 2.0 ** 9
    two = w.copy()
    two[0, 3, 3] += 977.0
    two[2, 5, 200] -= 55.0
    cases = [(one, WR.REPAIRED), (col, WR.REPAIRED), (two, WR.ESCALATE),
             (w, WR.CLEAN)]
    for bad, want in cases:
        for dtype, rtol in ((torch.float64, WR.HOST_RTOL),
                            (torch.float32, WR.REPAIR_RTOL)):
            tol = float(WR.locator_tol(wlc, rtol))
            out = {}
            for dev in ("cpu", cuda_device):
                f, v = WR.repair_stacked_matmul_weight(
                    torch.as_tensor(bad).to(dev), wlc, tol, dtype=dtype)
                out[str(dev)] = (f.to(torch.float32).cpu(), int(v))
            (fc, vc), (fg, vg) = out.values()
            assert vc == vg == want, (dtype, want)
            if dtype == torch.float64:
                assert torch.equal(fc, fg)
                if want == WR.REPAIRED:
                    assert torch.equal(fg, torch.as_tensor(w))
            else:
                assert_close(fg, fc, 0, 2e-2, "f32 repair")
    # the audit ladder through a plan on the card: bf16 leaf, bitwise
    wb = torch.as_tensor(normal(4, (256, 192))).to(torch.bfloat16)
    plans = {dev: tcore.ProtectionPlan(entries={"fc": tcore.matmul_entry(
        "fc", wb.to(dev), tcore.DEFAULT_CONFIG.replace(col_chunk=64))})
        for dev in ("cpu", "cuda")}
    leaves = {}
    for dev, plan in plans.items():
        bad = wb.to(dev).clone()
        bad[17, 100] = 300.0
        ok, flagged = ft.audit_weights_against_plan({"fc": {"w": bad}}, plan)
        assert not ok
        fixed, repaired = ft.repair_weights_against_plan(
            {"fc": {"w": bad}}, plan, flagged)
        assert repaired == ["fc"]
        leaves[dev] = tcore.weight_leaf(fixed, "fc").cpu()
    assert torch.equal(leaves["cpu"].view(torch.int16),
                       leaves["cuda"].view(torch.int16))
    assert torch.equal(leaves["cuda"].view(torch.int16), wb.view(torch.int16))


# the H100 SXM's datasheet corners: fp32 outside the tensor cores, HBM3
H100_FP32_FLOPS, H100_HBM_BYTES = 67e12, 3.35e12


def test_measure_peaks_on_card(cuda_device, tmp_path):
    """The card's calibration is measured (never the CPU fallback), the
    cache records the card's microbenchmark sizes, and neither peak
    reads above 105% of the datasheet's."""
    import json
    from repro_torch.core.cost_model import measure_peaks
    path = str(tmp_path / "roofline.json")
    p = measure_peaks(cache_path=path, refresh=True, device=cuda_device)
    assert p.source == "measured" and p.backend == "cuda"
    assert 0 < p.peak_flops <= 1.05 * H100_FP32_FLOPS
    assert 0 < p.hbm_bw <= 1.05 * H100_HBM_BYTES
    doc = json.loads(open(path).read())
    assert (doc["gemm_n"], doc["triad_elems"]) == (8192, 1 << 26)
    assert measure_peaks(cache_path=path, device=cuda_device).source == \
        "cache"


def test_profile_functions_launch_their_kernels(cuda_device):
    """Both profiles return finite times and time the kernel route: the
    conv sums and abft_matmul launch counts rise."""
    import math
    before = TCR.LAUNCHES
    cv = tcore.profile_conv_detect_kernel((8, 64, 56, 56),
                                          device=cuda_device)
    assert TCR.LAUNCHES > before
    assert math.isfinite(cv.t_plain) and math.isfinite(cv.t_fused)
    assert cv.use_fused == (cv.t_fused < cv.t_plain)
    before = TAM.LAUNCHES
    mm = tcore.profile_matmul_kernel(8, 512, 1000, device=cuda_device)
    assert TAM.LAUNCHES > before
    assert math.isfinite(mm.t_plain) and math.isfinite(mm.t_fused)
    assert mm.use_fused == (mm.t_fused < mm.t_plain)


def test_driver_serves_on_card(cuda_device):
    """The async driver serves two requests on the card through the
    detect kernel, one host read per forward, with the session's tokens."""
    import repro_torch.configs as TCF
    from repro_torch.core import workflow as TW
    from repro_torch.models import transformer as TM
    from repro_torch.serving import ProtectedSession, ServingDriver
    cfg = TCF.get("smollm-360m-smoke").replace(dtype="bfloat16")
    params = TM.init_params(cfg, device=cuda_device)
    plan = tcore.force_fused_matmul(tcore.build_plan(
        params, cfg, batch=2, seq=32, device=cuda_device))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (6, 11)]
    TAM.DETECT_LAUNCHES = TW.HOST_READS = 0
    d = ServingDriver(params, cfg, plan, slots=2, max_len=32,
                      device=cuda_device)
    try:
        rids = [d.submit(p, max_new_tokens=5).rid for p in prompts]
        report = d.drain(timeout=300)
    finally:
        d.close()
    c = report["counters"]
    forwards = c["prefills"] + c["decode_steps"]
    assert report["completed"] == 2 and c["faults_detected"] == 0
    assert TAM.DETECT_LAUNCHES == 15 * forwards
    assert TW.HOST_READS == forwards
    sess = ProtectedSession(params, cfg, plan, slots=2, max_len=32,
                            device=cuda_device)
    srids = [sess.submit(p, max_new_tokens=5) for p in prompts]
    sess.run()
    assert [d.tokens_for(r) for r in rids] == \
        [sess.tokens_for(r) for r in srids]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,m,transposed", [(256, 960, 320, False),
                                              (128, 64, 1000, True)])
def test_abft_matmul_vjp_on_card(cuda_device, dtype, n, k, m, transposed):
    """abft_matmul_vjp with the kernel pinned: three abft_matmul launches
    per call (one with protect_backward off), clean reports, and O, dD,
    dW against autograd of the plain product - in bf16 one ulp of the
    result plus the fp32 summation noise of a K-term dot product on
    either side (2^-21 sqrt(K) |A| @ |B|, as chip_smoke.py phase 11a), in
    fp32 rtol 1e-5 (atol 1e-5 of the scale). A transposed W (the tied
    head's view) is read in place."""
    from repro_torch import fp32_ieee
    from repro_torch.core.protected import matmul_raw
    d = torch.as_tensor(normal(3, (n, k))).to(cuda_device, dtype)
    store = torch.as_tensor(normal(4, (m, k) if transposed else (k, m))
                            * k ** -0.5).to(cuda_device, dtype)
    w = store.T if transposed else store
    g = torch.as_tensor(normal(5, (n, m))).to(cuda_device, dtype)
    cfg = tcore.DEFAULT_CONFIG.replace(use_fused_kernel=True)

    def grads(fn):
        a = d.clone().requires_grad_(True)
        b = w.detach().clone().requires_grad_(True) if not transposed \
            else store.clone().requires_grad_(True)
        bw = b.T if transposed else b
        with fp32_ieee():
            o = fn(a, bw)
            return o, torch.autograd.grad(o, (a, b), g)

    ref_o, ref = grads(matmul_raw)
    a_, w_, g_ = d.float().abs(), w.float().abs(), g.float().abs()
    absdot = (a_ @ w_, g_ @ w_.T, (a_.T @ g_).T if transposed else a_.T @ g_)
    ks = (k, m, n)
    for protect, launches in ((True, 3), (False, 1)):
        reports = []
        TAM.LAUNCHES = 0
        o, got = grads(lambda a, b: tcore.abft_matmul_vjp(
            a, b, cfg.replace(protect_backward=protect), reports))
        torch.cuda.synchronize()
        assert TAM.LAUNCHES == launches
        assert [tuple(int(x) for x in r) for r in reports] == \
            [(0, 0, 0)] * (2 if protect else 0)
        for x, y, a, kk in zip((o,) + got, (ref_o,) + ref, absdot, ks):
            x, y = x.detach(), y.detach()
            assert x.dtype == y.dtype == dtype and x.shape == y.shape
            if dtype == torch.bfloat16:
                tol = y.float().abs() * 2.0 ** -7 + 2.0 ** -21 * kk ** 0.5 * a
                assert bool(((x.float() - y.float()).abs() <= tol).all())
            else:
                assert_close(x, y, 1e-5, 1e-5 * float(y.abs().max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_on_card_bitwise_unprotected(cuda_device, dtype):
    """One train step of the smoke config on the card (two microbatches):
    the report clean, no kernel launched (the step runs the plain route,
    as the JAX package's does), and the new state, loss and gnorm bitwise
    equal to the abft=False step's from the same state."""
    import repro_torch.configs as TCF
    from repro_torch._tree import tree_flatten_with_path
    from repro_torch.data import DataConfig, host_batch
    from repro_torch.launch import steps as TS
    from repro_torch.optim import OptConfig
    cfg = TCF.get("smollm-360m-smoke").replace(dtype=dtype)
    opt = OptConfig(lr=1e-3)
    state = TS.init_train_state(None, cfg, opt, device=cuda_device)
    tokens, labels = host_batch(DataConfig(cfg.vocab_size, 32, 4), 0)
    batch = {"tokens": tokens.to(cuda_device),
             "labels": labels.to(cuda_device)}
    outs = []
    TAM.LAUNCHES = 0
    for abft in (True, False):
        step = TS.make_train_step(cfg.replace(abft=abft), opt,
                                  microbatches=2, warmup=0)
        outs.append(step(state, batch))
    (a, ma), (b, mb) = outs
    assert TAM.LAUNCHES == 0
    assert tuple(int(x) for x in ma["report"]) == (0, 0, 0)
    assert torch.equal(ma["loss"], mb["loss"])
    assert torch.equal(ma["gnorm"], mb["gnorm"])
    fa, fb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (n, x), (_, y) in zip(fa, fb):
        assert x.device.type == "cuda" and torch.equal(x, y), n


# --------------------------------------------------------------------------
# the group axis: G products of one shape in one launch (MoE experts)
# --------------------------------------------------------------------------

# (G, n, k, m, rb, cb, transposed): a decode step's one row per expert, a
# prefill's few, row chunks under the block tile, K not a multiple of the
# stage, W read transposed per group
GROUPED_CASES = [(8, 1, 256, 128, 1, 64, False), (6, 3, 200, 96, 3, 32, False),
                 (4, 16, 520, 200, 8, 40, False), (5, 2, 96, 64, 2, 64, True),
                 (3, 40, 72, 96, 8, 48, False)]


def _grouped_operands(dev, dtype, g, n, k, m, transposed):
    d = torch.as_tensor(normal(g * n, (g, n, k))).to(dev, dtype)
    if transposed:
        w = torch.as_tensor(normal(m, (g, m, k)) * k ** -0.5).to(
            dev, dtype).transpose(1, 2)
    else:
        # a view into a stacked leaf, as a stage's expert slice is
        w = torch.as_tensor(normal(m, (2, g, k, m)) * k ** -0.5).to(
            dev, dtype)[1]
    return d, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,n,k,m,rb,cb,transposed", GROUPED_CASES)
def test_grouped_detect_kernel_on_card(cuda_device, g, n, k, m, rb, cb,
                                       transposed, dtype):
    """One launch for all G groups: flags equal to the plain version's and
    clear on exact checksums; +1e4 at one element of one group flags
    exactly that group's chunk; O bitwise equal to G launches of the 2-D
    kernel (each group tiled as its own product) and to the grouped
    partials kernel, within rounding of the plain version."""
    from repro_torch.core import thresholds as TTH
    d, w = _grouped_operands(cuda_device, dtype, g, n, k, m, transposed)
    cs = [torch.stack(x) for x in zip(*(_chunk_checksums(d[i], w[i], rb, cb)
                                        for i in range(g)))]
    tau_a, tau_b = TTH.tau_scalar_coeffs(k, dtype, 32.0)
    before = (TAM.GROUPED_DETECT_LAUNCHES, TAM.DETECT_LAUNCHES)
    o, flag, score = TAM.abft_matmul_detect(d, w, *cs, rb, cb, tau_a, tau_b)
    torch.cuda.synchronize()
    assert (TAM.GROUPED_DETECT_LAUNCHES, TAM.DETECT_LAUNCHES) == \
        (before[0] + 1, before[1])
    o_r, flag_r, score_r = tref.abft_matmul_detect_ref(
        d, w, *cs, rb, cb, tau_a, tau_b)
    assert flag.shape == (g, n // rb, m // cb)
    assert torch.equal(flag, flag_r) and int(flag.sum()) == 0
    assert_close(score, score_r, 1e-4, 1e-2, "score")
    assert_close(o.float(), o_r.float(), 1e-2 if dtype != torch.float32
                 else 1e-5, 1e-4 * k ** 0.5, "O")
    singles = torch.stack([TAM.abft_matmul_detect(
        d[i], w[i], *(c[i] for c in cs), rb, cb, tau_a, tau_b)[0]
        for i in range(g)])
    assert torch.equal(o, singles), "a group's O differs from its own launch"
    o_p, parts = TAM.abft_matmul(d, w, 8 if n >= 8 else 1, 8)
    assert torch.equal(o, o_p)
    _, parts_r = tref.abft_matmul_ref(d, w, 8 if n >= 8 else 1, 8)
    for a, b, name in zip(parts[:3], parts_r[:3],
                          ("colsum", "rowsum", "sumsq")):
        assert a.shape == b.shape, name
        assert_close(a, b, 1e-2 if dtype != torch.float32 else 1e-5,
                     1e-3 * k ** 0.5, name)
    hit_g, r, c = g - 2, n - 1, m - 5
    p = d[hit_g].float() @ w[hit_g].float()
    p[r, c] += 1e4
    bad = [x.clone() for x in cs]
    for j, x in enumerate(tref.chunk_sums_ref(p, rb, cb)[:3]):
        bad[j][hit_g] = x
    _, flag_t, _ = TAM.abft_matmul_detect(d, w, *bad, rb, cb, tau_a, tau_b)
    want = torch.zeros_like(flag_t)
    want[hit_g, r // rb, c // cb] = 1
    assert torch.equal(flag_t, want)


def test_grouped_kernels_refuse_bad_groups(cuda_device):
    d = torch.zeros((4, 8, 64), device=cuda_device)
    w = torch.zeros((3, 64, 32), device=cuda_device)
    with pytest.raises(ValueError):
        TAM.abft_matmul(d, w, 8, 8)
    with pytest.raises(ValueError):
        TAM.abft_matmul(d, w[0], 8, 8)
    with pytest.raises(NotImplementedError):
        TAM.abft_matmul(d, w[:1].expand(4, 64, 32).half(), 8, 8)


@pytest.mark.parametrize("fused", [False, True])
def test_protected_grouped_matmul_on_card(cuda_device, fused):
    """protected_grouped_matmul in bf16 on the card: the clean path gives
    zero flags in both modes; with use_fused_kernel one group-axis launch
    per call (detect_only: the detect kernel; per_layer: the partials
    kernel), O bitwise equal between the two; a corrupted expert weight
    element, against the clean weight's checksums, is detected, as the
    same call on the CPU detects it (which rung then answers may differ
    between the two, ROADMAP 3.4)."""
    from repro_torch.core import protected as TP
    g, n, k, m = 8, 2, 256, 192
    d = torch.as_tensor(normal(3, (g, n, k))).to(cuda_device, torch.bfloat16)
    w = torch.as_tensor(normal(4, (g, k, m)) * k ** -0.5).to(
        cuda_device, torch.bfloat16)
    cfg = tcore.DEFAULT_CONFIG.replace(row_chunk=64, col_chunk=64,
                                       use_fused_kernel=fused)
    before = (TAM.GROUPED_DETECT_LAUNCHES, TAM.GROUPED_LAUNCHES)
    o_d, ev = TP.protected_grouped_matmul(d, w, cfg=cfg, mode="detect_only")
    o_c, rep = TP.protected_grouped_matmul(d, w, cfg=cfg)
    assert int(ev.flag) == 0 and tuple(int(x) for x in rep) == (0, 0, 0)
    assert (TAM.GROUPED_DETECT_LAUNCHES - before[0],
            TAM.GROUPED_LAUNCHES - before[1]) == ((1, 1) if fused else (0, 0))
    assert torch.equal(o_d, o_c)
    ref = (d.float() @ w.float()).to(torch.bfloat16)
    assert_close(o_c.float(), ref.float(), 1e-2, 1e-2, "O")
    wck = tcore.stacked_weight_checksums_matmul(w, 64)
    bad = w.clone()
    bad[5, 17, 40] += 30.0
    _, rep_b = TP.protected_grouped_matmul(d, bad, wck=wck, cfg=cfg)
    cpu = lambda t: t.cpu()
    _, rep_h = TP.protected_grouped_matmul(
        cpu(d), cpu(bad), wck=tcore.WeightChecksums(cpu(wck.cw1),
                                                    cpu(wck.cw2), 64),
        cfg=cfg)
    assert int(rep_b.detected) == int(rep_h.detected) == 1


def test_moe_serving_on_card(cuda_device):
    """The reduced Kimi-K2 in bf16 served on the card: zero clean flags;
    every plain-matmul site of every deferred forward on
    abft_matmul_detect (24 per forward: the prefix's 7, each of 2 repeats'
    attention, router and shared expert, the head), the expert GEMMs on
    the plain grouped route, one host read a forward; per_layer reads once
    per site call (24 + 3 grouped sites x 2 repeats = 30) and gives the
    same tokens."""
    import repro_torch.configs as TCF
    from repro_torch.core import workflow as TW
    from repro_torch.models import transformer as TM
    from repro_torch.serving import ProtectedSession
    cfg = TCF.get("kimi-k2-1t-a32b-smoke").replace(dtype="bfloat16")
    params = TM.init_params(cfg, device=cuda_device)
    plan = tcore.force_fused_matmul(tcore.build_plan(
        params, cfg, batch=4, seq=32, device=cuda_device))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (5, 9, 13, 7, 3)]
    tokens = {}
    for mode in ("deferred", "per_layer"):
        TAM.LAUNCHES = TAM.DETECT_LAUNCHES = TW.HOST_READS = 0
        sess = ProtectedSession(params, cfg, plan, slots=4, max_len=32,
                                correction=mode, device=cuda_device)
        rids = [sess.submit(p, max_new_tokens=6) for p in prompts]
        report = sess.run()
        c = report["counters"]
        forwards = c["prefills"] + c["decode_steps"]
        assert c["faults_detected"] == 0 and report["completed"] == 5
        if mode == "deferred":
            assert (TAM.DETECT_LAUNCHES, TAM.LAUNCHES) == (24 * forwards, 0)
            assert TW.HOST_READS == forwards
        else:
            assert (TAM.DETECT_LAUNCHES, TAM.LAUNCHES) == (0, 24 * forwards)
            assert TW.HOST_READS == 30 * forwards
        tokens[mode] = [sess.tokens_for(r) for r in rids]
    assert tokens["deferred"] == tokens["per_layer"]


# --------------------------------------------------------------------------
# a corrected bf16 output keeps the site's own rounding
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n,k,m", [(107, 2048, 2048), (8, 2048, 8192)])
def test_corrected_bf16_site_is_bitwise_clean_on_card(cuda_device, fused, n,
                                                      k, m):
    """+1e3 at one element of a bf16 site's output (the serving drills'
    seam: protect_op with the injected O), at 16 places, in chunks whose
    rounding noise can shift CoC's weighted ratios by an index (values up
    to ~20): the ladder corrects it and the corrected output equals the
    route's clean output bitwise, so the KV cache a corrected prefill
    writes, and every later token, are the clean run's."""
    from repro_torch import fp32_ieee
    from repro_torch.core import plan as TPL
    bf16 = torch.bfloat16
    d = torch.as_tensor(normal(5, (n, k)) * 4.0).to(cuda_device, bf16)
    w = torch.as_tensor(normal(6, (k, m)) * k ** -0.5).to(cuda_device, bf16)
    cfg = tcore.DEFAULT_CONFIG.replace(use_fused_kernel=fused)
    rng = np.random.default_rng(1)
    with torch.no_grad(), fp32_ieee():
        clean = TPL._site_product(d, w, cfg)
        for r, c in zip(rng.integers(0, n, 16), rng.integers(0, m, 16)):
            bad = clean.clone()
            bad[r, c] += 1e3
            out, rep = TPL.protect_op(TPL.OpSpec("matmul"), (d, w), cfg=cfg,
                                      o=bad)
            assert (int(rep.detected), int(rep.residual)) == (1, 0)
            assert torch.equal(out, clean), (
                f"({r}, {c}) corrected by rung {int(rep.corrected_by)}: "
                f"{int((out != clean).sum())} elements differ from the "
                "clean output")


def test_corrected_prefill_keeps_clean_tokens_on_card(cuda_device):
    """MusicGen-large at full width and 24 of its 48 layers in bf16 (random
    params drawn on the card from seed 0), 8 requests of chip_smoke.py's
    phase-14 traffic served for 8 tokens, deferred, the kernels pinned:
    +1e3 at one element of repeat 12's attention wk in each prefill is
    detected and corrected (residual 0), and every served token equals
    the clean run's. A ladder that recomputed the located element in
    another summation order than the site's kernel moved a token here."""
    import repro_torch.configs as TCF
    from repro_torch.core import injection
    from repro_torch.models import transformer as TM
    from repro_torch.serving import ProtectedSession
    cfg = TCF.get("musicgen-large").replace(num_layers=24)
    params = TM.init_params(
        cfg, generator=torch.Generator(device=cuda_device).manual_seed(0),
        device=cuda_device)
    plan = tcore.force_fused_matmul(tcore.build_plan(
        params, cfg, batch=8, seq=256, device=cuda_device))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, (int(s), cfg.num_codebooks))
               for s in rng.integers(16, 129, 16)][:8]
    reps, calls = cfg.stages()[1], [0]

    def prefill_hook(o):
        if o.shape[0] == 1 and o.shape[1] > 1:
            calls[0] += 1
            if (calls[0] - 1) % reps == reps // 2:
                o = o.clone()
                o[0, 5, 17] += 1e3
        return o

    def serve(hook=None):
        sess = ProtectedSession(params, cfg, plan, slots=8, max_len=256,
                                device=cuda_device)
        rids = [sess.submit(p, max_new_tokens=8) for p in prompts]
        with (injection.fault_scope("stages/b0_attn_full/attn/wk", hook)
              if hook else contextlib.nullcontext()):
            report = sess.run()
        return [sess.tokens_for(r) for r in rids], report

    clean, _ = serve()
    got, report = serve(prefill_hook)
    recs = report["requests"]
    assert [(r["prefill_detected"], r["corrections_applied"], r["residuals"])
            for r in recs] == [(1, 1, 0)] * 8
    assert got == clean


# --------------------------------------------------------------------------
# training through the ssm, rec and moe blocks, rematerialised
# --------------------------------------------------------------------------

TRAIN_BLOCK_ARCHS = ("mamba2-1.3b-smoke", "recurrentgemma-2b-smoke",
                     "kimi-k2-1t-a32b-smoke",
                     "llama4-maverick-400b-a17b-smoke")
# a stage site per family: the ssm's in_proj, the rec block's in_x, the
# experts' grouped gate and the fp32 router
TRAIN_BLOCK_SITES = {"mamba2-1.3b-smoke": "stages/b0_ssm/ssm/in_proj",
                     "recurrentgemma-2b-smoke": "stages/b0_rec/rec/in_x",
                     "kimi-k2-1t-a32b-smoke": "stages/b1_moe/moe/gate",
                     "llama4-maverick-400b-a17b-smoke":
                         "stages/b3_moe/moe/router"}


def _block_train(dev, arch, seed=0):
    """(cfg in bf16, state, batch, step factory) of a train-block smoke on
    `dev`: 2 microbatches of 2 x 32 tokens, AdamW, warmup 0."""
    import repro_torch.configs as TCF
    from repro_torch.data import DataConfig, host_batch
    from repro_torch.launch import steps as TS
    from repro_torch.optim import OptConfig
    cfg = TCF.get(arch).replace(dtype="bfloat16")
    opt = OptConfig(lr=1e-3)
    state = TS.init_train_state(torch.Generator().manual_seed(seed), cfg,
                                opt, device=dev)
    tokens, labels = host_batch(DataConfig(cfg.vocab_size, 32, 4), seed)
    batch = {"tokens": tokens.to(dev), "labels": labels.to(dev)}
    make = lambda c: TS.make_train_step(c, opt, microbatches=2, warmup=0)
    return cfg, state, batch, make


def _states_equal(a, b) -> list:
    from repro_torch._tree import tree_flatten_with_path
    fa, fb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    return [n for (n, x), (_, y) in zip(fa, fb)
            if not (x.dtype == y.dtype and torch.equal(x, y))]


def _repeat_hook(calls, repeat=1):
    """+1e4 at one element of the site's output in stage repeat `repeat`."""
    from repro_torch.core.plan import current_repeat

    def hook(o):
        calls.append(current_repeat())
        if current_repeat() != repeat:
            return o
        o = o.clone()
        o.reshape(-1)[5] += 1e4
        return o
    return hook


@pytest.mark.parametrize("arch", TRAIN_BLOCK_ARCHS)
def test_remat_train_step_bitwise_on_card(cuda_device, arch):
    """A bf16 train step on the card with remat on and off: the same new
    state, loss and gnorm bitwise, the reports clean, no kernel launched
    (the plain route, as the JAX package's step), and the rematerialised
    step's recompute reading flags of its own (RECOMPUTE_READS)."""
    from repro_torch.core import workflow as TW
    cfg, state, batch, make = _block_train(cuda_device, arch)
    outs, reads = [], []
    TAM.LAUNCHES = TAM.DETECT_LAUNCHES = 0
    for remat in (True, False):
        TW.HOST_READS = TW.RECOMPUTE_READS = 0
        outs.append(make(cfg.replace(remat=remat))(state, batch))
        reads.append((TW.HOST_READS, TW.RECOMPUTE_READS))
    (a, ma), (b, mb) = outs
    assert TAM.LAUNCHES == TAM.DETECT_LAUNCHES == 0
    assert tuple(int(x) for x in ma["report"]) == (0, 0, 0)
    assert tuple(int(x) for x in mb["report"]) == (0, 0, 0)
    assert torch.equal(ma["loss"], mb["loss"])
    assert torch.equal(ma["gnorm"], mb["gnorm"])
    assert not _states_equal(a, b)
    assert reads[0][1] > 0 and reads[1][1] == 0
    assert reads[0][0] - reads[0][1] == reads[1][0]


@pytest.mark.parametrize("arch", TRAIN_BLOCK_ARCHS[2:])
def test_protected_moe_step_bitwise_unprotected_on_card(cuda_device, arch):
    """A protected, rematerialised bf16 moe train step on the card equals
    its abft=False twin bitwise, and its own rerun: the dispatch's and the
    combine's backward sum each token's k copies in a fixed order (no
    float atomics), and the workflow's output carries the plain grouped
    product's gradient."""
    cfg, state, batch, make = _block_train(cuda_device, arch)
    a, ma = make(cfg)(state, batch)
    b, mb = make(cfg.replace(abft=False))(state, batch)
    c, _ = make(cfg)(state, batch)
    assert torch.equal(ma["loss"], mb["loss"])
    assert not _states_equal(a, b)
    assert not _states_equal(a, c)


@pytest.mark.parametrize("arch", TRAIN_BLOCK_ARCHS)
def test_corrected_stage_fault_under_remat_on_card(cuda_device, arch):
    """+1e4 at one element of a stage site's output in repeat 1 of every
    forward of one bf16 step on the card, remat on: the hook fires in the
    forward and again in the recompute of each microbatch, StepRunner
    counts one fault detected and corrected (residual 0) and no retry,
    the loss is the clean step's within rtol 1e-4, and the new state
    equals the remat=False faulted step's bitwise. At a bf16 site the
    ladder takes the located elements from the route's product, so the
    new state is the clean step's bitwise; at the fp32 router the scheme's
    fix rounds, and the state stays within 2 lr of the clean one."""
    import repro_torch.core as tc
    from repro_torch.core import injection as tinj
    from repro_torch.runtime.ft import FTPolicy, StepRunner
    cfg, state, batch, make = _block_train(cuda_device, arch)
    site = TRAIN_BLOCK_SITES[arch]
    with tc.plan_scope(mode="correct"):
        clean, mc = make(cfg)(state, batch)
    runs = {}
    for remat in (True, False):
        calls = []
        runner = StepRunner(make(cfg.replace(remat=remat)), FTPolicy())
        with tc.plan_scope(mode="correct"), \
                tinj.fault_scope(site, _repeat_hook(calls)):
            runs[remat] = runner.run(state, batch)
        assert runner.stats["faults_detected"] == 1
        assert runner.stats["faults_corrected"] == 1
        assert runner.stats["retries"] == 0
        assert calls.count(1) == (4 if remat else 2), calls
    (new, m), (new_off, _) = runs[True], runs[False]
    det, by, resid = (int(x) for x in m["report"])
    assert det == 1 and by != 0 and resid == 0
    assert abs(float(m["loss"]) - float(mc["loss"])) <= \
        1e-4 * abs(float(mc["loss"]))
    assert not _states_equal(new, new_off)
    if site.endswith("router"):
        from repro_torch._tree import tree_flatten_with_path
        for (n, x), (_, y) in zip(tree_flatten_with_path(new["params"]),
                                  tree_flatten_with_path(clean["params"])):
            assert float((x.float() - y.float()).abs().max()) <= 2e-3, n
    else:
        assert not _states_equal(new, clean)


# --------------------------------------------------------------------------
# the (data, model) mesh on the card
# --------------------------------------------------------------------------

def test_two_rank_mesh_serves_on_the_card(cuda_device):
    """A (1, 2) gloo mesh of two ranks sharing the card serves
    yi-9b-smoke in bf16 with the kernels pinned: every rank's detect
    kernel launches on its local shards (15 sites a forward: 7 in each of
    2 repeats and the head's vocabulary half), one read per forward, and
    both ranks serve the unsharded session's tokens."""
    import torch_mesh_ranks as R
    from repro_torch.launch.mesh import run_ranks
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n) for n in (5, 8, 6, 11, 4, 9)]
    ranks = run_ranks(R.session_rank, 2, "gloo", 300,
                      (1, 2, "gloo", "cuda", None, prompts, None,
                       "bfloat16", True, False))
    for res in ranks:
        assert res["tokens"] == res["tokens_ref"]
        assert res["detect_launches"] == 15 * res["forwards"] > 0
        assert res["reads_per_forward"] == 1.0
        assert res["faults_clean"] == 0


def test_two_rank_mesh_serves_the_recurrent_smokes_on_the_card(cuda_device):
    """A (1, 2) gloo mesh of two ranks sharing the card serves
    mamba2-1.3b-smoke and recurrentgemma-2b-smoke in bf16 with the
    kernels pinned: every rank's detect kernel launches at every site of
    its local shards (in_proj's 148 columns, the rec widths' 32), one read
    per forward, the unsharded session's tokens; a +1e3 drill at the last
    rank's in_proj or gate_a shard is corrected on both ranks."""
    import torch_mesh_ranks as R
    from repro_torch.launch.mesh import run_ranks
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n) for n in (10, 12, 3)]
    cases = [{"arch": arch, "dtype": "bfloat16", "prompts": prompts,
              "slots": 2, "max_len": 24, "gen": 4, "unsharded": True,
              "drill": drill, "drill_row": arch.startswith("recurrent"),
              "table_scale": 1 / 16 if arch.startswith("recurrent")
              else None}
             for arch, drill in (
                 ("mamba2-1.3b-smoke", "stages/b0_ssm/ssm/in_proj"),
                 ("recurrentgemma-2b-smoke", "stages/b0_rec/rec/gate_a"))]
    ranks = run_ranks(R.recurrent_rank, 2, "gloo", 300,
                      (1, 2, "gloo", "cuda", cases))
    for res in ranks:
        for case in res["cases"]:
            assert case["tokens"] == case["tokens_ref"]
            assert case["detect_launches"] == \
                case["sites"] * case["forwards"] > 0
            assert case["reads_per_forward"] == 1.0
            assert case["counters"]["faults_detected"] == 0
            c = case["drill"]["counters"]
            assert (c["faults_detected"], c["faults_corrected"]) == (1, 1)
            assert c["residual_steps"] == 0
            assert case["drill"]["tokens"] == case["tokens"]
