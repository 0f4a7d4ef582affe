"""The port on the card: each CUDA kernel against its plain PyTorch
version, and the reduced CNN slice through the kernels. Every test here is
marked `gpu` and skips on a host without a CUDA card; the file needs no
JAX, so it runs on the GPU host as it is:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances as in test_torch_kernels.py: rtol=1e-5, atol=1e-4*sqrt(K) for
O, 1e-3*sqrt(K) for the epilogue partials, 1e-5 of the output's scale for
checksum_reduce's partials and 1e-4 for the finished detection sums
(fp32 reassociation only)."""
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


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    o = torch.zeros((16, 16), device=cuda_device, dtype=torch.bfloat16)
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
