"""The port's protected ops (repro_torch.core.protected) against the JAX
package's, on the same numpy operands and the same injected faults.

Verdicts (detected, corrected_by, residual) must be exactly equal;
corrected outputs agree to fp32 reassociation (rtol 1e-5, atol 1e-4 of the
output's scale). Each JAX program is jitted with the faulty output as an
argument, so it compiles once per test module."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import checksums as JC  # noqa: E402
from repro.core import injection as jinj  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import checksums as TC  # noqa: E402
from repro_torch.core import types as TT  # noqa: E402
from torch_parity import assert_close, normal, to_np, verdict  # noqa: E402

N, CH, H, M, R = 4, 6, 10, 12, 3
NM, KM, MM = 48, 40, 60
PAD = [(1, 1)] * 2
MM_CFG = dict(row_chunk=16, col_chunk=20)

_jax_conv = jax.jit(lambda d, w, b, o: jcore.protected_conv(
    d, w, bias=b, padding=PAD, o=o))
_jax_mm = jax.jit(lambda d, w, b, o: jcore.protect_matmul_output(
    d, w, o, bias=b, cfg=jcore.DEFAULT_CONFIG.replace(**MM_CFG)))


@pytest.fixture(scope="module")
def conv_case():
    d = normal(0, (N, CH, H, H))
    w = normal(1, (M, CH, R, R), 0.3)
    b = normal(2, (M,))
    o = to_np(TC.conv2d(torch.as_tensor(d), torch.as_tensor(w),
                        padding=[(1, 1)] * 2)) + b[None, :, None, None]
    return d, w, b, o


@pytest.fixture(scope="module")
def mm_case():
    d = normal(3, (NM, KM))
    w = normal(4, (KM, MM), KM ** -0.5)
    b = normal(5, (MM,))
    return d, w, b, d @ w + b


def _inject(o, kind: str, seed: int) -> np.ndarray:
    """Numpy-made faults on O of shape (N, M, ...): one element, a burst
    along one block row (one n, several m), one block column (one m,
    several n), or one element in each of two blocks at two payload
    positions."""
    g = np.random.default_rng(seed)
    bad = o.copy()
    n, m = o.shape[:2]
    pay = o.shape[2:]
    pos = tuple(int(g.integers(s)) for s in pay)
    mag = lambda: float(g.uniform(20.0, 60.0)) * (1 if g.random() < .5 else -1)
    if kind == "single":
        bad[(int(g.integers(n)), int(g.integers(m))) + pos] += mag()
    elif kind == "row_burst":
        i = int(g.integers(n))
        for j in g.choice(m, size=min(4, m), replace=False):
            bad[(i, int(j)) + pos] += mag()
    elif kind == "col_burst":
        j = int(g.integers(m))
        for i in g.choice(n, size=min(3, n), replace=False):
            bad[(int(i), j) + pos] += mag()
    elif kind == "two_block":
        bad[(0, 1) + pos] += mag()
        pos2 = tuple((p + 1) % s for p, s in zip(pos, pay)) if pay else ()
        bad[(n - 1, m - 2) + pos2] += mag()
    else:
        raise ValueError(kind)
    return bad


FAULTS = ["clean", "single", "row_burst", "col_burst", "two_block"]


@pytest.mark.parametrize("fault", FAULTS)
def test_protected_conv_matches_jax(conv_case, fault):
    d, w, b, o = conv_case
    bad = o if fault == "clean" else _inject(o, fault, seed=11)
    out_t, rep_t = tcore.protected_conv(
        torch.as_tensor(d), torch.as_tensor(w), bias=torch.as_tensor(b),
        padding=PAD, o=torch.as_tensor(bad))
    out_j, rep_j = _jax_conv(*map(jnp.asarray, (d, w, b, bad)))
    assert verdict(rep_t) == verdict(rep_j)
    if fault != "clean":
        assert verdict(rep_t)[0] == 1 and verdict(rep_t)[2] == 0
    scale = float(np.max(np.abs(o))) + 1.0
    assert_close(out_t, out_j, 1e-5, 1e-4 * scale)
    assert_close(out_t, o, 0, 5e-2)


@pytest.mark.parametrize("fault", FAULTS)
def test_protected_matmul_bias_matches_jax(mm_case, fault):
    d, w, b, o = mm_case
    bad = o if fault == "clean" else _inject(o, fault, seed=12)
    out_t, rep_t = tcore.protect_matmul_output(
        torch.as_tensor(d), torch.as_tensor(w), torch.as_tensor(bad),
        bias=torch.as_tensor(b), cfg=tcore.DEFAULT_CONFIG.replace(**MM_CFG))
    out_j, rep_j = _jax_mm(*map(jnp.asarray, (d, w, b, bad)))
    assert verdict(rep_t) == verdict(rep_j)
    if fault != "clean":
        assert verdict(rep_t)[0] == 1 and verdict(rep_t)[2] == 0
    scale = float(np.max(np.abs(o))) + 1.0
    assert_close(out_t, out_j, 1e-5, 1e-4 * scale)
    assert_close(out_t, o, 0, 2e-2 * scale)


def test_clean_path_is_bitwise_the_unprotected_op(conv_case, mm_case):
    d, w, b, _ = conv_case
    dt, wt, bt = map(torch.as_tensor, (d, w, b))
    out, rep = tcore.protected_conv(dt, wt, bias=bt, padding=PAD)
    plain = TC.conv2d(dt, wt, padding=PAD) + bt[None, :, None, None]
    assert verdict(rep) == (0, 0, 0) and torch.equal(out, plain)
    d, w, b, _ = mm_case
    dt, wt, bt = map(torch.as_tensor, (d, w, b))
    for fused in (False, True):
        cfg = tcore.DEFAULT_CONFIG.replace(use_fused_kernel=fused)
        out, rep = tcore.protected_matmul(dt, wt, bias=bt, cfg=cfg)
        assert verdict(rep) == (0, 0, 0)
        assert torch.equal(out, dt @ wt + bt), fused


def test_fused_matmul_matches_jax(mm_case):
    """The partials route (abft_matmul + chunk_sums_from_partials) gives
    the JAX package's verdict on clean and faulty weights alike."""
    d, w, b, _ = mm_case
    wck_t = tcore.weight_checksums_matmul(torch.as_tensor(w), 20)
    wck_j = jcore.weight_checksums_matmul(jnp.asarray(w), 20)
    jcfg = jcore.DEFAULT_CONFIG.replace(use_fused_kernel=True,
                                        kernel_interpret=True, **MM_CFG)
    run_j = jax.jit(lambda d, w, b: jcore.protected_matmul(
        d, w, wck=wck_j, bias=b, cfg=jcfg))
    for tamper in (0.0, 40.0):
        wx = w.copy()
        wx[3, 5] += tamper
        out_t, rep_t = tcore.protected_matmul(
            torch.as_tensor(d), torch.as_tensor(wx), wck=wck_t,
            bias=torch.as_tensor(b),
            cfg=tcore.DEFAULT_CONFIG.replace(use_fused_kernel=True,
                                             **MM_CFG))
        out_j, rep_j = run_j(*map(jnp.asarray, (d, wx, b)))
        assert verdict(rep_t) == verdict(rep_j), tamper
        assert verdict(rep_t)[0] == (1 if tamper else 0)
        assert_close(out_t, out_j, 1e-5, 1e-3)


def test_fused_detect_only_bias_free_site_raises(mm_case):
    d, w, _, _ = mm_case
    cfg = tcore.DEFAULT_CONFIG.replace(use_fused_kernel=True)
    with pytest.raises(NotImplementedError, match="2.3"):
        tcore.protected_matmul(torch.as_tensor(d), torch.as_tensor(w),
                               cfg=cfg, mode="detect_only")


def test_coc_miscorrection_regression_twin():
    """Twin of test_campaign's pinned CoC collision: a row burst whose
    column locator lands near an integer. The row/column verification must
    reject CoC's single-point fix and escalate, as in the JAX package."""
    model = jinj.FAULT_MODELS["burst_row"]
    kd, kw, kf = jax.random.split(jax.random.PRNGKey(21), 3)
    d = jax.random.normal(kd, (64, 32), jnp.float32)
    w = jax.random.normal(kw, (32, 48), jnp.float32)
    o = jnp.dot(d, w, preferred_element_type=jnp.float32)
    o_bad = jax.jit(lambda o, k: jinj.inject(
        o, model.plan(k, 64, 48, 1, 100), model))(o, kf)
    rep_j = jax.jit(lambda d, w, o: jcore.protect_matmul_output(
        d, w, o)[1])(d, w, o_bad)
    fixed, rep_t = tcore.protect_matmul_output(
        torch.as_tensor(to_np(d)), torch.as_tensor(to_np(w)),
        torch.as_tensor(to_np(o_bad)))
    assert verdict(rep_t) == verdict(rep_j)
    assert verdict(rep_t)[0] == 1 and verdict(rep_t)[2] == 0
    assert verdict(rep_t)[1] != TT.COC
    scale = float(jnp.max(jnp.abs(o))) + 1.0
    assert_close(fixed, o, 0, 2e-2 * scale)


def test_detect_only_then_correct_op(conv_case):
    """protect_op(mode="detect_only") leaves O untouched and returns a
    device-side DetectEvidence; correct_op with the carried flag fixes O
    without re-detecting."""
    d, w, b, o = conv_case
    op = tcore.OpSpec("conv", pad=1)
    ins = tuple(map(torch.as_tensor, (d, w, b)))
    out, ev = tcore.protect_op(op, ins, o=torch.as_tensor(o),
                               mode="detect_only")
    assert isinstance(ev, TT.DetectEvidence)
    assert int(ev.flag) == 0 and float(ev.score) < 1.0
    bad = torch.as_tensor(_inject(o, "single", seed=3))
    out, ev = tcore.protect_op(op, ins, o=bad, mode="detect_only")
    assert torch.equal(out, bad)
    assert int(ev.flag) == 1 and float(ev.score) > 1.0
    fixed, rep = tcore.correct_op(op, ins, o=bad, detected=ev.flag > 0)
    assert verdict(rep) == (1, TT.COC, 0)
    assert_close(fixed, o, 0, 5e-2)


def test_verdict_types_merge():
    a = TT.FaultReport(1, TT.RC, 0)
    b = TT.FaultReport(torch.tensor(0), torch.tensor(TT.FC), 1)
    m = TT.merge_verdicts(a, b)
    assert verdict(m) == (1, TT.FC, 1)
    e = TT.merge_verdicts(TT.DetectEvidence.clean(),
                          TT.DetectEvidence(torch.tensor(1),
                                            torch.tensor(3.0)))
    assert int(e.flag) == 1 and float(e.score) == 3.0
    with pytest.raises(TypeError):
        TT.merge_verdicts(a, TT.DetectEvidence.clean())
    rep = TT.ModelReport({"a": a, "b": TT.FaultReport.clean()})
    assert rep.summary()["a"] == {"detected": 1, "corrected_by": "rc",
                                  "residual": 0}
    assert rep.scheme_histogram()["rc"] == 1


def test_config_fields_match_jax():
    """ProtectConfig carries the JAX package's fields, defaults included,
    so either package's plan JSON builds the other's config."""
    jf = {f.name: f.default for f in dataclasses.fields(jcore.ProtectConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tcore.ProtectConfig)}
    assert jf == tf
    assert TT.SCHEME_NAMES == jcore.SCHEME_NAMES


def test_thresholds_match_jax():
    from repro.core import thresholds as JT
    from repro_torch.core import thresholds as TTH
    for k in (1, 27, 576, 4608):
        for f in (12.0, 32.0, 64.0):
            assert TTH.tau_scalar_coeffs(k, torch.float32, f) == \
                JT.tau_scalar_coeffs(k, jnp.float32, f)
    sq = normal(9, (5,)) ** 2
    got = TTH.tau_scalar(torch.as_tensor(sq), 576, torch.float32, 24.0,
                         torch.tensor(3.5))
    want = JT.tau_scalar(jnp.asarray(sq), 576, jnp.float32, 24.0,
                         jnp.float32(3.5))
    np.testing.assert_array_equal(to_np(got), to_np(want))


def _encodes(C, mod, mm, conv):
    """Every encode of one package, in a fixed order, on its own arrays."""
    d, w, o = mm
    cd, cw = C.encode_d_matmul(d), C.encode_w_matmul(w)
    out = list(cd) + list(cw)
    out += list(C.output_checksums_matmul(d, w, *cd, *cw))
    out += list(C.output_sums_matmul(o))
    out.append(C.absdot_matmul(cd[0], cw[0]))
    d, w, o = conv
    cd, cw = C.encode_d_conv(d), C.encode_w_conv(w)
    out += list(cd) + list(cw)
    out += list(C.output_checksums_conv(d, w, *cd, *cw, padding=PAD))
    out += list(C.output_sums_conv(o))
    out += list(C.detect_checksums_conv(*cd, *cw, padding=PAD))
    out.append(C.absdot_conv(cd[0], cw[0], padding=PAD))
    return out


def test_checksum_encodes_match_jax(conv_case, mm_case):
    """The matmul/conv encodes, output sums/checksums, absdot and CoC-D's
    scheme-level compare, value for value (fp32 reassociation only)."""
    mm = [mm_case[0], mm_case[1], mm_case[3]]
    conv = [conv_case[0], conv_case[1], conv_case[3]]
    got = _encodes(TC, torch, [torch.as_tensor(a) for a in mm],
                   [torch.as_tensor(a) for a in conv])
    want = jax.jit(lambda mm, conv: _encodes(JC, jnp, mm, conv))(
        [jnp.asarray(a) for a in mm], [jnp.asarray(a) for a in conv])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        scale = float(np.max(np.abs(to_np(b)))) + 1.0
        assert tuple(a.shape) == tuple(np.shape(b))
        assert_close(a, b, 1e-5, 1e-5 * scale)
    d, w, _, o = conv_case
    dt, wt, ot = map(torch.as_tensor, (d, w, o))
    # exact_order keeps output_sums_conv's reduction order, bit for bit
    full = TC.output_sums_conv(ot)
    for a, b in zip(TC.detect_sums(ot, exact_order=True),
                    (full.s5, full.s6, full.s7, full.sumsq)):
        assert torch.equal(a, b)
    # the scheme-level CoC-D compare: clean O passes, a faulty O flags
    from repro_torch.core import schemes as TS
    cd, cw = TC.encode_d_conv(dt), TC.encode_w_conv(wt)
    cs = TC.output_checksums_conv(dt, wt, *cd, *cw, padding=PAD)
    b = torch.as_tensor(conv_case[2])
    cs = cs._replace(c5=cs.c5 + N * b.sum(),
                     c6=cs.c6 + N * (N - 1) / 2 * b.sum(),
                     c7=cs.c7 + N * (torch.arange(M) * b).sum())
    tau = 1e-3 * float(np.sqrt(np.sum(o.astype(np.float64) ** 2)))
    for oo, want_flag in ((o, False), (_inject(o, "single", seed=5), True)):
        ss = TC.output_sums_conv(torch.as_tensor(oo))
        assert bool(TS.detect(cs, ss, tau, tau * N, tau * M)) is want_flag
