"""The port's in-place weight-repair rung (repro_torch.core.weight_repair,
repro_torch.runtime.ft) against the JAX package's, on the same numpy
weights: locator persistence, the block solver in torch float64 (the
audit's rung) and float32 (the campaign's device path),
`repair_weights_against_plan` on f32, bf16, int8 and stacked stage
leaves, and the audit's satellites (twins of
tests/test_weight_repair.py; the grouped expert stack is ROADMAP item
1.11). Verdicts and repaired weights must equal JAX's; f32 and bf16
repairs are bitwise, int8 repairs exact."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import weight_repair as JWR  # noqa: E402
from repro.optim import dequantize_weight as jdequant  # noqa: E402
from repro.optim import quantize_weight as jquant  # noqa: E402
from repro.runtime import ft as jft  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import weight_repair as WR  # noqa: E402
from repro_torch.optim import dequantize_weight, quantize_weight  # noqa: E402
from repro_torch.runtime import ft  # noqa: E402
from torch_parity import normal, to_np  # noqa: E402

TCFG = dataclasses.replace(tcore.DEFAULT_CONFIG, col_chunk=16)
JCFG = dataclasses.replace(jcore.DEFAULT_CONFIG, col_chunk=16)


def _both(w_np, dtype="float32"):
    """The same numpy weight as a JAX array and a torch tensor (bf16 is
    rounded to nearest even on both sides)."""
    if dtype == "bfloat16":
        return (jnp.asarray(w_np, jnp.bfloat16),
                torch.as_tensor(w_np).to(torch.bfloat16))
    return jnp.asarray(w_np), torch.as_tensor(w_np)


def _plans(wj, wt, name="fc", conv=False):
    if conv:
        return (jcore.ProtectionPlan(entries={
                    name: jcore.conv_entry(name, wj, JCFG)}),
                tcore.ProtectionPlan(entries={
                    name: tcore.conv_entry(name, wt, TCFG)}))
    return (jcore.ProtectionPlan(entries={
                name: jcore.matmul_entry(name, wj, JCFG)}),
            tcore.ProtectionPlan(entries={
                name: tcore.matmul_entry(name, wt, TCFG)}))


def _repair_both(bad_np, plan_j, plan_t, name="fc", dtype="float32"):
    """Audit + repair the same corrupted weight in both packages; the
    verdicts must agree. Returns (JAX leaf or None, port leaf or None)."""
    bj, bt = _both(bad_np, dtype)
    ok_j, bad_j = jft.audit_weights_against_plan({name: {"w": bj}}, plan_j)
    ok_t, bad_t = ft.audit_weights_against_plan({name: {"w": bt}}, plan_t)
    assert ok_j == ok_t and bad_j == bad_t
    if ok_t:
        return None, None
    fj, rj = jft.repair_weights_against_plan({name: {"w": bj}}, plan_j,
                                             bad_j)
    ft_, rt = ft.repair_weights_against_plan({name: {"w": bt}}, plan_t,
                                             bad_t)
    assert rj == rt
    if rt is None:
        return None, None
    return (jcore.weight_leaf(fj, name), tcore.weight_leaf(ft_, name))


# --------------------------------------------------------------------------
# locator persistence
# --------------------------------------------------------------------------

def test_locators_roundtrip_float64_and_match_jax(tmp_path):
    """Locator sums survive save/load bitwise, stay float64 numpy, and
    equal the JAX package's on the same weights."""
    wm, wc = normal(0, (8, 32)), normal(1, (6, 3, 3, 3))
    plan = tcore.ProtectionPlan(entries={
        "fc": tcore.matmul_entry("fc", torch.as_tensor(wm), TCFG),
        "conv": tcore.conv_entry("conv", torch.as_tensor(wc), TCFG)})
    jplan = jcore.ProtectionPlan(entries={
        "fc": jcore.matmul_entry("fc", jnp.asarray(wm), JCFG),
        "conv": jcore.conv_entry("conv", jnp.asarray(wc), JCFG)})
    path = str(tmp_path / "plan.json")
    plan.save(path)
    loaded = tcore.ProtectionPlan.load(path, device="cpu")
    for name in ("fc", "conv"):
        got, want = loaded[name].wlc, plan[name].wlc
        assert int(got.cb) == int(want.cb) == int(jplan[name].wlc.cb)
        for fld in ("r1", "r2", "c1", "c2"):
            g = getattr(got, fld)
            assert isinstance(g, np.ndarray) and g.dtype == np.float64
            np.testing.assert_array_equal(g, getattr(want, fld))
            np.testing.assert_array_equal(
                g, np.asarray(getattr(jplan[name].wlc, fld)))


def test_old_plan_without_locators_still_loads(tmp_path):
    """Plans saved before locator sums existed audit detect-only: load
    must not crash, and repair reports unrepairable (escalate)."""
    w = torch.as_tensor(normal(0, (8, 32)))
    plan = tcore.ProtectionPlan(
        entries={"fc": tcore.matmul_entry("fc", w, TCFG)})
    path = str(tmp_path / "plan.json")
    plan.save(path)
    with open(path) as f:
        doc = json.load(f)
    for e in doc["entries"].values():
        e["wlc"] = None
    with open(path, "w") as f:
        json.dump(doc, f)
    loaded = tcore.ProtectionPlan.load(path, device="cpu")
    assert loaded["fc"].wlc is None
    bad_w = w.clone()
    bad_w[0, 0] += 5.0
    ok, bad = ft.audit_weights_against_plan({"fc": {"w": bad_w}}, loaded)
    assert not ok
    _, repaired = ft.repair_weights_against_plan({"fc": {"w": bad_w}},
                                                 loaded, bad)
    assert repaired is None


# --------------------------------------------------------------------------
# repair_weights_against_plan: bitwise restoration, equal to JAX's
# --------------------------------------------------------------------------

def _corrupted(w, edits):
    bad = w.copy()
    for idx, delta in edits:
        bad[idx] += delta
    return bad


def test_single_element_repairs_bitwise():
    w = normal(0, (8, 32))
    plan_j, plan_t = _plans(*_both(w))
    gj, gt = _repair_both(_corrupted(w, [((3, 20), 977.0)]), plan_j, plan_t)
    np.testing.assert_array_equal(to_np(gt), w)
    np.testing.assert_array_equal(to_np(gt), np.asarray(gj))
    ok, _ = ft.audit_weights_against_plan({"fc": {"w": gt}}, plan_t)
    assert ok


def test_single_column_repairs_bitwise():
    """A whole corrupted chunk column (every K row of one M index) is the
    one-column case: dr1 down the column is the per-row damage."""
    w = normal(0, (8, 32))
    bad = w.copy()
    bad[:, 5] += np.arange(8, dtype=np.float32) + 1.0
    plan_j, plan_t = _plans(*_both(w))
    gj, gt = _repair_both(bad, plan_j, plan_t)
    np.testing.assert_array_equal(to_np(gt), w)
    np.testing.assert_array_equal(to_np(gt), np.asarray(gj))


def test_single_filter_conv_repairs_bitwise():
    """An entire corrupted conv filter is one row of the (M, Ch*R*R)
    block: dc1 across the row is the per-position damage."""
    w = normal(1, (6, 3, 3, 3))
    bad = w.copy()
    bad[2] += normal(9, (3, 3, 3), 7.0)
    plan_j, plan_t = _plans(*_both(w), name="conv", conv=True)
    gj, gt = _repair_both(bad, plan_j, plan_t, name="conv")
    np.testing.assert_array_equal(to_np(gt), w)
    np.testing.assert_array_equal(to_np(gt), np.asarray(gj))


def test_multiblock_damage_escalates():
    w = normal(0, (8, 32))
    plan_j, plan_t = _plans(*_both(w))
    for edits in ([((0, 0), 977.0), ((5, 20), 55.0)],     # two blocks
                  [((0, 0), 977.0), ((1, 1), 55.0)]):     # rows AND cols
        bad = _corrupted(w, edits)
        assert _repair_both(bad, plan_j, plan_t) == (None, None)
        bad_params = {"fc": {"w": torch.as_tensor(bad)}}
        ok, flagged = ft.audit_weights_against_plan(bad_params, plan_t)
        assert not ok
        out, repaired = ft.repair_weights_against_plan(bad_params, plan_t,
                                                       flagged)
        assert repaired is None and out is bad_params   # untouched


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_stacked_stage_repairs_in_place(dtype):
    """Stage weights carry a leading reps axis; locator sums match, and
    the single-damaged-block gate is global across slices. The torch
    solver gives the verdicts of the JAX package's float64 host solver;
    its float64 solves are bitwise."""
    w = normal(2, (3, 8, 32))
    wlc = tcore.stacked_weight_locators_matmul(torch.as_tensor(w), 16)
    jwlc = jcore.stacked_weight_locators_matmul(jnp.asarray(w), 16)
    for fld in ("r1", "r2", "c1", "c2"):
        np.testing.assert_array_equal(getattr(wlc, fld),
                                      np.asarray(getattr(jwlc, fld)))
    rtol = WR.REPAIR_RTOL if dtype == torch.float32 else WR.HOST_RTOL
    tol = float(WR.locator_tol(wlc, rtol))
    jtol = float(JWR.locator_tol(jwlc, rtol, xp=np))
    assert tol == jtol

    def fix(bad):
        f, v = WR.repair_stacked_matmul_weight(torch.as_tensor(bad), wlc,
                                               tol, dtype=dtype)
        return to_np(f.to(torch.float32)), int(v)

    bad = _corrupted(w, [((1, 4, 20), 977.0)])
    fixed, verdict = fix(bad)
    jfixed, jverdict = JWR.repair_stacked_matmul_weight(bad, jwlc, jtol,
                                                        xp=np)
    assert verdict == int(jverdict) == WR.REPAIRED
    if dtype == torch.float32:
        np.testing.assert_allclose(fixed, w, rtol=0, atol=2e-2)
    else:
        np.testing.assert_array_equal(fixed, w)
        np.testing.assert_array_equal(fixed, jfixed.astype(np.float32))
    # damage in two repeat slices = two touched blocks: escalate
    bad2 = _corrupted(w, [((0, 0, 0), 977.0), ((2, 1, 17), 55.0)])
    _, verdict = fix(bad2)
    _, jverdict = JWR.repair_stacked_matmul_weight(bad2, jwlc, jtol, xp=np)
    assert verdict == int(jverdict) == WR.ESCALATE


def test_stacked_entry_repairs_through_the_plan():
    """A stacked stage entry, flagged by the audit, repaired through
    repair_weights_against_plan; other leaves are shared, not copied."""
    w = torch.as_tensor(normal(3, (3, 8, 32)))
    e = tcore.PlanEntry(
        "stages/b0/ffn/up", tcore.OpSpec("matmul"), TCFG,
        wck=tcore.stacked_weight_checksums_matmul(w, 16),
        wlc=tcore.stacked_weight_locators_matmul(w, 16),
        w_shape=tuple(w.shape), w_dtype="float32", stack=1)
    plan = tcore.ProtectionPlan(entries={e.name: e})
    other = torch.zeros(3)
    params = {"stages": {"b0": {"ffn": {"up": {"w": w.clone()}},
                                "norm": other}}}
    params["stages"]["b0"]["ffn"]["up"]["w"][2, 7, 3] = 64.0
    ok, bad = ft.audit_weights_against_plan(params, plan)
    assert not ok and bad[0].startswith(e.name)
    fixed, repaired = ft.repair_weights_against_plan(params, plan, bad)
    assert repaired == [e.name]
    assert torch.equal(tcore.weight_leaf(fixed, e.name), w)
    assert fixed["stages"]["b0"]["norm"] is other


def test_grouped_entries_name_their_item():
    w = torch.as_tensor(normal(4, (8, 32)))
    e = tcore.matmul_entry("moe/experts", w, TCFG)
    e = dataclasses.replace(e, op=tcore.OpSpec("grouped_matmul"))
    plan = tcore.ProtectionPlan(entries={"moe/experts": e})
    params = {"moe": {"experts": {"w": w}}}
    with pytest.raises(NotImplementedError, match="1.11"):
        ft.audit_weights_against_plan(params, plan)
    with pytest.raises(NotImplementedError, match="1.11"):
        ft.repair_weights_against_plan(params, plan, ["moe/experts: x"])


# --------------------------------------------------------------------------
# dtype drift: bf16 and quantized int8 leaves
# --------------------------------------------------------------------------

def test_bf16_leaf_audits_and_repairs_bitwise():
    w = normal(3, (8, 32))
    wj, wt = _both(w, "bfloat16")
    plan_j, plan_t = _plans(wj, wt)
    ok, bad = ft.audit_weights_against_plan({"fc": {"w": wt}}, plan_t)
    assert ok and bad == []
    bad_t = wt.clone()
    bad_t[2, 9] += 977.0
    bad_j = wj.at[2, 9].add(jnp.asarray(977.0, wj.dtype))
    ok, flagged = ft.audit_weights_against_plan({"fc": {"w": bad_t}}, plan_t)
    assert not ok
    fixed, repaired = ft.repair_weights_against_plan({"fc": {"w": bad_t}},
                                                     plan_t, flagged)
    assert repaired == ["fc"]
    got = tcore.weight_leaf(fixed, "fc")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), wt.view(torch.int16))
    ok, jflag = jft.audit_weights_against_plan({"fc": {"w": bad_j}}, plan_j)
    jfixed, _ = jft.repair_weights_against_plan({"fc": {"w": bad_j}},
                                                plan_j, jflag)
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(jcore.weight_leaf(jfixed, "fc")).view(np.int16))


def test_int8_quantized_leaf_repairs_exactly():
    """A plan built over int8 codes has exact f64 locator sums, so a
    corrupted code is restored EXACTLY and the dequantized weights are
    untouched; the codes and scale equal the JAX package's."""
    w = normal(4, (8, 32))
    q, scale = quantize_weight(torch.as_tensor(w))
    jq, jscale = jquant(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    plan_j, plan_t = _plans(jq, q)
    bad = q.numpy().astype(np.int16)
    bad[1, 3] += 50
    bad = bad.astype(np.int8)
    ok, flagged = ft.audit_weights_against_plan(
        {"fc": {"w": torch.as_tensor(bad)}}, plan_t)
    assert not ok
    fixed, repaired = ft.repair_weights_against_plan(
        {"fc": {"w": torch.as_tensor(bad)}}, plan_t, flagged)
    assert repaired == ["fc"]
    got = tcore.weight_leaf(fixed, "fc")
    assert got.dtype == torch.int8
    assert torch.equal(got, q)
    assert torch.equal(dequantize_weight(got, scale),
                       dequantize_weight(q, scale))
    np.testing.assert_array_equal(dequantize_weight(q, scale).numpy(),
                                  np.asarray(jdequant(jq, jscale)))
    gj, gt = _repair_both(bad, plan_j, plan_t, dtype="int8")
    np.testing.assert_array_equal(to_np(gt), np.asarray(gj))


# --------------------------------------------------------------------------
# the device (f32, branchless) path the campaign scores
# --------------------------------------------------------------------------

def test_device_path_repairs_like_jax():
    w = normal(5, (16, 32))
    wlc = tcore.weight_locators_matmul(torch.as_tensor(w), 16)
    tol = WR.locator_tol(wlc, WR.REPAIR_RTOL, dtype=torch.float32)
    jwlc = jcore.weight_locators_matmul(jnp.asarray(w), 16)
    jtol = JWR.locator_tol(jwlc, JWR.REPAIR_RTOL, xp=jnp)
    assert float(tol) == float(jtol)
    jfix = jax.jit(lambda ww: JWR.repair_matmul_weight(ww, jwlc, jtol,
                                                       xp=jnp))
    cases = [(_corrupted(w, [((3, 20), 977.0)]), WR.REPAIRED),
             (w, WR.CLEAN),
             (_corrupted(w, [((0, 0), 977.0), ((1, 1), 55.0)]), WR.ESCALATE)]
    for bad, want in cases:
        fixed, verdict = WR.repair_matmul_weight(torch.as_tensor(bad), wlc,
                                                 tol)
        jfixed, jverdict = jfix(jnp.asarray(bad))
        assert int(verdict) == int(jverdict) == want
        np.testing.assert_allclose(to_np(fixed), np.asarray(jfixed),
                                   rtol=0, atol=1e-4)
        if want == WR.REPAIRED:
            np.testing.assert_allclose(to_np(fixed), w, rtol=0, atol=2e-2)
        else:
            np.testing.assert_array_equal(to_np(fixed), bad)
    wc = normal(6, (8, 4, 3, 3))
    cwlc = tcore.weight_locators_conv(torch.as_tensor(wc))
    ctol = WR.locator_tol(cwlc, WR.REPAIR_RTOL, dtype=torch.float32)
    bad = wc.copy()
    bad[5, :, 1] = 256.0
    fixed, verdict = WR.repair_conv_weight(torch.as_tensor(bad), cwlc, ctol)
    assert int(verdict) == WR.REPAIRED
    np.testing.assert_allclose(to_np(fixed), wc, rtol=0, atol=2e-2)


# --------------------------------------------------------------------------
# audit-side satellites: falsy-zero scales + missing trusted keys
# --------------------------------------------------------------------------

def test_all_zero_fingerprint_is_a_scale_not_a_missing_one():
    """w_asum == 0.0 (all-zero leaf) must not fall back to the signed
    sum; the serving audit's fingerprint fallback flags signed drift."""
    e = tcore.matmul_entry("z", cfg=TCFG)        # policy-only: no wck
    e.w_shape, e.w_dtype = (4, 4), "float32"
    e.w_sum, e.w_asum = 0.0, 0.0
    plan = tcore.ProtectionPlan(entries={"z": e})
    plan.validate({"z": {"w": torch.zeros((4, 4))}})
    cancel = torch.zeros((4, 4))
    cancel[0, 0], cancel[1, 1] = 0.5, -0.5
    with pytest.raises(tcore.PlanStaleError, match="content changed"):
        plan.validate({"z": {"w": cancel}})
    drift = torch.zeros((4, 4))
    drift[0, 0] = 1e-3
    ok, bad = ft.audit_weights_against_plan({"z": {"w": drift}}, plan)
    assert not ok and any("fingerprint" in b for b in bad)


def test_audit_weights_missing_trusted_key_reported_not_raised():
    params = {"a": {"w": torch.ones((2, 2))}, "b": [torch.ones(3)]}
    trusted = ft.weight_checksums(params)
    jtrusted = jft.weight_checksums({"a": {"w": jnp.ones((2, 2))},
                                     "b": [jnp.ones(3)]})
    assert sorted(trusted) == sorted(jtrusted)
    for k in trusted:
        assert float(trusted[k]) == float(jtrusted[k])
    trusted["ghost/w"] = np.asarray(1.0, np.float32)
    ok, bad = ft.audit_weights(params, trusted)
    assert not ok and "ghost/w" in bad
    params["a"]["w"] = params["a"]["w"] * 2
    ok, bad = ft.audit_weights(params, trusted)
    assert "a/w" in bad


def test_plan_auditor_ladder():
    """Audit -> repair in place -> restore -> refuse, with the verdicts
    and counters the serving session records."""
    w = torch.as_tensor(normal(7, (8, 32)))
    plan = tcore.ProtectionPlan(
        entries={"fc": tcore.matmul_entry("fc", w, TCFG)})
    clean = {"fc": {"w": w}}
    aud = ft.PlanAuditor(plan, restore_fn=lambda: clean)
    assert aud.audit_or_restore(clean) is clean
    assert aud.last_verdict == "clean"
    one = {"fc": {"w": w.clone()}}
    one["fc"]["w"][1, 2] = 300.0
    out = aud.audit_or_restore(one)
    assert aud.last_verdict == "repaired" and aud.last_repair_s > 0
    assert torch.equal(out["fc"]["w"], w)
    two = {"fc": {"w": w.clone()}}
    two["fc"]["w"][0, 0] = 300.0
    two["fc"]["w"][5, 20] = 300.0
    assert aud.audit_or_restore(two) is clean
    assert aud.last_verdict == "restored"
    assert (aud.stats["weight_repairs"], aud.stats["weight_restores"]) == \
        (1, 1)
    with pytest.raises(ft.WeightDivergenceError):
        ft.PlanAuditor(plan).audit_or_restore(two)
    with pytest.raises(ft.WeightDivergenceError, match="still diverges"):
        ft.PlanAuditor(plan, restore_fn=lambda: two).audit_or_restore(two)


def test_step_runner_audits_and_retries():
    """StepRunner audits on its cadence (step 0 included) and retries a
    step whose verdict carries a residual."""
    w = torch.as_tensor(normal(8, (8, 32)))
    plan = tcore.ProtectionPlan(
        entries={"fc": tcore.matmul_entry("fc", w, TCFG)})
    calls = []

    def step_fn(state, batch):
        calls.append(batch)
        resid = 1 if len(calls) == 1 else 0
        return state, {"report": tcore.FaultReport(resid, 0, resid),
                       "loss": 0.5}

    runner = ft.StepRunner(step_fn, ft.FTPolicy(audit_weights_every=1),
                           plan=plan)
    bad = {"params": {"fc": {"w": w.clone()}}}
    bad["params"]["fc"]["w"][4, 4] = -512.0
    state, metrics = runner.run(bad, "b0")
    assert torch.equal(state["params"]["fc"]["w"], w)
    assert runner.stats["weight_repairs"] == 1
    assert runner.stats["retries"] == 1 and len(calls) == 2
    assert runner.stats["faults_detected"] == 1
