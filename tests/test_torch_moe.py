"""The port's MoE slice (repro_torch.core.protected_grouped_matmul, the
grouped plan entries of core.plan, the grouped audit and repair of
runtime.ft, layers.moe and the moe blocks of models.transformer) against
the JAX package's, on the reduced Kimi-K2 (`kimi-k2-1t-a32b-smoke`: fp32,
d 64, a dense prefix layer, then 2 repeats of attention and a moe block of
8 experts, top-2, moe_d_ff 48, one shared expert; chunks 1024) and, for
top-1 routing, the reduced Llama-4-Maverick, with the JAX package's own
random params carried across as numpy arrays.

The JAX side's outputs are computed once per pytest run and shared with
every xdist worker (torch_parity.shared_reference); the port side runs in
each test. The JAX package's moe block passes its abft config to
protected_grouped_matmul by position (src/repro/layers/moe.py:41, ROADMAP
3.8), so its protected runs go through a plan (ProtectedModel, the
session), where that call is not taken, and its unprotected ones through
abft=False models, whose outputs are the plain product either way. Its
session reference is torch_parity.steady_jax_session. MoE couples the rows
of a batch through expert capacity, so served tokens are held to the JAX
session's, not to an unbatched greedy reference.

Values agree to fp32 reassociation (rtol 1e-5, atol 1e-5 of the scale);
corrected outputs within rtol 1e-4 (atol 1e-4 of the scale); verdicts,
dispatch indices, host reads and served tokens exactly. Inside the port
the clean protected paths are bitwise the unprotected one, and per_layer
and deferred agree bitwise."""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JCF  # noqa: E402
import repro.core as jcore  # noqa: E402
from repro.core import injection as jinj  # noqa: E402
from repro.layers import linear as JL  # noqa: E402
from repro.layers import moe as JMOE  # noqa: E402
from repro.models import transformer as JM  # noqa: E402
from repro.runtime import ft as jft  # noqa: E402
import repro_torch.configs as TCF  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import injection as tinj  # noqa: E402
from repro_torch.core import protected as TP  # noqa: E402
from repro_torch.core import workflow as TW  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as TST  # noqa: E402
from repro_torch.layers import moe as TMOE  # noqa: E402
from repro_torch.models import transformer as TM  # noqa: E402
from repro_torch.optim import OptConfig, init_opt_state  # noqa: E402
from repro_torch.runtime import ft as tft  # noqa: E402
from repro_torch.serving import ProtectedSession  # noqa: E402
from torch_parity import (_shared_dir, assert_close, normal,  # noqa: E402
                          shared_reference, steady_jax_session, to_np,
                          tree_np, verdict)

ARCH = "kimi-k2-1t-a32b-smoke"
TOP1 = "llama4-maverick-400b-a17b-smoke"
MAX_LEN = 24
SEQ = 8
ROUTER = "stages/b1_moe/moe/router"
MODES = ("per_layer", "deferred")
RTOL = 1e-5


def _scale(x) -> float:
    return float(np.abs(to_np(x)).max()) + 1.0


def _close(got, want, what, rtol=RTOL):
    assert_close(got, want, rtol, rtol * _scale(want), what)


def _tokens(seed, shape, cfg):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _jax_params(arch, cfg_j):
    return tree_np(jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg_j))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(JAX cfg, port cfg, JAX params, port params) of the reduced
    Kimi-K2: the JAX package's random params, drawn once per run."""
    cfg_j, cfg_t = JCF.get(ARCH), TCF.get(ARCH)
    pn = shared_reference(tmp_path_factory, "moe_params",
                          lambda: _jax_params(ARCH, cfg_j))
    return (cfg_j, cfg_t, jax.tree.map(jnp.asarray, pn),
            TM.params_from_numpy(pn, device="cpu"))


@pytest.fixture(scope="module")
def plan_t(model):
    _, cfg_t, _, pt = model
    return tcore.build_plan(pt, cfg_t, batch=1, seq=SEQ, device="cpu")


# ---------------------------------------------------------------------------
# the grouped GEMM
# ---------------------------------------------------------------------------

G, N, K, M = 4, 16, 64, 48
GROUPED_CASES = [(fused, stacked, mode) for fused in (False, True)
                 for stacked in (False, True)
                 for mode in (None, "detect_only")]


def _grouped_operands():
    d = normal(11, (G, N, K))
    w = normal(12, (G, K, M), K ** -0.5)
    bad = w.copy()
    bad[2, 5, 7] += 30.0
    return d, w, bad


def _gcfg(pkg, fused):
    return pkg.DEFAULT_CONFIG.replace(row_chunk=8, col_chunk=16,
                                      use_fused_kernel=fused)


def _jax_grouped():
    """The JAX package's protected_grouped_matmul (called with cfg=, its
    Pallas kernels in interpret mode where the config pins them) on every
    case, and on an expert weight with one element corrupted at rest
    against the clean weight's per-expert checksums."""
    d, w, bad = (jnp.asarray(x) for x in _grouped_operands())
    wck = jcore.plan.stacked_weight_checksums_matmul(w, 16)
    out = {}
    for fused, stacked, mode in GROUPED_CASES:
        o, rep = jcore.protected_grouped_matmul(
            d, w, wck=wck if stacked else None, cfg=_gcfg(jcore, fused),
            mode=mode)
        out[str((fused, stacked, mode))] = {
            "o": np.asarray(o), "rep": [np.asarray(x) for x in rep]}
    for fused in (False, True):
        o, rep = jcore.protected_grouped_matmul(
            d, jnp.asarray(bad), wck=wck, cfg=_gcfg(jcore, fused))
        out[f"bad{fused}"] = {"o": np.asarray(o), "rep": verdict(rep)}
    return out


@pytest.mark.parametrize("fused,stacked,mode", GROUPED_CASES)
def test_grouped_matmul_matches_jax(fused, stacked, mode, tmp_path_factory):
    """O and the verdict (a FaultReport, or in detect_only the evidence:
    the flag exactly; a clean score, the checksums' reassociation noise
    over tau, under 0.1 in both) of protected_grouped_matmul equal the
    JAX package's: with the per-expert checksums stacked on a leading G
    axis and encoded per call, on the plain route and the kernel route
    (the port's plain versions, the JAX package's interpret mode)."""
    ref = shared_reference(tmp_path_factory, "moe_grouped", _jax_grouped)
    want = ref[str((fused, stacked, mode))]
    d, w, _ = (torch.as_tensor(x) for x in _grouped_operands())
    wck = tcore.stacked_weight_checksums_matmul(w, 16) if stacked else None
    o, rep = TP.protected_grouped_matmul(d, w, wck=wck,
                                         cfg=_gcfg(tcore, fused), mode=mode)
    assert tuple(o.shape) == (G, N, M)
    _close(o, want["o"], "O")
    if mode == "detect_only":
        assert int(rep.flag) == int(want["rep"][0]) == 0
        # a clean score is |C - S| / tau, both sides' reassociation noise
        # over the threshold: each package's own noise, far under 1
        assert 0 <= float(rep.score) < 0.1 and float(want["rep"][1]) < 0.1
    else:
        assert verdict(rep) == tuple(int(x) for x in want["rep"]) == \
            (0, 0, 0)


@pytest.mark.parametrize("fused", [False, True])
def test_grouped_weight_fault_matches_jax(fused, tmp_path_factory):
    """One expert weight element corrupted at rest (+30), checked against
    the clean stack's per-expert checksums: the same (detected,
    corrected_by, residual) and output as the JAX package's."""
    ref = shared_reference(tmp_path_factory, "moe_grouped", _jax_grouped)
    want = ref[f"bad{fused}"]
    d, w, bad = (torch.as_tensor(x) for x in _grouped_operands())
    wck = tcore.stacked_weight_checksums_matmul(w, 16)
    o, rep = TP.protected_grouped_matmul(d, bad, wck=wck,
                                         cfg=_gcfg(tcore, fused))
    assert verdict(rep) == tuple(want["rep"])
    assert verdict(rep)[0] == 1
    _close(o, want["o"], "O", rtol=1e-4)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", [None, "detect_only"])
def test_clean_grouped_call_runs_no_loop_over_groups(fused, mode):
    """The clean path is batched over the groups: one clean call makes the
    same torch ops, in the same order, at G = 4 and G = 16 (one host read
    of the group flags in per_layer mode, whatever G is)."""
    seen = []
    for g in (4, 16):
        d = torch.as_tensor(normal(g, (g, N, K)))
        w = torch.as_tensor(normal(g + 1, (g, K, M), K ** -0.5))
        TW.HOST_READS = 0
        with _OpCount() as count:
            _, rep = TP.protected_grouped_matmul(d, w, cfg=_gcfg(tcore, fused),
                                                 mode=mode)
        assert TW.HOST_READS == (0 if mode else 1)
        seen.append(count.ops)
    assert seen[0] == seen[1] and len(seen[0]) > 10


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

# (arch, batch, seq, seed): capacity 5 for 16 tokens of top-2 over 8
# experts (drops), 1.25 * 8 * 2 / 8 = 2.5 (banker's rounding: 2), and
# top-1 at 1.25 * 16 / 8 = 2.5
MOE_CASES = [(ARCH, 2, 8, 21), (ARCH, 1, 8, 22), (TOP1, 2, 8, 23)]


def _jax_dispatch(top_e, e, cap):
    """The JAX package's dispatch (src/repro/layers/moe.py:85-92)."""
    t, k = top_e.shape
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    group_start = jnp.searchsorted(sorted_e, sorted_e, side="left")
    pos = jnp.arange(t * k, dtype=jnp.int32) - group_start
    valid = pos < cap
    slot = jnp.where(valid, sorted_e * cap + pos, e * cap)
    return order, slot, valid, order // k


def _unprotected_jax():
    """A scope in which the JAX package's moe block runs the plain
    product: an ambient mode routes its expert GEMMs through protect_site,
    whose fallback for cfg=None is unprotected (outside a scope its
    positional call would protect them under DEFAULT_CONFIG, ROADMAP 3.8,
    compiling the ladder for outputs that are the plain product's)."""
    return jcore.plan_scope(None, mode="detect_only")


def _jax_moe(arch, b, s, seed):
    cfg = JCF.get(arch)
    p = JMOE.init_moe(jax.random.PRNGKey(seed), cfg, jnp.float32)
    x = jnp.asarray(normal(seed, (b, s, cfg.d_model)))
    with _unprotected_jax():
        y, rep, aux = JMOE.apply_moe(p, x, cfg, None)
    t = b * s
    logits, _ = JL.apply_dense(p["router"], x.reshape(t, -1), None,
                               name="router")
    probs = jax.nn.softmax(logits, axis=-1)
    top_w, top_e = jax.lax.top_k(probs, cfg.top_k)
    cap = int(max(1, round(cfg.capacity_factor * t * cfg.top_k
                           / cfg.num_experts)))
    order, slot, valid, token_of = _jax_dispatch(top_e, cfg.num_experts, cap)
    return {"params": tree_np(p), "x": np.asarray(x), "y": np.asarray(y),
            "aux": np.asarray(aux), "flag": int(rep.flag), "cap": cap,
            "top_e": np.asarray(top_e), "slot": np.asarray(slot),
            "valid": np.asarray(valid), "token_of": np.asarray(token_of)}


@pytest.mark.parametrize("arch,b,s,seed", MOE_CASES)
def test_apply_moe_matches_jax(arch, b, s, seed, tmp_path_factory):
    """apply_moe's output and aux equal the JAX package's (rtol 1e-5),
    its routing and dispatch (top-k experts, slot, valid, token_of)
    exactly: capacity drops in the first case, a capacity of 1.25 * t * k
    / E = 2.5 rounded to 2 in the others, top-2 and top-1."""
    ref = shared_reference(tmp_path_factory, f"moe_block_{arch}_{b}_{s}",
                           lambda: _jax_moe(arch, b, s, seed))
    cfg = TCF.get(arch)
    p = TM.params_from_numpy(ref["params"], device="cpu")
    x = torch.as_tensor(ref["x"])
    y, rep, aux = TMOE.apply_moe(p, x, cfg, None)
    _close(y, ref["y"], "y")
    _close(aux, ref["aux"], "aux")
    assert verdict(rep) == (0, 0, 0) and ref["flag"] == 0
    t = b * s
    cap = TMOE.capacity(cfg, t)
    assert cap == ref["cap"]
    if seed != 21:
        assert cap == 2        # round(2.5) == 2
    logits = x.reshape(t, -1) @ p["router"]["w"]
    _, top_e = TMOE.route(torch.softmax(logits, dim=-1), cfg.top_k)
    assert np.array_equal(to_np(top_e), ref["top_e"])
    order, slot, valid, token_of = TMOE.dispatch(top_e, cfg.num_experts, cap)
    assert np.array_equal(to_np(slot), ref["slot"])
    assert np.array_equal(to_np(valid), ref["valid"])
    assert np.array_equal(to_np(token_of), ref["token_of"])
    if seed == 21:
        assert not bool(valid.all())           # drops happened


def test_route_breaks_ties_to_the_lower_expert():
    """Equal probabilities keep the lower expert index first, as
    jax.lax.top_k does."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]],
                     np.float32)
    w, e = TMOE.route(torch.as_tensor(probs), 2)
    jw, je = jax.lax.top_k(jnp.asarray(probs), 2)
    assert np.array_equal(to_np(e), np.asarray(je))
    assert to_np(e).tolist() == [[1, 2], [0, 1]]


# ---------------------------------------------------------------------------
# plans, audit and repair
# ---------------------------------------------------------------------------

def _prefix_moe(cfg):
    """The reduced Kimi-K2 with its dense prefix FFN made a moe block: an
    unstacked (E, K, M) expert stack, which the plan encodes per expert."""
    return cfg.replace(prefix_pattern=("attn_full", "moe"))


PREFIX_GATE = "prefix/b1_moe/moe/gate"
STAGE_GATE = "stages/b1_moe/moe/gate"


def _site_doc(s):
    shape = None if s.shape is None else (s.shape.n, s.shape.m, s.shape.ch)
    return (s.path, s.op.kind, s.k_dim, shape, s.stack, s.w_view, s.optional)


def _plan_doc(plan):
    doc = {}
    for name, e in plan.entries.items():
        doc[name] = {
            "cfg": dataclasses.asdict(e.cfg), "kind": e.op.kind,
            "stack": e.stack, "w_shape": list(e.w_shape),
            "w_dtype": e.w_dtype, "w_sum": e.w_sum,
            "wck": None if e.wck is None else [
                np.asarray(e.wck.cw1), np.asarray(e.wck.cw2),
                int(e.wck.col_chunk)],
            "wlc": None if e.wlc is None else [
                np.asarray(getattr(e.wlc, f)) for f in ("r1", "r2", "c1",
                                                         "c2")]}
    return doc


def _jax_plans(tmp_path_factory):
    """The JAX package's specs and plans of the reduced Kimi-K2 and of its
    moe-prefix variant (whose params are drawn here too), the latter also
    saved as a plan file; its audit and repair of one damaged element of
    the prefix's and of a stage's expert stack."""
    cfg = JCF.get(ARCH)
    cfg3 = _prefix_moe(cfg)
    p = jax.tree.map(jnp.asarray, _jax_params(ARCH, cfg))
    p3 = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(1),
                                                    cfg3)
    out = {"params3": tree_np(p3)}
    for key, c, pp in (("kimi", cfg, p), ("prefix", cfg3, p3)):
        plan = jcore.build_plan(pp, c, batch=1, seq=SEQ)
        out[key] = {"sites": [list(_site_doc(s)) for s in
                              jcore.protection_spec(c, 1, SEQ).sites],
                    "plan": _plan_doc(plan)}
    plan3 = jcore.build_plan(p3, cfg3, batch=1, seq=SEQ)
    path = str(_shared_dir(tmp_path_factory) / "moe_jax_plan.json")
    plan3.save(path)
    out["path"] = path
    audits = {}
    for name, idx in ((PREFIX_GATE, (3, 10, 20)), (STAGE_GATE, (1, 3, 10, 20))):
        leaf = np.array(jcore.weight_leaf(p3, name))
        leaf[idx] += 64.0
        bad = jft.set_weight_leaf(p3, name, jnp.asarray(leaf))
        ok, flagged = jft.audit_weights_against_plan(bad, plan3)
        fixed, repaired = jft.repair_weights_against_plan(bad, plan3,
                                                          flagged)
        audits[name] = {"ok": ok, "bad": [b.split(":")[0] for b in flagged],
                        "repaired": repaired,
                        "fixed": None if repaired is None else np.asarray(
                            jcore.weight_leaf(fixed, name))}
    out["audits"] = audits
    return out


@pytest.fixture(scope="module")
def jax_plans(tmp_path_factory):
    return shared_reference(tmp_path_factory, "moe_plans",
                            lambda: _jax_plans(tmp_path_factory))


@pytest.mark.parametrize("variant", ["kimi", "prefix"])
def test_plan_matches_jax(model, jax_plans, variant):
    """protection_spec's sites and build_plan's entries equal the JAX
    package's: the router a stacked fp32 matmul site, the expert GEMMs
    shapeless grouped sites; a stage's (reps, E, K, M) expert stack is
    fingerprint-only, an unstacked (E, K, M) one gets per-expert
    checksums and locators equal to the reference's."""
    _, cfg_t, _, pt = model
    ref = jax_plans[variant]
    if variant == "prefix":
        cfg_t = _prefix_moe(cfg_t)
        pt = TM.params_from_numpy(jax_plans["params3"], device="cpu")
    sites = [list(_site_doc(s)) for s in
             tcore.protection_spec(cfg_t, 1, SEQ).sites]
    assert sites == ref["sites"]
    plan = tcore.build_plan(pt, cfg_t, batch=1, seq=SEQ, device="cpu")
    got = _plan_doc(plan)
    assert list(got) == list(ref["plan"])
    for name, want in ref["plan"].items():
        g = got[name]
        for f in ("cfg", "kind", "stack", "w_shape", "w_dtype"):
            assert g[f] == want[f], (name, f)
        assert g["w_sum"] == pytest.approx(want["w_sum"], rel=1e-5, abs=1e-4)
        assert (g["wck"] is None) == (want["wck"] is None), name
        assert (g["wlc"] is None) == (want["wlc"] is None), name
        if g["wck"] is not None:
            assert g["wck"][2] == want["wck"][2]
            for x, y in zip(g["wck"][:2], want["wck"][:2]):
                assert x.shape == y.shape, name
                assert_close(x, y, 1e-5, 1e-4 * _scale(y), name)
        if g["wlc"] is not None:
            for x, y in zip(g["wlc"], want["wlc"]):
                assert x.dtype == np.float64
                np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)
    kinds = {n: e.op.kind for n, e in plan.entries.items()}
    grouped = [n for n, k in kinds.items() if k == "grouped_matmul"]
    assert len(grouped) == 3 * (1 + (variant == "prefix"))
    for n in grouped:
        e = plan[n]
        assert e.w_sum is not None
        assert (e.wck is None) == bool(e.stack)
        if not e.stack:
            assert tuple(e.wck.cw1.shape) == (8, 1, e.w_shape[1])


def test_plan_files_load_both_ways(model, jax_plans, tmp_path):
    """A plan with grouped entries (unstacked and stage-stacked) saved by
    either package loads in the other and validates against the same
    params; the per-expert checksums survive the trip."""
    cfg3 = _prefix_moe(TCF.get(ARCH))
    p3 = TM.params_from_numpy(jax_plans["params3"], device="cpu")
    loaded = tcore.ProtectionPlan.load(jax_plans["path"], device="cpu")
    loaded.validate(p3)
    mine = tcore.build_plan(p3, cfg3, batch=1, seq=SEQ, device="cpu")
    assert loaded.names() == mine.names()
    for n in (PREFIX_GATE, STAGE_GATE):
        assert loaded[n].op.kind == "grouped_matmul"
        assert (loaded[n].wck is None) == (mine[n].wck is None)
    _close(loaded[PREFIX_GATE].wck.cw2, mine[PREFIX_GATE].wck.cw2, "cw2")
    mine.save(str(tmp_path / "port_plan.json"))
    back = jcore.ProtectionPlan.load(str(tmp_path / "port_plan.json"))
    back.validate(jax.tree.map(jnp.asarray, jax_plans["params3"]))
    assert back.names() == loaded.names()
    assert back[STAGE_GATE].wck is None and back[STAGE_GATE].wlc is None
    _close(back[PREFIX_GATE].wck.cw1, mine[PREFIX_GATE].wck.cw1, "cw1")


@pytest.mark.parametrize("name", [PREFIX_GATE, STAGE_GATE])
def test_grouped_audit_and_repair_match_jax(jax_plans, name):
    """One element of an expert stack damaged at rest (+64): the audit
    flags that entry alone in both packages; an unstacked (E, K, M) stack
    is repaired in place from its per-expert locators, bitwise the clean
    leaf and equal to the JAX package's repair; a stage's stack, which the
    plan only fingerprints, is reported by its fingerprint and left to the
    restore rung (no repair) in both."""
    cfg3 = _prefix_moe(TCF.get(ARCH))
    p3 = TM.params_from_numpy(jax_plans["params3"], device="cpu")
    plan = tcore.build_plan(p3, cfg3, batch=1, seq=SEQ, device="cpu")
    ok, bad = tft.audit_weights_against_plan(p3, plan)
    assert ok and bad == []
    want = jax_plans["audits"][name]
    idx = (3, 10, 20) if name == PREFIX_GATE else (1, 3, 10, 20)
    clean = tcore.weight_leaf(p3, name)
    leaf = clean.clone()
    leaf[idx] += 64.0
    damaged = tft.set_weight_leaf(p3, name, leaf)
    ok, flagged = tft.audit_weights_against_plan(damaged, plan)
    assert not ok and not want["ok"]
    assert [b.split(":")[0] for b in flagged] == want["bad"] == [name]
    if name == STAGE_GATE:
        assert "fingerprint" in flagged[0]
    fixed, repaired = tft.repair_weights_against_plan(damaged, plan, flagged)
    assert repaired == want["repaired"]
    if repaired is None:
        assert name == STAGE_GATE and fixed is damaged
        return
    assert repaired == [name]
    assert torch.equal(tcore.weight_leaf(fixed, name), clean)
    assert np.array_equal(to_np(tcore.weight_leaf(fixed, name)),
                          want["fixed"])


# ---------------------------------------------------------------------------
# the protected model
# ---------------------------------------------------------------------------

def _add_j(delta):
    """A JAX fault hook adding `delta` (traced: 0 leaves the site clean) at
    one router logit of every call."""
    return lambda o: o.at[2, 5].add(delta.astype(o.dtype))


def _hook_t(o):
    o = o.clone()
    o[2, 5] += 50.0
    return o


def _jax_verdicts(model, mode):
    """The JAX ProtectedModel's per-section verdicts and logits for a clean
    prefill and one with +50 at one router logit in both repeats, one
    jitted program for both runs (the fault's delta is an argument)."""
    cfg_j, _, pj, _ = model
    plan_j = jcore.build_plan(pj, cfg_j, batch=1, seq=SEQ)
    pm = jcore.ProtectedModel(JM.prefill_apply(cfg_j, MAX_LEN), plan_j)

    def forward(p, t, delta):
        with jinj.fault_scope(ROUTER, _add_j(delta)):
            return pm(p, t, correction=mode)

    run = jax.jit(forward)
    toks = jnp.asarray(_tokens(3, (1, SEQ), cfg_j))
    out = {}
    for path, delta in ((None, 0.0), (ROUTER, 50.0)):
        (lj, _), rj = run(pj, toks, jnp.float32(delta))
        out[str(path)] = {"verdicts": {k: verdict(v)
                                       for k, v in rj.by_layer.items()},
                          "logits": np.asarray(lj)}
    return out


@pytest.mark.parametrize("mode", MODES)
def test_protected_model_verdicts_match_jax(model, plan_t, mode,
                                            tmp_path_factory):
    """Through ProtectedModel, the port's per-section verdicts equal the
    JAX package's, clean and with a fault_scope hook on the fp32 router
    (the drill seam the reference has at a moe block); the logits agree
    (rtol 1e-5 clean, 1e-4 corrected). Host reads: one per site call
    per_layer (24 matmul sites and 3 grouped ones in each of 2 repeats:
    30), one deferred."""
    _, cfg_t, _, pt = model
    ref = shared_reference(tmp_path_factory, f"moe_verdicts_{mode}",
                           lambda: _jax_verdicts(model, mode))
    toks = torch.as_tensor(_tokens(3, (1, SEQ), cfg_t))
    pm = tcore.ProtectedModel(TM.prefill_apply(cfg_t, MAX_LEN), plan_t)
    for path in (None, ROUTER):
        TW.HOST_READS = 0
        scope = (tinj.fault_scope(path, _hook_t) if path
                 else contextlib.nullcontext())
        with scope, torch.no_grad():
            (lt, _), rt = pm(pt, toks, correction=mode)
        if path is None:
            assert TW.HOST_READS == {"per_layer": 30, "deferred": 1}[mode]
        want = ref[str(path)]
        got = {k: verdict(v) for k, v in rt.by_layer.items()}
        assert got == want["verdicts"], path
        assert {k for k, v in got.items() if v[0]} == \
            ({"stages"} if path else set())
        assert all(v[2] == 0 for v in got.values())
        _close(lt, want["logits"], f"logits {path}",
               rtol=1e-4 if path else RTOL)


@pytest.mark.parametrize("grouped_fused", [False, True])
def test_clean_paths_are_bitwise_inside_the_port(model, plan_t,
                                                 grouped_fused):
    """Clean per_layer and deferred prefills give bitwise equal logits and
    caches, equal to the unprotected prefill's: with the plan as built
    and with every matmul entry pinned to the kernel route (the plain
    versions here), the grouped entries on their plain route or pinned to
    the group-axis kernels too."""
    _, cfg_t, _, pt = model
    plans = {"built": plan_t, "fused": tcore.force_fused_matmul(plan_t)}
    if grouped_fused:
        plans = {k: tcore.ProtectionPlan(
            entries={n: dataclasses.replace(e, cfg=e.cfg.replace(
                use_fused_kernel=True)) if e.op.kind == "grouped_matmul"
                else e for n, e in p.entries.items()}, meta=p.meta)
            for k, p in plans.items()}
    toks = torch.as_tensor(_tokens(6, (1, SEQ), cfg_t))
    with torch.no_grad():
        lu, _, cu = TM.prefill(pt, toks, cfg_t.replace(abft=False), MAX_LEN)
        for name, plan in plans.items():
            pm = tcore.ProtectedModel(TM.prefill_apply(cfg_t, MAX_LEN), plan)
            for mode in MODES:
                (lt, ct), rep = pm(pt, toks, correction=mode)
                assert verdict(rep) == (0, 0, 0)
                assert torch.equal(lt, lu), (name, mode)
                for k, v in cu["stages"]["b0_attn_full"].items():
                    assert torch.equal(ct["stages"]["b0_attn_full"][k], v)


def _jax_forward_train(model):
    cfg_j, _, pj, _ = model
    toks = _tokens(7, (2, SEQ), cfg_j)
    ucfg = cfg_j.replace(abft=False)

    def forward(p, t):
        with _unprotected_jax():
            return JM.forward_train(p, t, ucfg)

    logits, _, aux = jax.jit(forward)(pj, jnp.asarray(toks))
    return {"tokens": toks, "logits": np.asarray(logits),
            "aux": np.asarray(aux)}


def test_forward_train_aux_matches_jax(model, tmp_path_factory):
    """forward_train returns the moe blocks' load-balancing loss summed
    over both repeats, equal to the JAX package's (rtol 1e-5), beside the
    logits; the train step takes moe models (its loss adds 0.01 aux; held
    to the JAX package's in tests/test_torch_train_blocks.py)."""
    _, cfg_t, _, pt = model
    ref = shared_reference(tmp_path_factory, "moe_forward_train",
                           lambda: _jax_forward_train(model))
    logits, rep, aux = TM.forward_train(pt, torch.as_tensor(ref["tokens"]),
                                        cfg_t.replace(abft=False))
    _close(logits, ref["logits"], "logits")
    _close(aux, ref["aux"], "aux")
    assert float(aux) > 0 and verdict(rep) == (0, 0, 0)
    _, _, aux_p = TM.forward_train(pt, torch.as_tensor(ref["tokens"]), cfg_t)
    assert torch.equal(aux_p, aux)
    step = TST.make_train_step(cfg_t, OptConfig(), warmup=0)
    toks = torch.as_tensor(ref["tokens"])
    state = {"params": pt, "opt": init_opt_state(pt, OptConfig()),
             "step": torch.zeros((), dtype=torch.int32)}
    _, m = step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert torch.isfinite(m["loss"]) and verdict(m["report"]) == (0, 0, 0)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

LENS = (5, 7, 3)         # one prefill bucket; the third waits for a slot
GEN = 4


def _prompts(cfg):
    rng = np.random.default_rng(1)
    return [rng.integers(0, cfg.vocab_size, (n,)) for n in LENS]


@pytest.fixture(scope="module")
def served_plan(model):
    _, cfg_t, _, pt = model
    return tcore.build_plan(pt, cfg_t, batch=2, seq=MAX_LEN, device="cpu")


def _serve_port(pt, cfg, plan, mode, hook=None):
    sess = ProtectedSession(pt, cfg, plan, slots=2, max_len=MAX_LEN,
                            correction=mode, device="cpu")
    rids = [sess.submit(p, max_new_tokens=GEN) for p in _prompts(cfg)]
    with (tinj.fault_scope(*hook) if hook else contextlib.nullcontext()):
        report = sess.run()
    return sess, rids, report


def _jax_session_tokens(model):
    """The JAX ProtectedSession's tokens per request in deferred mode (a
    plan of its own), its decode steps completed before the host moves
    the slots' positions."""
    cfg_j, _, pj, _ = model
    plan_j = jcore.build_plan(pj, cfg_j, batch=2, seq=MAX_LEN)
    js = steady_jax_session(pj, cfg_j, plan_j, slots=2, max_len=MAX_LEN)
    jr = [js.submit(p, max_new_tokens=GEN) for p in _prompts(cfg_j)]
    report = js.run()
    return {"tokens": [js.tokens_for(r) for r in jr],
            "faults": int(report["counters"]["faults_detected"])}


@pytest.mark.parametrize("mode", MODES)
def test_session_tokens_match_jax(model, served_plan, mode,
                                  tmp_path_factory):
    """2 slots, prompts of 5, 7 and 3 tokens (the third admitted when a
    slot frees), 4 new tokens each: every request's tokens equal the JAX
    ProtectedSession's (deferred, the batch composition its scheduler
    gives: prompts bucketed, as for any model without recurrent blocks)
    in both of the port's modes; no flags, no request echoing its
    prompt."""
    _, cfg_t, _, pt = model
    want = shared_reference(tmp_path_factory, "moe_session",
                            lambda: _jax_session_tokens(model))
    assert want["faults"] == 0
    sess, rids, report = _serve_port(pt, cfg_t, served_plan, mode)
    assert not sess.scheduler.exact_prefill
    assert report["counters"]["faults_detected"] == 0
    assert report["completed"] == len(LENS)
    got = [sess.tokens_for(r) for r in rids]
    assert got == want["tokens"]
    for p, toks in zip(_prompts(cfg_t), got):
        assert len(toks) == GEN and toks != [int(p[-1])] * GEN


def test_session_router_drill_keeps_the_clean_tokens(model, served_plan):
    """+1e4 at one router logit of slot 1's token in one decode step (the
    detect pass and its rerun): detected, corrected with residual 0 and
    attributed to that slot's request; every token equals the clean
    run's."""
    _, cfg_t, _, pt = model
    clean, rids, _ = _serve_port(pt, cfg_t, served_plan, "deferred")
    calls = [0]

    def hook(o):
        if o.shape[0] == 2:                     # a decode step's 2 rows
            calls[0] += 1
            # each decode step calls the router once per repeat; calls
            # 5-6 are the third step's detect pass, 7-8 its rerun
            if calls[0] in (5, 7):
                o = o.clone()
                o[1, 3] += 1e4
        return o

    sess, rids2, report = _serve_port(pt, cfg_t, served_plan, "deferred",
                                      (ROUTER, hook))
    c = report["counters"]
    assert c["faults_detected"] == 1 and c["faults_corrected"] == 1
    assert c["residual_steps"] == 0 and c["faults_unattributed"] == 0
    recs = {r["slot"]: r for r in report["requests"] if r["id"] < 2}
    assert recs[1]["faults_detected"] == 1
    assert recs[1]["corrections_applied"] == 1 and recs[1]["residuals"] == 0
    for a, b in zip(rids, rids2):
        assert sess.tokens_for(b) == clean.tokens_for(a), b


def test_top1_model_serves_in_both_modes():
    """The reduced Llama-4-Maverick (top-1 routing, two moe blocks per
    repeat) builds, plans and serves on the CPU: the same tokens per_layer
    and deferred, no flags."""
    cfg = TCF.get(TOP1)
    pt = TM.init_params(cfg, device="cpu")
    plan = tcore.build_plan(pt, cfg, batch=2, seq=MAX_LEN, device="cpu")
    assert sum(e.op.kind == "grouped_matmul"
               for e in plan.entries.values()) == 6
    toks = {}
    for mode in MODES:
        sess, rids, report = _serve_port(pt, cfg, plan, mode)
        assert report["counters"]["faults_detected"] == 0
        assert report["completed"] == len(LENS)
        toks[mode] = [sess.tokens_for(r) for r in rids]
    assert toks["per_layer"] == toks["deferred"]


def test_serve_cli_runs_kimi_on_the_cpu(capsys):
    """`python -m repro_torch.launch.serve --arch kimi-k2-1t-a32b-smoke
    --device cpu` serves through ServingDriver with no flags."""
    tserve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                 "--prompt-len", "5", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out and "faults=0" in out
