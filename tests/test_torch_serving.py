"""The port's serving slice (repro_torch.serving) on the reduced
SmolLM-360M: scheduler bookkeeping, clean-traffic token parity with both
packages' greedy_reference, EOS eviction and per-request attribution of a
prefill fault (twins of tests/test_serving.py). Params are the JAX
package's, carried across as numpy arrays; tokens must match exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as JCF  # noqa: E402
from repro.models import transformer as JM  # noqa: E402
from repro.serving import greedy_reference as jax_greedy  # noqa: E402
import repro_torch.configs as TCF  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import injection as tinj  # noqa: E402
from repro_torch.models import transformer as TM  # noqa: E402
from repro_torch.serving import (ProtectedSession, SlotScheduler,  # noqa: E402
                                 bucket_for, greedy_reference)
from torch_parity import shared_reference, to_np, tree_np  # noqa: E402

ARCH = "smollm-360m-smoke"
MAX_LEN = 24


# the JAX package's greedy_reference tokens of the prompts of these
# lengths (seed 1, 4 new tokens each), shared with the other smoke-model
# serving file: its prompts are the first of these
GREEDY_LENS = (5, 8, 6, 11, 4, 9)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(cfg, JAX params, port params, port plan) of the smoke model; the
    JAX package's params drawn once per pytest run and shared with every
    xdist worker (torch_parity.shared_reference)."""
    cfg_j = JCF.get(ARCH)
    pn = shared_reference(
        tmp_path_factory, "smollm-360m-smoke_params",
        lambda: tree_np(JM.init_params(jax.random.PRNGKey(0), cfg_j)))
    pj = jax.tree.map(jnp.asarray, pn)
    cfg = TCF.get(ARCH)
    params = TM.params_from_numpy(pn, device="cpu")
    plan = tcore.build_plan(params, cfg, batch=2, seq=MAX_LEN, device="cpu")
    return cfg, pj, params, plan


@pytest.fixture(scope="module")
def jax_greedy_tokens(served, tmp_path_factory):
    """{prompt length: (prompt, the JAX package's greedy_reference
    tokens)} for the prompts of GREEDY_LENS, once per pytest run."""
    cfg, pj, _, _ = served
    ucfg_j = JCF.get(ARCH).replace(abft=False)
    return shared_reference(
        tmp_path_factory, "smollm-360m-smoke_greedy",
        lambda: {len(p): (p, jax_greedy(pj, ucfg_j, p, 4, MAX_LEN))
                 for p in _prompts(cfg, GREEDY_LENS)})


def _jax_greedy_of(tokens, p):
    """The shared JAX greedy tokens of prompt `p` (4 new tokens)."""
    prompt, want = tokens[len(p)]
    assert np.array_equal(prompt, p)
    return want


def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n) for n in lens]


# ---------------------------------------------------------------------------
# scheduler bookkeeping (no device work)
# ---------------------------------------------------------------------------

def test_scheduler_admission_eviction_refill():
    s = SlotScheduler(slots=2, max_len=32)
    reqs = [s.submit(np.arange(4), 8), s.submit(np.arange(6), 8),
            s.submit(np.arange(5), 8)]
    assert all(r is not None for r in reqs)
    placed = s.admit()
    assert [(sl, r.id) for sl, r in placed] == [(0, 0), (1, 1)]
    assert s.admit() == [] and s.busy()
    s.evict(1)
    placed = s.admit()
    assert [(sl, r.id) for sl, r in placed] == [(1, 2)]
    s.evict(0)
    s.evict(1)
    assert not s.busy()
    assert s.submit(np.arange(32), 1) is None
    assert len(s.dropped) == 1 and not s.busy()


def test_scheduler_same_step_evict_then_refill():
    s = SlotScheduler(slots=2, max_len=32)
    r = [s.submit(np.arange(4), 8) for _ in range(4)]
    s.admit()
    s.evict(0)
    s.evict(1)
    placed = s.admit()
    assert [(sl, q.id) for sl, q in placed] == [(0, r[2].id), (1, r[3].id)]
    assert s.active[0] is r[2] and s.active[1] is r[3]
    s2 = SlotScheduler(slots=1, max_len=32)
    a, ok = s2.make_request(np.arange(4), 8)
    assert ok and s2.place(a) == 0
    b, ok = s2.make_request(np.arange(4), 8)
    assert ok and s2.place(b) is None
    assert s2.evict(0) is a
    assert s2.place(b) == 0
    c, ok = s2.make_request(np.arange(64), 1)
    assert not ok and c in s2.dropped and not s2.queue


def test_scheduler_buckets():
    assert bucket_for(5, 64) == 8
    assert bucket_for(8, 64) == 8
    assert bucket_for(9, 64) == 16
    assert bucket_for(40, 48) == 48
    assert bucket_for(5, 64, exact=True) == 5
    rec_cfg = TCF.get(ARCH).replace(stage_pattern=("rec", "ffn"))
    assert SlotScheduler(2, 64, cfg=rec_cfg).exact_prefill


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_session_mixed_prompts_clean_parity(served, kernels, request):
    """More requests than slots, mixed prompt lengths: every request's
    tokens through the deferred protected session equal the port's
    unbatched unprotected greedy_reference and the JAX package's, with
    zero faults and zero drops. With the kernels pinned the prefills take
    the detect route and the 2-slot decode the partials route."""
    cfg, _, params, plan = served
    if kernels:
        plan = tcore.force_fused_matmul(plan)
    gen = 4
    prompts = _prompts(cfg, (5, 8, 6, 11))
    sess = ProtectedSession(params, cfg, plan, slots=2, max_len=MAX_LEN,
                            device="cpu")
    rids = [sess.submit(p, max_new_tokens=gen) for p in prompts]
    report = sess.run()
    assert report["schema"] == "repro.serving/v2"
    assert report["counters"]["dropped"] == 0
    assert report["counters"]["faults_detected"] == 0
    assert report["completed"] == len(prompts)
    log = sess.stats.decode_log
    assert len(log) == report["counters"]["decode_steps"]
    assert all(not any(e["hit"]) for e in log)
    ucfg = cfg.replace(abft=False)
    recs = {r["id"]: r for r in report["requests"]}
    for rid, p in zip(rids, prompts):
        want = greedy_reference(params, ucfg, p, gen, MAX_LEN)
        assert sess.tokens_for(rid) == want, f"request {rid} diverged"
        if not kernels:
            assert want == _jax_greedy_of(
                request.getfixturevalue("jax_greedy_tokens"), p), rid
        r = recs[rid]
        assert r["ttft_s"] is not None and r["completed_at"] is not None
        assert r["tokens_generated"] == gen
        assert r["finish_reason"] == "length"
    assert {recs[rids[2]]["slot"], recs[rids[3]]["slot"]} <= {0, 1}


def test_session_eos_eviction(served):
    """A request whose eos fires stops early and frees its slot."""
    cfg, _, params, plan = served
    gen = 6
    p = _prompts(cfg, (5,))[0]
    stream = greedy_reference(params, cfg.replace(abft=False), p, gen,
                              MAX_LEN)
    eos = stream[2]
    sess = ProtectedSession(params, cfg, plan, slots=1, max_len=MAX_LEN,
                            device="cpu")
    rid = sess.submit(p, max_new_tokens=gen, eos_id=int(eos))
    report = sess.run()
    rec = {r["id"]: r for r in report["requests"]}[rid]
    assert rec["finish_reason"] == "eos"
    cut = stream.index(eos) + 1
    assert sess.tokens_for(rid) == stream[:cut]


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_session_prefill_fault_attributed_to_request(served, kernels):
    """A prefill-only fault at the tied head lands in each admitted
    request's prefill_detected ledger, is corrected without residual, and
    the tokens stay the clean ones."""
    cfg, _, params, plan = served
    if kernels:
        plan = tcore.force_fused_matmul(plan)

    def hook(o):
        if o.dim() == 3 and o.shape[0] == 1 and o.shape[1] > 1:
            o = o.clone()
            o[0, 0, 0] += 1e4
        return o

    prompts = _prompts(cfg, (5, 8))
    sess = ProtectedSession(params, cfg, plan, slots=2, max_len=MAX_LEN,
                            device="cpu")
    rids = [sess.submit(p, max_new_tokens=2) for p in prompts]
    with tinj.fault_scope("embed/table", hook):
        report = sess.run()
    recs = {r["id"]: r for r in report["requests"]}
    ucfg = cfg.replace(abft=False)
    for rid, p in zip(rids, prompts):
        assert recs[rid]["prefill_detected"] == 1
        assert recs[rid]["faults_detected"] >= 1
        assert recs[rid]["residuals"] == 0
        assert sess.tokens_for(rid) == greedy_reference(params, ucfg, p, 2,
                                                        MAX_LEN)
    assert report["counters"]["faults_detected"] >= 2


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_session_decode_fault_localized_to_slot(served, kernels):
    """A decode-only fault in slot 1's logits row is detected, corrected
    and attributed to that slot's request alone; the session's decode log
    holds one entry per decode step, each hit vector naming slot 1, and
    the tokens stay the clean ones."""
    cfg, _, params, plan = served
    if kernels:
        plan = tcore.force_fused_matmul(plan)

    def hook(o):
        if o.dim() == 3 and o.shape[0] == 2 and o.shape[1] == 1:
            o = o.clone()
            o[1, 0, 7] += 1e4
        return o

    prompts = _prompts(cfg, (5, 8))
    sess = ProtectedSession(params, cfg, plan, slots=2, max_len=MAX_LEN,
                            device="cpu")
    rids = [sess.submit(p, max_new_tokens=3) for p in prompts]
    with tinj.fault_scope("embed/table", hook):
        report = sess.run()
    c = report["counters"]
    log = sess.stats.decode_log
    assert c["decode_steps"] == 2 and len(log) == 2
    assert [e["hit"] for e in log] == [[0, 1]] * 2
    assert all(e["dispatch_s"] > 0 for e in log)
    assert "decode_log" not in report
    recs = {r["slot"]: r for r in report["requests"]}
    assert recs[1]["faults_detected"] == 2
    assert recs[1]["corrections_applied"] == 2 and recs[1]["residuals"] == 0
    assert recs[0]["faults_detected"] == 0
    assert c["faults_unattributed"] == 0 and c["residual_steps"] == 0
    ucfg = cfg.replace(abft=False)
    for rid, p in zip(rids, prompts):
        assert sess.tokens_for(rid) == greedy_reference(params, ucfg, p, 3,
                                                        MAX_LEN)


def test_session_refuses_what_is_not_ported(served):
    """A mesh that is not a launch.mesh.Mesh is refused (the sharded
    session itself: tests/test_torch_distributed.py); so is a deferred
    session without a plan."""
    cfg, _, params, plan = served
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        ProtectedSession(params, cfg, plan, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="needs a ProtectionPlan"):
        ProtectedSession(params, cfg, None, correction="deferred",
                         device="cpu")


# ---------------------------------------------------------------------------
# plan-trusted weight audits on the session cadence
# ---------------------------------------------------------------------------

def _audited_entry(plan):
    return next(n for n, e in plan.entries.items()
                if n.startswith("stages/") and e.wlc is not None)


def _corrupt(params, name, flips=1):
    """A copy of the params with `flips` elements of `name`'s leaf raised
    by 977: flip i lands at index (i,)*ndim, so two flips hit distinct
    repeats, rows AND columns - beyond the single-block repair."""
    bad = {k: v for k, v in params.items()}
    parts = name.split("/")
    parent, src = bad, params
    for part in parts[:-1]:
        parent[part] = dict(src[part])
        parent, src = parent[part], src[part]
    leaf = dict(src[parts[-1]])
    w = leaf["w"].clone()
    for i in range(flips):
        w[(i,) * w.dim()] += 977.0
    leaf["w"] = w
    parent[parts[-1]] = leaf
    return bad


def _jax_corrupt(pj, name, flips=1):
    bad = jax.tree.map(lambda x: x, pj)
    parts = name.split("/")
    parent = bad
    for part in parts[:-1]:
        parent = parent[part]
    w = parent[parts[-1]]["w"]
    for i in range(flips):
        w = w.at[(i,) * w.ndim].add(jax.numpy.asarray(977.0, w.dtype))
    parent[parts[-1]]["w"] = w
    return bad


def test_session_audit_refuses_corrupt_weights(served):
    """Two flips sit beyond the in-place repair rung, and without a
    restore_fn the session refuses to serve - in both packages."""
    from repro.core import build_plan as jbuild
    from repro.runtime.ft import WeightDivergenceError as JErr
    from repro.serving import ProtectedSession as JSession
    from repro_torch.runtime.ft import WeightDivergenceError
    cfg, pj, params, plan = served
    name = _audited_entry(plan)
    sess = ProtectedSession(_corrupt(params, name, flips=2), cfg, plan,
                            slots=1, max_len=MAX_LEN, audit_every=1,
                            device="cpu")
    sess.submit(_prompts(cfg, (5,))[0], max_new_tokens=2)
    with pytest.raises(WeightDivergenceError):
        sess.run()
    assert sess.stats.counters["weight_audits"] == 1
    assert sess.stats.counters["weight_repairs"] == 0
    cfg_j = JCF.get(ARCH)
    jplan = jbuild(pj, cfg_j, batch=2, seq=MAX_LEN)
    assert _audited_entry(jplan) == name
    jsess = JSession(_jax_corrupt(pj, name, flips=2), cfg_j, jplan,
                     slots=1, max_len=MAX_LEN, audit_every=1)
    jsess.submit(_prompts(cfg, (5,))[0], max_new_tokens=2)
    with pytest.raises(JErr):
        jsess.run()


def test_session_audit_restores_and_serves(served):
    """Multi-block damage escalates to the restore rung; the restored
    params serve the clean tokens."""
    cfg, _, params, plan = served
    name = _audited_entry(plan)
    sess = ProtectedSession(_corrupt(params, name, flips=2), cfg, plan,
                            slots=1, max_len=MAX_LEN, audit_every=1,
                            restore_fn=lambda: params, device="cpu")
    p = _prompts(cfg, (5,))[0]
    rid = sess.submit(p, max_new_tokens=3)
    report = sess.run()
    c = report["counters"]
    assert c["weight_restores"] == 1 and c["weight_repairs"] == 0
    assert c["weight_audits"] >= 2          # the restore is re-audited
    assert sess.params is params
    rec = {r["id"]: r for r in report["requests"]}[rid]
    assert "clean" in rec["audit_verdicts"]
    ucfg = cfg.replace(abft=False)
    assert sess.tokens_for(rid) == greedy_reference(params, ucfg, p, 3,
                                                    MAX_LEN)


def test_session_mid_stream_repair_keeps_serving(served):
    """A weight element flips while a request is mid-stream. The next
    audit solves the block in place from the plan's locator sums - no
    restore, no dropped request - the leaf is bitwise the original and
    equal to the JAX package's repair of the same damage, and the tokens
    stay the clean reference's."""
    from repro.core import build_plan as jbuild
    from repro.runtime import ft as jft
    from repro_torch.runtime import ft
    cfg, pj, params, plan = served
    gen = 6
    p = _prompts(cfg, (5,))[0]
    name = _audited_entry(plan)
    sess = ProtectedSession(params, cfg, plan, slots=1, max_len=MAX_LEN,
                            audit_every=1, device="cpu")
    rid = sess.submit(p, max_new_tokens=gen)
    for _ in range(2):
        assert sess.step()           # prefill + decode on clean weights
    sess.params = _corrupt(sess.params, name)
    while sess.step():
        pass
    report = sess.stats.report()
    c = report["counters"]
    assert c["weight_repairs"] == 1 and c["weight_restores"] == 0
    assert c["dropped"] == 0
    assert report["mttr_repair_s"] is not None and report["mttr_repair_s"] > 0
    rec = {r["id"]: r for r in report["requests"]}[rid]
    assert "repaired" in rec["audit_verdicts"]
    assert rec["finish_reason"] == "length"
    got = tcore.weight_leaf(sess.params, name)
    assert torch.equal(got, tcore.weight_leaf(params, name))
    ucfg = cfg.replace(abft=False)
    assert sess.tokens_for(rid) == greedy_reference(params, ucfg, p, gen,
                                                    MAX_LEN)
    # the JAX package's ladder on the same damage: the same divergence
    # list, and the same repaired leaf
    jplan = jbuild(pj, JCF.get(ARCH), batch=2, seq=MAX_LEN)
    jbad = _jax_corrupt(pj, name)
    ok_j, bad_j = jft.audit_weights_against_plan(jbad, jplan)
    ok_t, bad_t = ft.audit_weights_against_plan(_corrupt(params, name), plan)
    assert not ok_j and not ok_t and bad_j == bad_t
    fixed_j, rep_j = jft.repair_weights_against_plan(jbad, jplan, bad_j)
    assert rep_j == [name]
    np.testing.assert_array_equal(
        to_np(got), np.asarray(tcore.weight_leaf(fixed_j, name)))
