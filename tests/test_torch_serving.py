"""The port's serving slice (repro_torch.serving) on the reduced
SmolLM-360M: scheduler bookkeeping, clean-traffic token parity with both
packages' greedy_reference, EOS eviction and per-request attribution of a
prefill fault (twins of tests/test_serving.py). Params are the JAX
package's, carried across as numpy arrays; tokens must match exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as JCF  # noqa: E402
from repro.models import transformer as JM  # noqa: E402
from repro.serving import greedy_reference as jax_greedy  # noqa: E402
import repro_torch.configs as TCF  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import injection as tinj  # noqa: E402
from repro_torch.models import transformer as TM  # noqa: E402
from repro_torch.serving import (ProtectedSession, SlotScheduler,  # noqa: E402
                                 bucket_for, greedy_reference)
from torch_parity import tree_np  # noqa: E402

ARCH = "smollm-360m-smoke"
MAX_LEN = 24


@pytest.fixture(scope="module")
def served():
    """(cfg, JAX params, port params, port plan) of the smoke model."""
    cfg_j = JCF.get(ARCH)
    pj = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    cfg = TCF.get(ARCH)
    params = TM.params_from_numpy(tree_np(pj), device="cpu")
    plan = tcore.build_plan(params, cfg, batch=2, seq=MAX_LEN, device="cpu")
    return cfg, pj, params, plan


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
def test_session_mixed_prompts_clean_parity(served, kernels):
    """More requests than slots, mixed prompt lengths: every request's
    tokens through the deferred protected session equal the port's
    unbatched unprotected greedy_reference and the JAX package's, with
    zero faults and zero drops. With the kernels pinned the prefills take
    the detect route and the 2-slot decode the partials route."""
    cfg, pj, params, plan = served
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
            assert want == jax_greedy(pj, JCF.get(ARCH).replace(abft=False),
                                      p, gen, MAX_LEN), rid
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
    cfg, _, params, plan = served
    for kw, item in ((dict(mesh=object()), "1.12"),
                     (dict(audit_every=2), "1.8"),
                     (dict(restore_fn=lambda: params), "1.8")):
        with pytest.raises(NotImplementedError, match=item):
            ProtectedSession(params, cfg, plan, device="cpu", **kw)
    with pytest.raises(ValueError, match="needs a ProtectionPlan"):
        ProtectedSession(params, cfg, None, correction="deferred",
                         device="cpu")
