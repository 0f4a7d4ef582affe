"""The port's async serving driver (repro_torch.serving.driver) and its
launcher (repro_torch.launch.serve) on the reduced SmolLM-360M, with the
JAX package's params carried across as numpy arrays: the admission cases
of tests/test_serving_driver.py (deadline, backpressure, oversized
prompt, no step()), drain parity with the JAX package's greedy_reference
and the port's ProtectedSession, fault attribution through a fault_scope
entered on the submitting thread, the controller's mid-stream repair, and
one concurrent-submit stress test. Tokens must match exactly."""
import sys
import threading
import time

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
from repro_torch.core import workflow  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as TM  # noqa: E402
from repro_torch.serving import (ProtectedSession, ServingDriver,  # noqa: E402
                                 SubmitVerdict, greedy_reference)
from torch_parity import tree_np  # noqa: E402

ARCH = "smollm-360m-smoke"
MAX_LEN = 24
LENS = (5, 8, 6, 11, 4, 9)


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


def _wait(pred, timeout=60.0, what="condition"):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _driver(served, **kw):
    cfg, _, params, plan = served
    kw.setdefault("slots", 1)
    return ServingDriver(params, cfg, kw.pop("plan", plan),
                         max_len=MAX_LEN, device="cpu", **kw)


# ---------------------------------------------------------------------------
# admission-side semantics
# ---------------------------------------------------------------------------

def test_driver_deadline_expires_in_queue(served):
    """A request whose TTL lapses while still queued finishes as
    "timeout" and never occupies a slot - swept by the controller while
    the runner admits nothing."""
    cfg = served[0]
    d = _driver(served)
    try:
        with d.paused():
            v = d.submit(_prompts(cfg, (5,))[0], max_new_tokens=2,
                         deadline_s=0.05)
            assert v.accepted and v.verdict == "queued"
            _wait(lambda: d.stats.record(v.rid).finish_reason == "timeout",
                  what="controller deadline sweep")
        report = d.drain()
    finally:
        d.close()
    rec = {r["id"]: r for r in report["requests"]}[v.rid]
    assert rec["finish_reason"] == "timeout"
    assert rec["slot"] is None and rec["admitted_at"] is None
    assert report["counters"]["timeouts"] == 1
    assert report["completed"] == 0


def test_driver_backpressure_when_queue_full(served):
    """The bounded queue answers "rejected" instead of growing; after a
    drain, admission reopens."""
    cfg = served[0]
    d = _driver(served, queue_capacity=2)
    p = _prompts(cfg, (5,))[0]
    try:
        with d.paused():
            v1 = d.submit(p, max_new_tokens=2)
            v2 = d.submit(p, max_new_tokens=2)
            v3 = d.submit(p, max_new_tokens=2)
            assert d.queue_depth == 2
        assert v1.accepted and v2.accepted
        assert isinstance(v3, SubmitVerdict) and not v3.accepted
        assert v3.verdict == "rejected" and v3.reason == "queue_full"
        report = d.drain()
        assert report["completed"] == 2
        assert report["counters"]["rejected"] == 1
        assert report["counters"]["dropped"] == 0
        v4 = d.submit(p, max_new_tokens=2)
        assert v4.accepted
        report = d.drain()
        assert report["completed"] == 3
    finally:
        d.close()
    rec = {r["id"]: r for r in report["requests"]}[v3.rid]
    assert rec["finish_reason"] == "rejected" and rec["slot"] is None


def test_driver_oversized_prompt_dropped(served):
    d = _driver(served)
    try:
        v = d.submit(np.arange(MAX_LEN), max_new_tokens=1)
        assert not v.accepted and v.verdict == "dropped"
        assert v.reason == "oversized_prompt"
        report = d.drain()
    finally:
        d.close()
    assert report["counters"]["dropped"] == 1


def test_driver_step_surface_disabled(served):
    d = _driver(served)
    try:
        with pytest.raises(RuntimeError, match="asynchronous"):
            d.step()
        with pytest.raises(RuntimeError, match="asynchronous"):
            d.run()
    finally:
        d.close()
    with pytest.raises(ValueError, match="queue_capacity"):
        _driver(served, queue_capacity=0)


# ---------------------------------------------------------------------------
# drain + parity with the session and the JAX package's greedy_reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels,sync_lag",
                         [(False, 1), (True, 1), (False, 0)],
                         ids=["plain", "kernels", "sync_lag0"])
def test_driver_drain_finishes_all_with_parity(served, kernels, sync_lag):
    """More requests than slots: drain serves every one (no drops, no
    timeouts), each request's tokens equal the port's ProtectedSession's,
    its unbatched unprotected greedy_reference's and (plain route) the
    JAX package's, and every forward made one host read."""
    cfg, pj, params, plan = served
    if kernels:
        plan = tcore.force_fused_matmul(plan)
    gen = 4
    prompts = _prompts(cfg, LENS)
    d = _driver(served, plan=plan, slots=2, sync_lag=sync_lag)
    workflow.HOST_READS = 0
    try:
        verdicts = [d.submit(p, max_new_tokens=gen) for p in prompts]
        assert all(v.accepted for v in verdicts)
        report = d.drain()
    finally:
        d.close()
    c = report["counters"]
    assert report["completed"] == len(prompts)
    for key in ("dropped", "timeouts", "rejected", "faults_detected"):
        assert c[key] == 0, (key, c)
    assert workflow.HOST_READS == c["prefills"] + c["decode_steps"]
    assert len(d.stats.decode_log) == c["decode_steps"]

    sess = ProtectedSession(params, cfg, plan, slots=2, max_len=MAX_LEN,
                            device="cpu")
    rids = [sess.submit(p, max_new_tokens=gen) for p in prompts]
    sess.run()
    ucfg = cfg.replace(abft=False)
    ucfg_j = JCF.get(ARCH).replace(abft=False)
    for v, rid, p in zip(verdicts, rids, prompts):
        want = greedy_reference(params, ucfg, p, gen, MAX_LEN)
        assert d.tokens_for(v.rid) == want, f"driver {v.rid} diverged"
        assert sess.tokens_for(rid) == want
        if not kernels and sync_lag:
            assert want == jax_greedy(pj, ucfg_j, p, gen, MAX_LEN)
    recs = {r["id"]: r for r in report["requests"]}
    for v in verdicts:
        r = recs[v.rid]
        assert r["finish_reason"] == "length"
        assert r["queue_delay_s"] is not None and r["queue_delay_s"] >= 0
        assert r["ttft_s"] is not None
    assert report["ttft_p99_s"] is not None


def test_driver_finishes_at_kv_capacity(served):
    """A request that runs to the end of its slot's KV capacity finishes
    as "max_len"; the step launched for it before its eviction is
    discarded (its cache write lands on the last position), and the
    request queued behind it is served clean."""
    cfg, _, params, plan = served
    p_long, p_next = _prompts(cfg, (20, 6))
    d = _driver(served)
    try:
        v1 = d.submit(p_long, max_new_tokens=10)
        v2 = d.submit(p_next, max_new_tokens=3)
        report = d.drain()
    finally:
        d.close()
    recs = {r["id"]: r for r in report["requests"]}
    assert recs[v1.rid]["finish_reason"] == "max_len"
    assert recs[v2.rid]["finish_reason"] == "length"
    ucfg = cfg.replace(abft=False)
    assert d.tokens_for(v1.rid) == greedy_reference(params, ucfg, p_long, 10,
                                                    MAX_LEN)
    assert d.tokens_for(v2.rid) == greedy_reference(params, ucfg, p_next, 3,
                                                    MAX_LEN)


# ---------------------------------------------------------------------------
# fault attribution: a fault_scope entered on the submitting thread
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_driver_fault_attributes_to_correct_slot(served, kernels):
    """A decode fault pinned to one slot's logits row, under a fault_scope
    entered around submit/drain on the caller's thread, reaches the
    runner (its context is a copy of the submitter's) and lands on
    exactly the requests that occupied that slot; correction keeps every
    stream clean."""
    cfg, _, params, plan = served
    if kernels:
        plan = tcore.force_fused_matmul(plan)
    slots, target, gen = 2, 1, 4

    def hook(o):
        if o.dim() == 3 and o.shape[0] == slots and o.shape[1] == 1:
            o = o.clone()
            o[target, 0, 3] += 1e4
        return o

    prompts = _prompts(cfg, (5, 8, 6, 11))
    d = _driver(served, plan=plan, slots=slots)
    try:
        with tinj.fault_scope("embed/table", hook):
            verdicts = [d.submit(p, max_new_tokens=gen) for p in prompts]
            report = d.drain()
    finally:
        d.close()
    assert report["completed"] == len(prompts)
    recs = {r["id"]: r for r in report["requests"]}
    hit = [recs[v.rid] for v in verdicts if recs[v.rid]["slot"] == target]
    clean = [recs[v.rid] for v in verdicts
             if recs[v.rid]["slot"] == 1 - target]
    assert hit and clean
    for r in hit:
        assert r["faults_detected"] >= 1, r
        assert r["corrections_applied"] >= 1, r
        assert r["residuals"] == 0
    for r in clean:
        assert r["faults_detected"] == 0, r
    assert report["counters"]["residual_steps"] == 0
    ucfg = cfg.replace(abft=False)
    for v, p in zip(verdicts, prompts):
        assert d.tokens_for(v.rid) == greedy_reference(
            params, ucfg, p, gen, MAX_LEN), f"request {v.rid} diverged"


# ---------------------------------------------------------------------------
# mid-stream weight repair by the controller's audit
# ---------------------------------------------------------------------------

def _corrupt_in_place(params, name):
    w = tcore.weight_leaf(params, name)
    w[(0,) * w.dim()] += 977.0


def test_driver_mid_stream_repair_keeps_serving(served):
    """A weight element flips while a request is mid-stream. The
    controller's audit repairs the block in place before the next decode
    launch (no restore); admission answers throughout, and the tokens stay
    the clean reference's."""
    cfg, _, params, plan = served
    gen = 6
    p = _prompts(cfg, (5,))[0]
    name = next(n for n, e in plan.entries.items()
                if n.startswith("stages/") and e.wlc is not None)
    mine = TM.params_from_numpy(tree_np(params), device="cpu")
    d = ServingDriver(mine, cfg, plan, slots=2, max_len=MAX_LEN,
                      audit_every=1, device="cpu")
    try:
        v0 = d.submit(p, max_new_tokens=gen)
        _wait(lambda: d.tokens_generated(v0.rid) >= 2,
              what="mid-stream progress")
        with d.paused():
            _corrupt_in_place(d.params, name)
            v1 = d.submit(_prompts(cfg, (8,))[0], max_new_tokens=2)
            assert v1.accepted
        report = d.drain()
    finally:
        d.close()
    c = report["counters"]
    assert c["weight_repairs"] == 1 and c["weight_restores"] == 0
    assert c["timeouts"] == 0 and report["completed"] == 2
    assert report["mttr_repair_s"] is not None and report["mttr_repair_s"] > 0
    rec = {r["id"]: r for r in report["requests"]}[v0.rid]
    assert "repaired" in rec["audit_verdicts"]
    assert rec["finish_reason"] == "length"
    assert torch.equal(tcore.weight_leaf(d.params, name),
                       tcore.weight_leaf(params, name))
    ucfg = cfg.replace(abft=False)
    assert d.tokens_for(v0.rid) == greedy_reference(params, ucfg, p, gen,
                                                    MAX_LEN)


# ---------------------------------------------------------------------------
# concurrent submitters
# ---------------------------------------------------------------------------

def test_driver_concurrent_submits_lose_no_request(served):
    """Eight threads submit at once against a small queue, with a short
    switch interval: every verdict has its own rid, accepted + rejected
    counts every submit, and every accepted request completes."""
    cfg = served[0]
    prompts = _prompts(cfg, (3, 4, 5, 6))
    d = _driver(served, slots=2, queue_capacity=3)
    verdicts, mu = [], threading.Lock()

    def worker(i):
        for p in prompts:
            v = d.submit(p, max_new_tokens=1)
            with mu:
                verdicts.append(v)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        report = d.drain(timeout=120)
    finally:
        sys.setswitchinterval(saved)
        d.close()
    assert len(verdicts) == 32
    assert len({v.rid for v in verdicts}) == 32
    accepted = [v for v in verdicts if v.accepted]
    c = report["counters"]
    assert len(accepted) + c["rejected"] == 32 and accepted
    assert report["completed"] == len(accepted)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_serve_driver_and_session_give_the_same_tokens():
    toks_d, st_d = tserve.serve(ARCH, batch=2, prompt_len=6, gen=3,
                                driver=True, device="cpu")
    toks_s, st_s = tserve.serve(ARCH, batch=2, prompt_len=6, gen=3,
                                driver=False, device="cpu")
    assert toks_d.shape == (2, 3)
    np.testing.assert_array_equal(toks_d, toks_s)
    for st in (st_d, st_s):
        assert st["faults_detected"] == 0
        assert st["report"]["completed"] == 2
        assert st["tok_per_s"] > 0
