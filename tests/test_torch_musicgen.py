"""The port's multi-codebook I/O (repro_torch.layers.embedding's K tables
and K·V head, (B, S, K) tokens through models.transformer, the K·V head
entry of core.plan, K-list tokens through serving and the codebook average
of launch.steps.cross_entropy) against the JAX package's, on the reduced
MusicGen-large (`musicgen-large-smoke`: fp32, d 64, 2 layers of attention
and gelu FFN, 4 codebooks of vocab 512, untied head of 64 x 2048, chunks
64) with the JAX package's own random params carried across as numpy
arrays.

The JAX side's outputs are computed once per pytest run and shared with
every xdist worker (torch_parity.shared_reference); the port side runs in
each test. Its session reference is torch_parity.steady_jax_session,
whose decode steps cannot race the host's position update.

Outputs and caches agree to fp32 reassociation (rtol 1e-5, atol 1e-5 of
the output's scale: the K gathers are summed and the GEMMs contract in
another order); the corrected logits of a faulted forward within rtol
1e-4 (atol 1e-4 of the scale); verdicts (detected, corrected_by,
residual), host reads and served tokens exactly. Inside the port the
clean protected paths are bitwise the unprotected one."""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as JCF  # noqa: E402
import repro.core as jcore  # noqa: E402
from repro.core import injection as jinj  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.layers import embedding as JE  # noqa: E402
from repro.models import transformer as JM  # noqa: E402
import repro_torch.configs as TCF  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import injection as tinj  # noqa: E402
from repro_torch.core import workflow as TW  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as TST  # noqa: E402
from repro_torch.layers import embedding as TE  # noqa: E402
from repro_torch.models import transformer as TM  # noqa: E402
from repro_torch.runtime import ft as tft  # noqa: E402
from repro_torch.serving import (ProtectedSession, ServingDriver,  # noqa: E402
                                 greedy_reference)
from torch_parity import (assert_close, normal, shared_reference,  # noqa: E402
                          steady_jax_session, to_np, tree_np, verdict)

ARCH = "musicgen-large-smoke"
K = 4
MAX_LEN = 24
SEQ = 8
HEAD = "embed/head"
STAGE_SITE = "stages/b0_attn_full/attn/wk"
MODES = ("per_layer", "deferred")
RTOL = ATOL = 1e-5


def _cfgs():
    return JCF.get(ARCH), TCF.get(ARCH)


def _scale(x) -> float:
    return float(np.abs(to_np(x)).max()) + 1.0


def _close(got, want, what, rtol=RTOL):
    assert_close(got, want, rtol, rtol * _scale(want), what)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(JAX cfg, port cfg, JAX params, port params): the JAX package's
    random params, drawn once per run."""
    cfg_j, cfg_t = _cfgs()
    pn = shared_reference(
        tmp_path_factory, "musicgen_params",
        lambda: tree_np(jax.jit(JM.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), cfg_j)))
    return (cfg_j, cfg_t, jax.tree.map(jnp.asarray, pn),
            TM.params_from_numpy(pn, device="cpu"))


@pytest.fixture(scope="module")
def plan_t(model):
    _, cfg_t, _, pt = model
    return tcore.build_plan(pt, cfg_t, batch=1, seq=SEQ, device="cpu")


def _tokens(seed, shape, cfg):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


# ---------------------------------------------------------------------------
# the layer and the full-width model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_embed_sum_and_heads_match_jax(model, tied):
    """The sum of the K codebook gathers, and the head's (B, S, K, V)
    fp32 logits unprotected and protected (clean verdicts) in both
    branches: the untied K·V dense head and the tied one, whose weight is
    the (K·V, d) table transposed in place."""
    cfg_j, cfg_t, pj, pt = model
    cfg_j, cfg_t = (c.replace(tie_embeddings=tied) for c in (cfg_j, cfg_t))
    ej, et = dict(pj["embed"]), dict(pt["embed"])
    if tied:
        del ej["head"], et["head"]
    toks = _tokens(5, (2, 5, K), cfg_t)
    xj = JE.embed(ej, jnp.asarray(toks), cfg_j)
    xt = TE.embed(et, torch.as_tensor(toks), cfg_t)
    assert tuple(xt.shape) == (2, 5, cfg_t.d_model)
    _close(xt, xj, "embed")
    table = to_np(et["table"])
    _close(xt, sum(table[k][toks[..., k]] for k in range(K)), "by hand")
    h = normal(6, (2, 5, cfg_t.d_model))
    on_j = jcore.DEFAULT_CONFIG.replace(row_chunk=64, col_chunk=64)
    on_t = tcore.DEFAULT_CONFIG.replace(row_chunk=64, col_chunk=64)
    for abft_j, abft_t in ((None, None), (on_j, on_t)):
        lj, rj = JE.logits_head(ej, jnp.asarray(h), cfg_j, abft_j)
        lt, rt = TE.logits_head(et, torch.as_tensor(h), cfg_t, abft_t)
        assert tuple(lt.shape) == (2, 5, K, cfg_t.vocab_size)
        assert lt.dtype == torch.float32
        _close(lt, lj, f"logits abft={abft_t is not None}")
        assert verdict(rt) == verdict(rj) == (0, 0, 0)
    if tied:
        w = tcore.apply_w_view(et["table"], "tied_head")
        assert tuple(w.shape) == (cfg_t.d_model, K * cfg_t.vocab_size)
        assert w.data_ptr() == et["table"].data_ptr()


def test_musicgen_builds_at_full_width_and_smoke():
    """MusicGen-large at full width: every param and cache leaf has the JAX
    package's shape and type (jax.eval_shape beside torch's fake tensors:
    nothing is allocated), 3,254.8 M params, the head site d x K·V; the
    smoke config builds and runs a forward."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def types(tree):
        return {k: types(v) if isinstance(v, dict)
                else (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tree.items()}

    cfg_j, cfg_t = JCF.get("musicgen-large"), TCF.get("musicgen-large")
    pj = jax.eval_shape(lambda k: JM.init_params(k, cfg_j),
                        jax.random.PRNGKey(0))
    cj = jax.eval_shape(lambda: JM.init_caches(cfg_j, 8, 256))
    with FakeTensorMode():
        pt = TM.init_params(cfg_t, device="cpu")
        ct = TM.init_caches(cfg_t, 8, 256, device="cpu")
    assert types(pt) == types(pj) and types(ct) == types(cj)
    assert types(pt)["embed"] == {
        "table": ((4, 2048, 2048), "bfloat16"),
        "head": {"w": ((2048, 8192), "bfloat16")}}
    assert TM.count_params(cfg_t) == JM.count_params(cfg_j) == 3_254_779_904
    spec = tcore.protection_spec(cfg_t, batch=8, seq=1)
    head = spec.sites[-1]
    assert (head.path, head.k_dim, head.shape.m) == (HEAD, 2048, 8192)
    assert len(spec.sites) == 7 + 1
    small = TCF.get(ARCH)
    p = TM.init_params(small, device="cpu")
    logits, rep, _ = TM.forward_train(
        p, torch.as_tensor(_tokens(1, (1, 3, K), small)), small)
    assert tuple(logits.shape) == (1, 3, K, small.vocab_size)
    assert verdict(rep) == (0, 0, 0)


def _cache_np(c):
    return c["stages"]["b0_attn_full"]


def _jax_prefill_decode(model):
    """Unprotected prefill of 2 rows of SEQ x K tokens, then 3 decode
    steps fed the JAX package's own greedy tokens: logits, the KV caches
    and the tokens of each step."""
    cfg_j, _, pj, _ = model
    uj = cfg_j.replace(abft=False)
    toks = _tokens(4, (2, SEQ, K), cfg_j)
    lj, _, cj = JM.prefill(pj, jnp.asarray(toks), uj, MAX_LEN)
    out = {"tokens": toks, "steps": []}
    for step in range(4):
        nxt = np.array(jnp.argmax(lj, -1))
        out["steps"].append({"logits": np.asarray(lj),
                             "cache": tree_np(_cache_np(cj)), "next": nxt})
        if step < 3:
            lj, _, cj = JM.decode_step(pj, jnp.asarray(nxt), cj, SEQ + step,
                                       uj)
    return out


def test_prefill_and_decode_match_jax(model, tmp_path_factory):
    """Unprotected prefill of (2, 8, 4) tokens and 3 decode steps of
    (2, 1, 4) tokens: (B, 1, K, V) logits and every KV cache leaf agree
    with the JAX package's; the caller's caches are left as they were."""
    _, cfg_t, _, pt = model
    ref = shared_reference(tmp_path_factory, "musicgen_prefill",
                           lambda: _jax_prefill_decode(model))
    ut = cfg_t.replace(abft=False)
    lt, rep, ct = TM.prefill(pt, torch.as_tensor(ref["tokens"]), ut,
                             MAX_LEN)
    assert verdict(rep) == (0, 0, 0)
    for step, want in enumerate(ref["steps"]):
        assert tuple(lt.shape) == (2, 1, K, cfg_t.vocab_size)
        _close(lt, want["logits"], f"logits after {step} decode steps")
        for k, v in want["cache"].items():
            _close(_cache_np(ct)[k], v, f"cache {k} after {step} steps")
        nxt = torch.argmax(lt, dim=-1)
        assert np.array_equal(to_np(nxt), want["next"]), step
        if step == 3:
            break
        before = {k: v.clone() for k, v in _cache_np(ct).items()}
        lt, _, ct_new = TM.decode_step(pt, nxt, ct, SEQ + step, ut)
        for k, v in before.items():
            assert torch.equal(_cache_np(ct)[k], v)
        ct = ct_new


def test_cross_entropy_averages_codebooks_as_jax():
    """cross_entropy on (B, S, K, V) logits equals the JAX package's and
    the mean of the K per-codebook losses (rtol 1e-6)."""
    logits = normal(8, (2, 5, K, 64), 3.0)
    labels = np.random.default_rng(9).integers(0, 64, (2, 5, K))
    got = float(TST.cross_entropy(torch.as_tensor(logits),
                                  torch.as_tensor(labels)))
    want = float(JST.cross_entropy(jnp.asarray(logits),
                                   jnp.asarray(labels)))
    per_cb = [float(TST.cross_entropy(torch.as_tensor(logits[:, :, k]),
                                      torch.as_tensor(labels[:, :, k])))
              for k in range(K)]
    assert got == pytest.approx(want, rel=1e-6)
    assert got == pytest.approx(np.mean(per_cb), rel=1e-6)


# ---------------------------------------------------------------------------
# the plan and the protected forward
# ---------------------------------------------------------------------------

def test_plan_matches_jax_and_loads_both_ways(model, plan_t, tmp_path):
    """build_plan walks the same sites with the same shapes, chunks,
    checksums and locators, the head as one d x K·V entry; a plan file of
    either package loads in the other; the tied variant's weight view
    covers the K tables."""
    cfg_j, cfg_t, pj, pt = model
    plan_j = jcore.build_plan(pj, cfg_j, batch=1, seq=SEQ)
    assert list(plan_t.names()) == list(plan_j.names())
    assert len(plan_t) == 8 and plan_t.names()[-1] == HEAD
    head = plan_t[HEAD]
    assert tuple(head.w_shape) == (64, K * 512) and head.w_view is None
    assert tuple(head.wck.cw1.shape) == (K * 512 // 64, 64)
    for name in plan_j.names():
        a, b = plan_j[name], plan_t[name]
        assert dataclasses.asdict(a.cfg) == dataclasses.asdict(b.cfg), name
        assert (a.stack, a.w_view, tuple(a.w_shape), a.w_dtype) == \
            (b.stack, b.w_view, tuple(b.w_shape), b.w_dtype), name
        assert a.wck.col_chunk == b.wck.col_chunk
        for x, y in ((a.wck.cw1, b.wck.cw1), (a.wck.cw2, b.wck.cw2)):
            assert tuple(x.shape) == tuple(y.shape), name
            assert_close(y, x, 1e-5, 1e-4 * _scale(x), name)
        for fld in ("r1", "r2", "c1", "c2"):
            x, y = getattr(a.wlc, fld), getattr(b.wlc, fld)
            assert y.dtype == np.float64
            np.testing.assert_allclose(y, x, rtol=1e-6, atol=1e-6)
        assert b.w_sum == pytest.approx(a.w_sum, rel=1e-5, abs=1e-4)
    plan_t.validate(pt)
    plan_j.save(str(tmp_path / "jax_plan.json"))
    loaded = tcore.ProtectionPlan.load(str(tmp_path / "jax_plan.json"),
                                       device="cpu")
    loaded.validate(pt)
    assert tuple(loaded[HEAD].w_shape) == (64, K * 512)
    assert_close(loaded[HEAD].wck.cw1, head.wck.cw1, 1e-5,
                 1e-4 * _scale(head.wck.cw1), "loaded head")
    plan_t.save(str(tmp_path / "port_plan.json"))
    back = jcore.ProtectionPlan.load(str(tmp_path / "port_plan.json"))
    back.validate(pj)
    assert back.names() == plan_j.names()
    for name in plan_j.names():
        assert_close(back[name].wck.cw2, plan_j[name].wck.cw2, 1e-5,
                     1e-4 * _scale(plan_j[name].wck.cw2), name)
    tied = cfg_t.replace(tie_embeddings=True)
    pt_tied = {**pt, "embed": {"table": pt["embed"]["table"]}}
    tplan = tcore.build_plan(pt_tied, tied, batch=1, seq=SEQ, device="cpu")
    e = tplan["embed/table"]
    assert e.w_view == "tied_head" and tuple(e.w_shape) == (64, K * 512)
    flat = pt["embed"]["table"].reshape(K * 512, 64).T.contiguous()
    want = tcore.matmul_entry("head", flat, e.cfg)
    for x, y in ((e.wck.cw1, want.wck.cw1), (e.wck.cw2, want.wck.cw2)):
        assert_close(x, y, 1e-6, 1e-6 * _scale(y), "tied head")


def test_plan_auditor_repairs_the_codebook_head(model, plan_t):
    """The weight audit finds one damaged element of the K·V head,
    repairs it in place from the plan's locator sums (bitwise the clean
    weight) and restores beyond one block, like any dense entry."""
    _, _, _, pt = model
    clean = pt["embed"]["head"]["w"]
    aud = tft.PlanAuditor(plan_t, restore_fn=lambda: pt)
    assert aud.audit_or_restore(pt) is pt and aud.last_verdict == "clean"
    bad = {**pt, "embed": {**pt["embed"], "head": {"w": clean.clone()}}}
    bad["embed"]["head"]["w"][5, 3 * 512 + 17] += 40.0
    assert not aud.audit(bad)
    assert [m.split(":")[0] for m in aud.last_bad] == [HEAD]
    fixed = aud.audit_or_restore(bad)
    assert aud.last_verdict == "repaired"
    assert aud.stats["weight_repairs"] == 1
    assert torch.equal(fixed["embed"]["head"]["w"], clean)
    two = {**pt, "embed": {**pt["embed"], "head": {"w": clean.clone()}}}
    two["embed"]["head"]["w"][5, 17] += 40.0
    two["embed"]["head"]["w"][9, 2 * 512 + 100] += 40.0
    assert aud.audit_or_restore(two) is pt
    assert aud.last_verdict == "restored"


def _add_j(delta):
    """A JAX fault hook adding `delta` (traced: 0 leaves the site clean) at
    one element of the site's output."""
    return lambda o: o.at[0, 2, 5].add(delta.astype(o.dtype))


def _hook_t(o):
    o = o.clone()
    o[0, 2, 5] += 50.0
    return o


def _jax_verdicts(model, mode):
    """The JAX ProtectedModel's per-section verdicts and logits for a clean
    prefill and ones with +50 at one element of the K·V head's or a stage
    site's output (firing in every repeat). One jitted program serves the
    three runs: both sites carry a fault hook whose delta is an argument,
    0 where the run leaves the site clean (the JAX package keeps an
    untouched output bitwise the clean path's)."""
    cfg_j, _, pj, _ = model
    plan_j = jcore.build_plan(pj, cfg_j, batch=1, seq=SEQ)
    pm = jcore.ProtectedModel(JM.prefill_apply(cfg_j, MAX_LEN), plan_j)

    def forward(p, t, d_head, d_site):
        with jinj.fault_scope(HEAD, _add_j(d_head)), \
                jinj.fault_scope(STAGE_SITE, _add_j(d_site)):
            return pm(p, t, correction=mode)

    run = jax.jit(forward)
    toks = jnp.asarray(_tokens(3, (1, SEQ, K), cfg_j))
    out = {}
    for path, deltas in ((None, (0.0, 0.0)), (HEAD, (50.0, 0.0)),
                         (STAGE_SITE, (0.0, 50.0))):
        (lj, _), rj = run(pj, toks, *map(jnp.float32, deltas))
        out[str(path)] = {"verdicts": {k: verdict(v)
                                       for k, v in rj.by_layer.items()},
                          "logits": np.asarray(lj)}
    return out


@pytest.mark.parametrize("mode", MODES)
def test_protected_model_verdicts_match_jax(model, plan_t, mode,
                                            tmp_path_factory):
    """Through ProtectedModel, the port's per-section verdicts equal the
    JAX package's, clean and with a fault_scope hook on the K·V head and
    on a stage site; the corrected logits agree (rtol 1e-4). Host reads:
    one per site call per_layer (7 sites x 2 repeats + the head), one
    deferred."""
    _, cfg_t, _, pt = model
    ref = shared_reference(tmp_path_factory, f"musicgen_verdicts_{mode}",
                           lambda: _jax_verdicts(model, mode))
    toks = torch.as_tensor(_tokens(3, (1, SEQ, K), cfg_t))
    pm = tcore.ProtectedModel(TM.prefill_apply(cfg_t, MAX_LEN), plan_t)
    for path in (None, HEAD, STAGE_SITE):
        TW.HOST_READS = 0
        scope = (tinj.fault_scope(path, _hook_t) if path
                 else contextlib.nullcontext())
        with scope, torch.no_grad():
            (lt, _), rt = pm(pt, toks, correction=mode)
        if path is None:
            assert TW.HOST_READS == {"per_layer": 15, "deferred": 1}[mode]
        want = ref[str(path)]
        got = {k: verdict(v) for k, v in rt.by_layer.items()}
        assert got == want["verdicts"], path
        hit = {None: None, HEAD: HEAD, STAGE_SITE: "stages"}[path]
        assert {k for k, v in got.items() if v[0]} == \
            ({hit} if hit else set())
        assert all(v[2] == 0 for v in got.values())
        assert tuple(lt.shape) == (1, 1, K, cfg_t.vocab_size)
        _close(lt, want["logits"], f"logits {path}", rtol=1e-4)


def test_kernel_route_is_bitwise_the_plain_one_inside_the_port(model,
                                                               plan_t):
    """With the kernels pinned (their plain versions here), clean
    per_layer and deferred prefills give bitwise equal (B, 1, K, V)
    logits and caches, equal to the unprotected prefill's."""
    _, cfg_t, _, pt = model
    fused = tcore.force_fused_matmul(plan_t)
    toks = torch.as_tensor(_tokens(6, (1, SEQ, K), cfg_t))
    out = {}
    with torch.no_grad():
        for mode in MODES:
            pm = tcore.ProtectedModel(TM.prefill_apply(cfg_t, MAX_LEN),
                                      fused)
            out[mode], rep = pm(pt, toks, correction=mode)
            assert verdict(rep) == (0, 0, 0)
        lu, _, cu = TM.prefill(pt, toks, cfg_t.replace(abft=False), MAX_LEN)
    for mode in MODES:
        assert torch.equal(out[mode][0], lu), mode
        for k, v in _cache_np(cu).items():
            assert torch.equal(_cache_np(out[mode][1])[k], v), (mode, k)


# ---------------------------------------------------------------------------
# serving K-list tokens
# ---------------------------------------------------------------------------

LENS = (5, 9, 3)         # the third waits for a slot
GEN = 4


def _prompts(cfg):
    rng = np.random.default_rng(1)
    return [rng.integers(0, cfg.vocab_size, (n, K)) for n in LENS]


@pytest.fixture(scope="module")
def served_plan(model):
    _, cfg_t, _, pt = model
    return tcore.build_plan(pt, cfg_t, batch=2, seq=MAX_LEN, device="cpu")


def _serve_port(model, plan, mode, hook=None):
    _, cfg_t, _, pt = model
    sess = ProtectedSession(pt, cfg_t, plan, slots=2, max_len=MAX_LEN,
                            correction=mode, device="cpu")
    rids = [sess.submit(p, max_new_tokens=GEN) for p in _prompts(cfg_t)]
    with (tinj.fault_scope(HEAD, hook) if hook
          else contextlib.nullcontext()):
        report = sess.run()
    return sess, rids, report


def _jax_session_tokens(model):
    """The JAX ProtectedSession's K-list tokens per request, served with
    protection off (its scheduling, bucketed prefills and cache inserts
    as when protected), its decode steps completed before the host moves
    the slots' positions."""
    cfg_j, cfg_t, pj, _ = model
    js = steady_jax_session(pj, cfg_j.replace(abft=False), None, slots=2,
                            max_len=MAX_LEN)
    jr = [js.submit(p, max_new_tokens=GEN) for p in _prompts(cfg_t)]
    js.run()
    return [js.tokens_for(r) for r in jr]


@pytest.mark.parametrize("mode", MODES)
def test_session_tokens_match_jax(model, served_plan, mode,
                                  tmp_path_factory):
    """2 slots, (5, 4), (9, 4) and (3, 4) prompts, 4 new tokens each:
    every request's tokens are K-lists equal to the JAX ProtectedSession's
    and to the port's unbatched greedy_reference, not an echo of the
    prompt; the async driver serves the same ones; no flags."""
    _, cfg_t, _, pt = model
    want = shared_reference(tmp_path_factory, "musicgen_session",
                            lambda: _jax_session_tokens(model))
    sess, rids, report = _serve_port(model, served_plan, mode)
    assert report["counters"]["faults_detected"] == 0
    assert report["completed"] == len(LENS)
    got = [sess.tokens_for(r) for r in rids]
    assert got == want
    assert all(len(t) == GEN and all(len(x) == K for x in t) for t in got)
    ucfg = cfg_t.replace(abft=False)
    for p, toks in zip(_prompts(cfg_t), got):
        assert greedy_reference(pt, ucfg, p, GEN, MAX_LEN) == toks
        assert toks[0] != p[-1].tolist()
        assert len({tuple(x) for x in toks}) > 1
    d = ServingDriver(pt, cfg_t, served_plan, slots=2, max_len=MAX_LEN,
                      correction=mode, device="cpu")
    try:
        vs = [d.submit(p, max_new_tokens=GEN) for p in _prompts(cfg_t)]
        d.drain()
        assert [d.tokens_for(v.rid) for v in vs] == want
    finally:
        d.close()


def test_session_head_fault_is_attributed_to_its_slot(model, served_plan):
    """+1e4 at one logit of slot 1's row of the K·V head in one decode
    step (the detect pass and its rerun): detected, corrected with
    residual 0 and attributed to that slot's request alone, on the
    flattened K·V logits; every token equals the clean run's."""
    clean, rids, _ = _serve_port(model, served_plan, "deferred")
    calls = [0]

    def hook(o):
        if o.shape[:2] == (2, 1):
            calls[0] += 1
            # call 1 is the first decode step, 2 the second's detect pass,
            # 3 its rerun
            if calls[0] in (2, 3):
                o = o.clone()
                o[1, 0, 3 * 512 + 7] += 1e4
        return o

    sess, rids2, report = _serve_port(model, served_plan, "deferred", hook)
    c = report["counters"]
    assert c["faults_detected"] == 1 and c["faults_corrected"] == 1
    assert c["faults_unattributed"] == 0 and c["residual_steps"] == 0
    recs = {r["slot"]: r for r in report["requests"] if r["id"] < 2}
    assert recs[1]["faults_detected"] == 1
    assert recs[1]["corrections_applied"] == 1 and recs[1]["residuals"] == 0
    assert recs[0]["faults_detected"] == 0
    assert [e["hit"] for e in sess.stats.decode_log].count([0, 1]) == 1
    for a, b in zip(rids, rids2):
        assert sess.tokens_for(b) == clean.tokens_for(a), b


def test_serve_cli_runs_musicgen_on_the_cpu(capsys):
    """`python -m repro_torch.launch.serve --arch musicgen-large-smoke
    --device cpu` serves (B, S, K) prompts through the driver with no
    flags and returns (B, gen, K) tokens."""
    tserve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                 "--prompt-len", "5", "--gen", "3"])
    out = capsys.readouterr().out
    assert f"generated (2, 3, {K}) tokens" in out and "faults=0" in out
