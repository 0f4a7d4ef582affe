"""The port's Mamba-2 (SSD) slice (repro_torch.layers.ssm, the ssm blocks of
models.transformer and core.plan, and serving a recurrent state) against
the JAX package's, on the reduced Mamba2-1.3B (`mamba2-1.3b-smoke`: fp32,
d 64, 2 layers, N 16, P 16, chunk 8) with the JAX package's own random
params carried across as numpy arrays.

Outputs and states agree to fp32 reassociation (rtol 1e-5, atol 1e-5 of
the output's scale: the einsums contract in another order); cache types,
verdicts (detected, corrected_by, residual), host reads and served tokens
exactly. The reference's cache types are kept where they are quirks: the
conv tail is made bfloat16 in any model and comes back float32 from a
float32 model's forward; h is float32 in any model."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as JCF  # noqa: E402
import repro.core as jcore  # noqa: E402
from repro.core import injection as jinj  # noqa: E402
from repro.layers import ssm as JS  # noqa: E402
from repro.models import transformer as JM  # noqa: E402
import repro_torch.configs as TCF  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import injection as tinj  # noqa: E402
from repro_torch.core import workflow as TW  # noqa: E402
from repro_torch.layers import ssm as TS  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as TM  # noqa: E402
from repro_torch.serving import ProtectedSession  # noqa: E402
from torch_parity import (assert_close, normal,  # noqa: E402
                          shared_reference, steady_jax_session, to_np,
                          tree_np, verdict)

ARCH = "mamba2-1.3b-smoke"
MAX_LEN = 24
SEQ = 11                 # not a multiple of the chunk (8): the padding branch
IN_PROJ = "stages/b0_ssm/ssm/in_proj"
OUT_PROJ = "stages/b0_ssm/ssm/out_proj"
HEAD = "embed/head"
RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(JAX cfg, port cfg, JAX params, port params): the JAX package's
    random params, drawn once per pytest run and shared with every xdist
    worker (torch_parity.shared_reference)."""
    cfg_j, cfg_t = JCF.get(ARCH), TCF.get(ARCH)
    pn = shared_reference(
        tmp_path_factory, "ssm_params",
        lambda: tree_np(JM.init_params(jax.random.PRNGKey(0), cfg_j)))
    return (cfg_j, cfg_t, jax.tree.map(jnp.asarray, pn),
            TM.params_from_numpy(pn, device="cpu"))


@pytest.fixture(scope="module")
def plan_t(model):
    """The port's plan; the JAX package's is built where a test or a
    shared reference needs it."""
    _, cfg_t, _, pt = model
    return tcore.build_plan(pt, cfg_t, batch=1, seq=SEQ, device="cpu")


def _scale(x) -> float:
    return float(np.abs(to_np(x)).max()) + 1.0


def _close(got, want, what):
    assert_close(got, want, RTOL, ATOL * _scale(want), what)


def _block(pj, pt):
    """The first repeat's ssm params of both packages."""
    return tuple(jax.tree.map(lambda t: t[0], p["stages"]["b0_ssm"]["ssm"])
                 for p in (pj, pt))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_tail", [False, True], ids=["zeros", "tail"])
def test_causal_conv_matches_jax(with_tail):
    x = normal(1, (2, 5, 12))
    w = normal(2, (4, 12), 0.5)
    tail = normal(3, (2, 3, 12)) if with_tail else None
    yj, tj = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                             None if tail is None else jnp.asarray(tail))
    yt, tt = TS._causal_conv(torch.as_tensor(x), torch.as_tensor(w),
                             None if tail is None else torch.as_tensor(tail))
    _close(yt, yj, "conv y")
    _close(tt, tj, "conv tail")
    # a bfloat16 tail meeting a float32 input comes back float32
    tb = torch.zeros((2, 3, 12), dtype=torch.bfloat16)
    assert TS._causal_conv(torch.as_tensor(x), torch.as_tensor(w),
                           tb)[1].dtype == torch.float32


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_ssd_chunked_matches_jax(with_h0):
    b, s, h, p, n, q = 2, 16, 3, 4, 5, 8
    xh = normal(4, (b, s, h, p))
    dt = np.abs(normal(5, (b, s, h), 0.5))
    a = -np.exp(normal(6, (h,), 0.3))
    bm, cm = normal(7, (b, s, n)), normal(8, (b, s, n))
    h0 = normal(9, (b, h, p, n)) if with_h0 else None
    yj, hj = JS._ssd_chunked(*map(jnp.asarray, (xh, dt, a, bm, cm)), q,
                             h0=None if h0 is None else jnp.asarray(h0))
    yt, ht = TS._ssd_chunked(*map(torch.as_tensor, (xh, dt, a, bm, cm)), q,
                             h0=None if h0 is None else torch.as_tensor(h0))
    _close(yt, yj, "ssd y")
    _close(ht, hj, "ssd h_last")
    seg = np.array([0.5, -1.0, 2.0])
    np.testing.assert_allclose(to_np(TS._segsum(torch.as_tensor(seg))),
                               np.asarray(JS._segsum(jnp.asarray(seg))))


@pytest.mark.parametrize("path,s", [("train", SEQ), ("prefill", 8),
                                    ("prefill", SEQ), ("decode", 1)])
def test_apply_ssm_paths_match_jax(model, path, s):
    """The uncached forward, the chunked prefill from a carried state (8
    rows: one chunk; 11: the padding branch) and the one-step decode
    recurrence, output and new state."""
    cfg_j, cfg_t, pj, pt = model
    bj, bt = _block(pj, pt)
    x = normal(10 + s, (2, s, cfg_t.d_model))
    state_np = None
    if path != "train":
        di, h, p, n = TS._dims(cfg_t)
        state_np = {"h": normal(30, (2, h, p, n), 0.3),
                    "conv": normal(31, (2, cfg_t.conv_kernel - 1,
                                        di + 2 * n), 0.3)}
    sj = None if state_np is None else jax.tree.map(jnp.asarray, state_np)
    st = None if state_np is None else {k: torch.as_tensor(v)
                                        for k, v in state_np.items()}
    oj, rj, nj = JS.apply_ssm(bj, jnp.asarray(x), cfg_j, None, sj)
    ot, rt, nt = TS.apply_ssm(bt, torch.as_tensor(x), cfg_t, None, st)
    _close(ot, oj, f"{path} out")
    assert verdict(rt) == verdict(rj) == (0, 0, 0)
    if state_np is None:
        assert nj is None and nt is None
        return
    for k in ("h", "conv"):
        assert str(nt[k].dtype).split(".")[-1] == str(nj[k].dtype), k
        _close(nt[k], nj[k], f"{path} new {k}")
    # the state it was given is left as it was
    assert np.array_equal(to_np(st["h"]), state_np["h"])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _cache_types(tree):
    return {k: _cache_types(v) if isinstance(v, dict)
            else (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tree.items()}


def test_prefill_and_decode_match_jax_with_cache_types(model):
    """Unprotected prefill (11 tokens, 2 rows) then 3 decode steps: logits
    and every cache leaf agree with the JAX package's, their types
    included (conv bfloat16 as made, float32 after a float32 forward)."""
    cfg_j, cfg_t, pj, pt = model
    uj, ut = cfg_j.replace(abft=False), cfg_t.replace(abft=False)
    assert _cache_types(TM.init_caches(ut, 2, MAX_LEN, device="cpu")) == \
        _cache_types(JM.init_caches(uj, 2, MAX_LEN))
    toks = np.random.default_rng(4).integers(0, cfg_t.vocab_size, (2, SEQ))
    lj, _, cj = JM.prefill(pj, jnp.asarray(toks), uj, MAX_LEN)
    lt, rep, ct = TM.prefill(pt, torch.as_tensor(toks), ut, MAX_LEN)
    assert verdict(rep) == (0, 0, 0)
    for step in range(4):
        _close(lt, lj, f"logits after {step} decode steps")
        assert _cache_types(ct) == _cache_types(cj), step
        for k in ("h", "conv"):
            _close(ct["stages"]["b0_ssm"][k], cj["stages"]["b0_ssm"][k],
                   f"cache {k} after {step} decode steps")
        if step == 3:
            break
        nxt = np.array(jnp.argmax(lj, -1))
        lj, _, cj = JM.decode_step(pj, jnp.asarray(nxt), cj, SEQ + step, uj)
        before = {k: v.clone() for k, v in ct["stages"]["b0_ssm"].items()}
        lt, _, ct_new = TM.decode_step(pt, torch.as_tensor(nxt), ct,
                                       SEQ + step, ut)
        # the caller's state is left as it was
        for k, v in before.items():
            assert torch.equal(ct["stages"]["b0_ssm"][k], v)
        ct = ct_new


def test_prefill_then_decode_equals_longer_prefill(model):
    """The recurrence carried through the cache: prefill of 12 then one
    decode step of token 13 gives the logits and state of a prefill of
    13."""
    _, cfg_t, _, pt = model
    ut = cfg_t.replace(abft=False)
    toks = torch.as_tensor(
        np.random.default_rng(5).integers(0, cfg_t.vocab_size, (1, 13)))
    l12, _, c12 = TM.prefill(pt, toks[:, :12], ut, MAX_LEN)
    l1, _, c1 = TM.decode_step(pt, toks[:, 12:], c12, 12, ut)
    l13, _, c13 = TM.prefill(pt, toks, ut, MAX_LEN)
    _close(l1, l13, "logits")
    for k in ("h", "conv"):
        _close(c1["stages"]["b0_ssm"][k], c13["stages"]["b0_ssm"][k], k)


def test_full_width_shapes_and_types_match_jax():
    """Mamba2-1.3B at full width: every param and cache leaf has the JAX
    package's shape and type (jax.eval_shape beside torch's fake tensors:
    nothing is allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg_j, cfg_t = JCF.get("mamba2-1.3b"), TCF.get("mamba2-1.3b")
    pj = jax.eval_shape(lambda k: JM.init_params(k, cfg_j),
                        jax.random.PRNGKey(0))
    cj = jax.eval_shape(lambda: JM.init_caches(cfg_j, 8, 256))
    with FakeTensorMode():
        pt = TM.init_params(cfg_t, device="cpu")
        ct = TM.init_caches(cfg_t, 8, 256, device="cpu")
    assert _cache_types(pt) == _cache_types(pj)
    assert _cache_types(ct) == _cache_types(cj)
    assert _cache_types(pt)["stages"]["b0_ssm"]["ssm"]["A_log"] == \
        ((48, 64), "float32")
    assert _cache_types(ct)["stages"]["b0_ssm"] == {
        "h": ((48, 8, 64, 64, 128), "float32"),
        "conv": ((48, 8, 3, 4352), "bfloat16")}
    assert TM.count_params(cfg_t) == JM.count_params(cfg_j)
    assert 1.4e9 < TM.count_params(cfg_t) < 1.5e9


# ---------------------------------------------------------------------------
# the plan and the protected forward
# ---------------------------------------------------------------------------

def test_plan_matches_jax(model, plan_t, tmp_path):
    """build_plan walks the same sites with the same shapes, chunks and
    checksums, and a plan file of either package loads in the other."""
    cfg_j, cfg_t, pj, pt = model
    plan_j = jcore.build_plan(pj, cfg_j, batch=1, seq=SEQ)
    assert list(plan_t.names()) == list(plan_j.names()) == \
        [IN_PROJ, OUT_PROJ, HEAD]
    spec = tcore.protection_spec(cfg_t, batch=1, seq=SEQ)
    assert [(s.path, s.k_dim, s.shape.m) for s in spec.sites] == \
        [(IN_PROJ, 64, 2 * 128 + 2 * 16 + 8), (OUT_PROJ, 128, 64),
         (HEAD, 64, 512)]
    for name in plan_j.names():
        a, b = plan_j[name], plan_t[name]
        assert dataclasses.asdict(a.cfg) == dataclasses.asdict(b.cfg), name
        assert (a.stack, tuple(a.w_shape), a.w_dtype) == \
            (b.stack, tuple(b.w_shape), b.w_dtype), name
        assert a.wck.col_chunk == b.wck.col_chunk
        for x, y in ((a.wck.cw1, b.wck.cw1), (a.wck.cw2, b.wck.cw2)):
            assert tuple(x.shape) == tuple(y.shape), name
            assert_close(y, x, 1e-5, 1e-4 * _scale(x), name)
    plan_t.validate(pt)
    plan_j.save(str(tmp_path / "jax_plan.json"))
    loaded = tcore.ProtectionPlan.load(str(tmp_path / "jax_plan.json"),
                                       device="cpu")
    loaded.validate(pt)
    plan_t.save(str(tmp_path / "port_plan.json"))
    back = jcore.ProtectionPlan.load(str(tmp_path / "port_plan.json"))
    back.validate(pj)
    assert back.names() == plan_j.names()
    for name in plan_j.names():
        assert_close(back[name].wck.cw2, plan_j[name].wck.cw2, 1e-5,
                     1e-4 * _scale(plan_j[name].wck.cw2), name)


def _on_repeat(rep: int, reps: int, fn):
    """A hook that corrupts the site's output in one repeat of the stage:
    it counts its calls, and every forward calls it once per repeat."""
    calls = [0]

    def hook(o):
        i = calls[0]
        calls[0] += 1
        return fn(o) if i % reps == rep else o
    return hook


def _add_j(delta):
    """A JAX fault hook adding `delta` (traced: 0 leaves the site clean) at
    one element of the site's output."""
    return lambda o: o.at[0, 2, 5].add(delta.astype(o.dtype))


def _hook_t(o):
    o = o.clone()
    o[0, 2, 5] += 50.0
    return o


def _jax_verdicts(model, mode):
    """The JAX ProtectedModel's per-section verdicts, logits and states of
    a clean prefill and of ones with +50 at one element of repeat 1's
    in_proj output or of the untied head's. A hook in a lax.scan body
    fires in every repeat, so the JAX model runs its stages unrolled (the
    same model). One jitted program serves the three runs: both sites
    carry a fault hook whose delta is an argument, 0 where the run leaves
    the site clean (the JAX package keeps an untouched output bitwise the
    clean path's)."""
    cfg_j, cfg_t, pj, _ = model
    plan_j = jcore.build_plan(pj, cfg_j, batch=1, seq=SEQ)
    reps = cfg_t.stages()[1]
    pm_j = jcore.ProtectedModel(
        JM.prefill_apply(cfg_j.replace(scan_stages=False), MAX_LEN), plan_j)

    def forward(p, t, d_in, d_head):
        with jinj.fault_scope(IN_PROJ, _on_repeat(1, reps, _add_j(d_in))), \
                jinj.fault_scope(HEAD, _add_j(d_head)):
            return pm_j(p, t, correction=mode)

    run = jax.jit(forward)
    tokens = jnp.asarray(np.random.default_rng(3).integers(
        0, cfg_t.vocab_size, (1, SEQ)))
    out = {}
    for path, deltas in ((None, (0.0, 0.0)), (IN_PROJ, (50.0, 0.0)),
                         (HEAD, (0.0, 50.0))):
        (lj, cj), rj = run(pj, tokens, *map(jnp.float32, deltas))
        out[str(path)] = {
            "verdicts": {k: verdict(v) for k, v in rj.by_layer.items()},
            "logits": np.asarray(lj),
            "state": tree_np(cj["stages"]["b0_ssm"])}
    return out


@pytest.mark.parametrize("mode", ["per_layer", "deferred"])
def test_protected_model_verdicts_match_jax(model, plan_t, mode,
                                            tmp_path_factory):
    """Through ProtectedModel, the port's per-section verdicts equal the
    JAX package's, clean, with a fault in repeat 1's in_proj and at the
    untied head; the corrected logits agree. Host reads: one per site call
    in per_layer mode (2 sites x 2 repeats + the head), one deferred. The
    JAX side runs once per pytest run (torch_parity.shared_reference)."""
    _, cfg_t, _, pt = model
    ref = shared_reference(tmp_path_factory, f"ssm_verdicts_{mode}",
                           lambda: _jax_verdicts(model, mode))
    reps = cfg_t.stages()[1]
    tokens = np.random.default_rng(3).integers(0, cfg_t.vocab_size,
                                               (1, SEQ))
    pm_t = tcore.ProtectedModel(TM.prefill_apply(cfg_t, MAX_LEN), plan_t)
    for path in (None, IN_PROJ, HEAD):
        if path is None:
            TW.HOST_READS = 0
            with torch.no_grad():
                (lt, ct), rt = pm_t(pt, torch.as_tensor(tokens),
                                    correction=mode)
            assert TW.HOST_READS == {"per_layer": 5, "deferred": 1}[mode]
        else:
            ht = _hook_t
            if path == IN_PROJ:
                ht = _on_repeat(1, reps, ht)
            with tinj.fault_scope(path, ht), torch.no_grad():
                (lt, ct), rt = pm_t(pt, torch.as_tensor(tokens),
                                    correction=mode)
        want = ref[str(path)]
        got = {k: verdict(v) for k, v in rt.by_layer.items()}
        assert got == want["verdicts"], path
        hit = {None: None, HEAD: HEAD, IN_PROJ: "stages"}[path]
        assert {k for k, v in got.items() if v[0]} == \
            ({hit} if hit else set())
        assert all(v[2] == 0 for v in got.values())
        _close(lt, want["logits"], f"logits {path}")
        for k in ("h", "conv"):
            _close(ct["stages"]["b0_ssm"][k], want["state"][k],
                   f"state {k} {path}")


def test_kernel_route_is_bitwise_the_plain_one_inside_the_port(model,
                                                               plan_t):
    """With the kernels pinned (their plain versions here) clean per_layer
    and deferred prefills give bitwise equal logits and states, equal to
    the unprotected prefill's, at a prefill length that is no power of two
    (the scheduler's exact prefill)."""
    _, cfg_t, _, pt = model
    fused = tcore.force_fused_matmul(plan_t)
    toks = torch.as_tensor(
        np.random.default_rng(6).integers(0, cfg_t.vocab_size, (1, SEQ)))
    out = {}
    with torch.no_grad():
        for mode in ("per_layer", "deferred"):
            pm = tcore.ProtectedModel(TM.prefill_apply(cfg_t, MAX_LEN),
                                      fused)
            out[mode], rep = pm(pt, toks, correction=mode)
            assert verdict(rep) == (0, 0, 0)
        lu, _, cu = TM.prefill(pt, toks, cfg_t.replace(abft=False), MAX_LEN)
    for mode in out:
        assert torch.equal(out[mode][0], lu), mode
        for k in ("h", "conv"):
            assert torch.equal(out[mode][1]["stages"]["b0_ssm"][k],
                               cu["stages"]["b0_ssm"][k]), (mode, k)


# ---------------------------------------------------------------------------
# serving a recurrent state
# ---------------------------------------------------------------------------

LENS = (5, 9, 3)
GEN = 4


def _prompts(cfg):
    rng = np.random.default_rng(1)
    return [rng.integers(0, cfg.vocab_size, n) for n in LENS]


def _serve_port(model, plan, mode, hook=None, path=OUT_PROJ):
    _, cfg_t, _, pt = model
    sess = ProtectedSession(pt, cfg_t, plan, slots=2, max_len=MAX_LEN,
                            correction=mode, device="cpu")
    rids = [sess.submit(p, max_new_tokens=GEN) for p in _prompts(cfg_t)]
    if hook is None:
        report = sess.run()
    else:
        with tinj.fault_scope(path, hook):
            report = sess.run()
    return sess, rids, report


@pytest.fixture(scope="module")
def served_plan(model):
    _, cfg_t, _, pt = model
    return tcore.build_plan(pt, cfg_t, batch=2, seq=MAX_LEN, device="cpu")


def _jax_session_tokens(model):
    """The JAX ProtectedSession's tokens per request, served with
    protection off (no plan, abft=False: its scheduling, exact prefills
    and cache inserts as when protected, and its clean protected sessions
    serve the same tokens), its decode steps completed before the host
    moves the slots' positions (torch_parity.steady_jax_session)."""
    cfg_j, cfg_t, pj, _ = model
    js = steady_jax_session(pj, cfg_j.replace(abft=False), None, slots=2,
                            max_len=MAX_LEN)
    jr = [js.submit(p, max_new_tokens=GEN) for p in _prompts(cfg_t)]
    js.run()
    return [js.tokens_for(r) for r in jr]


@pytest.fixture(scope="module")
def jax_tokens(model, tmp_path_factory):
    """The JAX session's tokens, served once per pytest run
    (torch_parity.shared_reference)."""
    return shared_reference(tmp_path_factory, "ssm_session",
                            lambda: _jax_session_tokens(model))


@pytest.mark.parametrize("mode", ["per_layer", "deferred"])
def test_session_tokens_match_jax(model, served_plan, jax_tokens, mode):
    """2 slots, prompts of 5, 9 and 3 tokens (exact prefills), 4 new
    tokens each: the third request is admitted after decode steps have
    run, so its conv tail is kept in float32 where the first two were
    rounded to the session's bfloat16 buffer, as in the JAX session. Every
    token equals the JAX ProtectedSession's; no flags."""
    sess, rids, report = _serve_port(model, served_plan, mode)
    assert report["counters"]["faults_detected"] == 0
    assert report["completed"] == len(LENS)
    assert sess.scheduler.exact_prefill
    recs = {r["id"]: r for r in report["requests"]}
    assert recs[rids[2]]["admitted_at"] > recs[rids[0]]["first_token_at"]
    assert [sess.tokens_for(r) for r in rids] == jax_tokens
    assert sess._caches["stages"]["b0_ssm"]["conv"].dtype == torch.float32


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_session_decode_fault_in_the_state_path_keeps_the_stream(
        model, served_plan, kernels):
    """+1e4 at one element of slot 1's out_proj row in one mid-stream
    decode step: detected, corrected with residual 0 and attributed to
    that slot's request alone, and every later token of every request
    equals the clean run's - the corrective rerun starts from the step's
    input state, not from the state the detect pass wrote."""
    plan = served_plan
    if kernels:
        plan = tcore.force_fused_matmul(plan)
    clean, rids, _ = _serve_port(model, plan, "deferred")
    calls = [0]

    def hook(o):
        if o.dim() == 3 and o.shape[:2] == (2, 1):
            calls[0] += 1
            # repeat 0 of the second decode step: calls 1-2 are the first
            # step's repeats, 3-4 the second's detect pass, 5-6 its rerun
            if calls[0] in (3, 5):
                o = o.clone()
                o[1, 0, 7] += 1e4
        return o

    sess, rids2, report = _serve_port(model, plan, "deferred", hook)
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


def test_serve_cli_runs_mamba_on_the_cpu(capsys):
    """`python -m repro_torch.launch.serve --arch mamba2-1.3b-smoke
    --device cpu` serves through the driver with no flags."""
    tserve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                 "--prompt-len", "5", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out and "faults=0" in out
