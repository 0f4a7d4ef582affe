"""The port's RG-LRU slice (repro_torch.layers.rglru, the rec blocks of
models.transformer and core.plan, the sliding-window attention and the
gelu FFN of RecurrentGemma, serving a recurrent state) against the JAX
package's, on the reduced RecurrentGemma-2B (`recurrentgemma-2b-smoke` at
5 layers: one stage of rec, ffn, rec, ffn, attn_swa, ffn plus the
remainder rec, ffn, rec, ffn; fp32, d 64, lru width 64, window 8, 10
query heads on one KV head, tied head) with the JAX package's own random
params carried across as numpy arrays. The tied table is scaled by 1/16
in both packages' copies: at its drawn scale the embedding (times
sqrt(d)) outweighs every block's output, so greedy decoding echoes the
last prompt token whatever the recurrent state holds; scaled, the served
tokens depend on the state.

The JAX package's protected programs are costly to build on the CPU
(about 1.7 s of lowering and compiling per site for each jitted program,
and 40 sites here), so its ProtectedModel runs eagerly under
`jax.disable_jit()`, and its ProtectedSession, whose tokens the port's
protected sessions must serve, runs with protection off (the port's clean
protected forwards are bitwise its unprotected ones, held below).

Outputs and states agree to fp32 reassociation (rtol 1e-5, atol 1e-5 of
the output's scale: the doubling scan and the JAX package's associative
scan add in another order); cache types, verdicts (detected,
corrected_by, residual), host reads and served tokens exactly. Prompts
and decode positions run past the window of 8, so the window binds. The
reference's cache types are kept where they are quirks: the conv tail is
made bfloat16 in any model and comes back float32 from a float32 model's
forward; h is float32 in any model."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as JCF  # noqa: E402
import repro.core as jcore  # noqa: E402
from repro.core import injection as jinj  # noqa: E402
from repro.layers import attention as JA  # noqa: E402
from repro.layers import rglru as JR  # noqa: E402
from repro.models import transformer as JM  # noqa: E402
import repro_torch.configs as TCF  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import injection as tinj  # noqa: E402
from repro_torch.core import workflow as TW  # noqa: E402
from repro_torch.layers import attention as TA  # noqa: E402
from repro_torch.layers import rglru as TR  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as TM  # noqa: E402
from repro_torch.serving import ProtectedSession  # noqa: E402
from torch_parity import (assert_close, normal,  # noqa: E402
                          shared_reference, steady_jax_session, to_np,
                          tree_np, verdict)

ARCH = "recurrentgemma-2b-smoke"
LAYERS = 5
MAX_LEN = 24
SEQ = 11                 # past the window (8), no power of two
REC = "stages/b0_rec/rec"
HEAD = "embed/table"
RTOL = ATOL = 1e-5


def _cfgs():
    return (JCF.get(ARCH).replace(num_layers=LAYERS),
            TCF.get(ARCH).replace(num_layers=LAYERS))


def _jax_params(cfg_j):
    pn = tree_np(jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg_j))
    pn["embed"]["table"] = pn["embed"]["table"] / 16
    return pn


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(JAX cfg, port cfg, JAX params, port params): the JAX package's
    random params, drawn once per pytest run and shared with every xdist
    worker (torch_parity.shared_reference)."""
    cfg_j, cfg_t = _cfgs()
    pn = shared_reference(tmp_path_factory, "rglru_params",
                          lambda: _jax_params(cfg_j))
    pj = jax.tree.map(jnp.asarray, pn)
    pt = TM.params_from_numpy(pn, device="cpu")
    return cfg_j, cfg_t, pj, pt


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


def _block(pj, pt, name="b0_rec", key="rec"):
    """The first repeat's params of one stage block in both packages."""
    return tuple(jax.tree.map(lambda t: t[0], p["stages"][name][key])
                 for p in (pj, pt))


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_scan_recurrence_matches_jax(with_h0):
    """The doubling scan against lax.associative_scan, at a length (13)
    that is no power of two, and against the sequential recurrence."""
    b, s, w = 2, 13, 6
    a = np.random.default_rng(1).uniform(0.5, 1.0, (b, s, w)).astype(
        np.float32)
    bx = normal(2, (b, s, w))
    h0 = normal(3, (b, w)) if with_h0 else None
    hj = JR._scan_recurrence(jnp.asarray(a), jnp.asarray(bx),
                             None if h0 is None else jnp.asarray(h0))
    ht = TR._scan_recurrence(torch.as_tensor(a), torch.as_tensor(bx),
                             None if h0 is None else torch.as_tensor(h0))
    _close(ht, hj, "scan")
    h = np.zeros((b, w), np.float32) if h0 is None else h0
    seq = []
    for t in range(s):
        h = a[:, t] * h + bx[:, t]
        seq.append(h)
    _close(ht, np.stack(seq, 1), "sequential")


@pytest.mark.parametrize("path,s", [("train", SEQ), ("prefill", SEQ),
                                    ("decode", 1)])
def test_apply_rglru_paths_match_jax(model, path, s):
    """The uncached forward, the scan from a carried state and the
    one-step decode update: output and new state, in the state's types."""
    cfg_j, cfg_t, pj, pt = model
    bj, bt = _block(pj, pt)
    assert bt["lam"].dtype == torch.float32
    x = normal(10 + s, (2, s, cfg_t.d_model))
    state_np = None
    if path != "train":
        state_np = {"h": normal(30, (2, cfg_t.lru_width), 0.3),
                    "conv": normal(31, (2, cfg_t.conv_kernel - 1,
                                        cfg_t.lru_width), 0.3)}
    sj = None if state_np is None else jax.tree.map(jnp.asarray, state_np)
    st = None if state_np is None else {k: torch.as_tensor(v)
                                        for k, v in state_np.items()}
    oj, rj, nj = JR.apply_rglru(bj, jnp.asarray(x), cfg_j, None, sj)
    ot, rt, nt = TR.apply_rglru(bt, torch.as_tensor(x), cfg_t, None, st)
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


@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached"])
def test_sliding_window_attention_matches_jax(model, cached):
    """attn_swa with the window (8) binding: 11 rows uncached, or an
    11-row prefill into the cache then a decode row per slot at its own
    position (11 and 9); one KV head for 10 query heads."""
    cfg_j, cfg_t, pj, pt = model
    aj, at = _block(pj, pt, "b4_attn_swa", "attn")
    assert cfg_t.num_kv_heads == 1 and cfg_t.q_per_kv == 10
    s = SEQ
    x = normal(40, (2, s, cfg_t.d_model))
    pos = np.arange(s)[None]
    kw = dict(kind="attn_swa", abft=None)
    if not cached:
        oj, _, _ = JA.apply_attention(aj, jnp.asarray(x), cfg=cfg_j,
                                      positions=jnp.asarray(pos), **kw)
        ot, _, _ = TA.apply_attention(at, torch.as_tensor(x), cfg=cfg_t,
                                      positions=torch.as_tensor(pos), **kw)
        _close(ot, oj, "uncached")
        return
    cj = JA.init_cache(cfg_j, "attn_swa", 2, MAX_LEN, jnp.float32)
    ct = TA.init_cache(cfg_t, "attn_swa", 2, MAX_LEN, torch.float32)
    oj, _, cj = JA.apply_attention(aj, jnp.asarray(x), cfg=cfg_j,
                                   positions=jnp.asarray(pos), cache=cj,
                                   cache_pos=jnp.asarray(0), **kw)
    ot, _, ct = TA.apply_attention(at, torch.as_tensor(x), cfg=cfg_t,
                                   positions=torch.as_tensor(pos), cache=ct,
                                   cache_pos=0, **kw)
    _close(ot, oj, "prefill")
    x1 = normal(41, (2, 1, cfg_t.d_model))
    p1 = np.array([SEQ, 9])
    oj, _, cj = JA.apply_attention(aj, jnp.asarray(x1), cfg=cfg_j,
                                   positions=jnp.asarray(p1[:, None]),
                                   cache=cj, cache_pos=jnp.asarray(p1), **kw)
    ot, _, ct = TA.apply_attention(at, torch.as_tensor(x1), cfg=cfg_t,
                                   positions=torch.as_tensor(p1[:, None]),
                                   cache=ct, cache_pos=torch.as_tensor(p1),
                                   **kw)
    _close(ot, oj, "decode")
    for k in ("k", "v"):
        _close(ct[k], cj[k], f"cache {k}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _cache_types(tree):
    return {k: _cache_types(v) if isinstance(v, dict)
            else (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tree.items()}


def _states(c):
    """The recurrent leaves of a cache tree, by path."""
    out = {}
    for sec in ("stages", "rem"):
        for name, blk in c[sec].items():
            if name.endswith("_rec"):
                for k in ("h", "conv"):
                    out[f"{sec}/{name}/{k}"] = blk[k]
    return out


def test_prefill_and_decode_match_jax_with_cache_types(model):
    """Unprotected prefill (11 tokens, 2 rows) then 3 decode steps past
    the window: logits and every cache leaf agree with the JAX package's,
    their types included (the rec conv tail bfloat16 as made, float32
    after a float32 forward)."""
    cfg_j, cfg_t, pj, pt = model
    uj, ut = cfg_j.replace(abft=False), cfg_t.replace(abft=False)
    made = _cache_types(TM.init_caches(ut, 2, MAX_LEN, device="cpu"))
    assert made == _cache_types(JM.init_caches(uj, 2, MAX_LEN))
    assert made["rem"]["b0_rec"] == {"h": ((2, 64), "float32"),
                                     "conv": ((2, 3, 64), "bfloat16")}
    toks = np.random.default_rng(4).integers(0, cfg_t.vocab_size, (2, SEQ))
    lj, _, cj = JM.prefill(pj, jnp.asarray(toks), uj, MAX_LEN)
    lt, rep, ct = TM.prefill(pt, torch.as_tensor(toks), ut, MAX_LEN)
    assert verdict(rep) == (0, 0, 0)
    for step in range(4):
        _close(lt, lj, f"logits after {step} decode steps")
        assert _cache_types(ct) == _cache_types(cj), step
        assert _cache_types(ct)["rem"]["b0_rec"]["conv"][1] == "float32"
        sj = _states(cj)
        for k, v in _states(ct).items():
            _close(v, sj[k], f"{k} after {step} decode steps")
        _close(ct["stages"]["b4_attn_swa"]["k"],
               cj["stages"]["b4_attn_swa"]["k"], f"kv after {step}")
        if step == 3:
            break
        nxt = np.array(jnp.argmax(lj, -1))
        lj, _, cj = JM.decode_step(pj, jnp.asarray(nxt), cj, SEQ + step, uj)
        before = {k: v.clone() for k, v in _states(ct).items()}
        lt, _, ct_new = TM.decode_step(pt, torch.as_tensor(nxt), ct,
                                       SEQ + step, ut)
        # the caller's state is left as it was
        for k, v in _states(ct).items():
            assert torch.equal(v, before[k]), k
        ct = ct_new


def test_prefill_then_decode_equals_longer_prefill(model):
    """The recurrence carried through the cache: a prefill of 12 (the
    scan) then one decode step of token 13 (the one-step update) gives the
    logits and states of a prefill of 13, to fp32 reassociation."""
    _, cfg_t, _, pt = model
    ut = cfg_t.replace(abft=False)
    toks = torch.as_tensor(
        np.random.default_rng(5).integers(0, cfg_t.vocab_size, (1, 13)))
    l12, _, c12 = TM.prefill(pt, toks[:, :12], ut, MAX_LEN)
    l1, _, c1 = TM.decode_step(pt, toks[:, 12:], c12, 12, ut)
    l13, _, c13 = TM.prefill(pt, toks, ut, MAX_LEN)
    _close(l1, l13, "logits")
    s13 = _states(c13)
    for k, v in _states(c1).items():
        _close(v, s13[k], k)


def test_full_width_shapes_and_types_match_jax():
    """RecurrentGemma-2B at full width and depth: every param and cache
    leaf has the JAX package's shape and type (jax.eval_shape beside
    torch's fake tensors: nothing is allocated); lam float32 in the bf16
    model; about 2.9 G params, as the JAX package counts them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg_j, cfg_t = JCF.get("recurrentgemma-2b"), TCF.get("recurrentgemma-2b")
    pj = jax.eval_shape(lambda k: JM.init_params(k, cfg_j),
                        jax.random.PRNGKey(0))
    cj = jax.eval_shape(lambda: JM.init_caches(cfg_j, 8, 256))
    with FakeTensorMode():
        pt = TM.init_params(cfg_t, device="cpu")
        ct = TM.init_caches(cfg_t, 8, 256, device="cpu")
    assert _cache_types(pt) == _cache_types(pj)
    assert _cache_types(ct) == _cache_types(cj)
    rec = _cache_types(pt)["stages"]["b0_rec"]["rec"]
    assert rec["lam"] == ((8, 2560), "float32")
    assert rec["in_x"]["w"] == ((8, 2560, 2560), "bfloat16")
    assert _cache_types(ct)["rem"]["b2_rec"] == {
        "h": ((8, 2560), "float32"), "conv": ((8, 3, 2560), "bfloat16")}
    assert _cache_types(ct)["stages"]["b4_attn_swa"]["k"] == \
        ((8, 8, 256, 1, 256), "bfloat16")
    assert TM.count_params(cfg_t) == JM.count_params(cfg_j)
    assert abs(TM.count_params(cfg_t) - 2.9e9) / 2.9e9 < 0.01


# ---------------------------------------------------------------------------
# the plan and the protected forward
# ---------------------------------------------------------------------------

def test_plan_matches_jax(model, plan_t, tmp_path):
    """build_plan walks the same 40 sites with the same shapes, chunks and
    checksums (the five rec sites of each rec block among them), and a
    plan file of either package loads in the other."""
    cfg_j, cfg_t, pj, pt = model
    plan_j = jcore.build_plan(pj, cfg_j, batch=1, seq=SEQ)
    assert list(plan_t.names()) == list(plan_j.names())
    # 4 rec blocks of 5 sites, one attn_swa of 4, 5 ffns of 3, the head
    assert len(plan_t) == 4 * 5 + 4 + 5 * 3 + 1
    spec = tcore.protection_spec(cfg_t, batch=1, seq=SEQ)
    rec = [(s.path, s.k_dim, s.shape.m) for s in spec.sites
           if s.path.startswith(REC)]
    assert rec == [(f"{REC}/in_x", 64, 64), (f"{REC}/in_gate", 64, 64),
                   (f"{REC}/gate_a", 64, 64), (f"{REC}/gate_i", 64, 64),
                   (f"{REC}/out", 64, 64)]
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


def _hook_j(o):
    return o.at[0, 2, 5].add(jnp.asarray(50.0, o.dtype))


def _hook_t(o):
    o = o.clone()
    o[0, 2, 5] += 50.0
    return o


GATE_A = f"{REC}/gate_a"


def _jax_verdicts(model, mode):
    """The JAX ProtectedModel's per-section verdicts, logits and recurrent
    states with a fault at gate_a, run eagerly (jax.disable_jit)."""
    cfg_j, cfg_t, pj, _ = model
    plan_j = jcore.build_plan(pj, cfg_j, batch=1, seq=SEQ)
    tokens = np.random.default_rng(3).integers(0, cfg_t.vocab_size,
                                               (1, SEQ))
    pm_j = jcore.ProtectedModel(JM.prefill_apply(cfg_j, MAX_LEN), plan_j)
    with jinj.fault_scope(GATE_A, _hook_j), jax.disable_jit():
        (lj, cj), rj = pm_j(pj, jnp.asarray(tokens), correction=mode)
    return {"verdicts": {k: verdict(v) for k, v in rj.by_layer.items()},
            "logits": np.asarray(lj),
            "states": {k: np.asarray(v) for k, v in _states(cj).items()}}


@pytest.mark.parametrize("mode", ["per_layer", "deferred"])
def test_protected_model_verdicts_match_jax(model, plan_t, mode,
                                            tmp_path_factory):
    """Through ProtectedModel, with a fault at gate_a of the stage's one
    repeat (its first rec block), the port's per-section verdicts equal
    the JAX package's and the corrected logits and states agree. Clean,
    every section's verdict is (0, 0, 0), with one host read per site call
    in per_layer mode (39 sites + the head) and one deferred. The JAX
    side runs once per pytest run (torch_parity.shared_reference)."""
    _, cfg_t, _, pt = model
    ref = shared_reference(tmp_path_factory, f"rglru_verdicts_{mode}",
                           lambda: _jax_verdicts(model, mode))
    tokens = np.random.default_rng(3).integers(0, cfg_t.vocab_size,
                                               (1, SEQ))
    pm_t = tcore.ProtectedModel(TM.prefill_apply(cfg_t, MAX_LEN), plan_t)
    TW.HOST_READS = 0
    with torch.no_grad():
        _, rt = pm_t(pt, torch.as_tensor(tokens), correction=mode)
    assert TW.HOST_READS == {"per_layer": 40, "deferred": 1}[mode]
    assert {k: verdict(v) for k, v in rt.by_layer.items()} == \
        {k: (0, 0, 0) for k in ("stages", "rem", HEAD)}
    with tinj.fault_scope(GATE_A, _hook_t), torch.no_grad():
        (lt, ct), rt = pm_t(pt, torch.as_tensor(tokens), correction=mode)
    got = {k: verdict(v) for k, v in rt.by_layer.items()}
    assert got == ref["verdicts"]
    assert {k for k, v in got.items() if v[0]} == {"stages"}
    assert all(v[2] == 0 for v in got.values())
    _close(lt, ref["logits"], "logits")
    for k, v in _states(ct).items():
        _close(v, ref["states"][k], k)


def test_kernel_route_is_bitwise_the_plain_one_inside_the_port(model,
                                                               plan_t):
    """With the kernels pinned (their plain versions here) clean per_layer
    and deferred prefills give bitwise equal logits and caches, equal to
    the unprotected prefill's, at an exact prefill length of 11."""
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
    su = _states(cu)
    for mode in out:
        assert torch.equal(out[mode][0], lu), mode
        for k, v in _states(out[mode][1]).items():
            assert torch.equal(v, su[k]), (mode, k)
        assert torch.equal(out[mode][1]["stages"]["b4_attn_swa"]["v"],
                           cu["stages"]["b4_attn_swa"]["v"]), mode


# ---------------------------------------------------------------------------
# serving a recurrent state
# ---------------------------------------------------------------------------

LENS = (10, 12, 3)       # past the window; the third waits for a slot
GEN = 4


def _prompts(cfg):
    rng = np.random.default_rng(1)
    return [rng.integers(0, cfg.vocab_size, n) for n in LENS]


def _serve_port(model, plan, mode, hook=None, path=f"{REC}/in_x"):
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
    and cache inserts as when protected), its decode steps completed
    before the host moves the slots' positions
    (torch_parity.steady_jax_session)."""
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
    return shared_reference(tmp_path_factory, "rglru_session",
                            lambda: _jax_session_tokens(model))


@pytest.mark.parametrize("mode", ["per_layer", "deferred"])
def test_session_tokens_match_jax(model, served_plan, jax_tokens, mode):
    """2 slots, prompts of 10, 12 and 3 tokens (exact prefills past the
    window), 4 new tokens each: the third request is admitted after decode
    steps have run, so its rec conv tails are kept in float32 where the
    first two were rounded to the session's bfloat16 buffer, as in the
    JAX session. Every token equals the JAX ProtectedSession's, and the
    tokens are not an echo of the prompt; no flags."""
    sess, rids, report = _serve_port(model, served_plan, mode)
    assert report["counters"]["faults_detected"] == 0
    assert report["completed"] == len(LENS)
    assert sess.scheduler.exact_prefill
    recs = {r["id"]: r for r in report["requests"]}
    assert recs[rids[2]]["admitted_at"] > recs[rids[0]]["first_token_at"]
    assert [sess.tokens_for(r) for r in rids] == jax_tokens
    assert all(len(set(t)) > 1 for t in jax_tokens)
    for sec, name in (("stages", "b0_rec"), ("rem", "b2_rec")):
        assert sess._caches[sec][name]["conv"].dtype == torch.float32
        assert sess._caches[sec][name]["h"].dtype == torch.float32


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_session_decode_fault_at_in_x_keeps_the_stream(
        model, served_plan, kernels):
    """+1e4 at one element of slot 1's in_x row (it feeds both the conv
    tail and h) in one mid-stream decode step: detected, corrected with
    residual 0 and attributed to that slot's request alone, and every
    later token of every request equals the clean run's - the corrective
    rerun starts from the step's input state, not from the state the
    detect pass wrote."""
    plan = served_plan
    if kernels:
        plan = tcore.force_fused_matmul(plan)
    clean, rids, _ = _serve_port(model, plan, "deferred")
    calls = [0]

    def hook(o):
        if o.dim() == 3 and o.shape[:2] == (2, 1):
            calls[0] += 1
            # one repeat: call 1 is the first decode step, 2 the second's
            # detect pass, 3 its rerun
            if calls[0] in (2, 3):
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


def test_serve_cli_runs_recurrentgemma_on_the_cpu(capsys):
    """`python -m repro_torch.launch.serve --arch recurrentgemma-2b-smoke
    --device cpu` serves through the driver with no flags."""
    tserve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                 "--prompt-len", "10", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out and "faults=0" in out


# ---------------------------------------------------------------------------
# the JAX session's position race (ROADMAP 3.7), as a study
# ---------------------------------------------------------------------------

def _aligned_int32(n: int, align: int = 64) -> np.ndarray:
    raw = np.zeros(n + align // 4, np.int32)
    off = (-raw.ctypes.data % align) // 4
    return raw[off:off + n]


def _race_study(runs: int, load: int) -> None:
    """Serve the session tests' requests `runs` times each through the JAX
    session (its own position buffer; one made 64-byte aligned, which
    jnp.asarray shares; the same under steady_jax_session) and the port's
    per_layer and deferred sessions, beside `load` busy processes; print
    each variant's distinct token lists."""
    import json
    import subprocess
    import sys
    from repro.serving import ProtectedSession as JSession
    shared = 0
    for _ in range(200):
        a = np.zeros((2,), np.int32)
        same = jnp.asarray(a).unsafe_buffer_pointer() == a.ctypes.data
        assert same == (a.ctypes.data % 64 == 0)
        shared += same
    print(f"jnp.asarray shares a (2,) int32 host buffer in {shared} of 200 "
          "arrays, exactly the 64-byte aligned ones")
    cfg_j, cfg_t = _cfgs()
    pn = _jax_params(cfg_j)
    model = (cfg_j, cfg_t, jax.tree.map(jnp.asarray, pn),
             TM.params_from_numpy(pn, device="cpu"))
    plan = tcore.build_plan(model[3], cfg_t, batch=2, seq=MAX_LEN,
                            device="cpu")

    def jax_run(make, aligned):
        js = make(model[2], cfg_j.replace(abft=False), None, slots=2,
                  max_len=MAX_LEN)
        if aligned:
            js._h_positions = _aligned_int32(2)
        rs = [js.submit(p, max_new_tokens=GEN) for p in _prompts(cfg_t)]
        js.run()
        return [js.tokens_for(r) for r in rs]

    def port_run(mode):
        sess, rids, _ = _serve_port(model, plan, mode)
        return [sess.tokens_for(r) for r in rids]

    variants = {
        "jax": lambda: jax_run(JSession, False),
        "jax, aligned positions": lambda: jax_run(JSession, True),
        "steady jax, aligned positions":
            lambda: jax_run(steady_jax_session, True),
        "port per_layer": lambda: port_run("per_layer"),
        "port deferred": lambda: port_run("deferred")}
    busy = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(load)]
    try:
        for name, run in variants.items():
            seen = sorted({json.dumps(run()) for _ in range(runs)})
            print(f"{name}: {len(seen)} distinct of {runs} runs: {seen}")
    finally:
        for p in busy:
            p.kill()
            p.wait()


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=_race_study.__doc__)
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--load", type=int, default=6,
                    help="busy processes beside the sessions")
    args = ap.parse_args()
    _race_study(args.runs, args.load)
