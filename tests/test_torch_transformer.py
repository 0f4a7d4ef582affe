"""The port's transformer slice (repro_torch.configs, layers,
models.transformer and the transformer half of core.plan) against the JAX
package's, on the reduced SmolLM-360M (`smollm-360m-smoke`: fp32, d 64,
2 layers, chunks 64) with the JAX package's own random params carried
across as numpy arrays.

Logits and checksums agree to fp32 reassociation (rtol 1e-5, atol 1e-5 of
the output's scale); verdicts (detected, corrected_by, residual) exactly.
Inside the port the clean protected paths are bitwise: per_layer equal to
deferred with the kernels pinned, and equal to the unprotected forward."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as JCF  # noqa: E402
import repro.core as jcore  # noqa: E402
from repro.core import injection as jinj  # noqa: E402
from repro.models import transformer as JM  # noqa: E402
import repro_torch.configs as TCF  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import injection as tinj  # noqa: E402
from repro_torch.core import workflow as TW  # noqa: E402
from repro_torch.models import transformer as TM  # noqa: E402
from torch_parity import (assert_close, shared_reference,  # noqa: E402
                          to_np, tree_np, verdict)

ARCH = "smollm-360m-smoke"
MAX_LEN = 16
SEQ = 8
HEAD = "embed/table"
STAGE_SITE = "stages/b0_attn_full/attn/wq"


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(JAX cfg, port cfg, JAX params, port params, tokens): the JAX
    package's random params, drawn once per pytest run and shared with
    every xdist worker (torch_parity.shared_reference)."""
    cfg_j, cfg_t = JCF.get(ARCH), TCF.get(ARCH)
    pn = shared_reference(
        tmp_path_factory, "smollm-360m-smoke_params",
        lambda: tree_np(JM.init_params(jax.random.PRNGKey(0), cfg_j)))
    pj = jax.tree.map(jnp.asarray, pn)
    pt = TM.params_from_numpy(pn, device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg_t.vocab_size,
                                               (1, SEQ))
    return cfg_j, cfg_t, pj, pt, tokens


@pytest.fixture(scope="module")
def plans(model):
    cfg_j, cfg_t, pj, pt, _ = model
    return (jcore.build_plan(pj, cfg_j, batch=1, seq=SEQ),
            tcore.build_plan(pt, cfg_t, batch=1, seq=SEQ, device="cpu"))


@pytest.fixture(scope="module")
def plan_t(model):
    """The port's plan alone, for tests whose JAX side is shared."""
    _, cfg_t, _, pt, _ = model
    return tcore.build_plan(pt, cfg_t, batch=1, seq=SEQ, device="cpu")


def test_configs_match_jax():
    for name in JCF.list_archs():
        for arch in (name, name + "-smoke"):
            a, b = JCF.get(arch), TCF.get(arch)
            assert dataclasses.asdict(a) == dataclasses.asdict(b), arch
            assert a.stages() == b.stages()
            assert JM.count_params(a) == TM.count_params(b)
    assert TCF.get("smollm-360m").param_count() == 361_758_720


def test_prefill_and_decode_logits_match_jax(model):
    """Unprotected prefill and a per-slot decode step agree with the JAX
    package's, caches included; a vector of equal positions writes the
    same caches as the scalar position (twin of
    test_vector_positions_match_scalar_decode)."""
    cfg_j, cfg_t, pj, pt, _ = model
    ucfg_j, ucfg_t = cfg_j.replace(abft=False), cfg_t.replace(abft=False)
    toks = np.random.default_rng(4).integers(0, cfg_t.vocab_size, (2, 6))
    lj, _, cj = JM.prefill(pj, jnp.asarray(toks), ucfg_j, MAX_LEN)
    lt, rep, ct = TM.prefill(pt, torch.as_tensor(toks), ucfg_t, MAX_LEN)
    scale = float(np.abs(np.asarray(lj)).max())
    assert_close(lt, lj, 1e-5, 1e-5 * scale, "prefill logits")
    assert verdict(rep) == (0, 0, 0)
    for a, b in zip(jax.tree.leaves(cj), (ct["stages"]["b0_attn_full"]["k"],
                                          ct["stages"]["b0_attn_full"]["v"])):
        assert_close(b, a, 1e-5, 1e-5, "cache")
    nxt = np.array(jnp.argmax(lj, -1))
    lj2, _, _ = JM.decode_step(pj, jnp.asarray(nxt), cj,
                               jnp.asarray([6, 6], jnp.int32), ucfg_j)
    lv, _, cv = TM.decode_step(pt, torch.as_tensor(nxt), ct,
                               torch.tensor([6, 6]), ucfg_t)
    assert_close(lv, lj2, 1e-5, 1e-5 * scale, "decode logits")
    ls, _, cs = TM.decode_step(pt, torch.as_tensor(nxt), ct, 6, ucfg_t)
    assert torch.equal(ls, lv)
    for blk in ("k", "v"):
        assert torch.equal(cs["stages"]["b0_attn_full"][blk],
                           cv["stages"]["b0_attn_full"][blk])
    # the caller's caches are left as they were
    assert not ct["stages"]["b0_attn_full"]["k"][:, :, 6].any()


def test_plan_matches_jax(model, plans):
    """build_plan walks the same sites: stacked stage entries with
    per-repeat checksums and float64 locators, and the tied head through
    its weight view."""
    _, _, _, pt, _ = model
    pj, ptp = plans
    assert pj.names() == ptp.names()
    assert len(ptp) == 8
    for name in pj.names():
        a, b = pj[name], ptp[name]
        assert dataclasses.asdict(a.cfg) == dataclasses.asdict(b.cfg), name
        assert (a.stack, a.w_view, tuple(a.w_shape), a.w_dtype) == \
            (b.stack, b.w_view, tuple(b.w_shape), b.w_dtype), name
        assert a.wck.col_chunk == b.wck.col_chunk
        for x, y in ((a.wck.cw1, b.wck.cw1), (a.wck.cw2, b.wck.cw2)):
            assert tuple(x.shape) == tuple(y.shape), name
            assert_close(y, x, 1e-5, 1e-4 * (np.abs(to_np(x)).max() + 1),
                         name)
        for fld in ("r1", "r2", "c1", "c2"):
            x, y = getattr(a.wlc, fld), getattr(b.wlc, fld)
            assert y.dtype == np.float64
            np.testing.assert_allclose(y, x, rtol=1e-6, atol=1e-6)
        assert b.w_sum == pytest.approx(a.w_sum, rel=1e-5, abs=1e-4)
    assert ptp["stages/b1_ffn/ffn/down"].wck.cw1.shape == (2, 1, 96)
    assert ptp[HEAD].w_view == "tied_head"
    table = pt["embed"]["table"]
    head_w = tcore.apply_w_view(table, "tied_head")
    assert head_w.shape == (64, 512) and head_w.data_ptr() == table.data_ptr()
    assert torch.equal(tplan.apply_w_view_inv(head_w, "tied_head",
                                              table.shape), table)
    ptp.validate(pt)
    bad = TM.params_from_numpy(tree_np(model[2]), device="cpu")
    bad["stages"]["b1_ffn"]["ffn"]["up"]["w"][1, 2, 3] += 5.0
    with pytest.raises(tcore.PlanStaleError):
        ptp.validate(bad)


def test_jax_plan_files_load_in_the_port(model, plans, tmp_path):
    """A transformer plan saved by the JAX package loads in the port,
    validates against the same params and serves a clean forward; the
    port's own save round-trips it."""
    cfg_j, cfg_t, _, pt, tokens = model
    pj, ptp = plans
    pj.save(str(tmp_path / "jax_plan.json"))
    loaded = tcore.ProtectionPlan.load(str(tmp_path / "jax_plan.json"),
                                       device="cpu")
    loaded.validate(pt)
    for name in ptp.names():
        assert loaded[name].stack == ptp[name].stack
        assert_close(loaded[name].wck.cw2, ptp[name].wck.cw2, 1e-5, 1e-4)
    loaded.save(str(tmp_path / "port_plan.json"))
    again = tcore.ProtectionPlan.load(str(tmp_path / "port_plan.json"),
                                      device="cpu")
    assert torch.equal(again[HEAD].wck.cw1, loaded[HEAD].wck.cw1)
    pm = tcore.ProtectedModel(TM.prefill_apply(cfg_t, MAX_LEN), loaded)
    with torch.no_grad():
        _, rep = pm(pt, torch.as_tensor(tokens), correction="deferred")
    assert verdict(rep) == (0, 0, 0)


def _add_j(delta):
    """A JAX fault hook adding `delta` (traced: 0 leaves the site clean) at
    one element of the site's output."""
    return lambda o: o.at[0, 2, 5].add(delta.astype(o.dtype))


def _hook_t(o):
    o = o.clone()
    o[0, 2, 5] += 50.0
    return o


def _jax_verdicts(model, mode):
    """The JAX ProtectedModel's per-section verdicts and logits, clean and
    with +50 at one element of the tied head's or a stage site's output
    (firing in every repeat). One jitted program serves the three runs:
    both sites carry a fault hook whose delta is an argument, 0 where the
    run leaves the site clean (the JAX package keeps an untouched output
    bitwise the clean path's); it gives the ModelReports of eager runs
    with one hook each, for one compile instead of three."""
    cfg_j, _, pj_, _, tokens = model
    plan_j = jcore.build_plan(pj_, cfg_j, batch=1, seq=SEQ)
    pm_j = jcore.ProtectedModel(JM.prefill_apply(cfg_j, MAX_LEN), plan_j)

    def forward(p, t, d_head, d_site):
        with jinj.fault_scope(HEAD, _add_j(d_head)), \
                jinj.fault_scope(STAGE_SITE, _add_j(d_site)):
            return pm_j(p, t, correction=mode)

    run = jax.jit(forward)
    out = {}
    for path, deltas in ((None, (0.0, 0.0)), (HEAD, (50.0, 0.0)),
                         (STAGE_SITE, (0.0, 50.0))):
        (lj, _), rj = run(pj_, jnp.asarray(tokens),
                          *map(jnp.float32, deltas))
        out[str(path)] = {
            "verdicts": {k: verdict(v) for k, v in rj.by_layer.items()},
            "logits": np.asarray(lj)}
    return out


@pytest.mark.parametrize("mode", ["per_layer", "deferred"])
def test_protected_model_verdicts_match_jax(model, plan_t, mode,
                                            tmp_path_factory):
    """Through ProtectedModel, the port's per-section verdicts equal the
    JAX package's ModelReport, clean and with a fault_scope hook on the
    tied head and on a stage site (firing in every repeat); the corrected
    logits agree with the JAX package's. The JAX side runs once per
    pytest run (torch_parity.shared_reference)."""
    _, cfg_t, _, pt, tokens = model
    ref = shared_reference(tmp_path_factory, f"transformer_verdicts_{mode}",
                           lambda: _jax_verdicts(model, mode))
    pm_t = tcore.ProtectedModel(TM.prefill_apply(cfg_t, MAX_LEN), plan_t)
    for path in (None, HEAD, STAGE_SITE):
        if path is None:
            with torch.no_grad():
                (lt, _), rt = pm_t(pt, torch.as_tensor(tokens),
                                   correction=mode)
        else:
            with tinj.fault_scope(path, _hook_t), torch.no_grad():
                (lt, _), rt = pm_t(pt, torch.as_tensor(tokens),
                                   correction=mode)
        want = ref[str(path)]
        got = {k: verdict(v) for k, v in rt.by_layer.items()}
        assert got == want["verdicts"], path
        hit = {None: None, HEAD: HEAD, STAGE_SITE: "stages"}[path]
        assert {k for k, v in got.items() if v[0]} == \
            ({hit} if hit else set())
        assert all(v[2] == 0 for v in got.values())
        lj = want["logits"]
        scale = float(np.abs(lj).max())
        assert_close(lt, lj, 1e-4, 1e-4 * scale, f"logits {path}")


def test_kernel_route_is_bitwise_the_plain_one_inside_the_port(model,
                                                               plan_t):
    """With the kernels pinned (their plain versions here), clean
    per_layer and deferred logits are bitwise equal, and equal to the
    unprotected forward's; the deferred detect pass ran the detect route
    (the prefill's 8 rows tile at the minimum)."""
    _, cfg_t, _, pt, tokens = model
    fused = tcore.force_fused_matmul(plan_t)
    toks = torch.as_tensor(tokens)
    out = {}
    with torch.no_grad():
        for mode in ("per_layer", "deferred"):
            pm = tcore.ProtectedModel(TM.prefill_apply(cfg_t, MAX_LEN),
                                      fused)
            (out[mode], caches), rep = pm(pt, toks, correction=mode)
            assert verdict(rep) == (0, 0, 0)
        with tcore.plan_scope(fused, mode="detect_only"):
            (_, _), ev = TM.prefill_apply(cfg_t, MAX_LEN)(pt, toks)
        assert isinstance(ev.by_layer["stages"], tcore.DetectEvidence)
        lu, _, _ = TM.prefill(pt, toks, cfg_t.replace(abft=False), MAX_LEN)
    assert torch.equal(out["per_layer"], out["deferred"])
    assert torch.equal(out["per_layer"], lu)


def test_host_reads_per_mode(model, plan_t):
    """One host read per protected site call in per_layer mode (7 sites
    in each of 2 repeats, plus the head) and one per deferred forward."""
    _, cfg_t, _, pt, tokens = model
    pm = tcore.ProtectedModel(TM.prefill_apply(cfg_t, MAX_LEN), plan_t)
    with torch.no_grad():
        for mode, want in (("per_layer", 15), ("deferred", 1)):
            TW.HOST_READS = 0
            pm(pt, torch.as_tensor(tokens), correction=mode)
            assert TW.HOST_READS == want, mode


def test_unported_blocks_name_their_roadmap_item():
    """moe blocks (kimi-k2) build, plan and train now
    (tests/test_torch_moe.py and tests/test_torch_train_blocks.py hold
    them to the JAX package); what is left of their training, the sharded
    step, raises naming its ROADMAP item."""
    from repro_torch.launch import steps as TST
    from repro_torch.optim import OptConfig
    cfg = TCF.get("kimi-k2-1t-a32b-smoke")
    params = TM.init_params(cfg, device="cpu")
    assert tuple(params["stages"]["b1_moe"]["moe"]["gate"].shape) == \
        (2, 8, 64, 48)
    kinds = [s.op.kind for s in tcore.protection_spec(cfg).sites]
    assert kinds.count("grouped_matmul") == 3
    assert callable(TST.make_train_step(cfg, OptConfig()))
    with pytest.raises(NotImplementedError, match="1.12"):
        TST.make_train_step(cfg, OptConfig(), mesh_axes=("data", "model"))
