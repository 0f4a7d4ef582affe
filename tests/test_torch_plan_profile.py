"""The port's measured-roofline plan and profile-mixed kernel pinning
(repro_torch.core.build_plan(cost_model=..., profile_kernels=True))
against the JAX package's.

The measured model is synthetic and host-independent, as in the JAX
package's mixed-membership fixture (tests/test_detect_path.py): reduced
AlexNet with the ridge set in the middle of its conv intensities, so the
plan mixes per_layer and deferred membership. Profiles are stubbed in both
packages with one fixed table, so the pinning is compared decision for
decision; the real profile functions run here only at tiny shapes (on the
CPU the kernel route is the kernels' plain versions, which decides
nothing about the card). Params and inputs are numpy arrays from a seed."""
import dataclasses
import json
import logging
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as JCF  # noqa: E402
import repro.core as jcore  # noqa: E402
from repro.core import plan as jplan_mod  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import repro_torch.configs as TCF  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import plan as tplan_mod  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import workflow as twf  # noqa: E402
from repro_torch.core.cost_model import shape_bytes, shape_flops  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from torch_parity import normal, shared_reference, to_np  # noqa: E402

SCALE, IMG, BATCH = 0.12, 48, 2
MODES = ("per_layer", "deferred")


def _numpy_params(cfg, seed: int) -> dict:
    g = np.random.default_rng(seed)
    params, ch = {}, cfg.in_ch
    for i, spec in enumerate(cfg.convs):
        out = cfg.scaled(spec.out_ch)
        shape = (out, ch, spec.kernel, spec.kernel)
        params[f"conv{i}"] = {
            "w": (g.standard_normal(shape) * (2.0 / (ch * spec.kernel ** 2))
                  ** 0.5).astype(np.float32),
            "b": (0.1 * g.standard_normal(out)).astype(np.float32)}
        ch = out
    params["fc"] = {"w": (g.standard_normal((ch, cfg.num_classes))
                          * ch ** -0.5).astype(np.float32),
                    "b": (0.1 * g.standard_normal(cfg.num_classes)
                          ).astype(np.float32)}
    return params


def _mid_ridge(spec, kind: str) -> float:
    ints = sorted(shape_flops(s.shape) / shape_bytes(s.shape)
                  for s in spec.sites
                  if s.shape is not None and s.op.kind == kind)
    assert ints[0] < ints[-1]
    return (ints[0] + ints[-1]) / 2.0


@dataclasses.dataclass
class MixedModel:
    cfg_t: object
    cfg_j: object
    tp: dict
    jp: dict
    x: np.ndarray
    ridge: float

    def models(self):
        return (tcore.MeasuredCostModel(peak_flops=self.ridge * 1e9,
                                        hbm_bw=1e9),
                jcore.MeasuredCostModel(peak_flops=self.ridge * 1e9,
                                        hbm_bw=1e9))


@pytest.fixture(scope="module")
def mixed():
    cfg_j = dataclasses.replace(jcnn.alexnet(SCALE), img=IMG)
    cfg_t = dataclasses.replace(tcnn.alexnet(SCALE), img=IMG)
    params_np = _numpy_params(cfg_t, seed=0)
    g = MixedModel(cfg_t, cfg_j, tcnn.params_from_numpy(params_np, "cpu"),
               jax.tree_util.tree_map(jnp.asarray, params_np),
               normal(1, (BATCH, 3, IMG, IMG)),
               _mid_ridge(tcore.protection_spec(cfg_t, batch=BATCH), "conv"))
    return g


@pytest.fixture(scope="module")
def plans(mixed):
    tm, jm = mixed.models()
    return (tcore.build_plan(mixed.tp, mixed.cfg_t, batch=BATCH,
                             cost_model=tm, device="cpu"),
            jcore.build_plan(mixed.jp, mixed.cfg_j, batch=BATCH,
                             cost_model=jm))


def _close_tree(a, b, rtol=1e-12, path=""):
    """Nested docs equal, floats to rtol."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _close_tree(a[k], b[k], rtol, f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close_tree(x, y, rtol, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert math.isclose(a, b, rel_tol=rtol, abs_tol=0.0), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _same_entries(tp, jp):
    assert tp.names() == jp.names()
    for n in jp.names():
        assert dataclasses.asdict(tp[n].cfg) == dataclasses.asdict(jp[n].cfg), n
        assert tp[n].execution == jp[n].execution, n


# ---------------------------------------------------------------------------
# the measured (roofline-mixed) plan
# ---------------------------------------------------------------------------

def test_measured_plan_matches_jax(plans):
    """Same synthetic calibration, same params: identical per-entry
    configs (rc, clc, chunks, kernel pinning) and execution membership,
    and meta.roofline / meta.cost_model equal to 1e-12."""
    tp, jp = plans
    _same_entries(tp, jp)
    inline = [n for n in tp.names() if tp[n].execution == "per_layer"]
    assert inline and len(inline) < len(tp)
    assert tp.meta["cost_model"]["class"] == "MeasuredCostModel"
    assert "kernel_profile" not in tp.meta
    _close_tree(tp.meta, jp.meta)
    for n in tp.names():
        want = ("per_layer" if tp.meta["roofline"][n]["bound"] == "compute"
                else "deferred")
        assert tp[n].execution == want, n


def test_default_plan_has_no_roofline_meta(mixed):
    plan = tcore.build_plan(mixed.tp, mixed.cfg_t, batch=BATCH,
                            device="cpu")
    assert "roofline" not in plan.meta
    assert plan.meta["cost_model"]["class"] == "CostModel"
    assert all(plan[n].execution is None for n in plan.names())


def test_measured_plan_files_load_in_both_packages(mixed, plans, tmp_path):
    """Each package's measured plan loads in the other with its execution
    membership and its roofline meta."""
    tp, jp = plans
    tpath, jpath = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    tp.save(tpath)
    jp.save(jpath)
    in_jax = jcore.ProtectionPlan.load(tpath)
    in_port = tcore.ProtectionPlan.load(jpath, device="cpu")
    in_jax.validate(mixed.jp)
    in_port.validate(mixed.tp)
    for loaded, built in ((in_jax, tp), (in_port, jp)):
        _close_tree(loaded.meta["roofline"], built.meta["roofline"])
        assert loaded.meta["cost_model"] == json.loads(
            json.dumps(built.meta["cost_model"]))
        for n in built.names():
            assert loaded[n].execution == built[n].execution, n
    _same_entries(in_port, jp)


# ---------------------------------------------------------------------------
# the mixed deferred forward
# ---------------------------------------------------------------------------

def _summary(rep):
    return {n: tuple(v.values()) for n, v in rep.summary().items()}


def _mixed_burst(mixed, plan, membership):
    """(layer, corrupted output) of the first conv of `membership` in the
    mixed plan: a burst over three channels of image 0 at one position,
    numpy-made deltas on the port's clean conv output."""
    convs = [n for n in plan.names() if n.startswith("conv")
             and (plan[n].execution == "per_layer")
             == (membership == "per_layer")]
    assert convs, f"no {membership} conv"
    layer = int(convs[0][len("conv"):])
    _, o = tcnn.conv_output_at(mixed.tp, torch.as_tensor(mixed.x),
                               mixed.cfg_t, layer)
    o = to_np(o)
    g = np.random.default_rng(layer)
    n_, m_, e1, e2 = o.shape
    y, xx = int(g.integers(e1)), int(g.integers(e2))
    for c in g.choice(m_, size=3, replace=False):
        o[0, int(c), y, xx] += float(g.uniform(10, 40))
    return layer, o


@pytest.fixture(scope="module")
def mixed_jax(mixed, plans, tmp_path_factory):
    """The JAX package's mixed deferred forwards (eager, so each lax.cond
    runs its live branch), clean and with each membership's burst, run in
    one process once per pytest run and shared with every xdist worker
    (torch_parity.shared_reference): verdict summaries and logits."""
    def build():
        tp, jp = plans

        def run(**inject):
            with jax.disable_jit():
                jl, jrep = jcnn.forward_cnn(
                    mixed.jp, jnp.asarray(mixed.x), mixed.cfg_j, plan=jp,
                    correction="deferred", **inject)
            return np.asarray(jl), _summary(jrep)

        out = {"clean": run()}
        for membership in MODES:
            layer, o = _mixed_burst(mixed, tp, membership)
            out[membership] = run(inject_layer=layer,
                                  inject_o=jnp.asarray(o))
        return out

    return shared_reference(tmp_path_factory, "plan_profile_mixed", build)


def test_mixed_clean_forward_is_unprotected_with_inline_plus_one_reads(
        mixed, plans, mixed_jax):
    """Clean, the mixed deferred forward's logits are bitwise the
    unprotected forward's, it makes one host read per inline member plus
    ONE for the deferred members (the JAX package's cond count), and its
    verdicts are the JAX package's."""
    tp, _ = plans
    x = torch.as_tensor(mixed.x)
    off = dataclasses.replace(mixed.cfg_t, abft=False)
    l_off, _ = tcnn.forward_cnn(mixed.tp, x, off, device="cpu")
    n_inline = sum(1 for n in tp.names() if tp[n].execution == "per_layer")
    twf.HOST_READS = 0
    l_mix, rep = tcnn.forward_cnn(mixed.tp, x, mixed.cfg_t, plan=tp,
                                  correction="deferred", device="cpu")
    assert twf.HOST_READS == n_inline + 1
    assert torch.equal(l_mix, l_off)
    assert int(rep.detected) == 0 and int(rep.residual) == 0
    assert _summary(rep) == mixed_jax["clean"][1]


@pytest.mark.parametrize("membership", MODES)
def test_mixed_injection_gives_jax_verdicts(mixed, plans, mixed_jax,
                                            membership):
    """A burst at an inline conv corrects through its immediate ladder, a
    burst at a deferred conv through the model-level rerun: verdicts
    (detected, corrected_by, residual) layer by layer are the JAX
    package's on the same corrupted output."""
    tp, _ = plans
    layer, o = _mixed_burst(mixed, tp, membership)
    x = torch.as_tensor(mixed.x)
    l_mix, rep = tcnn.forward_cnn(mixed.tp, x, mixed.cfg_t, plan=tp,
                                  correction="deferred", inject_layer=layer,
                                  inject_o=torch.as_tensor(o), device="cpu")
    jl, jsum = mixed_jax[membership]
    s = _summary(rep)
    assert s == jsum
    assert s[f"conv{layer}"][0] == 1 and s[f"conv{layer}"][2] == 0
    assert s[f"conv{layer}"][1] != "none"
    assert all(v[0] == 0 for k, v in s.items() if k != f"conv{layer}")
    l_clean, _ = tcnn.forward_cnn(mixed.tp, x, mixed.cfg_t, plan=tp,
                                  device="cpu")
    scale = float(l_clean.abs().max()) + 1.0
    np.testing.assert_allclose(to_np(l_mix), to_np(l_clean),
                               atol=1e-4 * scale)
    np.testing.assert_allclose(to_np(l_mix), to_np(jl), rtol=1e-4,
                               atol=1e-4 * scale)


# ---------------------------------------------------------------------------
# profile-mixed pinning with stubbed timings
# ---------------------------------------------------------------------------

def _table(kp_cls):
    """One fixed profile table, built with each package's KernelProfile:
    a conv view wins on the kernel when its edge is even, a GEMM when its
    output is wider than its contraction (with the middle tile
    candidate)."""
    def conv(o_shape, **_):
        n, m, e, _e = o_shape
        fused = e % 2 == 0
        t = 1e-5 * (1 + e + m / 64)
        return kp_cls(fused, None, t, t * (0.5 if fused else 2.0))

    def mm(n, k, m, **_):
        fused = m > k
        t = 1e-6 * (1 + n * k * m / 1e6)
        return kp_cls(fused, (128, 128, 256) if fused else None, t,
                      t * (0.5 if fused else 2.0))
    return conv, mm


def _stub(monkeypatch, mod, kp_cls):
    conv, mm = _table(kp_cls)
    monkeypatch.setattr(mod, "profile_conv_detect_kernel", conv)
    monkeypatch.setattr(mod, "profile_matmul_kernel", mm)


@pytest.mark.parametrize("arch", ["alexnet", "smollm"])
@pytest.mark.parametrize("measured", [False, True],
                         ids=["analytic", "measured"])
def test_profiled_plan_pins_as_jax_does(mixed, monkeypatch, arch,
                                        measured):
    """With both packages' profile functions stubbed to one table, the
    profiled plans are entry for entry identical (use_fused_kernel,
    kernel_tiles, the chunks snapped to the tiles, execution) and so are
    the kernel_profile documents - the measured model's roofline prune
    with its skip reasons included."""
    _stub(monkeypatch, tplan_mod, tpolicy.KernelProfile)
    _stub(monkeypatch, jplan_mod, jpolicy.KernelProfile)
    if arch == "alexnet":
        args_t = (mixed.tp, mixed.cfg_t)
        args_j = (mixed.jp, mixed.cfg_j)
        kw = dict(batch=BATCH)
        ridge = mixed.ridge
    else:
        cfg_t, cfg_j = TCF.get("smollm-360m-smoke"), \
            JCF.get("smollm-360m-smoke")
        args_t, args_j = (None, cfg_t), (None, cfg_j)
        kw = dict(batch=2, seq=16)
        # the narrowest GEMMs (wk/wv) fall below the profile window, the
        # others inside it
        spec = tcore.protection_spec(cfg_t, **kw)
        ridge = 4.5 * min(shape_flops(s.shape) / shape_bytes(s.shape)
                          for s in spec.sites)
    tm = jm = None
    if measured:
        tm = tcore.MeasuredCostModel(peak_flops=ridge * 1e9, hbm_bw=1e9)
        jm = jcore.MeasuredCostModel(peak_flops=ridge * 1e9, hbm_bw=1e9)
    tp = tcore.build_plan(*args_t, cost_model=tm, profile_kernels=True,
                          device="cpu", **kw)
    jp = jcore.build_plan(*args_j, cost_model=jm, profile_kernels=True,
                          **kw)
    _same_entries(tp, jp)
    _close_tree(tp.meta, jp.meta)
    kp = tp.meta["kernel_profile"]
    fused = [n for n, d in kp.items() if d["use_fused"]]
    plain = [n for n, d in kp.items() if not d["use_fused"]]
    skipped = [n for n, d in kp.items() if d.get("skipped")]
    assert bool(skipped) == measured and len(skipped) < len(kp)
    assert plain and (fused or measured), kp
    for n in fused:
        cfg = tp[n].cfg
        assert cfg.use_fused_kernel
        if tp[n].op.kind == "matmul":
            assert cfg.kernel_tiles == (128, 128, 256)
            assert (cfg.row_chunk, cfg.col_chunk) == (128, 128)
    for n in skipped:
        assert kp[n]["skipped"].startswith("roofline prune")
        assert tp.meta["roofline"][n]["profile_skipped"] == kp[n]["skipped"]


def test_no_profilable_site_warns(caplog):
    spec = tcore.ProtectionSpec(sites=[tplan_mod.OpSite(
        "fc", tcore.OpSpec("matmul"), k_dim=8)])
    with caplog.at_level(logging.WARNING, logger="repro_torch.plan"):
        plan = tcore.build_plan(None, spec, profile_kernels=True,
                                device="cpu")
    assert plan.meta["kernel_profile"] == {} and len(plan) == 1
    assert "no profilable sites" in caplog.text


# ---------------------------------------------------------------------------
# the profile functions themselves (tiny shapes, CPU route)
# ---------------------------------------------------------------------------

def test_matmul_profile_programs_end_at_the_same_outputs():
    """Both timed programs finish at the same (o, s5, s6, s7, sumsq), and
    at the JAX package's programs' values on the same inputs."""
    n, k, m = 32, 64, 96
    d, w = normal(11, (n, k)), normal(12, (k, m))
    f_plain, f_fused = tpolicy.matmul_profile_programs(n, k, m,
                                                       tiles=(16, 16, 32))
    j_plain, _ = jpolicy.matmul_profile_programs(n, k, m, tiles=(16, 16, 32),
                                                 interpret=True)
    outs_p = f_plain(torch.as_tensor(d), torch.as_tensor(w))
    outs_f = f_fused(torch.as_tensor(d), torch.as_tensor(w))
    outs_j = j_plain(jnp.asarray(d), jnp.asarray(w))
    assert len(outs_p) == len(outs_f) == len(outs_j) == 5
    for a, b, c, name in zip(outs_p, outs_f, outs_j,
                             ["o", "s5", "s6", "s7", "sumsq"]):
        scale = float(np.max(np.abs(to_np(c)))) + 1.0
        np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-4 * scale,
                                   err_msg=name)
        np.testing.assert_allclose(to_np(a), to_np(c), atol=1e-4 * scale,
                                   err_msg=name)


def test_profile_functions_run_on_the_cpu():
    mm = tcore.profile_matmul_kernel(32, 64, 96, device="cpu")
    assert math.isfinite(mm.t_plain) and mm.t_plain > 0
    assert math.isfinite(mm.t_fused) and mm.t_fused > 0
    assert mm.use_fused == (mm.t_fused < mm.t_plain)
    assert (mm.tiles in tpolicy._MATMUL_TILE_CANDIDATES) == mm.use_fused
    jdoc = jpolicy.KernelProfile(False, None, 1.0, float("inf")).doc()
    assert set(mm.doc()) == set(jdoc)
    cv = tcore.profile_conv_detect_kernel((2, 8, 6, 6), device="cpu")
    assert math.isfinite(cv.t_fused) and cv.tiles is None
    # a degenerate view has no kernel route on the CPU: never pinned
    dg = tcore.profile_conv_detect_kernel((2, 3, 3, 3), device="cpu")
    assert not dg.use_fused and dg.t_fused == float("inf")
    assert dg.doc()["fused_us"] is None
