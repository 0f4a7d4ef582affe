"""The port's protected CNN slice (build_plan -> forward_cnn) against the
JAX package's, on reduced ResNet-18 and AlexNet (width 0.12, batch 2).

Both packages get the same numpy params, input and injected outputs.
Verdicts must be identical layer by layer; logits agree to fp32
reassociation through the network (rtol 1e-4, atol 1e-4 of the logits'
scale). The port runs with the kernel route (use_fused_kernel) off and
pinned; the JAX side runs with it off - its interpret-mode kernels are held
shape for shape in test_torch_kernels.py - and with jit disabled, so each
lax.cond runs only its live branch."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import workflow as twf  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from torch_parity import (assert_close, normal,  # noqa: E402
                          shared_reference, to_np)

SCALE, BATCH = 0.12, 2
# injection layers share their output shape, so the JAX side compiles the
# correction ladder once per model: AlexNet conv2/conv3 (3x3, 384 ch) and
# ResNet-18 conv5 (the stride-2 stage entry) / conv6
ARCHS = {"alexnet": (48, (2, 3)), "resnet18": (32, (5, 6))}
MODES = ("per_layer", "deferred")


def _pin(plan, fused: bool):
    if not fused:
        return plan
    return tcore.ProtectionPlan(
        {n: dataclasses.replace(e, cfg=e.cfg.replace(use_fused_kernel=True))
         for n, e in plan.entries.items()}, dict(plan.meta))


def _summary(rep):
    return {n: tuple(v.values()) for n, v in rep.summary().items()}


@dataclasses.dataclass
class Model:
    arch: str
    cfg_t: object
    cfg_j: object
    params_np: dict
    tp: dict
    jp: dict
    x: np.ndarray
    tplan: object
    layers: tuple

    @functools.cached_property
    def jplan(self):
        """The JAX package's plan, built where a test or a shared
        reference needs it."""
        return jcore.build_plan(self.jp, self.cfg_j, batch=BATCH)

    def jax_forward(self, mode, layer=-1, o=None, plan=None):
        with jax.disable_jit():
            lg, rep = jcnn.forward_cnn(
                self.jp, jnp.asarray(self.x), self.cfg_j,
                plan=plan or self.jplan, correction=mode,
                inject_layer=layer,
                inject_o=None if o is None else jnp.asarray(o))
        return to_np(lg), _summary(rep)

    def torch_forward(self, mode, fused=False, layer=-1, o=None, plan=None):
        lg, rep = tcnn.forward_cnn(
            self.tp, torch.as_tensor(self.x), self.cfg_t,
            plan=_pin(plan or self.tplan, fused), correction=mode,
            inject_layer=layer,
            inject_o=None if o is None else torch.as_tensor(o),
            device="cpu")
        return to_np(lg), _summary(rep)


def _numpy_params(cfg, seed: int) -> dict:
    """He-initialised params in init_cnn's layout, drawn with numpy."""
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


@pytest.fixture(scope="module", params=list(ARCHS))
def model(request):
    arch = request.param
    img, layers = ARCHS[arch]
    cfg_j = dataclasses.replace(jcnn.CNN_REGISTRY[arch](SCALE), img=img)
    cfg_t = dataclasses.replace(tcnn.CNN_REGISTRY[arch](SCALE), img=img)
    params_np = _numpy_params(cfg_t, seed=0)
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    tp = tcnn.params_from_numpy(params_np, "cpu")
    x = normal(1, (BATCH, 3, img, img))
    return Model(arch, cfg_t, cfg_j, params_np, tp, jp, x,
                 tcore.build_plan(tp, cfg_t, batch=BATCH, device="cpu"),
                 layers)


def _logit_tol(ref):
    return dict(rtol=1e-4, atol=1e-4 * (float(np.max(np.abs(ref))) + 1.0))


def test_plan_matches_jax(model):
    jplan, tplan = model.jplan, model.tplan
    assert tplan.names() == jplan.names()
    assert tplan.meta == jplan.meta
    for name in jplan.names():
        je, te = jplan[name], tplan[name]
        assert dataclasses.asdict(te.cfg) == dataclasses.asdict(je.cfg), name
        assert dataclasses.asdict(te.op) == dataclasses.asdict(je.op)
        assert (te.w_shape, te.w_dtype) == (je.w_shape, je.w_dtype)
        jw, tw = list(je.wck)[:2], list(te.wck)[:2]
        for a, b in zip(tw, jw):
            scale = float(np.max(np.abs(to_np(b)))) + 1.0
            assert_close(a, b, 1e-5, 1e-5 * scale, f"{name} checksums")
        for fld in ("r1", "r2", "c1", "c2"):
            assert_close(getattr(te.wlc, fld), getattr(je.wlc, fld), 1e-12,
                         1e-9, f"{name} locator {fld}")
        assert te.wlc.cb == je.wlc.cb
        assert te.w_sum == pytest.approx(je.w_sum, rel=1e-5, abs=1e-4)
    tplan.validate(model.tp)
    stale = {k: dict(v) for k, v in model.tp.items()}
    stale["fc"]["w"] = stale["fc"]["w"] * 1.01
    with pytest.raises(tcore.PlanStaleError):
        tplan.validate(stale)


@pytest.fixture(scope="module")
def jax_ref(model, tmp_path_factory):
    """Every JAX forward the model's tests compare with, run in one process
    (the eager forwards share their per-op compiles) once per pytest run
    and shared with every xdist worker (torch_parity.shared_reference):
    the clean forward in both modes, each injection of
    test_injected_forward_matches_jax in both modes, and the per_layer
    forward of test_jax_plan_files_load_in_the_port. The injected outputs
    are the port's clean conv outputs with numpy-made deltas, as the
    tests make them."""
    def build():
        out = {"clean": {mode: model.jax_forward(mode) for mode in MODES},
               "injected": {}}
        for which, layer in enumerate(model.layers):
            o_bad = _injected(model, layer, seed=layer + which)
            out["injected"][which] = {
                mode: model.jax_forward(mode, layer, o_bad)
                for mode in MODES}
        layer = model.layers[0]
        out["plan_file"] = model.jax_forward(
            "per_layer", layer, _injected(model, layer, seed=7))
        return out

    return shared_reference(tmp_path_factory, f"cnn_{model.arch}_jax",
                            build)


@pytest.mark.parametrize("fused", [False, True])
def test_clean_forward_matches_jax(model, jax_ref, fused):
    off = dataclasses.replace(model.cfg_t, abft=False)
    l_off, _ = tcnn.forward_cnn(model.tp, torch.as_tensor(model.x), off,
                                device="cpu")
    for mode in MODES:
        jl, jsum = jax_ref["clean"][mode]
        tl, tsum = model.torch_forward(mode, fused=fused)
        assert tsum == jsum
        assert all(v == (0, "none", 0) for v in tsum.values())
        np.testing.assert_allclose(tl, jl, **_logit_tol(jl))
        # inside the port the protected clean path is the unprotected one
        np.testing.assert_array_equal(tl, to_np(l_off))


def _injected(model, layer: int, seed: int) -> np.ndarray:
    """The clean conv output of `layer`, with a burst on one image over
    three channels at one payload position and a single element
    elsewhere (numpy-made deltas)."""
    _, o = tcnn.conv_output_at(model.tp, torch.as_tensor(model.x),
                               model.cfg_t, layer)
    o = to_np(o)
    g = np.random.default_rng(seed)
    n, m, e1, e2 = o.shape
    y, x = int(g.integers(e1)), int(g.integers(e2))
    if seed % 2:
        for c in g.choice(m, size=3, replace=False):
            o[0, int(c), y, x] += float(g.uniform(10, 40))
    else:
        o[n - 1, int(g.integers(m)), y, x] += float(g.uniform(10, 40))
    return o


@pytest.mark.parametrize("which", [0, 1])
def test_injected_forward_matches_jax(model, jax_ref, which):
    layer = model.layers[which]
    o_bad = _injected(model, layer, seed=layer + which)
    jl_clean = jax_ref["clean"]["per_layer"][0]
    for mode in MODES:
        jl, jsum = jax_ref["injected"][which][mode]
        assert jsum[f"conv{layer}"][0] == 1 and jsum[f"conv{layer}"][2] == 0
        for fused in (False, True):
            tl, tsum = model.torch_forward(mode, fused, layer, o_bad)
            assert tsum == jsum, (mode, fused)
            np.testing.assert_allclose(tl, jl, **_logit_tol(jl))
            np.testing.assert_allclose(tl, jl_clean, **_logit_tol(jl_clean))


def test_jax_plan_files_load_in_the_port(model, jax_ref, tmp_path):
    """A plan saved by the JAX package's build_plan loads in the port and
    gives the same verdicts; the port's saved plan loads back in JAX."""
    path = str(tmp_path / "jplan.json")
    model.jplan.save(path)
    loaded = tcore.ProtectionPlan.load(path, device="cpu")
    assert loaded.names() == model.jplan.names()
    for name in loaded.names():
        assert isinstance(loaded[name].wlc.r1, np.ndarray)
        assert loaded[name].wlc.r1.dtype == np.float64
    loaded.validate(model.tp)
    layer = model.layers[0]
    o_bad = _injected(model, layer, seed=7)
    jl, jsum = jax_ref["plan_file"]
    tl, tsum = model.torch_forward("per_layer", True, layer, o_bad,
                                   plan=loaded)
    assert tsum == jsum
    np.testing.assert_allclose(tl, jl, **_logit_tol(jl))

    back = str(tmp_path / "tplan.json")
    model.tplan.save(back)
    jloaded = jcore.ProtectionPlan.load(back)
    for name in jloaded.names():
        assert jloaded[name].cfg == model.jplan[name].cfg
        assert_close(jloaded[name].wck[0], model.jplan[name].wck[0], 1e-5,
                     1e-4)
    jloaded.validate(model.jp)


def test_host_reads_per_mode(model):
    """per_layer reads one flag per protected site; deferred reads every
    site's flag in one transfer; a carried flag is never read again."""
    for fused in (False, True):
        for mode, want in (("per_layer", len(model.tplan)), ("deferred", 1)):
            twf.HOST_READS = 0
            model.torch_forward(mode, fused)
            assert twf.HOST_READS == want, (mode, fused)
    layer = model.layers[0]
    o_bad = _injected(model, layer, seed=3)
    twf.HOST_READS = 0
    _, tsum = model.torch_forward("deferred", True, layer, o_bad)
    assert tsum[f"conv{layer}"][0] == 1
    # one read for the detect pass, then only the flagged site's ladder
    # reads (its rungs and the residual check), never a carried flag
    reads = twf.HOST_READS
    twf.HOST_READS = 0
    model.torch_forward("per_layer", True, layer, o_bad)
    assert reads == twf.HOST_READS - (len(model.tplan) - 1)


def test_params_from_numpy_round_trips(model):
    back = {k: {kk: to_np(vv) for kk, vv in v.items()}
            for k, v in model.tp.items()}
    for k, v in model.params_np.items():
        for kk, vv in v.items():
            np.testing.assert_array_equal(back[k][kk], vv)
    again = tcnn.params_from_numpy(back, "cpu")
    for k, v in again.items():
        for kk, vv in v.items():
            assert torch.equal(vv, model.tp[k][kk])
    fresh = tcnn.init_cnn(model.cfg_t,
                          generator=torch.Generator().manual_seed(3),
                          device="cpu")
    same = tcnn.init_cnn(model.cfg_t,
                         generator=torch.Generator().manual_seed(3),
                         device="cpu")
    assert all(torch.equal(fresh[k]["w"], same[k]["w"]) for k in fresh)
    assert {k: tuple(v["w"].shape) for k, v in fresh.items()} == \
        {k: tuple(v["w"].shape) for k, v in model.tp.items()}
