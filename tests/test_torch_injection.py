"""The port's fault-injection registry (repro_torch.core.injection) against
the JAX package's: the registry itself, specs drawn by JAX replayed through
both packages' `inject`, the pre-registry helpers from replayed plans, and
the invariants of the port's own draws (twins of tests/test_campaign.py's
registry properties). Operands are made with numpy from a seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import injection as jinj  # noqa: E402
from repro.core import thresholds as JTH  # noqa: E402
from repro_torch.core import injection as tinj  # noqa: E402
from repro_torch.core import thresholds as TTH  # noqa: E402
from repro_torch.core.types import DEFAULT_CONFIG  # noqa: E402
from torch_parity import normal, to_np  # noqa: E402

OUTPUT_MODELS = ["burst_row", "burst_col", "burst", "single_flip",
                 "scattered"]
# (label, tensor shape, block dims (n, m, p), max_elems): a matmul, a conv,
# a rectangular matmul, a conv weight, and spans shorter than max_elems
SHAPES = [("matmul", (24, 20), (24, 20, 1), 16),
          ("conv", (6, 8, 8, 8), (6, 8, 64), 100),
          ("rect", (5, 40), (5, 40, 1), 100),
          ("conv_weight", (8, 4, 3, 3), (8, 4, 9), 100),
          ("short_span", (4, 3), (4, 3, 1), 16),
          ("short_conv", (3, 2, 2, 2), (3, 2, 4), 16)]


def _spec_t(spec) -> tinj.FaultSpec:
    """A JAX FaultSpec as the port's (the same int32/f32 fields)."""
    return tinj.FaultSpec(*(torch.as_tensor(np.array(f)) for f in spec))


def test_registry_matches_jax():
    """Same names in the same order, so the same model ids, and the same
    detectable/target/correctable flags."""
    assert list(tinj.FAULT_MODELS) == list(jinj.FAULT_MODELS)
    for name, jm in jinj.FAULT_MODELS.items():
        tm = tinj.FAULT_MODELS[name]
        assert (tm.model_id, tm.detectable, tm.target, tm.correctable) == \
            (jm.model_id, jm.detectable, jm.target, jm.correctable), name
    assert tinj.CONTROL_MODEL == jinj.CONTROL_MODEL
    assert tinj.fault_model_names() == jinj.fault_model_names()
    assert tinj.fault_model_names(True) == jinj.fault_model_names(True)
    assert tinj.SUBTHRESHOLD_REL == jinj.SUBTHRESHOLD_REL


@pytest.mark.parametrize("label,shape,dims,max_elems", SHAPES,
                         ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("fault", list(jinj.FAULT_MODELS))
def test_replayed_spec_injects_alike(fault, label, shape, dims, max_elems):
    """A spec JAX drew, applied by both packages' inject: bitwise for the
    affine models, within one ulp at the hit element for subthreshold
    (its norm is summed in another order). Positions and the sentinel
    mask agree exactly."""
    n, m, p = dims
    jm, tm = jinj.FAULT_MODELS[fault], tinj.FAULT_MODELS[fault]
    seed = (tm.model_id * 97 + len(label)) % 1000
    o = normal(seed, shape)
    spec = jm.plan(jax.random.PRNGKey(seed), n, m, p, max_elems)
    spec_t = _spec_t(spec)
    want = np.asarray(jinj.inject(jnp.asarray(o), spec, jm))
    got = to_np(tinj.inject(torch.as_tensor(o), spec_t, tm))
    np.testing.assert_array_equal(
        to_np(tinj.position_mask(spec_t, n, m, p)),
        np.asarray(jinj.position_mask(spec, n, m, p)))
    jpos = np.asarray(jinj.spec_positions(spec, n, m, p))
    np.testing.assert_array_equal(
        to_np(tinj.spec_positions(spec_t, n, m, p)), jpos)
    if fault == "subthreshold":
        hit = got != o
        np.testing.assert_array_equal(hit, want != o)
        assert hit.sum() == 1
        assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))
        np.testing.assert_array_equal(got[~hit], want[~hit])
    else:
        np.testing.assert_array_equal(got, want)


def test_batched_spec_injects_each_trial():
    """Specs stacked over a trials axis corrupt a batch of outputs in one
    call, each trial exactly as its own spec alone."""
    model = tinj.FAULT_MODELS["burst"]
    g = torch.Generator().manual_seed(5)
    specs = [model.plan(g, 6, 8, 64, 100) for _ in range(5)]
    o = torch.as_tensor(normal(3, (5, 6, 8, 8, 8)))
    batched = tinj.inject(o, tinj.stack_specs(specs), model)
    for i, s in enumerate(specs):
        assert torch.equal(batched[i], tinj.inject(o[i], s, model))
    sub = tinj.FAULT_MODELS["subthreshold"]
    specs = [sub.plan(g, 6, 8, 64, 100) for _ in range(5)]
    batched = tinj.inject(o, tinj.stack_specs(specs), sub)
    for i, s in enumerate(specs):
        assert torch.equal(batched[i], tinj.inject(o[i], s, sub))


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("nm", [(16, 12), (12, 16)])
def test_inject_matmul_from_replayed_plan(axis, nm):
    n, m = nm
    for seed in range(4):
        p = jinj.plan(jax.random.PRNGKey(seed), n, m, max_elems=10,
                      axis=axis)
        o = normal(seed, (n, m))
        want = np.asarray(jinj.inject_matmul(jnp.asarray(o), p))
        got = to_np(tinj.inject_matmul(
            torch.as_tensor(o),
            tinj.InjectionPlan(*(torch.as_tensor(np.array(f))
                                 for f in p))))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(6, 8), (5, 4, 3, 3)])
def test_inject_single_block_from_replayed_key(shape):
    """The port's helper at the block JAX's key selects: bitwise."""
    n, m = shape[0], shape[1]
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        i = int(jax.random.randint(key, (), 0, n))
        j = int(jax.random.randint(jax.random.fold_in(key, 1), (), 0, m))
        o = normal(seed, shape)
        want = np.asarray(jinj.inject_single_block(jnp.asarray(o), key))
        got = to_np(tinj.inject_single_block(torch.as_tensor(o),
                                             block=(i, j)))
        np.testing.assert_array_equal(got, want)
    g = torch.Generator().manual_seed(1)
    o = torch.as_tensor(normal(9, shape))
    changed = tinj.inject_single_block(o, g) != o
    assert changed.reshape(n, m, -1).any(-1).sum() == 1


@pytest.mark.parametrize("nelem", [1, 5, 200])
def test_inject_conv_from_replayed_plan(nelem):
    """inject_conv draws its payload positions from its own generator, so
    parity is of structure: the same blocks, min(nelem, E*E) payload
    elements in each, and the same corrupted values."""
    o = normal(11, (5, 6, 4, 4))
    pe = 16
    for seed in range(4):
        p = jinj.plan(jax.random.PRNGKey(seed), 5, 6, max_elems=100)
        p = p._replace(nelem=jnp.int32(nelem))
        want = np.asarray(jinj.inject_conv(jnp.asarray(o), p))
        got = to_np(tinj.inject_conv(
            torch.as_tensor(o),
            tinj.InjectionPlan(*(torch.as_tensor(np.array(f))
                                 for f in p))))
        corrupt = o * np.float32(p.scale) + np.float32(1.0)
        for out in (want, got):
            hit = out != o
            np.testing.assert_array_equal(out[hit], corrupt[hit])
            per_block = hit.reshape(5, 6, pe).sum(-1)
            blocks = per_block > 0
            if int(p.axis) == 0:
                assert blocks[int(p.index)].all() and blocks.sum() == 6
            else:
                assert blocks[:, int(p.index)].all() and blocks.sum() == 5
            assert set(per_block[blocks].tolist()) == {min(nelem, pe)}
        np.testing.assert_array_equal(
            (want != o).reshape(5, 6, pe).any(-1),
            (got != o).reshape(5, 6, pe).any(-1))


# --------------------------------------------------------------------------
# the port's own draws (tests/test_campaign.py's registry properties)
# --------------------------------------------------------------------------

N, K, M = 24, 16, 20


def _output(seed):
    d, w = normal(seed, (N, K)), normal(seed + 1, (K, M))
    return torch.as_tensor(d) @ torch.as_tensor(w)


@pytest.mark.parametrize("fault", OUTPUT_MODELS)
def test_own_draws_respect_the_plan(fault):
    """Corruption lands only inside the planned span and touches between
    1 and nelem elements; single_flip touches one; each detectable
    corruption exceeds the thresholds.py scalar floor."""
    model = tinj.FAULT_MODELS[fault]
    for seed in range(25):
        o = _output(seed)
        spec = model.plan(torch.Generator().manual_seed(seed ^ 0x77),
                          N, M, 1, 16)
        o_bad = tinj.inject(o, spec, model)
        changed = np.argwhere(to_np(o_bad != o))
        assert 1 <= len(changed) <= int(spec.nelem)
        if int(spec.axis) == 0:
            assert (changed[:, 0] == int(spec.index)).all()
        elif int(spec.axis) == 1:
            assert (changed[:, 1] == int(spec.index)).all()
        if fault == "single_flip":
            assert len(changed) == 1
        tau = TTH.tau_scalar(torch.sum(o * o), K, o.dtype,
                             DEFAULT_CONFIG.tau_factor)
        assert float(torch.amax(torch.abs(o_bad - o))) > float(tau)
        # the JAX package's floor for the same output agrees
        tau_j = JTH.tau_scalar(jnp.sum(jnp.asarray(to_np(o)) ** 2), K,
                               jnp.float32, jcore.DEFAULT_CONFIG.tau_factor)
        assert float(torch.amax(torch.abs(o_bad - o))) > float(tau_j)


def test_none_model_is_identity():
    model = tinj.FAULT_MODELS["none"]
    o = _output(3)
    spec = model.plan(torch.Generator().manual_seed(0), N, M, 1, 16)
    assert torch.equal(tinj.inject(o, spec, model), o)


def test_own_subthreshold_draws_stay_below_floor():
    """The negative control changes the output, but its whole corruption
    sits far below the floor of tau_scalar."""
    model = tinj.FAULT_MODELS["subthreshold"]
    for seed in range(25):
        o = _output(seed)
        spec = model.plan(torch.Generator().manual_seed(seed ^ 0x29),
                          N, M, 1, 16)
        diff = torch.abs(tinj.inject(o, spec, model) - o)
        assert float(torch.amax(diff)) > 0.0
        floor = (DEFAULT_CONFIG.tau_factor * TTH.out_eps(o.dtype)
                 * float(torch.sqrt(torch.sum(o * o))))
        assert float(torch.sum(diff)) < 0.1 * floor


def test_own_specs_stack_over_trials():
    model = tinj.FAULT_MODELS["burst"]
    g = torch.Generator().manual_seed(0)
    specs = tinj.stack_specs([model.plan(g, N, M, 1, 16) for _ in range(64)])
    assert specs.offsets.shape == (64, 16)
    assert specs.offsets.dtype == torch.int32
    assert bool(torch.all((specs.axis == 0) | (specs.axis == 1)))
    assert bool(torch.all(specs.nelem >= 1))
    assert 0 < int(torch.sum(specs.axis)) < 64


@pytest.mark.parametrize("p", [1, 9])
def test_weight_correctable_draws_hit_one_block(p):
    """Matmul (p = 1): one column of W; conv: one filter. Elements are
    overwritten (scale 0) with +-2^e."""
    model = tinj.FAULT_MODELS["weight_corrupt_correctable"]
    n, m = (16, 20) if p == 1 else (8, 4)
    for seed in range(10):
        spec = model.plan(torch.Generator().manual_seed(seed), n, m, p, 100)
        w = torch.as_tensor(normal(seed, (n, m, p)))
        bad = tinj.inject(w, spec, model)
        hit = np.argwhere(to_np(bad != w))
        assert 1 <= len(hit) <= int(spec.nelem)
        assert len(set(hit[:, 1 if p == 1 else 0].tolist())) == 1
        vals = to_np(bad)[bad != w]
        assert set(np.abs(vals).tolist()) == {abs(float(spec.add))}


def test_unknown_target_and_duplicates_are_refused():
    with pytest.raises(ValueError, match="unknown fault target"):
        tinj.register_fault_model("x", target="input")
    with pytest.raises(ValueError, match="already registered"):
        tinj.register_fault_model("burst")(lambda *a: None)
