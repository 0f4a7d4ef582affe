"""The port's campaign (repro_torch.campaign) against the JAX package's:
trials replayed from the JAX engine's own draws must give its verdicts
exactly; the statistical smoke campaign of tests/test_campaign.py holds on
the port at the same trial counts; artifacts cross between the packages
and both `check`s agree on them; the CLI runs on the CPU and rejects
unknown cells; a custom fault model runs through the port's engine."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.campaign as jcamp  # noqa: E402
from repro.campaign.run import check as jcheck  # noqa: E402
from repro.core import injection as jinj  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch import campaign as tcamp  # noqa: E402
from repro_torch.campaign import engine as teng  # noqa: E402
from repro_torch.campaign.run import check as tcheck  # noqa: E402
from repro_torch.campaign.run import main as tmain  # noqa: E402
from repro_torch.core import injection as tinj  # noqa: E402
import torch_parity  # noqa: E402,F401  (one torch thread per worker)

REPLAY_KEYS = 8


@pytest.fixture(scope="module")
def jax_engine():
    return jcamp.CampaignEngine()


@pytest.fixture(scope="module")
def engine():
    return tcamp.CampaignEngine(device="cpu")


def _replay(jax_engine, layer, scheme, fault, n=REPLAY_KEYS, base=100,
            jax_eager=False):
    """Trials the JAX engine draws from `n` keys of PRNGKey(base +
    model_id): its own per-trial outcomes (`want`), the port's `score` on
    the operands and spec each key draws (`got`), and each key's oracle
    scale. With `jax_eager`, also the JAX engine's trial run per key with
    jit disabled (`eager`, else None)."""
    jm, tm = jinj.FAULT_MODELS[fault], tinj.FAULT_MODELS[fault]
    keys = jax.random.split(jax.random.PRNGKey(base + jm.model_id), n)
    want = jax_engine._runner(layer, scheme)(keys, jnp.int32(jm.model_id))
    case = teng.LAYER_CASES[layer]
    d_shape, w_shape = teng._operand_shapes(case)
    dims = teng.spec_dims(case, tm)
    deferred = scheme == "deferred"
    trial = getattr(jcamp.engine, f"_{layer}_trial")(
        jcamp.LAYER_CASES[layer], jcamp.SCHEME_CONFIGS[scheme], 100,
        jax_engine._models, deferred=deferred) if jax_eager else None
    got, scales, eager = [], [], []
    with torch.no_grad():
        for key in keys:
            kd, kw, kf = jax.random.split(key, 3)
            d = torch.as_tensor(np.array(
                jax.random.normal(kd, d_shape, jnp.float32)))
            w = torch.as_tensor(np.array(
                jax.random.normal(kw, w_shape, jnp.float32)))
            spec = jm.plan(kf, *dims, 100)
            spec_t = tinj.FaultSpec(*(torch.as_tensor(np.array(f))
                                      for f in spec))
            got.append(teng.score(case, teng.SCHEME_CONFIGS[scheme], d, w,
                                  spec_t, tm, deferred=deferred))
            scales.append(float(torch.amax(torch.abs(
                teng.oracle(case, d, w)))) + 1.0)
            if jax_eager:
                with jax.disable_jit():
                    eager.append(trial(key, jnp.int32(jm.model_id)))
    return want, got, scales, (eager if jax_eager else None)


def _verdicts(out, i=None):
    """(detected, corrected_by, residual) of one trial."""
    vals = (getattr(out, f) for f in ("detected", "corrected_by", "residual"))
    return tuple(int(v if i is None else np.asarray(v)[i]) for v in vals)


# verdicts that correct the output: a scheme that verified, or recompute
_CORRECTING = {tcore.COC, tcore.RC, tcore.CLC, tcore.FC, tcore.RECOMPUTE}
# the most of an arm's REPLAY_KEYS trials whose corrected_by may differ:
# over 200 trials per arm the rate was at most 11 (5.5%) on matmul/full,
# 4 on transformer_gemm/deferred and none on conv/full (ROADMAP 3.4)
_MAX_RUNG_DIFFS = {"matmul": 1, "conv": 0, "transformer_gemm": 1}


@pytest.mark.parametrize("layer,scheme", [("matmul", "full"),
                                          ("conv", "full"),
                                          ("transformer_gemm", "deferred")])
def test_replayed_trials_give_jax_verdicts(jax_engine, layer, scheme):
    """Per arm, the JAX engine's own trials replayed through the port's
    `score`: detected, residual and corrected (output back at the oracle)
    exact; max_err within 1e-3 of the oracle's scale. corrected_by is
    exact too, except where both packages corrected the output and differ
    only in which rung first verified: a located fix of a +-2^e
    corruption carries about eps * |corrupted value| of rounding from the
    row/column sums, and whether the re-verification accepts it depends
    on the order those sums are taken in (ROADMAP 3.4). Such differences
    are capped per arm at the rate measured over 200 trials."""
    for fault in jinj.FAULT_MODELS:
        want, got, scales, _ = _replay(jax_engine, layer, scheme, fault)
        rung_diffs = 0
        for i, g in enumerate(got):
            what = (layer, scheme, fault, i)
            for fld in ("detected", "residual", "corrected"):
                assert int(g._asdict()[fld]) == \
                    int(np.asarray(getattr(want, fld))[i]), (what, fld)
            by, jby = int(g.corrected_by), int(want.corrected_by[i])
            if by != jby:
                assert {by, jby} <= _CORRECTING, (what, by, jby)
                assert int(g.detected) == 1 and int(g.residual) == 0
                assert int(g.corrected) == 1, what
                rung_diffs += 1
            assert abs(float(g.max_err) - float(want.max_err[i])) \
                <= 1e-3 * scales[i], what
        assert rung_diffs <= _MAX_RUNG_DIFFS[layer], (layer, fault,
                                                       rung_diffs)


# --------------------------------------------------------------------------
# the statistical smoke campaign (tests/test_campaign.py, on the port)
# --------------------------------------------------------------------------

def test_campaign_smoke_burst(engine):
    cell = engine.run_cell("matmul", "full", "burst", trials=200, seed=1)
    assert cell.trials == 200
    assert cell.detection_rate == 1.0
    assert cell.correction_rate >= 0.99
    assert cell.residual_rate == 0.0


def test_campaign_control_arms(engine):
    clean = engine.run_cell("matmul", "full", "none", trials=200, seed=2)
    assert clean.false_positive_rate == 0.0
    assert clean.correction_rate == 1.0
    sub = engine.run_cell("matmul", "full", "subthreshold", trials=200,
                          seed=3)
    assert sub.detection_rate == 0.0


def test_campaign_per_model_detection(engine):
    for fault in ("burst_row", "burst_col", "single_flip", "scattered"):
        cell = engine.run_cell("matmul", "full", fault, trials=64, seed=4)
        assert cell.detection_rate == 1.0, fault
        assert cell.residual_rate == 0.0, fault
    single = engine.run_cell("matmul", "full", "single_flip", trials=64,
                             seed=5)
    assert single.corrected_by.get("coc", 0) > 0


def test_campaign_weight_corrupt_detected_not_corrected(engine):
    cell = engine.run_cell("matmul", "full", "weight_corrupt", trials=128,
                           seed=6)
    assert cell.detection_rate == 1.0
    assert cell.correction_rate == 0.0
    assert cell.residual_rate == 1.0
    conv = engine.run_cell("conv", "full", "weight_corrupt", trials=64,
                           seed=7)
    assert conv.detection_rate == 1.0
    assert tcheck(tcamp.CampaignResult(cells=[cell, conv], meta={})) == []


def test_campaign_weight_corrupt_correctable_repairs(engine):
    """The repair rung's arm: every trial detected, repaired in place
    (W_REPAIR), none escalating to a restore."""
    for layer in ("matmul", "conv"):
        cell = engine.run_cell(layer, "full", "weight_corrupt_correctable",
                               trials=64, seed=11)
        assert cell.detection_rate == 1.0 and cell.residual_rate == 0.0
        assert cell.correction_rate == 1.0
        assert cell.corrected_by["w_repair"] == 64


def test_campaign_transformer_gemm_arm(engine):
    cell = engine.run_cell("transformer_gemm", "full", "burst_row",
                           trials=128, seed=8)
    assert cell.detection_rate == 1.0
    assert cell.correction_rate >= 0.99
    assert cell.residual_rate == 0.0
    clean = engine.run_cell("transformer_gemm", "full", "none",
                            trials=128, seed=9)
    assert clean.false_positive_rate == 0.0
    assert clean.correction_rate == 1.0
    wc = engine.run_cell("transformer_gemm", "full", "weight_corrupt",
                         trials=64, seed=10)
    assert wc.detection_rate == 1.0
    deferred = engine.run_cell("transformer_gemm", "deferred", "burst_row",
                               trials=64, seed=8)
    full = engine.run_cell("transformer_gemm", "full", "burst_row",
                           trials=64, seed=8)
    assert deferred.detection_rate == full.detection_rate
    assert deferred.corrected_by == full.corrected_by


def test_campaign_deferred_scheme_matches_full(engine):
    for fault in ("burst", "single_flip", "none"):
        cd = engine.run_cell("matmul", "deferred", fault, trials=128, seed=1)
        cf = engine.run_cell("matmul", "full", fault, trials=128, seed=1)
        assert cd.detection_rate == cf.detection_rate, fault
        assert cd.correction_rate == cf.correction_rate, fault
        assert cd.residual_rate == cf.residual_rate, fault
        assert cd.corrected_by == cf.corrected_by, fault
    assert cd.false_positive_rate == 0.0        # the control arm (none)


def test_draws_are_seeded_per_arm(engine):
    """A seed gives the same trials every time; arms draw apart."""
    a = engine.draw("conv", "burst", 4, seed=3)
    b = engine.draw("conv", "burst", 4, seed=3)
    c = engine.draw("conv", "burst_row", 4, seed=3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2].offsets,
                                                   b[2].offsets)
    assert not torch.equal(a[0], c[0])
    assert a[2].offsets.shape == (4, 100)


# --------------------------------------------------------------------------
# artifacts and gates across the packages, the CLI, a custom model
# --------------------------------------------------------------------------

def _cells(cls):
    base = dict(layer="matmul", scheme="full", fault="burst", trials=10,
                detection_rate=1.0, correction_rate=1.0, residual_rate=0.0,
                false_positive_rate=0.0, recompute_rate=0.0,
                corrected_by={"rc": 10}, max_abs_err=1e-5, wall_seconds=0.1)
    edits = [{}, dict(fault="none", detection_rate=0.0, corrected_by={}),
             dict(fault="custom_not_registered"),
             dict(detection_rate=0.9),
             dict(fault="none", detection_rate=0.1, false_positive_rate=0.1),
             dict(fault="subthreshold", detection_rate=0.4),
             dict(fault="single_flip", correction_rate=0.5,
                  residual_rate=0.2),
             dict(fault="weight_corrupt", correction_rate=0.0,
                  residual_rate=1.0, corrected_by={}),
             dict(fault="weight_corrupt_correctable", residual_rate=0.1,
                  correction_rate=0.9),
             dict(scheme="detect", fault="burst_row", correction_rate=0.0,
                  residual_rate=1.0)]
    return [cls(**{**base, **e}) for e in edits]


def test_port_artifact_loads_in_jax_and_gates_agree(tmp_path, engine):
    real = [engine.run_cell("conv", "full", f, trials=6, seed=0)
            for f in ("none", "burst")]
    res = tcamp.CampaignResult(
        cells=real + _cells(tcamp.CellResult),
        meta={"trials": 6, "seed": 0, "max_elems": 100,
              "torch_version": torch.__version__, "device": "cpu",
              "wall_seconds": 0.1})
    path = str(tmp_path / "port.json")
    res.save(path)
    raw = json.loads(open(path).read())
    assert raw["schema"] == "repro.campaign/v1"
    loaded = jcamp.CampaignResult.load(path)
    assert [c.to_dict() for c in loaded.cells] == \
        [c.to_dict() for c in res.cells]
    assert loaded.cell("conv", "full", "burst").detection_rate == 1.0
    assert jcheck(loaded) == tcheck(res)
    assert len(tcheck(res)) == 7


def test_jax_artifact_loads_in_port_and_gates_agree(tmp_path):
    res = jcamp.CampaignResult(cells=_cells(jcamp.CellResult),
                               meta={"trials": 10, "seed": 0,
                                     "max_elems": 100,
                                     "jax_version": jax.__version__,
                                     "wall_seconds": 0.1})
    path = str(tmp_path / "jax.json")
    res.save(path)
    loaded = tcamp.CampaignResult.load(path)
    assert loaded.cell("matmul", "full", "nope") is None
    assert [c.to_dict() for c in loaded.cells] == \
        [c.to_dict() for c in res.cells]
    assert tcheck(loaded) == jcheck(res)
    assert loaded.cells[0].row() == res.cells[0].row()


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "c.json")
    rc = tmain(["--trials", "3", "--layers", "matmul,conv", "--faults",
                "burst,weight_corrupt_correctable", "--out", out,
                "--device", "cpu"])
    assert rc == 0
    rows = [r for r in capsys.readouterr().out.splitlines()
            if r.startswith("campaign/")]
    assert len(rows) == 6 and rows[0].startswith("campaign/matmul/full/none,")
    res = tcamp.CampaignResult.load(out)
    assert res.meta["device"] == "cpu" and len(res.cells) == 6
    assert jcheck(jcamp.CampaignResult.load(out)) == []


def test_cli_rejects_unknown_cells():
    for argv in (["--layers", "matmull"], ["--schemes", "bogus"],
                 ["--faults", "bogus"], ["--trials", "0"]):
        with pytest.raises(SystemExit):
            tmain(argv + ["--trials", "1", "--device", "cpu"]
                  if argv[0] != "--trials" else argv + ["--device", "cpu"])


def _apply_stuck_zero(o3, spec):
    n, m, p = o3.shape[-3:]
    mask = tinj.position_mask(spec, n, m, p).reshape(o3.shape)
    return torch.where(mask, torch.zeros((), dtype=o3.dtype), o3)


def test_custom_model_runs_through_the_engine():
    """The stuck-at-zero model of examples/fault_campaign.py, registered
    in the port: an engine built after it runs it (detected, corrected);
    an engine built before it refuses it."""
    early = tcamp.CampaignEngine(device="cpu")
    assert "stuck_zero" not in tinj.FAULT_MODELS

    def plan_stuck_zero(g, n, m, p, max_elems=100):
        i = int(torch.randint(0, n, (), generator=g))
        j = int(torch.randint(0, m, (), generator=g))
        off = (i * m + j) * p + torch.arange(max_elems) % p
        return tinj.FaultSpec(
            torch.tensor(tinj.FAULT_MODELS["stuck_zero"].model_id,
                         dtype=torch.int32),
            torch.tensor(2, dtype=torch.int32),
            torch.tensor(-1, dtype=torch.int32),
            torch.tensor(min(p, max_elems), dtype=torch.int32),
            torch.tensor(0.0), torch.tensor(0.0), off.to(torch.int32))

    tinj.register_fault_model("stuck_zero", apply=_apply_stuck_zero)(
        plan_stuck_zero)
    try:
        with pytest.raises(ValueError, match="registered after"):
            early.run_cell("conv", "full", "stuck_zero", trials=2)
        eng = tcamp.CampaignEngine(device="cpu")
        for layer in ("matmul", "conv"):
            cell = eng.run_cell(layer, "full", "stuck_zero", trials=16,
                                seed=4)
            assert cell.detection_rate == 1.0, layer
            assert cell.residual_rate == 0.0 and cell.correction_rate >= 0.99
        res = eng.run(["matmul"], ["full"], ["stuck_zero"], trials=4)
        assert [c.fault for c in res.cells] == ["none", "stuck_zero"]
        assert tcheck(res) == []
    finally:
        tinj.FAULT_MODELS.pop("stuck_zero")
    assert list(tinj.FAULT_MODELS) == list(jinj.FAULT_MODELS)
    assert tcore.FAULT_MODELS is tinj.FAULT_MODELS


if __name__ == "__main__":
    # Count per-trial verdict differences over many trials per arm:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_campaign.py \
    #       [--trials 200] [--jax-eager]
    # One JSON line per (layer, arm): trials whose (detected, corrected_by,
    # residual) differ between the JAX engine and the port's `score`, by
    # verdicts; with --jax-eager also where the JAX engine's jitted trials
    # differ from the same trials run with jit disabled.
    import argparse
    import collections
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=200)
    ap.add_argument("--jax-eager", action="store_true")
    args = ap.parse_args()
    eng = jcamp.CampaignEngine()
    for layer, scheme in (("matmul", "full"), ("conv", "full"),
                          ("transformer_gemm", "deferred")):
        for fault in jinj.FAULT_MODELS:
            want, got, _, eager = _replay(eng, layer, scheme, fault,
                                          n=args.trials, base=7,
                                          jax_eager=args.jax_eager)
            diff, self_diff = collections.Counter(), collections.Counter()
            for i, g in enumerate(got):
                a, b = _verdicts(want, i), _verdicts(g)
                if a != b:
                    diff[f"jax {a} port {b}"] += 1
                if eager is not None and _verdicts(eager[i]) != a:
                    self_diff[f"jit {a} eager {_verdicts(eager[i])}"] += 1
            line = {"layer": layer, "scheme": scheme, "fault": fault,
                    "trials": args.trials, "differ": sum(diff.values()),
                    "by_verdicts": dict(diff)}
            if eager is not None:
                line.update(jax_eager_differ=sum(self_diff.values()),
                            jax_eager_by_verdicts=dict(self_diff))
            print(json.dumps(line), flush=True)
