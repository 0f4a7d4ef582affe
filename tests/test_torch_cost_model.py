"""The port's measured roofline cost model (repro_torch.core.cost_model)
and calibrate(), against the JAX package's: the calibration cache
(written then loaded, stale backend rejected, refresh), the roofline
verdicts given a cache, and the derived plan decisions, each held equal
to repro.core.cost_model's for the same (peak_flops, hbm_bw) over every
op shape of ResNet-18 and AlexNet (twins of tests/test_cost_model.py).
The microbenchmarks run here on the CPU only; the card's run is a gpu
test."""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core.cost_model import (CACHE_ENV, CACHE_SCHEMA,  # noqa: E402
                                         HostPeaks, MeasuredCostModel,
                                         cost_model_doc, default_cache_path,
                                         measure_peaks, shape_bytes,
                                         shape_flops)
from repro_torch.core.policy import CostModel, OpShape  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402


def _write_cache(path, peak_flops=2e11, hbm_bw=2e10, backend="cpu"):
    path.write_text(json.dumps({
        "schema": CACHE_SCHEMA, "backend": backend, "host": "testhost",
        "peak_flops": peak_flops, "hbm_bw": hbm_bw}))
    return str(path)


# --------------------------------------------------------------------------
# calibration cache
# --------------------------------------------------------------------------

def test_measure_peaks_writes_then_loads_cache(tmp_path):
    """The first call measures and writes; the second loads the same
    numbers (source 'cache'); the document records the CPU's
    microbenchmark sizes."""
    path = str(tmp_path / "roofline.json")
    p1 = measure_peaks(cache_path=path, device="cpu")
    assert p1.source == "measured" and p1.backend == "cpu"
    assert p1.peak_flops > 0 and p1.hbm_bw > 0
    p2 = measure_peaks(cache_path=path, device="cpu")
    assert p2.source == "cache"
    assert p2.peak_flops == p1.peak_flops and p2.hbm_bw == p1.hbm_bw
    with open(path) as f:
        doc = json.load(f)
    assert doc["schema"] == CACHE_SCHEMA and doc["backend"] == "cpu"
    assert doc["peak_flops"] == p1.peak_flops
    assert (doc["gemm_n"], doc["triad_elems"]) == (512, 1 << 22)


def test_measure_peaks_stale_backend_cache_rejected(tmp_path):
    """A cache recorded under another backend (the card's, read on the
    CPU) is stale: re-measured, not trusted."""
    path = _write_cache(tmp_path / "roofline.json", 1.0, 1.0,
                        backend="cuda")
    p = measure_peaks(cache_path=path, device="cpu")
    assert p.source == "measured"
    assert p.peak_flops != 1.0


def test_measure_peaks_refresh_overwrites(tmp_path):
    path = _write_cache(tmp_path / "roofline.json", 1.0, 1.0)
    assert measure_peaks(cache_path=path, device="cpu").source == "cache"
    p = measure_peaks(cache_path=path, refresh=True, device="cpu")
    assert p.source == "measured" and p.peak_flops != 1.0
    assert json.loads(open(path).read())["peak_flops"] == p.peak_flops


def test_cache_location(monkeypatch, tmp_path):
    """REPRO_ROOFLINE_CACHE wins; otherwise the port keeps its own
    directory, apart from the JAX package's."""
    monkeypatch.setenv(CACHE_ENV, str(tmp_path / "x.json"))
    assert default_cache_path("cuda") == str(tmp_path / "x.json")
    monkeypatch.delenv(CACHE_ENV)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    got = default_cache_path("cuda")
    assert got.startswith(str(tmp_path / "repro_torch"))
    assert "roofline_cuda_" in got
    assert got != jcm.default_cache_path("cuda")


def test_measure_peaks_needs_a_card_unless_cpu_is_asked(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure_peaks(cache_path=str(tmp_path / "r.json"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MeasuredCostModel.from_host(cache_path=str(tmp_path / "r.json"))


def test_host_peaks_ridge():
    p = HostPeaks(2e11, 2e10, "cpu", "h", "measured")
    assert p.ridge == pytest.approx(10.0)
    assert p.doc() == jcm.HostPeaks(2e11, 2e10, "cpu", "h",
                                    "measured").doc()


# --------------------------------------------------------------------------
# deterministic classification
# --------------------------------------------------------------------------

def test_classify_deterministic_given_cached_calibration(tmp_path):
    path = _write_cache(tmp_path / "roofline.json")
    m1 = MeasuredCostModel.from_host(cache_path=path, device="cpu")
    m2 = MeasuredCostModel.from_host(cache_path=path, device="cpu")
    assert m1.source == "cache" == m2.source
    shapes = [OpShape(n=8, m=256, ch=96, r=5, h=27),
              OpShape(n=16, m=4096, ch=1024),
              OpShape(n=2, m=64, ch=64, r=3, h=8)]
    for s in shapes:
        assert m1.classify(s) == m2.classify(s)
        assert m1.detect_chunk(512) == m2.detect_chunk(512)
        assert m1.should_profile(s) == m2.should_profile(s)


def test_classify_bound_tracks_ridge():
    s = OpShape(n=8, m=256, ch=96, r=5, h=27)
    inten = shape_flops(s) / shape_bytes(s)
    c_lo = MeasuredCostModel(peak_flops=inten * 0.5e9,
                             hbm_bw=1e9).classify(s)
    c_hi = MeasuredCostModel(peak_flops=inten * 2e9, hbm_bw=1e9).classify(s)
    assert c_lo["bound"] == "compute" and c_hi["bound"] == "bandwidth"
    assert c_lo["intensity"] == pytest.approx(inten)
    for c in (c_lo, c_hi):
        p = c["predicted_us"]
        assert p["base"] < p["coc"] <= min(p["rc"], p["clc"], p["fc"])


def test_measured_alpha_beta_are_real_seconds():
    m = MeasuredCostModel(peak_flops=2e11, hbm_bw=2e10)
    assert m.alpha == pytest.approx(2.0 / 2e11)
    assert m.beta == pytest.approx(4.0 / 2e10)
    s = OpShape(n=8, m=64, ch=32)
    assert m.t_coc(s) > 0 and m.t_rc(s) > 0


# --------------------------------------------------------------------------
# derived plan-build decisions
# --------------------------------------------------------------------------

def test_detect_chunk_power_of_two_and_clamped():
    c = MeasuredCostModel(peak_flops=2e11, hbm_bw=2e10).detect_chunk(512)
    assert c & (c - 1) == 0 and 256 <= c <= 4096
    assert MeasuredCostModel(peak_flops=1e6,
                             hbm_bw=1e6).detect_chunk(512) == 256
    assert MeasuredCostModel(peak_flops=1e15,
                             hbm_bw=1e15).detect_chunk(512) == 4096


def test_should_profile_window():
    s = OpShape(n=8, m=256, ch=96, r=5, h=27)
    inten = shape_flops(s) / shape_bytes(s)
    assert MeasuredCostModel(peak_flops=inten * 1e9,
                             hbm_bw=1e9).should_profile(s)
    assert not MeasuredCostModel(peak_flops=inten * 100e9,
                                 hbm_bw=1e9).should_profile(s)


def test_cost_model_doc_names_the_class():
    doc = cost_model_doc(MeasuredCostModel(peak_flops=2e11, hbm_bw=2e10))
    assert doc["class"] == "MeasuredCostModel"
    assert doc["params"]["ridge"] == pytest.approx(10.0)
    legacy = cost_model_doc(CostModel())
    assert legacy["class"] == "CostModel"
    assert legacy["params"] == {"alpha": legacy["alpha"],
                                "beta": legacy["beta"]}
    assert math.isfinite(doc["alpha"]) and doc["alpha"] > 0


def test_core_exports():
    assert tcore.MeasuredCostModel is MeasuredCostModel
    assert tcore.measure_peaks is measure_peaks
    assert tcore.HostPeaks is HostPeaks
    assert tcore.cost_model_doc is cost_model_doc
    assert tcore.cost_model.shape_flops is shape_flops
    assert tcore.KernelProfile is tpolicy.KernelProfile
    assert tcore.calibrate is tpolicy.calibrate


# --------------------------------------------------------------------------
# parity with the JAX package's model
# --------------------------------------------------------------------------

# (peak FLOP/s, bytes/s): the H100's datasheet corners, and a CPU-sized pair
PEAKS = [(67e12, 3.35e12), (2e11, 2e10)]


def _shapes(arch: str):
    cfg_t = tcnn.CNN_REGISTRY[arch](1.0)
    cfg_j = jcnn.CNN_REGISTRY[arch](1.0)
    t = [s.shape for s in tcore.protection_spec(cfg_t, batch=8).sites]
    j = [s.shape for s in jcore.protection_spec(cfg_j, batch=8).sites]
    assert [tuple(vars(s).values()) for s in t] == \
        [tuple(vars(s).values()) for s in j]
    return list(zip(t, j))


def _close(a, b, rtol=1e-12):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k], rtol)
    elif isinstance(a, float):
        assert math.isclose(a, b, rel_tol=rtol, abs_tol=0.0), (a, b)
    else:
        assert a == b


@pytest.mark.parametrize("peaks", PEAKS, ids=["h100_datasheet", "small"])
@pytest.mark.parametrize("arch", ["resnet18", "alexnet"])
def test_model_matches_jax_over_every_op_shape(arch, peaks):
    """classify, base_us, should_profile, detect_chunk and params_doc of
    the port equal the JAX package's, floats to 1e-12 and verdicts
    exactly, over every protected op of the full-width model."""
    tm = MeasuredCostModel(peak_flops=peaks[0], hbm_bw=peaks[1])
    jm = jcm.MeasuredCostModel(peak_flops=peaks[0], hbm_bw=peaks[1])
    _close(tm.params_doc(), jm.params_doc())
    _close(cost_model_doc(tm), jcm.cost_model_doc(jm))
    for default in (256, 512, 1024):
        assert tm.detect_chunk(default) == jm.detect_chunk(default)
    for ts, js in _shapes(arch):
        _close(tm.classify(ts), jm.classify(js))
        assert math.isclose(tm.base_us(ts), jm.base_us(js), rel_tol=1e-12)
        assert tm.should_profile(ts) == jm.should_profile(js)
        assert tpolicy.decide_rc_clc(ts, tm) == jpolicy.decide_rc_clc(js, jm)


def test_calibrate_matches_jax():
    """calibrate() fits the same (alpha, beta) as the JAX package's lstsq
    on the same samples."""
    g = np.random.default_rng(5)
    samples_t, samples_j = [], []
    for i in range(12):
        dims = dict(n=int(g.integers(1, 16)), m=int(g.integers(8, 512)),
                    ch=int(g.integers(3, 256)), r=int(g.choice([1, 3, 5])),
                    h=int(g.integers(1, 56)))
        scheme = ("fc", "rc", "clc", "coc")[i % 4]
        secs = float(g.uniform(1e-5, 1e-2))
        samples_t.append((OpShape(**dims), scheme, secs))
        samples_j.append((jpolicy.OpShape(**dims), scheme, secs))
    t, j = tpolicy.calibrate(samples_t), jpolicy.calibrate(samples_j)
    assert isinstance(t, CostModel)
    assert math.isclose(t.alpha, j.alpha, rel_tol=1e-9)
    assert math.isclose(t.beta, j.beta, rel_tol=1e-9)
