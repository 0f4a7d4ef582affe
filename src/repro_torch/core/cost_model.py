"""Measured roofline cost model (twin of repro.core.cost_model): the
offline-calibration half of the arithmetic-intensity ABFT decision layer.

The paper's SS4.3 analytic model (policy.CostModel) prices schemes in
abstract alpha/beta units; which ABFT variant actually wins on a given
device is decided by each layer's arithmetic intensity *relative to that
device's ridge point* (peak_FLOPs / memory_bandwidth). This module
measures both peaks once per host and backend (an IEEE-fp32 GEMM FLOPs
microbenchmark and a STREAM triad bandwidth microbenchmark, cached as
JSON) and derives a `MeasuredCostModel` whose alpha/beta are real
seconds, so every consumer of the analytic model - `decide_rc_clc`, rung
selection, chunk sizing, kernel-profile pruning and the per-entry
execution membership - classifies shapes against this device.

    peaks = measure_peaks()                    # cached after first call
    model = MeasuredCostModel.from_host()
    model.classify(OpShape(n=8, m=256, ch=96, r=5, h=27))
    # -> {"bound": "compute", "intensity": ..., "ridge": ...,
    #     "predicted_us": {"base": ..., "coc": ..., "rc": ..., ...}}

The backend is "cuda" (the card, the default) or "cpu" (`device="cpu"`).
On the card the microbenchmarks are sized to measure it (an 8192^3 GEMM,
256 MiB per triad array, far beyond the 50 MB L2) and timed with CUDA
events; on the CPU they keep the JAX package's sizes and the host clock.
Refresh a stale calibration with `measure_peaks(refresh=True)` or by
deleting the cache file (`REPRO_ROOFLINE_CACHE` overrides its location;
the default lives under `~/.cache/repro_torch/`, apart from the JAX
package's).
"""
from __future__ import annotations

import dataclasses
import json
import os
import platform
import time
from typing import Dict, Optional

import torch

from .._device import DeviceLike, fp32_ieee, resolve_device
from .policy import CostModel, OpShape

CACHE_SCHEMA = "repro.roofline_cache/v1"
CACHE_ENV = "REPRO_ROOFLINE_CACHE"

BYTES_F32 = 4
# microbenchmark sizes per backend: on the CPU the JAX package's (above
# dispatch noise on a small host, ~1 s of calibration); on the card a GEMM
# big enough to leave launch overhead behind and triad arrays of 256 MiB
# each, so the stream runs from device memory and not from the L2
_GEMM_N = {"cpu": 512, "cuda": 8192}
_TRIAD_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 26}

# conservative fallbacks for a CPU whose microbenchmark cannot run (never
# negative-cost a scheme): a ~2010s-class core. The card has none: a
# failing measurement there raises.
_FALLBACK_FLOPS = 5e9
_FALLBACK_BW = 5e9


@dataclasses.dataclass(frozen=True)
class HostPeaks:
    """One device's measured roofline corners (sustained, not datasheet)."""
    peak_flops: float     # FLOP/s sustained on an IEEE-fp32 GEMM
    hbm_bw: float         # bytes/s sustained on a triad stream
    backend: str          # "cuda" | "cpu"
    host: str             # platform.node() at measurement time
    source: str           # "measured" | "cache" | "fallback"

    @property
    def ridge(self) -> float:
        """Ridge-point arithmetic intensity (FLOPs per byte)."""
        return self.peak_flops / self.hbm_bw

    def doc(self) -> dict:
        return {"peak_flops": self.peak_flops, "hbm_bw": self.hbm_bw,
                "ridge": self.ridge, "backend": self.backend,
                "host": self.host, "source": self.source}


def default_cache_path(backend: Optional[str] = None) -> str:
    """Per-host calibration cache location (REPRO_ROOFLINE_CACHE wins)."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    host = platform.node() or "unknown"
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "repro_torch",
                        f"roofline_{backend}_{host}.json")


def _time_best(fn, dev: torch.device, iters: int = 5,
               warmup: int = 2) -> float:
    """Best seconds of one fn() over `iters` after `warmup` calls: CUDA
    events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    best = float("inf")
    for _ in range(iters):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            t = a.elapsed_time(b) * 1e-3
        else:
            t0 = time.perf_counter()
            fn()
            t = time.perf_counter() - t0
        best = min(best, t)
    return best


def _randn(shape, seed: int, dev: torch.device) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float32, device=dev)


def _bench_gemm_flops(dev: torch.device, n: int) -> float:
    """Sustained IEEE-fp32 GEMM FLOP/s: 2*n^3 FLOPs over the best of a
    few timed (n,n)@(n,n) products (TF32 off, as the detection path runs)."""
    a, b = _randn((n, n), 0, dev), _randn((n, n), 1, dev)
    c = torch.empty((n, n), dtype=torch.float32, device=dev)
    with fp32_ieee():
        t = _time_best(lambda: torch.mm(a, b, out=c), dev)
    return 2.0 * n ** 3 / max(t, 1e-9)


def _bench_triad_bw(dev: torch.device, elems: int) -> float:
    """Sustained bytes/s on a STREAM-triad pass (y = 2x + z, one kernel):
    three f32 streams (two reads, one write) per element."""
    x, z = _randn((elems,), 2, dev), _randn((elems,), 3, dev)
    y = torch.empty_like(x)
    t = _time_best(lambda: torch.add(z, x, alpha=2.0, out=y), dev)
    return 3.0 * BYTES_F32 * elems / max(t, 1e-9)


def measure_peaks(cache_path: Optional[str] = None, refresh: bool = False,
                  device: DeviceLike = None) -> HostPeaks:
    """This device's (peak_flops, hbm_bw), measured once and cached as
    JSON.

    The first call runs the two microbenchmarks and writes the cache;
    later calls (and other processes) load it, so plan builds are
    deterministic given the cache file. `refresh=True` re-measures and
    rewrites; a cache recorded under a different backend is treated as
    stale and re-measured too. `device` is the card unless the caller
    asks for the CPU."""
    dev = resolve_device(device)
    backend = dev.type
    path = cache_path or default_cache_path(backend)
    if not refresh and os.path.exists(path):
        try:
            with open(path) as f:
                doc = json.load(f)
            if (doc.get("schema") == CACHE_SCHEMA
                    and doc.get("backend") == backend):
                return HostPeaks(float(doc["peak_flops"]),
                                 float(doc["hbm_bw"]),
                                 backend, doc.get("host", "?"), "cache")
        except (ValueError, KeyError, OSError):
            pass                       # unreadable cache: re-measure
    gemm_n, triad = _GEMM_N[backend], _TRIAD_ELEMS[backend]
    if backend == "cuda":
        flops = _bench_gemm_flops(dev, gemm_n)
        bw = _bench_triad_bw(dev, triad)
        source = "measured"
    else:
        try:
            flops = _bench_gemm_flops(dev, gemm_n)
            bw = _bench_triad_bw(dev, triad)
            source = "measured"
        except (RuntimeError, MemoryError):   # a host that cannot run it
            flops, bw, source = _FALLBACK_FLOPS, _FALLBACK_BW, "fallback"
    host = platform.node() or "unknown"
    if source == "measured":
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"schema": CACHE_SCHEMA, "backend": backend,
                       "host": host, "peak_flops": flops, "hbm_bw": bw,
                       "gemm_n": gemm_n, "triad_elems": triad,
                       "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S")},
                      f, indent=2)
    return HostPeaks(flops, bw, backend, host, source)


# --------------------------------------------------------------------------
# the measured model
# --------------------------------------------------------------------------

def shape_flops(s: OpShape) -> float:
    """FLOPs of the raw op (2 per MAC): matmul r=h=1 gives 2*n*m*ch."""
    return 2.0 * s.n * s.m * s.ch * s.r ** 2 * s.h ** 2


def shape_bytes(s: OpShape) -> float:
    """Minimum f32 traffic: read D and W once, write O once."""
    return BYTES_F32 * (s.d_elems + s.w_elems + s.n * s.m * s.h ** 2)


@dataclasses.dataclass
class MeasuredCostModel(CostModel):
    """policy.CostModel with measured coefficients: alpha is this device's
    seconds per MAC (2 FLOPs), beta its seconds per f32 element moved, so
    `decide_rc_clc` and the Table-4 t_* terms price schemes in real
    seconds. Adds roofline classification (`classify`), the
    kernel-profile pruning window (`should_profile`) and bandwidth-bound
    detection chunk sizing (`detect_chunk`)."""
    peak_flops: float = _FALLBACK_FLOPS
    hbm_bw: float = _FALLBACK_BW
    source: str = "fallback"
    # profile only shapes whose intensity/ridge ratio falls inside this
    # window: far-bandwidth-bound shapes never amortise a fused epilogue
    # and far-compute-bound shapes hide the detection pass entirely, so
    # timing either is wasted plan-build time
    profile_window: tuple = (0.25, 4.0)
    # target seconds of streamed detect traffic per chunk: keeps the
    # chunked detection pass bandwidth-bound
    chunk_stream_s: float = 1e-4

    def __post_init__(self):
        self.alpha = 2.0 / self.peak_flops
        self.beta = BYTES_F32 / self.hbm_bw

    @classmethod
    def from_host(cls, cache_path: Optional[str] = None,
                  refresh: bool = False,
                  device: DeviceLike = None) -> "MeasuredCostModel":
        p = measure_peaks(cache_path=cache_path, refresh=refresh,
                          device=device)
        return cls(peak_flops=p.peak_flops, hbm_bw=p.hbm_bw,
                   source=p.source)

    @property
    def ridge(self) -> float:
        return self.peak_flops / self.hbm_bw

    def intensity(self, s: OpShape) -> float:
        return shape_flops(s) / shape_bytes(s)

    def base_us(self, s: OpShape) -> float:
        """Roofline time of the raw op: max of the compute and memory
        terms, in microseconds."""
        return max(shape_flops(s) / self.peak_flops,
                   shape_bytes(s) / self.hbm_bw) * 1e6

    def classify(self, s: OpShape) -> Dict:
        """Roofline verdict for one op shape: which side of this device's
        ridge it falls on, plus the predicted cost of each scheme tier
        (base = the raw op; the others add the Table-4 scheme term)."""
        inten = self.intensity(s)
        base = self.base_us(s)
        return {
            "intensity": inten,
            "ridge": self.ridge,
            "bound": "compute" if inten >= self.ridge else "bandwidth",
            "predicted_us": {
                "base": base,
                "coc": base + self.t_coc(s) * 1e6,
                "rc": base + (self.t_coc(s) + self.t_rc(s)) * 1e6,
                "clc": base + (self.t_coc(s) + self.t_clc(s)) * 1e6,
                "fc": base + (self.t_coc(s) + self.t_fc(s)) * 1e6,
            },
        }

    def should_profile(self, s: OpShape) -> bool:
        """Prune the profile_kernels candidate set to shapes near the
        ridge - the only regime where the plain-vs-fused decision is
        close enough to need a measurement."""
        lo, hi = self.profile_window
        ratio = self.intensity(s) / self.ridge
        return lo <= ratio <= hi

    def detect_chunk(self, default: int,
                     lo: int = 256, hi: int = 4096) -> int:
        """Detection chunk edge sized so one (chunk x chunk) f32 tile
        streams in ~chunk_stream_s at this device's measured bandwidth,
        snapped to a power of two and clamped to [lo, hi]; deterministic
        given the calibration."""
        budget_elems = self.chunk_stream_s * self.hbm_bw / BYTES_F32
        edge = max(budget_elems, 1.0) ** 0.5
        snapped = 1 << max(int(edge).bit_length() - 1, 0)
        return int(min(max(snapped, lo), hi))

    def params_doc(self) -> dict:
        return {"alpha": self.alpha, "beta": self.beta,
                "peak_flops": self.peak_flops, "hbm_bw": self.hbm_bw,
                "ridge": self.ridge, "source": self.source,
                "profile_window": list(self.profile_window),
                "chunk_stream_s": self.chunk_stream_s}


def cost_model_doc(model: CostModel) -> dict:
    """Persistable description of any cost model: class name + its
    parameters, in the layout of repro.core.cost_model.cost_model_doc."""
    doc = {"class": type(model).__name__,
           "alpha": model.alpha, "beta": model.beta}
    if hasattr(model, "params_doc"):
        doc["params"] = model.params_doc()
    else:
        doc["params"] = {"alpha": model.alpha, "beta": model.beta}
    return doc
