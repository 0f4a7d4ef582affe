"""Fault-injection campaign engine (twin of repro.campaign.engine).

One campaign cell = (layer kind, scheme config, fault model). A trial draws
fresh operands, computes the unfaulted reference through the plain
oracles in kernels/ref.py, injects a planned fault, runs the protected op
through the full multischeme workflow, and scores the result against the
oracle (the differential part: the protected path and the oracle are
different implementations, so the campaign doubles as a randomized
correctness harness).

The JAX engine vmaps a trial and switches over model ids inside one
compiled program. Here the workflow's gates are Python `if`s on device
flags and the kernels launch through ctypes, so a trial cannot be
vmapped. What is free of control flow is batched instead: a cell's
operands and FaultSpecs are drawn over a leading trials axis, injected and
run through the oracle in one call each; then the protected op runs trial
by trial. A trial factors into *draw* (`CampaignEngine.draw`) and *score*
(`score`), so a test can replay operands and specs drawn elsewhere.

Draws come from a CPU generator seeded from (seed, model_id), so a seed
gives the same trials on the CPU and on the card; every trial runs inside
`fp32_ieee()` (TF32 off), whose thresholds price IEEE fp32 noise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, fp32_ieee, resolve_device
from ..core import injection as inj
from ..core import (ProtectionPlan, conv_entry, correct_op, matmul_entry,
                    path_scope, plan_scope, protect_op, protect_site,
                    resolve_entry)
from ..core import types as T
from ..core import weight_repair as WR
from ..core.workflow import host_read
from ..kernels import ref
from .report import CampaignResult, CellResult, summarize_cell

F32 = torch.float32

# Scheme-ladder configurations, keyed like the paper's Fig. 10 variants.
SCHEME_CONFIGS: Dict[str, T.ProtectConfig] = {
    # the full multischeme workflow (CoC -> RC -> ClC -> FC -> recompute)
    "full": T.DEFAULT_CONFIG,
    # RC/ClC disabled (paper Fig. 10b): CoC then FC then recompute
    "no_rcclc": T.DEFAULT_CONFIG.replace(rc_enabled=False,
                                         clc_enabled=False),
    # CoC only: anything CoC can't fix falls through to recompute
    "coc": T.DEFAULT_CONFIG.replace(rc_enabled=False, clc_enabled=False,
                                    fc_enabled=False),
    # detection-only (CoC-D, the serving mode): no in-graph correction
    "detect": T.DEFAULT_CONFIG.replace(detect_only=True),
    # deferred correction: the op runs detect-only and ONE `if` on its
    # flag invokes correct_op - the per-op twin of forward_cnn(...,
    # correction="deferred"). Ladder config = full.
    "deferred": T.DEFAULT_CONFIG,
}


@dataclasses.dataclass(frozen=True)
class MatmulCase:
    """O[N,M] = D[N,K] @ W[K,M]; normalised block form has P=1."""
    n: int = 64
    k: int = 32
    m: int = 48

    kind = "matmul"

    @property
    def block_shape(self) -> Tuple[int, int, int]:
        return self.n, self.m, 1


@dataclasses.dataclass(frozen=True)
class ConvCase:
    """O[N,M,E,E] = D[N,Ch,H,H] (x) W[M,Ch,R,R]; P = E*E."""
    n: int = 6
    ch: int = 4
    m: int = 8
    h: int = 10
    r: int = 3
    stride: int = 1

    kind = "conv"

    @property
    def e(self) -> int:
        return (self.h - self.r) // self.stride + 1

    @property
    def block_shape(self) -> Tuple[int, int, int]:
        return self.n, self.m, self.e * self.e


@dataclasses.dataclass(frozen=True)
class TransformerGemmCase:
    """A transformer-block GEMM (d_model -> d_ff shape) protected through
    the ambient plan-context path (plan_scope + by-path entry resolution,
    the route every ProtectedModel layer takes) instead of an explicit
    entry argument."""
    n: int = 48     # tokens (B*S of a decode-ish microbatch)
    k: int = 64     # d_model
    m: int = 96     # d_ff

    kind = "transformer_gemm"

    @property
    def block_shape(self) -> Tuple[int, int, int]:
        return self.n, self.m, 1


LAYER_CASES = {"matmul": MatmulCase(), "conv": ConvCase(),
               "transformer_gemm": TransformerGemmCase()}

# Differential-oracle tolerance: corrected output must match the reference
# to within TOL_REL * (max|O_ref| + 1) - the same envelope the scheme tests
# use for checksum-corrected values in fp32.
TOL_REL = 2e-2

_GATE = "blk/ffn/gate"


class TrialOutcome(NamedTuple):
    """Per-trial scores (0-d values for one trial, arrays for a cell)."""
    detected: object      # i32
    corrected_by: object  # i32 scheme enum
    residual: object      # i32
    corrected: object     # i32: 1 if output matches the oracle
    max_err: object       # f32 max |out - oracle|


def _ordered_models() -> List[inj.FaultModel]:
    models = sorted(inj.FAULT_MODELS.values(), key=lambda fm: fm.model_id)
    assert [fm.model_id for fm in models] == list(range(len(models)))
    return models


def _operand_shapes(case) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    if case.kind == "conv":
        return ((case.n, case.ch, case.h, case.h),
                (case.m, case.ch, case.r, case.r))
    return (case.n, case.k), (case.k, case.m)


def spec_dims(case, model: inj.FaultModel) -> Tuple[int, int, int]:
    """The block dims a model's plan draws over: O's block form for
    output models, W's ((K, M, 1) or (M, Ch, R*R)) for weight models."""
    if model.target == "output":
        return case.block_shape
    if case.kind == "conv":
        return case.m, case.ch, case.r * case.r
    return case.k, case.m, 1


def oracle(case, d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The case's output through kernels/ref.py; d and w may carry a
    leading trials axis (a conv batch runs as one grouped im2col
    product, one group per trial)."""
    if case.kind != "conv":
        return ref.matmul_ref(d, w)
    if d.dim() == 4:
        return ref.conv2d_ref(d, w, stride=case.stride)
    t, n = d.shape[0], d.shape[1]
    dg = d.transpose(0, 1).reshape(n, t * case.ch, case.h, case.h)
    wg = w.reshape(t * case.m, case.ch, case.r, case.r)
    o = ref.conv2d_ref(dg, wg, stride=case.stride, groups=t)
    return o.reshape(n, t, case.m, case.e, case.e).transpose(0, 1) \
        .contiguous()


def prepare(case, model: inj.FaultModel, d, w, spec: inj.FaultSpec):
    """(o_ref, w_run, o_bad) of one trial, or of a batch with a leading
    trials axis: the oracle output, the weight the op runs with (corrupted
    after the plan encoded it, for weight models) and the output handed
    to the protected op (corrupted, for output models)."""
    o_ref = oracle(case, d, w)
    if model.target == "weight":
        w_run = inj.inject(w, spec, model)
        return o_ref, w_run, oracle(case, d, w_run)
    return o_ref, w, inj.inject(o_ref, spec, model)


def _entry(case, cfg: T.ProtectConfig, w):
    """The per-trial offline step: the plan entry encoded from the clean
    weight."""
    if case.kind == "conv":
        return conv_entry("cell", w, cfg, stride=case.stride)
    return matmul_entry(_GATE if case.kind == "transformer_gemm" else "cell",
                        w, cfg)


def _deferred_protect(entry, d, w, o_bad):
    """The per-op deferred workflow: detect-only pass, then ONE `if` (one
    host read) that runs the full correction ladder only when the evidence
    flagged, trusting the carried flag - the campaign-grade twin of the
    model-level deferred forward."""
    out_d, ev = protect_op(entry.op, (d, w), entry=entry, o=o_bad,
                           mode="detect_only")
    if host_read(ev.flag > 0):
        o_c, rep = correct_op(entry.op, (d, w), entry=entry, o=o_bad,
                              detected=True)
        return o_c, T.FaultReport(ev.flag, rep.corrected_by, rep.residual)
    return out_d, T.FaultReport(ev.flag, 0, 0)


def _protect(case, entry, d, w_run, o_bad, deferred: bool):
    if case.kind != "transformer_gemm":
        if deferred:
            return _deferred_protect(entry, d, w_run, o_bad)
        return protect_op(entry.op, (d, w_run), entry=entry, o=o_bad)
    # the ambient route: a one-entry plan, the call site resolving
    # "blk/ffn/gate" from nested path scopes
    with plan_scope(ProtectionPlan(entries={_GATE: entry})), \
            path_scope("blk", "ffn"):
        e = resolve_entry("gate")
        if e is None:   # would silently run unprotected
            raise RuntimeError("ambient plan resolution failed")
        if deferred:
            return _deferred_protect(e, d, w_run, o_bad)
        return protect_site("gate", (d, w_run), entry=e, o=o_bad)


def _err(out, o_ref):
    scale = torch.amax(torch.abs(o_ref.to(F32))) + 1.0
    err = torch.amax(torch.abs(out.to(F32) - o_ref.to(F32)))
    return err, err <= TOL_REL * scale


def _score(out, rep, o_ref) -> TrialOutcome:
    err, ok = _err(out, o_ref)
    return TrialOutcome(rep.detected, rep.corrected_by, rep.residual,
                        ok.to(torch.int32), err)


def _weight_repair_outcome(case, entry, d, w_run, o_ref) -> TrialOutcome:
    """Score the audit ladder's in-place repair rung for one trial: solve
    the corrupted weights against the entry's locator sums on the device
    (core.weight_repair, f32 path), recompute the output from the
    repaired weights through the same oracle, and report the verdict in
    TrialOutcome terms - detected = locator residuals fired, corrected_by
    = W_REPAIR, residual = the ladder would have escalated to a checkpoint
    restore (so run.check's zero-residual gate IS the zero-restores gate
    for this arm)."""
    tol = WR.locator_tol(entry.wlc, WR.REPAIR_RTOL, dtype=F32)
    fix = (WR.repair_conv_weight if entry.op.kind == "conv"
           else WR.repair_matmul_weight)
    w_fix, verdict = fix(w_run, entry.wlc, tol)
    err, ok = _err(oracle(case, d, w_fix), o_ref)
    repaired = verdict == WR.REPAIRED
    return TrialOutcome(
        (verdict != WR.CLEAN).to(torch.int32),
        torch.where(repaired, T.W_REPAIR, T.NONE).to(torch.int32),
        (verdict == WR.ESCALATE).to(torch.int32),
        (repaired & ok).to(torch.int32), err)


def _trial(case, cfg, model, d, w, w_run, o_ref, o_bad,
           deferred: bool) -> TrialOutcome:
    entry = _entry(case, cfg, w)
    if model.target == "weight" and model.correctable:
        # weight-correctable arms are scored by the repair rung alone
        return _weight_repair_outcome(case, entry, d, w_run, o_ref)
    out, rep = _protect(case, entry, d, w_run, o_bad, deferred)
    return _score(out, rep, o_ref)


def score(case, cfg: T.ProtectConfig, d, w, spec: inj.FaultSpec,
          model: inj.FaultModel, deferred: bool = False) -> TrialOutcome:
    """One trial from its operands and spec (no trials axis): the plan
    entry encoded from `w`, `spec` applied to W (weight models) or O,
    the protected op (or, for weight-correctable arms, the repair rung)
    scored against the oracle. Values may be device tensors."""
    o_ref, w_run, o_bad = prepare(case, model, d, w, spec)
    return _trial(case, cfg, model, d, w, w_run, o_ref, o_bad, deferred)


def _host_vector(vals, dtype) -> np.ndarray:
    """Per-trial values (host numbers or 0-d device tensors) as one host
    array, with one transfer for all the device ones."""
    out = np.array([0 if isinstance(v, torch.Tensor) else v for v in vals],
                   dtype=dtype)
    dev = [i for i, v in enumerate(vals) if isinstance(v, torch.Tensor)]
    if dev:
        got = torch.stack([vals[i].reshape(()).to(torch.float64)
                           for i in dev]).cpu().numpy()
        out[dev] = got.astype(dtype)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cell_seed(seed: int, model_id: int) -> int:
    return int(np.random.SeedSequence([seed, model_id]).generate_state(1)[0])


class CampaignEngine:
    """Draws, runs and scores campaign cells on one device (the card
    unless the caller asks for the CPU)."""

    def __init__(self, cases: Optional[Dict[str, object]] = None,
                 max_elems: int = 100, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cases = dict(cases or LAYER_CASES)
        self.max_elems = max_elems
        self._models = _ordered_models()

    def model(self, fault: str) -> inj.FaultModel:
        if fault not in inj.FAULT_MODELS:
            raise ValueError(f"unknown fault model {fault!r} "
                             f"(have {sorted(inj.FAULT_MODELS)})")
        model = inj.FAULT_MODELS[fault]
        if model.model_id >= len(self._models):
            # the engine's model table was fixed when it was built; a
            # model registered later is refused rather than guessed at
            raise ValueError(
                f"fault model {fault!r} was registered after this engine "
                "was built; construct a fresh CampaignEngine")
        return model

    def draw(self, layer: str, fault: str, trials: int, seed: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor, inj.FaultSpec]:
        """(d, w, spec) of a cell's trials, each with a leading trials
        axis, drawn on the CPU from a generator seeded by (seed,
        model_id): a seed gives the same trials on every device, and
        every scheme of a layer sees the same trials of an arm."""
        case = self.cases[layer]
        model = self.model(fault)
        g = torch.Generator().manual_seed(_cell_seed(seed, model.model_id))
        d_shape, w_shape = _operand_shapes(case)
        d = torch.randn((trials,) + d_shape, generator=g)
        w = torch.randn((trials,) + w_shape, generator=g)
        dims = spec_dims(case, model)
        spec = inj.stack_specs([model.plan(g, *dims, self.max_elems)
                                for _ in range(trials)])
        return d, w, spec

    def run_trials(self, layer: str, scheme: str, fault: str, trials: int,
                   seed: int = 0) -> Tuple[TrialOutcome, float]:
        """Per-trial outcomes (host arrays) of one cell, and the wall
        seconds of its trial loop (ended by a synchronize; one untimed
        warm-up trial runs first)."""
        if trials < 1:
            raise ValueError(f"trials must be >= 1, got {trials}")
        if scheme not in SCHEME_CONFIGS:
            raise ValueError(f"unknown scheme {scheme!r} "
                             f"(have {sorted(SCHEME_CONFIGS)})")
        case, cfg = self.cases[layer], SCHEME_CONFIGS[scheme]
        model = self.model(fault)
        deferred = scheme == "deferred"
        d, w, spec = self.draw(layer, fault, trials, seed)
        dev = self.device
        with torch.no_grad(), fp32_ieee():
            d, w, spec = d.to(dev), w.to(dev), spec.to(dev)
            o_ref, w_run, o_bad = prepare(case, model, d, w, spec)

            def one(i):
                return _trial(case, cfg, model, d[i], w[i], w_run[i],
                              o_ref[i], o_bad[i], deferred)

            one(0)
            _sync(dev)
            t0 = time.perf_counter()
            outs = [one(i) for i in range(trials)]
            _sync(dev)
            wall = time.perf_counter() - t0
            merged = TrialOutcome(*(
                _host_vector(list(f), np.float64 if k == "max_err"
                             else np.int32)
                for k, f in zip(TrialOutcome._fields, zip(*outs))))
        return merged, wall

    def run_cell(self, layer: str, scheme: str, fault: str, trials: int,
                 seed: int = 0) -> CellResult:
        """Run one (layer, scheme, fault) cell of `trials` trials."""
        out, wall = self.run_trials(layer, scheme, fault, trials, seed)
        return summarize_cell(layer, scheme, fault, out.detected,
                              out.corrected_by, out.residual, out.corrected,
                              out.max_err, wall_seconds=wall)

    def run(self, layers: Iterable[str], schemes: Iterable[str],
            faults: Optional[Iterable[str]] = None, trials: int = 1000,
            seed: int = 0, progress=None) -> CampaignResult:
        """The full campaign grid. `faults=None` means every registered
        model; the error-free control arm always rides along."""
        fault_list = list(faults) if faults is not None else \
            inj.fault_model_names()
        if inj.CONTROL_MODEL not in fault_list:
            fault_list = [inj.CONTROL_MODEL] + fault_list
        cells = []
        for layer in layers:
            for scheme in schemes:
                for fault in fault_list:
                    cell = self.run_cell(layer, scheme, fault, trials, seed)
                    cells.append(cell)
                    if progress is not None:
                        progress(cell)
        meta = {"trials": trials, "seed": seed, "max_elems": self.max_elems,
                "torch_version": torch.__version__,
                "device": (torch.cuda.get_device_name(self.device)
                           if self.device.type == "cuda"
                           else str(self.device)),
                "wall_seconds": sum(c.wall_seconds for c in cells)}
        return CampaignResult(cells=cells, meta=meta)


def run_campaign(layers=("matmul", "conv"), schemes=("full",), faults=None,
                 trials: int = 1000, seed: int = 0, max_elems: int = 100,
                 progress=None, device: DeviceLike = None) -> CampaignResult:
    """One-shot convenience wrapper around CampaignEngine."""
    eng = CampaignEngine(max_elems=max_elems, device=device)
    return eng.run(layers, schemes, faults, trials=trials, seed=seed,
                   progress=progress)
