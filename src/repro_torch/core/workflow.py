"""Multischeme workflow engine (paper SS4.3, Fig. 7); twin of
repro.core.workflow.

Detection (CoC-D) runs on every protected op and leaves its flag on the
device. The JAX package gates the correction ladder CoC -> RC -> ClC -> FC
-> recompute with `lax.cond`; in eager PyTorch the gate is a Python `if`
on that flag, which costs one device->host read. Per-layer mode pays one
read per protected op; the deferred mode reads every op's flag in ONE
transfer per forward, which is why it exists. `HOST_READS` counts every
such read, so tests and the chip run can pin both numbers;
`RECOMPUTE_READS` counts those of them that autograd's recompute of a
rematerialised stage made in the backward (models.transformer).

Under a mesh (runtime.sharding.parallel_scope) every rank reads its own
flags. A flag whose value decides which collectives run - the deferred
forward's one read, which decides whether the corrective rerun runs - is
max-reduced over the world first (`host_read_world`): a rank that reran
while another did not would wait forever in the rerun's first collective.
A flag local to one protected op (the ladder's rungs, which run no
collective) stays local.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, List, Tuple

import torch

from . import types as T

# A rung: o -> (o_fixed, ok). Verification is applied by the engine.
Rung = Tuple[int, Callable]

HOST_READS = 0
RECOMPUTE_READS = 0

_RECOMPUTING: contextvars.ContextVar[bool] = \
    contextvars.ContextVar("repro_torch_recomputing", default=False)


@contextlib.contextmanager
def recompute_scope() -> Iterator[None]:
    """Mark the reads of the scope as a recompute's (RECOMPUTE_READS)."""
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


def host_read(flag):
    """The host's view of a device flag (a bool, or a list for a vector),
    counted in HOST_READS (and in RECOMPUTE_READS inside a
    recompute_scope); host values pass through uncounted."""
    global HOST_READS, RECOMPUTE_READS
    if not isinstance(flag, torch.Tensor):
        return flag
    HOST_READS += 1
    if _RECOMPUTING.get():
        RECOMPUTE_READS += 1
    if flag.dim() == 0:
        return bool(flag.item())
    return flag.tolist()


def host_read_world(flags: torch.Tensor) -> Tuple[list, bool]:
    """(this rank's flags as a host list, whether any rank of the ambient
    mesh has one set) in ONE device->host read, counted once: under a
    mesh the flags are max-reduced over the world beside the local ones;
    without one the two halves are the same flags."""
    from ..runtime.sharding import axis_max, current_mesh
    local = flags.reshape(-1)
    mesh = current_mesh()
    both = torch.cat([local, axis_max(local, mesh, "world")])
    read = host_read(both)
    n = local.numel()
    return read[:n], any(read[n:])


def run_ladder(o, detected, rungs: List[Rung], verify_fn: Callable,
               recompute_fn: Callable):
    """Escalate through `rungs` until one verifies; fall back to
    recompute. `detected` is a device flag or a host bool (a flag the
    caller already read). verify_fn(o) re-derives the output summations
    of `o` and compares them against freshly recomputed checksums."""
    if not host_read(detected):
        return o, T.FaultReport(0, 0, 0)
    by = 0
    for enum_val, fn in rungs:
        fixed, ok = fn(o)
        if host_read(ok & verify_fn(fixed)):
            o, by = fixed, enum_val
            break
    if by == 0:
        # last resort: full recompute (paper SS4.1.1 for multi-fault cases)
        o, by = recompute_fn(), T.RECOMPUTE
    residual = 0 if host_read(verify_fn(o)) else 1
    return o, T.FaultReport(1, by, residual)


class ProtectedModel:
    """The model-agnostic protection session.

        plan = build_plan(params, arch_cfg)
        pm = ProtectedModel(apply_fn, plan)
        out, report = pm(params, x)                          # per-layer
        out, report = pm(params, x, correction="deferred")   # one read

    `apply_fn(params, *args, **kwargs) -> (out, report)` is a forward whose
    protected call sites resolve their PlanEntry from the ambient plan
    context (protect_site). In deferred mode apply_fn runs detect-only;
    every site's flag is read in one transfer and, only when one is set,
    apply_fn reruns with full correction, trusting the flags it read
    (sites do not re-detect)."""

    def __init__(self, apply_fn: Callable, plan=None):
        from .plan import ProtectionPlan
        if plan is not None and not isinstance(plan, ProtectionPlan):
            raise TypeError("ProtectedModel expects a ProtectionPlan "
                            f"(or None); got {type(plan).__name__}")
        self.apply_fn = apply_fn
        self.plan = plan

    @staticmethod
    def _layer_map(rep, what: str):
        if isinstance(rep, T.ModelReport):
            return dict(rep.by_layer)
        if isinstance(rep, (T.FaultReport, T.DetectEvidence)):
            return {"model": rep}
        raise TypeError(f"ProtectedModel: apply_fn's {what} report must be "
                        "a ModelReport, FaultReport or DetectEvidence; got "
                        f"{type(rep).__name__}")

    def __call__(self, params, *args, correction: str = "per_layer",
                 with_detect_out: bool = False, **kwargs):
        from .plan import plan_scope
        if correction not in ("per_layer", "deferred"):
            raise ValueError(f"ProtectedModel: unknown correction mode "
                             f"{correction!r} (have 'per_layer', "
                             "'deferred')")
        if with_detect_out and correction != "deferred":
            raise ValueError("ProtectedModel: with_detect_out requires "
                             "correction='deferred' (there is no separate "
                             "detect pass in per-layer mode)")
        if correction == "per_layer":
            with plan_scope(self.plan):
                return self.apply_fn(params, *args, **kwargs)

        # ---- deferred: detect-only pass + ONE host read -----------------
        with plan_scope(self.plan, mode="detect_only"):
            out_d, ev = self.apply_fn(params, *args, **kwargs)
        evmap = self._layer_map(ev, "detect-only")
        # mixed execution membership: sites marked execution="per_layer"
        # ran their own ladder in the detect pass and carry a FaultReport
        inline: dict = {}
        for n, e in evmap.items():
            if isinstance(e, T.DetectEvidence):
                continue
            entry = self.plan.get(n) if self.plan is not None else None
            if (isinstance(e, T.FaultReport) and entry is not None
                    and entry.execution == "per_layer"):
                inline[n] = e
                continue
            raise TypeError(
                "ProtectedModel deferred mode: the detect-only pass "
                f"returned a non-DetectEvidence carry for {n!r} whose "
                "plan entry is not marked execution='per_layer'; route "
                "the op through protect_site so it honours the ambient "
                "execution mode")
        names = list(evmap)
        if not names:
            rep0 = T.ModelReport({}, mode="deferred", world_clean=True)
            return ((out_d, rep0, out_d) if with_detect_out
                    else (out_d, rep0))
        deferred = [n for n in names if n not in inline]
        flags = {n: int(inline[n].detected) for n in inline}
        any_deferred = False
        if deferred:
            read, any_deferred = host_read_world(torch.stack(
                [evmap[n].flag.to(torch.int32).reshape(())
                 for n in deferred]))
            flags.update(zip(deferred, (int(f) for f in read)))
        # the no-rerun verdicts: inline members keep the ladder verdicts
        # they already earned, deferred members are clean
        base_by = [inline[n].corrected_by if n in inline else 0
                   for n in names]
        base_resid = [inline[n].residual if n in inline else 0
                      for n in names]

        def _corrective():
            # the rerun trusts the flags read above at every site, so no
            # site re-detects and no flag is read twice
            carried = {n: flags[n] > 0 for n in names}
            with plan_scope(self.plan, mode="correct", detected=carried):
                out_c, rep = self.apply_fn(params, *args, **kwargs)
            repmap = {n: T.as_fault_report(r) for n, r in
                      self._layer_map(rep, "corrective").items()}
            if set(repmap) != set(names):
                raise ValueError(
                    "ProtectedModel: the corrective rerun reported layers "
                    f"{sorted(repmap)} but the detect pass carried "
                    f"{sorted(names)}; apply_fn must be "
                    "mode-deterministic")
            return (out_c, [repmap[n].corrected_by for n in names],
                    [repmap[n].residual for n in names])

        if deferred:
            # every rank of a mesh reruns when any rank flagged (the
            # rerun's collectives need them all); each trusts its own flags
            out, by, resid = run_deferred(
                any_deferred, out_d, _corrective,
                len(names), base_by=base_by, base_resid=base_resid)
        else:
            out, by, resid = out_d, base_by, base_resid
        # inline members' ladder verdicts are this rank's own, outside the
        # world read
        rep = T.ModelReport(
            {n: T.FaultReport(flags[n], by[i], resid[i])
             for i, n in enumerate(names)}, mode="deferred",
            world_clean=None if inline else not any_deferred)
        return (out, rep, out_d) if with_detect_out else (out, rep)


def run_deferred(any_flag, clean_out, correct_fn: Callable, n_layers: int,
                 base_by=None, base_resid=None):
    """The multischeme workflow lifted to model granularity: `clean_out`
    is the detect-only pass's output; `correct_fn()` returns (out, by,
    resid) with per-layer lists of scheme enums / residual flags and runs
    only when `any_flag` (one host read) is set."""
    if host_read(any_flag):
        return correct_fn()
    z = [0] * n_layers
    return (clean_out, z if base_by is None else base_by,
            z if base_resid is None else base_resid)
