"""Fault-tolerant execution wrapper (twin of repro.runtime.ft): the
system-level loop around the paper's per-op workflow.

Per op, the ABFT ladder already corrected what it could; what bubbles up
is a FaultReport. This module implements the remaining semantics at step
granularity:
- residual/NaN verdicts -> bounded step retry (recompute),
- persistent weight corruption (RowHammer regime) -> audit the weights
  against the plan's persisted checksums and climb the repair ladder:
  solve single-block damage in place from the plan's locator sums,
  restore from checkpoint only beyond that (the paper's 'reload weights
  from the CNN model'),
- too many consecutive failures -> restore-from-checkpoint escalation.

Serving deployments hand the auditor a ProtectionPlan: the plan's
*persisted* checksums are the trusted root - no sums are re-derived at
startup (that would bless corruption that predates the process) - and
divergence climbs audit -> in-place repair -> restore ->
WeightDivergenceError.

The audit re-encodes each entry's checksums on the device the weights lie
on and reads one pair of numbers per checksum back; a grouped (MoE
expert) entry's (E, K, M) stack re-encodes per expert, as a stage's
stack does per repeat, and a stage-stacked expert leaf, which the plan
only fingerprints, is checked by its fingerprint. The repair rung runs
in float64 on that device too (core.weight_repair with
dtype=torch.float64), so a 724 MB model is never copied to the host; only
the flagged entries are touched.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._tree import tree_flatten_with_path
from ..core import (FaultReport, apply_w_view, apply_w_view_inv,
                    stacked_weight_checksums_matmul,
                    weight_checksums_matmul, weight_leaf)
from ..core import checksums as C
from ..core import weight_repair as WR
from ..core.plan import _fingerprint_of

log = logging.getLogger("repro_torch.ft")
F32 = torch.float32


class WeightDivergenceError(RuntimeError):
    """At-rest weights diverged from the plan's persisted checksums and no
    checkpoint restore path is available: serving on them would silently
    violate every invariant the plan encodes, so refusing is the only
    safe verdict."""


@dataclasses.dataclass
class FTPolicy:
    max_step_retries: int = 2
    restore_after_failures: int = 3
    audit_weights_every: int = 0       # 0 = off


def weight_checksums(params) -> Dict[str, np.ndarray]:
    """Trusted per-leaf sums (host-side), refreshed after every accepted
    optimizer step; used to detect at-rest weight corruption."""
    return {name: np.asarray(float(torch.sum(torch.as_tensor(leaf).to(F32))),
                             np.float32)
            for name, leaf in tree_flatten_with_path(params)}


def audit_weights(params, trusted: Dict[str, np.ndarray],
                  rtol: float = 1e-3) -> Tuple[bool, list]:
    """Compare current weight sums against trusted values."""
    current = weight_checksums(params)
    bad = []
    for name, want in trusted.items():
        if name not in current:
            # a trusted leaf vanishing from the live tree is divergence,
            # not a crash - report it like the plan audit does
            bad.append(name)
            continue
        got = current[name]
        tol = rtol * (abs(float(want)) + 1.0)
        if not np.isfinite(got) or abs(float(got) - float(want)) > tol:
            bad.append(name)
    return (len(bad) == 0), bad


def _diverged(want: torch.Tensor, got: torch.Tensor, rtol: float) -> bool:
    """Does a re-encoded checksum leave the plan's by more than rtol of
    its largest magnitude (or turn non-finite)? One host read."""
    want = want.to(got.device, F32)
    if want.numel() == 0:
        return False
    gap = torch.where(torch.isfinite(got).all(),
                      torch.abs(got - want).amax(),
                      torch.tensor(float("inf"), device=got.device))
    scale, d = torch.stack([torch.abs(want).amax(), gap]).tolist()
    return d > rtol * (scale + 1.0)


def audit_weights_against_plan(params, plan, rtol: float = 1e-5
                               ) -> Tuple[bool, list]:
    """Audit at-rest weights against a ProtectionPlan's *persisted*
    checksums (the RowHammer-regime trusted root).

    Nothing trusted is derived from the live params - the plan file is the
    root of trust, so corruption that happened before the serving process
    started is still caught. Per entry the current weight's checksums are
    re-encoded and compared against the plan's stored cw1/cw2 (full
    per-channel/per-chunk resolution); entries without precomputed
    checksums fall back to the w_sum/w_asum content fingerprint. rtol
    absorbs cross-backend reduction-order noise only."""
    bad = []
    for name, e in plan.entries.items():
        try:
            w = apply_w_view(weight_leaf(params, name), e.w_view)
        except KeyError:
            bad.append(f"{name}: missing from params")
            continue
        if e.w_shape is not None and tuple(w.shape) != tuple(e.w_shape):
            bad.append(f"{name}: shape {tuple(w.shape)} vs plan "
                       f"{tuple(e.w_shape)}")
            continue
        if e.wck is None:
            if e.w_sum is None:
                continue           # policy-only entry: nothing persisted
            got = _fingerprint_of(w)[0]
            # `is None`, not falsy: a recorded w_asum of 0.0 (all-zero
            # leaf) is a legitimate noise scale, not a missing one
            tol = rtol * ((abs(e.w_sum) if e.w_asum is None
                           else e.w_asum) + 1.0)
            if not np.isfinite(got) or abs(got - e.w_sum) > tol:
                bad.append(f"{name}: weight-sum fingerprint diverged "
                           f"({got:.6g} vs plan {e.w_sum:.6g})")
            continue
        if e.op.kind in ("matmul", "grouped_matmul"):
            # stage and per-expert grouped entries re-encode through the
            # same stacked helper build_plan used, so the recipes cannot
            # drift
            stacked = e.stack or e.op.kind == "grouped_matmul"
            fresh = (stacked_weight_checksums_matmul(w, e.wck.col_chunk)
                     if stacked
                     else weight_checksums_matmul(w, e.wck.col_chunk))
            pairs = ((e.wck.cw1, fresh.cw1), (e.wck.cw2, fresh.cw2))
        else:
            cw1, cw2 = C.encode_w_conv(w, groups=e.op.groups)
            pairs = ((e.wck[0], cw1), (e.wck[1], cw2))
        for i, (want, got) in enumerate(pairs):
            if _diverged(want, got, rtol):
                bad.append(f"{name}: cw{i + 1} diverged from the plan's "
                           "persisted checksums")
                break
    return (len(bad) == 0), bad


def _default_params(state):
    return state["params"] if isinstance(state, dict) and "params" in state \
        else state


def _update_params(state, params):
    """Inverse of _default_params: write a repaired param tree back into
    the carried state."""
    if isinstance(state, dict) and "params" in state:
        return {**state, "params": params}
    return params


def set_weight_leaf(params, name: str, leaf):
    """Return a copy of the params tree with entry `name`'s weight leaf
    replaced (same path grammar as weight_leaf; only the dicts along the
    path are copied, untouched subtrees are shared)."""
    parts = name.split("/")
    out = dict(params)
    node, cur = params, out
    for i, part in enumerate(parts):
        if not isinstance(node, dict) or part not in node:
            raise KeyError(name)
        child = node[part]
        if i == len(parts) - 1:
            if isinstance(child, dict):
                if "w" not in child:
                    raise KeyError(name)
                cur[part] = {**child, "w": leaf}
            else:
                cur[part] = leaf
        else:
            nd = dict(child)
            cur[part] = nd
            node, cur = child, nd
    return out


def repair_weights_against_plan(params, plan, bad: List[str],
                                rtol: float = WR.HOST_RTOL):
    """First rung of the audit ladder: solve audit-flagged entries in
    place from the plan's float64 locator sums (core.weight_repair).

    Only the entries named in `bad` (the audit's divergence list,
    '<name>: reason' strings) are touched. Returns (new_params,
    repaired_names); a None second element means some flagged entry could
    not be repaired (no locators, multi-block damage, failed verification)
    and the caller must escalate to the restore rung. The solve runs in
    float64 on the weight's device, so f32 and bf16 leaves are restored
    bitwise and integer (quantized) leaves exactly; the damaged leaf is
    the only one rewritten."""
    names: List[str] = []
    for b in bad:
        n = b.split(":")[0]
        if n not in names:
            names.append(n)
    new_params = params
    repaired: List[str] = []
    for name in names:
        e = plan.get(name) if plan is not None else None
        if e is None or e.wlc is None:
            return params, None
        try:
            leaf = weight_leaf(params, name)
        except KeyError:
            return params, None          # missing leaf: nothing to fix
        w = apply_w_view(leaf, e.w_view)
        tol = float(WR.locator_tol(e.wlc, rtol))
        if e.op.kind == "matmul":
            fix = (WR.repair_stacked_matmul_weight if e.stack
                   else WR.repair_matmul_weight)
            fixed, verdict = fix(w, e.wlc, tol, dtype=torch.float64)
        elif e.op.kind == "grouped_matmul":
            # per-expert stacks repair like stage stacks: the locator
            # sums carry one (K, M) block grid per leading-axis slice
            fixed, verdict = WR.repair_stacked_matmul_weight(
                w, e.wlc, tol, dtype=torch.float64)
        elif e.op.kind == "conv":
            fixed, verdict = WR.repair_conv_weight(w, e.wlc, tol,
                                                   dtype=torch.float64)
        else:
            return params, None
        if int(verdict) != WR.REPAIRED:
            return params, None
        arr = apply_w_view_inv(fixed, e.w_view, leaf.shape)
        if not leaf.dtype.is_floating_point:
            arr = torch.round(arr)       # integer deltas are f64-exact
        new_params = set_weight_leaf(new_params, name,
                                     arr.to(leaf.dtype).contiguous())
        repaired.append(name)
    return new_params, repaired


class PlanAuditor:
    """Plan-trusted at-rest weight audits with a three-rung escalation
    ladder, shared by StepRunner and the serving session. The plan file is
    the root of trust, and on divergence the auditor:

    1. repairs single-block corruption in place from the plan's locator
       sums (`repair_weights_against_plan`) and re-audits - no restore,
       no halted session;
    2. escalates multi-block / unrepairable damage to a checkpoint
       restore and re-audits the restored state;
    3. refuses with WeightDivergenceError when nothing can restore.

    `last_verdict` ('clean' | 'repaired' | 'restored') and
    `last_repair_s` expose the outcome of the latest audit_or_restore.
    `stats` may be a caller-owned dict (counters are merged via
    setdefault so existing keys are preserved). A repaired param tree is
    written back into the carried state where the default params_fn
    reads it (state["params"], or the state itself)."""

    def __init__(self, plan, restore_fn: Optional[Callable] = None,
                 params_fn: Optional[Callable] = None,
                 stats: Optional[dict] = None):
        self.plan = plan
        self.restore_fn = restore_fn
        self.params_fn = params_fn or _default_params
        self.stats = stats if stats is not None else {}
        self.stats.setdefault("weight_audits", 0)
        self.stats.setdefault("weight_repairs", 0)
        self.stats.setdefault("weight_restores", 0)
        self.last_verdict = "clean"
        self.last_repair_s: Optional[float] = None
        self.last_bad: List[str] = []

    def audit(self, state) -> bool:
        """One plan-trusted at-rest weight audit; True = weights match the
        plan's persisted checksums (no plan = trivially clean). The
        divergence list is kept on `last_bad` for the repair rung."""
        if self.plan is None:
            self.last_bad = []
            return True
        self.stats["weight_audits"] += 1
        ok, bad = audit_weights_against_plan(self.params_fn(state),
                                             self.plan)
        self.last_bad = bad
        if not ok:
            log.error("plan-trusted weight audit failed: %s", bad[:5])
        return ok

    def audit_or_restore(self, state):
        """Run the ladder: audit, then repair in place, then restore from
        checkpoint, then refuse. Every rung's output is re-audited before
        it is trusted."""
        self.last_verdict = "clean"
        self.last_repair_s = None
        if self.audit(state):
            return state
        t0 = time.perf_counter()
        fixed, repaired = repair_weights_against_plan(
            self.params_fn(state), self.plan, self.last_bad)
        if repaired:
            state2 = _update_params(state, fixed)
            if self.audit(state2):
                self.last_repair_s = time.perf_counter() - t0
                self.stats["weight_repairs"] += 1
                self.last_verdict = "repaired"
                log.warning(
                    "weight/plan divergence - repaired in place from "
                    "locator sums (%s, %.2f ms)", repaired,
                    self.last_repair_s * 1e3)
                return state2
        if self.restore_fn is None:
            raise WeightDivergenceError(
                "at-rest weights diverged from the ProtectionPlan's "
                "persisted checksums beyond in-place repair and no "
                "restore_fn is configured")
        log.error("weight/plan divergence beyond in-place repair - "
                  "restoring from checkpoint")
        self.stats["weight_restores"] += 1
        state = self.restore_fn()
        if not self.audit(state):
            raise WeightDivergenceError(
                "restored checkpoint still diverges from the "
                "ProtectionPlan's persisted checksums - refusing to serve "
                "(checkpoint corrupted, or plan built from different "
                "weights)")
        self.last_verdict = "restored"
        return state


class StepRunner:
    """Runs a step with verdict-driven retry/restore.

    With a `plan`, the runner also polices the RowHammer regime: every
    `policy.audit_weights_every` steps (including step 0 - corruption
    that predates the process must not be blessed) the at-rest weights
    are audited against the plan's persisted checksums, and divergence
    climbs the PlanAuditor's ladder."""

    def __init__(self, step_fn: Callable, policy: FTPolicy,
                 restore_fn: Optional[Callable] = None,
                 plan=None, params_fn: Optional[Callable] = None):
        self.step_fn = step_fn
        self.policy = policy
        self.restore_fn = restore_fn
        self.plan = plan
        self.params_fn = params_fn or _default_params
        self.consecutive_failures = 0
        self.step_count = 0
        self.stats = {"retries": 0, "restores": 0, "faults_detected": 0,
                      "faults_corrected": 0, "weight_audits": 0,
                      "weight_repairs": 0, "weight_restores": 0}
        self.auditor = PlanAuditor(plan, restore_fn=restore_fn,
                                   params_fn=self.params_fn,
                                   stats=self.stats)

    def audit(self, state) -> bool:
        """One plan-trusted at-rest weight audit; True = weights match the
        plan's persisted checksums (no plan = trivially clean)."""
        return self.auditor.audit(state)

    def _audit_or_restore(self, state):
        return self.auditor.audit_or_restore(state)

    def _verdict(self, metrics) -> Tuple[bool, FaultReport]:
        rep: FaultReport = metrics["report"]
        loss = float(metrics["loss"])
        detected = int(rep.detected)
        residual = int(rep.residual)
        if detected:
            self.stats["faults_detected"] += 1
            if not residual:
                self.stats["faults_corrected"] += 1
        ok = (residual == 0) and np.isfinite(loss)
        return ok, rep

    def run(self, state, batch):
        every = self.policy.audit_weights_every
        if self.plan is not None and every and self.step_count % every == 0:
            state = self._audit_or_restore(state)
        self.step_count += 1
        for attempt in range(self.policy.max_step_retries + 1):
            new_state, metrics = self.step_fn(state, batch)
            ok, rep = self._verdict(metrics)
            if ok:
                self.consecutive_failures = 0
                return new_state, metrics
            log.warning("step verdict failed (attempt %d): report=%s "
                        "loss=%s - recomputing step", attempt,
                        tuple(int(v) for v in rep), metrics["loss"])
            self.stats["retries"] += 1
        self.consecutive_failures += 1
        if (self.restore_fn is not None and self.consecutive_failures
                >= self.policy.restore_after_failures):
            log.error("persistent step failure - restoring from checkpoint")
            self.stats["restores"] += 1
            state = self.restore_fn()
            self.consecutive_failures = 0
            new_state, metrics = self.step_fn(state, batch)
            return new_state, metrics
        # accept the last attempt but surface the verdict to the caller
        return new_state, metrics
