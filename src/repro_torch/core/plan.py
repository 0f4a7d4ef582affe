"""Offline-compiled, model-level protection plans (twin of
repro.core.plan: the CNN and the transformer halves).

    plan = build_plan(params, cnn_cfg, batch=8)      # offline, once
    plan.save("plan.json")                           # JSON + sibling .npz
    plan = ProtectionPlan.load("plan.json")
    plan.validate(params)                            # stale plans fail
    logits, report = forward_cnn(params, x, cnn_cfg, plan=plan)

A plan maps param-tree paths to `PlanEntry`s: the op geometry (`OpSpec`),
the SS4.3 policy decision (a `ProtectConfig`) and the precomputed weight
checksums. Transformer stage entries are stacked: their weights and
checksums keep the leading repeats axis, and the forward swaps in each
repeat's slice (`entry_overrides`). Grouped entries (a MoE block's
experts) carry per-expert checksums and locators for an (E, K, M) stack;
a stage-stacked (reps, E, K, M) leaf is fingerprinted only, and every
call encodes its experts from the weight, as in the JAX package. The
file format is the JAX package's
`repro.plan/v1`, so a plan saved by either package loads in the other;
locator sums stay host numpy float64.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import logging
import math
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from . import checksums as C
from .cost_model import cost_model_doc
from .policy import (CostModel, OpShape, decide_rc_clc,
                     profile_conv_detect_kernel, profile_matmul_kernel)
from .protected import (ENCODE_SLAB, WeightChecksums, _site_product,
                        grouped_weight_checksums, pick_chunk,
                        protect_matmul_output, protected_conv,
                        protected_grouped_matmul, protected_matmul,
                        weight_checksums_matmul, with_product_grad)
from .types import (DEFAULT_CONFIG, DetectEvidence, FaultReport,
                    ProtectConfig)

PLAN_SCHEMA = "repro.plan/v1"

OP_KINDS = ("matmul", "conv", "grouped_matmul")


class PlanStaleError(ValueError):
    """A plan's recorded weight shapes/dtypes/content no longer match the
    params: its precomputed checksums would verify the wrong invariants."""


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """Static geometry of one protected op."""
    kind: str = "matmul"       # one of OP_KINDS
    stride: int = 1            # conv only
    pad: int = 0               # conv only: symmetric spatial padding
    groups: int = 1            # conv only

    def __post_init__(self):
        if self.kind not in OP_KINDS:
            raise ValueError(f"unknown op kind {self.kind!r} "
                             f"(have {OP_KINDS})")

    @property
    def padding(self):
        return [(self.pad, self.pad)] * 2


# Named weight views: how an entry's GEMM weight derives from the param
# leaf it is keyed under. The tied-embeddings LM head's (d, nc*V) weight is
# the transposed flattened embedding table - a view, never a copy.
W_VIEWS = {
    "tied_head": lambda w: w.reshape(-1, w.shape[-1]).T,
}

# Inverse views: write a GEMM weight back onto the leaf it derives from;
# apply_w_view(apply_w_view_inv(v, view, leaf.shape), view) == v.
W_VIEWS_INV = {
    "tied_head": lambda v, shape: v.T.reshape(shape),
}


def apply_w_view(w, view: Optional[str]):
    """Resolve a param leaf to the GEMM weight an entry was encoded from."""
    if view is None:
        return w
    if view not in W_VIEWS:
        raise ValueError(f"unknown weight view {view!r} "
                         f"(have {sorted(W_VIEWS)})")
    return W_VIEWS[view](w)


def apply_w_view_inv(v, view: Optional[str], leaf_shape):
    """Invert a weight view: map an entry's GEMM weight back onto the
    param leaf of shape `leaf_shape` it derives from."""
    if view is None:
        return v
    if view not in W_VIEWS_INV:
        raise ValueError(f"weight view {view!r} has no inverse "
                         f"(have {sorted(W_VIEWS_INV)})")
    return W_VIEWS_INV[view](v, tuple(leaf_shape))


def _dtype_name(dtype: torch.dtype) -> str:
    """The dtype's name as the JAX package records it ("float32")."""
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass
class PlanEntry:
    """One op's offline decisions: policy config + precomputed weight
    checksums + the weight identity they were encoded from."""
    name: str
    op: OpSpec
    cfg: ProtectConfig
    wck: Any = None                 # WeightChecksums | (cw1, cw2) | None
    wlc: Any = None                 # checksums.WeightLocators (float64)
    w_shape: Optional[Tuple[int, ...]] = None
    w_dtype: Optional[str] = None
    w_sum: Optional[float] = None
    w_asum: Optional[float] = None
    # leading stack axes on the recorded weight (1 for the transformer
    # stages, whose params carry a leading repeats axis; the op sees one
    # slice) - checksums of stacked entries keep a matching axis
    stack: int = 0
    w_view: Optional[str] = None     # W_VIEWS derivation of the GEMM weight
    # deferred-workflow membership ("per_layer" | "deferred" | None)
    execution: Optional[str] = None

    def check_weight(self, w) -> None:
        """Staleness check against the weight actually used."""
        if self.w_shape is not None:
            want = tuple(self.w_shape)
            ok = (tuple(w.shape) == want
                  or (self.stack and tuple(w.shape) == want[self.stack:]))
            if not ok:
                raise PlanStaleError(
                    f"plan entry {self.name!r} was built for weight shape "
                    f"{want} but got {tuple(w.shape)}; rebuild "
                    "the plan with build_plan()")
        if self.w_dtype is not None and _dtype_name(w.dtype) != self.w_dtype:
            raise PlanStaleError(
                f"plan entry {self.name!r} was built for dtype "
                f"{self.w_dtype} but got {_dtype_name(w.dtype)}; rebuild "
                "the plan with build_plan()")


# --------------------------------------------------------------------------
# plan entries (the offline encode step)
# --------------------------------------------------------------------------

def matmul_entry(name: str, w=None, cfg: ProtectConfig = DEFAULT_CONFIG
                 ) -> PlanEntry:
    """Entry for O = D @ W[K,M]; w=None builds a policy-only entry."""
    if w is None:
        return PlanEntry(name, OpSpec("matmul"), cfg)
    return PlanEntry(name, OpSpec("matmul"), cfg,
                     wck=weight_checksums_matmul(w, cfg.col_chunk),
                     wlc=C.weight_locators_matmul(w, cfg.col_chunk),
                     w_shape=tuple(w.shape), w_dtype=_dtype_name(w.dtype))


def conv_entry(name: str, w=None, cfg: ProtectConfig = DEFAULT_CONFIG,
               stride: int = 1, pad: int = 0, groups: int = 1) -> PlanEntry:
    """Entry for O = D (x) W[M,Ch,R,R]; w=None builds a policy-only entry."""
    op = OpSpec("conv", stride=stride, pad=pad, groups=groups)
    if w is None:
        return PlanEntry(name, op, cfg)
    return PlanEntry(name, op, cfg, wck=C.encode_w_conv(w, groups=groups),
                     wlc=C.weight_locators_conv(w),
                     w_shape=tuple(w.shape), w_dtype=_dtype_name(w.dtype))


def grouped_matmul_entry(name: str, w=None,
                         cfg: ProtectConfig = DEFAULT_CONFIG) -> PlanEntry:
    """Entry for expert-batched O[g] = D[g] @ W[g]. A concrete (E, K, M)
    expert stack also gets per-expert block checksums and locator sums
    (the stacked matmul encoders, one slice per expert), so the at-rest
    audit covers expert weights at block resolution and the repair rung
    can solve single-block damage; a stage-stacked (reps, E, K, M) leaf
    stays fingerprint-only, its checksums derived per call from the
    weight."""
    e = PlanEntry(name, OpSpec("grouped_matmul"), cfg)
    if w is not None:
        e.w_shape, e.w_dtype = tuple(w.shape), _dtype_name(w.dtype)
        if w.dim() == 3:
            e.wck = stacked_weight_checksums_matmul(w, cfg.col_chunk)
            e.wlc = stacked_weight_locators_matmul(w, cfg.col_chunk)
    return e


# --------------------------------------------------------------------------
# the unified protected-op entry point
# --------------------------------------------------------------------------

PROTECT_MODES = (None, "detect_only", "correct")


def protect_op(op: OpSpec, inputs, entry: Optional[PlanEntry] = None,
               cfg: Optional[ProtectConfig] = None, o=None,
               mode: Optional[str] = None, detected=None):
    """Run one protected op through the multischeme workflow.

    inputs is (d, w) or (d, w, bias). `entry` supplies the offline policy
    and precomputed weight checksums (staleness-checked); without one,
    `cfg` (default DEFAULT_CONFIG) applies and weight checksums are
    derived per call. `o` injects an already-computed output. `mode`:
    None (cfg-driven), "detect_only" (CoC-D only, DetectEvidence carry)
    or "correct" (force the ladder); `detected` gates it."""
    if mode not in PROTECT_MODES:
        raise ValueError(f"unknown protect_op mode {mode!r} "
                         f"(have {PROTECT_MODES})")
    d, w = inputs[0], inputs[1]
    bias = inputs[2] if len(inputs) > 2 else None
    if entry is not None:
        if entry.op != op:
            raise ValueError(
                f"protect_op: op spec {op} does not match entry "
                f"{entry.name!r}'s op {entry.op}")
        entry.check_weight(w)
        use_cfg = entry.cfg if cfg is None else cfg
        wck = entry.wck
    else:
        use_cfg = DEFAULT_CONFIG if cfg is None else cfg
        wck = None

    if op.kind == "matmul":
        if o is not None:
            if use_cfg is None or not use_cfg.enabled:
                return o, (DetectEvidence.clean() if mode == "detect_only"
                           else FaultReport.clean())
            return protect_matmul_output(d, w, o, wck=wck, bias=bias,
                                         cfg=use_cfg, mode=mode,
                                         detected=detected)
        return protected_matmul(d, w, wck=wck, bias=bias, cfg=use_cfg,
                                mode=mode, detected=detected)
    if op.kind == "conv":
        return protected_conv(d, w, bias=bias, stride=op.stride,
                              padding=op.padding, groups=op.groups,
                              wck=wck, cfg=use_cfg, o=o, mode=mode,
                              detected=detected)
    if op.kind == "grouped_matmul":
        if bias is not None:
            # silently dropping it would report clean verdicts on operands
            # the op never saw
            raise NotImplementedError(
                "protect_op: grouped_matmul does not support bias")
        if detected is not None:
            raise NotImplementedError(
                "protect_op: grouped_matmul does not support an external "
                "`detected` gate (per-group gates would need a vector)")
        return protected_grouped_matmul(d, w, wck=wck, cfg=use_cfg,
                                        mode=mode, o=o)
    raise ValueError(f"unknown op kind {op.kind!r}")


def correct_op(op: OpSpec, inputs, entry: Optional[PlanEntry] = None,
               cfg: Optional[ProtectConfig] = None, o=None, detected=None):
    """Run the full multischeme ladder on one op regardless of any
    detect_only config (the second half of the deferred workflow)."""
    return protect_op(op, inputs, entry=entry, cfg=cfg, o=o, mode="correct",
                      detected=detected)


# --------------------------------------------------------------------------
# the ambient plan context (how call sites resolve their PlanEntry)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _PlanContext:
    plan: Optional["ProtectionPlan"]
    mode: Optional[str] = None                     # PROTECT_MODES
    detected: Optional[Mapping[str, Any]] = None   # path -> carried flag
    prefix: Tuple[str, ...] = ()
    overrides: Dict[str, PlanEntry] = dataclasses.field(default_factory=dict)
    repeat: Optional[int] = None                   # stage repeat being run


_CTX: contextvars.ContextVar[Optional[_PlanContext]] = \
    contextvars.ContextVar("repro_torch_plan_context", default=None)


@contextlib.contextmanager
def plan_scope(plan: Optional["ProtectionPlan"] = None, *,
               mode: Optional[str] = None,
               detected: Optional[Mapping[str, Any]] = None
               ) -> Iterator[_PlanContext]:
    """Enter a fresh ambient protection context (path prefix resets to
    the param-tree root)."""
    if mode not in PROTECT_MODES:
        raise ValueError(f"unknown plan_scope mode {mode!r} "
                         f"(have {PROTECT_MODES})")
    ctx = _PlanContext(plan=plan, mode=mode, detected=detected)
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def path_scope(*segments: str) -> Iterator[None]:
    """Append param-tree path segments to the ambient prefix (no-op when
    no plan scope is active)."""
    ctx = _CTX.get()
    if ctx is None:
        yield
        return
    saved = ctx.prefix
    ctx.prefix = saved + tuple(segments)
    try:
        yield
    finally:
        ctx.prefix = saved


@contextlib.contextmanager
def entry_overrides(mapping: Dict[str, PlanEntry]) -> Iterator[None]:
    """Override resolved entries by absolute path for the scope: the
    stage loop swaps a stacked entry for the per-repeat view carrying
    that repeat's checksum slice."""
    ctx = _CTX.get()
    if ctx is None:
        yield
        return
    saved = dict(ctx.overrides)
    ctx.overrides.update(mapping)
    try:
        yield
    finally:
        ctx.overrides = saved


@contextlib.contextmanager
def repeat_scope(r: int) -> Iterator[None]:
    """Name the stage repeat the scope runs (current_repeat; no-op when
    no plan scope is active): the stage loop runs every repeat under the
    same paths, so a fault hook tells one repeat from another by it."""
    ctx = _CTX.get()
    if ctx is None:
        yield
        return
    saved = ctx.repeat
    ctx.repeat = r
    try:
        yield
    finally:
        ctx.repeat = saved


def current_repeat() -> Optional[int]:
    """The stage repeat being run (None outside the stage loop)."""
    ctx = _CTX.get()
    return ctx.repeat if ctx is not None else None


def capture_scope():
    """The ambient state a protected forward reads, as it stands here: the
    plan context (plan, mode, carried flags, path prefix, overrides,
    repeat), the fault hooks and the mesh (runtime.sharding's parallel
    scope). replay_scope re-enters it."""
    from ..runtime.sharding import current_parallel
    from .injection import active_faults
    ctx = _CTX.get()
    if ctx is not None:
        ctx = dataclasses.replace(ctx, overrides=dict(ctx.overrides))
    return ctx, active_faults(), current_parallel()


@contextlib.contextmanager
def replay_scope(captured) -> Iterator[None]:
    """Re-enter a capture_scope() value, its reads counted as a
    recompute's: autograd recomputes a rematerialised stage in the
    backward, after the forward's scopes have exited and maybe on its
    device thread, and the recompute must see the plan entries, the
    overrides, the fault hooks and the mesh its forward saw: under a mesh
    it replays the forward's collectives, in the order autograd recomputes
    the stages, which is the same on every rank."""
    from ..runtime.sharding import parallel_as
    from .injection import faults_as
    from .workflow import recompute_scope
    ctx, hooks, par = captured
    if ctx is not None:
        ctx = dataclasses.replace(ctx, overrides=dict(ctx.overrides))
    token = _CTX.set(ctx)
    try:
        with faults_as(hooks), parallel_as(par), recompute_scope():
            yield
    finally:
        _CTX.reset(token)


def in_plan_scope() -> bool:
    """Is a plan context active (are param-tree paths live)?"""
    return _CTX.get() is not None


def current_path(name: str = "") -> str:
    ctx = _CTX.get()
    parts = (ctx.prefix if ctx is not None else ()) + ((name,) if name else ())
    return "/".join(parts)


def ambient_mode() -> Optional[str]:
    ctx = _CTX.get()
    return ctx.mode if ctx is not None else None


def ambient_plan() -> Optional["ProtectionPlan"]:
    ctx = _CTX.get()
    return ctx.plan if ctx is not None else None


def resolve_entry(name: str) -> Optional[PlanEntry]:
    """PlanEntry for `name` under the ambient path prefix (None when no
    scope/plan is active or the plan has no entry at that path)."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    path = current_path(name)
    if path in ctx.overrides:
        return ctx.overrides[path]
    if ctx.plan is None:
        return None
    return ctx.plan.get(path)


def _carried_flag(path: str):
    ctx = _CTX.get()
    if ctx is None or ctx.detected is None:
        return None
    return ctx.detected.get(path)


def protect_site(name: str, inputs, *, entry: Optional[PlanEntry] = None,
                 cfg: Optional[ProtectConfig] = None, o=None,
                 op: Optional[OpSpec] = None):
    """The uniform protected call site: protect_op with the ambient
    context's entry resolution, execution mode and carried detect flags.
    With an entry its offline cfg rules; `cfg` is only the fallback for
    sites without one, and `cfg=None` there means unprotected."""
    if entry is None:
        entry = resolve_entry(name)
    if entry is not None:
        use_cfg = None
    else:
        use_cfg = cfg if cfg is not None \
            else DEFAULT_CONFIG.replace(enabled=False)
    mode = ambient_mode()
    if (mode == "detect_only" and entry is not None
            and entry.execution == "per_layer" and not entry.stack):
        # mixed deferred membership: a per_layer site keeps its immediate
        # ladder even inside the deferred workflow's detect pass
        mode = None
    detected = _carried_flag(current_path(name)) if mode == "correct" \
        else None
    if op is None:
        op = entry.op if entry is not None else OpSpec("matmul")
    if op.kind == "grouped_matmul":
        # per-group gates would need a vector; grouped sites re-detect
        detected = None
    if o is None and op.kind in ("matmul", "grouped_matmul"):
        # serving-drill seam: an ambient fault hook at this exact path
        # (injection.fault_scope) corrupts the raw output, which then takes
        # the ordinary `o=` injection path. Under autograd the workflow's
        # output carries the gradient of the site's product, as on the
        # clean path (protected.with_product_grad)
        from .injection import site_fault
        hook = site_fault(current_path(name))
        if hook is not None:
            d, w = inputs[0], inputs[1]
            site_cfg = entry.cfg if entry is not None else use_cfg
            if op.kind == "grouped_matmul":
                o2 = _site_product(d, w, site_cfg)
                return with_product_grad(o2, lambda o: protect_op(
                    op, inputs, entry=entry, cfg=use_cfg, o=hook(o),
                    mode=mode))
            lead, k, m = d.shape[:-1], d.shape[-1], w.shape[-1]
            d2 = d.reshape(-1, k)
            o2 = _site_product(d2, w, site_cfg)
            if len(inputs) > 2:
                o2 = (o2.to(torch.float32)
                      + inputs[2].to(torch.float32)).to(o2.dtype)
            out, rep = with_product_grad(o2, lambda o: protect_op(
                op, (d2,) + tuple(inputs[1:]), entry=entry, cfg=use_cfg,
                o=hook(o.reshape(*lead, m)).reshape(-1, m), mode=mode,
                detected=detected))
            return out.reshape(*lead, m), rep
    return protect_op(op, inputs, entry=entry, cfg=use_cfg, o=o, mode=mode,
                      detected=detected)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

def weight_leaf(params, name: str):
    """Resolve an entry name ('conv3', 'fc') to its weight leaf."""
    node = params
    for part in name.split("/"):
        if not isinstance(node, dict) or part not in node:
            raise KeyError(name)
        node = node[part]
    if isinstance(node, dict):
        if "w" not in node:
            raise KeyError(name)
        node = node["w"]
    return node


@dataclasses.dataclass
class ProtectionPlan:
    """Per-model protection plan: ordered {param path -> PlanEntry}."""
    entries: Dict[str, PlanEntry] = dataclasses.field(default_factory=dict)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __getitem__(self, name: str) -> PlanEntry:
        return self.entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self.entries

    def __len__(self) -> int:
        return len(self.entries)

    def get(self, name: str, default=None) -> Optional[PlanEntry]:
        return self.entries.get(name, default)

    def names(self) -> Tuple[str, ...]:
        return tuple(self.entries)

    def summary(self) -> Dict[str, dict]:
        return {name: {"kind": e.op.kind,
                       "enabled": e.cfg.enabled,
                       "rc": e.cfg.rc_enabled, "clc": e.cfg.clc_enabled,
                       "fc": e.cfg.fc_enabled,
                       "precomputed_checksums": e.wck is not None}
                for name, e in self.entries.items()}

    # -- staleness ---------------------------------------------------------
    def validate(self, params, rtol: float = 1e-5) -> None:
        """Raise PlanStaleError unless every entry's recorded weight
        shape/dtype and content fingerprint match `params`."""
        problems = []
        for name, e in self.entries.items():
            try:
                w = apply_w_view(weight_leaf(params, name), e.w_view)
            except KeyError:
                problems.append(f"{name}: not found in params")
                continue
            if e.w_shape is not None and tuple(w.shape) != tuple(e.w_shape):
                problems.append(f"{name}: shape {tuple(e.w_shape)} in plan "
                                f"vs {tuple(w.shape)} in params")
                continue
            if e.w_dtype is not None and _dtype_name(w.dtype) != e.w_dtype:
                problems.append(f"{name}: dtype {e.w_dtype} in plan vs "
                                f"{_dtype_name(w.dtype)} in params")
                continue
            if e.w_sum is not None:
                got, got_abs = _fingerprint_of(w)
                scale = rtol * ((abs(e.w_sum) if e.w_asum is None
                                 else e.w_asum) + 1.0)
                drift = abs(got - e.w_sum)
                if e.w_asum is not None:
                    drift = max(drift, abs(got_abs - e.w_asum))
                if drift > scale:
                    problems.append(
                        f"{name}: weight content changed (fingerprint "
                        f"{e.w_sum:.6g} in plan vs {got:.6g} in params - "
                        "same-shape retrain?)")
        if problems:
            raise PlanStaleError(
                "stale ProtectionPlan (rebuild with build_plan): "
                + "; ".join(problems))

    # -- serialization (JSON structure + npz checksum payload) -------------
    @staticmethod
    def _paths(path: str) -> Tuple[str, str]:
        base = path[:-5] if str(path).endswith(".json") else str(path)
        return base + ".json", base + ".npz"

    def save(self, path: str) -> None:
        """Write `<base>.json` (structure) + `<base>.npz` (checksums)."""
        json_path, npz_path = self._paths(path)
        arrays: Dict[str, np.ndarray] = {}
        entries_doc = {}
        host = lambda t: t.detach().cpu().numpy()
        for name, e in self.entries.items():
            doc = {"op": dataclasses.asdict(e.op),
                   "cfg": dataclasses.asdict(e.cfg),
                   "w_shape": list(e.w_shape) if e.w_shape else None,
                   "w_dtype": e.w_dtype, "w_sum": e.w_sum,
                   "w_asum": e.w_asum, "stack": e.stack,
                   "w_view": e.w_view, "execution": e.execution,
                   "wck": None, "wlc": None}
            if isinstance(e.wck, WeightChecksums):
                doc["wck"] = {"kind": "matmul",
                              "col_chunk": int(e.wck.col_chunk)}
                arrays[f"{name}/cw1"] = host(e.wck.cw1)
                arrays[f"{name}/cw2"] = host(e.wck.cw2)
            elif e.wck is not None:
                cw1, cw2 = e.wck
                doc["wck"] = {"kind": "conv"}
                arrays[f"{name}/cw1"] = host(cw1)
                arrays[f"{name}/cw2"] = host(cw2)
            if e.wlc is not None:
                doc["wlc"] = {"cb": int(e.wlc.cb)}
                for fld in ("r1", "r2", "c1", "c2"):
                    arrays[f"{name}/wl_{fld}"] = np.asarray(
                        getattr(e.wlc, fld), dtype=np.float64)
            entries_doc[name] = doc
        with open(json_path, "w") as f:
            json.dump({"schema": PLAN_SCHEMA, "meta": self.meta,
                       "entries": entries_doc}, f, indent=2)
        np.savez(npz_path, **arrays)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "ProtectionPlan":
        """Read a `repro.plan/v1` plan; checksums go to `device` (the card
        unless the caller asks for the CPU), locators stay host float64."""
        dev = resolve_device(device)
        json_path, npz_path = cls._paths(path)
        with open(json_path) as f:
            raw = json.load(f)
        if raw.get("schema") != PLAN_SCHEMA:
            raise ValueError(f"unknown plan schema {raw.get('schema')!r} "
                             f"(want {PLAN_SCHEMA})")
        entries: Dict[str, PlanEntry] = {}
        with np.load(npz_path) as payload:
            for name, doc in raw["entries"].items():
                wck = None
                if doc["wck"] is not None:
                    cw1 = torch.as_tensor(payload[f"{name}/cw1"], device=dev)
                    cw2 = torch.as_tensor(payload[f"{name}/cw2"], device=dev)
                    if doc["wck"]["kind"] == "matmul":
                        wck = WeightChecksums(cw1, cw2,
                                              doc["wck"]["col_chunk"])
                    else:
                        wck = (cw1, cw2)
                wlc = None
                if doc.get("wlc") is not None:
                    wlc = C.WeightLocators(
                        payload[f"{name}/wl_r1"], payload[f"{name}/wl_r2"],
                        payload[f"{name}/wl_c1"], payload[f"{name}/wl_c2"],
                        int(doc["wlc"]["cb"]))
                entries[name] = PlanEntry(
                    name, OpSpec(**doc["op"]), ProtectConfig(**doc["cfg"]),
                    wck=wck, wlc=wlc,
                    w_shape=tuple(doc["w_shape"]) if doc["w_shape"] else None,
                    w_dtype=doc["w_dtype"], w_sum=doc.get("w_sum"),
                    w_asum=doc.get("w_asum"), stack=doc.get("stack", 0),
                    w_view=doc.get("w_view"),
                    execution=doc.get("execution"))
        return cls(entries=entries, meta=raw.get("meta", {}))

    # -- sharding ----------------------------------------------------------
    def shard(self, mesh, cfg=None, *, params, specs) -> "ProtectionPlan":
        """This rank's plan on `mesh` (twin of the JAX package's
        ProtectionPlan.shard): `params` is this rank's local tree
        (runtime.sharding.shard_tree) of the params whose full tree has
        the spec tree `specs` (param_shardings(..., cfg)).

        Every local shard is first held to the entry's fingerprint, its
        (sum, sum of |w|) summed over the mesh axes the leaf is sharded
        on, so a shard is trusted only when the whole leaf matches the
        plan (PlanStaleError otherwise). Each entry's checksums and
        locator sums are then cut to the rank's shard: a column-sharded
        weight keeps the column chunks it holds, a row-sharded one the
        rows it holds. What cannot be cut is encoded from the local
        shard: a chunk that straddles a shard boundary (Yi-9B's 512-column
        wk/wv, one chunk, on two ranks), a row-sharded weight's column
        locators (sums over every row) and a weight view's checksums.
        Stacked entries are cut per repeat. The entries then record the
        local shape and fingerprint; `meta["mesh"]` the mesh's shape and
        the rank's coordinates. Grouped entries under a sharded spec are
        ROADMAP item 1.12's later steps and raise."""
        from ..runtime import sharding as SH
        flat = SH.flat_specs(specs)
        items = []
        for name, e in self.entries.items():
            leaf_path = _leaf_path(params, name)
            spec = flat.get(leaf_path, ())
            SH._check_executable(spec, mesh, name)
            local = apply_w_view(weight_leaf(params, name), e.w_view)
            items.append((name, e, spec, local))
        # one collective for every fingerprint: a sharded leaf's rows are
        # summed over 'model', a replicated leaf's stay as they are
        fp = torch.tensor([_fingerprint_of(w) for _, _, _, w in items],
                          dtype=torch.float32,
                          device=mesh.device).reshape(-1, 2)
        sharded = torch.tensor([SH.is_sharded(sp) for _, _, sp, _ in items],
                               device=mesh.device)[:, None]
        summed = SH.axis_sum(torch.where(sharded, fp, torch.zeros_like(fp)),
                             mesh, "model")
        whole = torch.where(sharded, summed, fp).tolist()
        entries: Dict[str, PlanEntry] = {}
        for (name, e, spec, w), (got, got_abs) in zip(items, whole):
            if e.w_sum is not None:
                scale = 1e-5 * ((abs(e.w_sum) if e.w_asum is None
                                 else e.w_asum) + 1.0)
                drift = abs(got - e.w_sum)
                if e.w_asum is not None:
                    drift = max(drift, abs(got_abs - e.w_asum))
                if drift > scale:
                    raise PlanStaleError(
                        f"plan entry {name!r}: the shards of the leaf on "
                        f"the mesh sum to {got:.6g}, the plan recorded "
                        f"{e.w_sum:.6g}; rebuild the plan from these "
                        "params")
            if not SH.is_sharded(spec):
                entries[name] = e
                continue
            if e.op.kind != "matmul":
                raise NotImplementedError(
                    f"plan entry {name!r}: a sharded {e.op.kind} entry is "
                    "not executed yet (ROADMAP item 1.12)")
            entries[name] = _shard_entry(e, spec, w, mesh)
        meta = dict(self.meta)
        meta["mesh"] = {"shape": dict(mesh.shape),
                        "coords": dict(mesh.coords)}
        return ProtectionPlan(entries=entries, meta=meta)


def _leaf_path(params, name: str) -> str:
    """The param-tree path of an entry's weight leaf (weight_leaf's)."""
    node = params
    for part in name.split("/"):
        node = node[part]
    return name + "/w" if isinstance(node, dict) else name


def _shard_entry(e: PlanEntry, spec, w, mesh) -> PlanEntry:
    """One matmul entry cut to this rank's shard `w` (the local GEMM
    weight, with the stage axis leading when stacked)."""
    from ..runtime import sharding as SH
    st = e.stack
    if e.w_view is not None:
        # the tied head's (K, V, d) table under (None, model, None): its
        # GEMM weight's columns are the local vocabulary
        k_sh, m_sh = False, True
    else:
        inner = tuple(spec[st:]) + (None, None)
        k_sh, m_sh = SH.is_sharded(inner[:1]), SH.is_sharded(inner[1:2])
    k_loc, m_loc = int(w.shape[-2]), int(w.shape[-1])
    r = mesh.index("model")
    cb = e.wck.col_chunk if e.wck is not None else None
    wck, wlc = e.wck, e.wlc
    encode = (e.w_view is not None or e.wck is None
              or (m_sh and m_loc % cb != 0))
    if encode:
        chunk = e.cfg.col_chunk
        if st:
            wck = stacked_weight_checksums_matmul(w, chunk)
            wlc = stacked_weight_locators_matmul(w, chunk)
        else:
            wck = weight_checksums_matmul(w, chunk)
            wlc = C.weight_locators_matmul(w, chunk)
    else:
        lead = (slice(None),) * st
        if m_sh:
            mb = m_loc // cb
            rows = slice(r * mb, (r + 1) * mb)
            wck = WeightChecksums(e.wck.cw1[lead + (rows,)],
                                  e.wck.cw2[lead + (rows,)], cb)
            if wlc is not None:
                wlc = C.WeightLocators(*(np.ascontiguousarray(
                    a[lead + (rows,)]) for a in wlc[:4]), wlc.cb)
        if k_sh:
            ks = slice(r * k_loc, (r + 1) * k_loc)
            wck = WeightChecksums(wck.cw1[lead + (slice(None), ks)],
                                  wck.cw2[lead + (slice(None), ks)], cb)
            # the column locators sum over every row: encoded locally
            wlc = (stacked_weight_locators_matmul(w, cb) if st
                   else C.weight_locators_matmul(w, cb))
        wck = WeightChecksums(wck.cw1.contiguous(), wck.cw2.contiguous(),
                              wck.col_chunk)
    ws, wa = _fingerprint_of(w)
    return dataclasses.replace(e, wck=wck, wlc=wlc,
                               w_shape=tuple(w.shape), w_sum=ws, w_asum=wa)


# --------------------------------------------------------------------------
# the protection spec
# --------------------------------------------------------------------------

TAU_DEFAULT = 32.0
TAU_FLOOR, TAU_CAP = 12.0, 64.0
_TAU_REF_K = 1024  # contraction depth at which the calibrated factor
                   # equals the historical global default


def calibrate_tau_factor(k_dim: int) -> float:
    """Per-layer detection safety factor from the contraction depth,
    clipped to [TAU_FLOOR, TAU_CAP]."""
    f = TAU_DEFAULT * math.sqrt(max(int(k_dim), 1) / _TAU_REF_K)
    return round(min(TAU_CAP, max(TAU_FLOOR, f)), 3)


@dataclasses.dataclass(frozen=True)
class OpSite:
    """One protectable GEMM/conv in a model, by its param-tree path."""
    path: str
    op: OpSpec
    k_dim: int                       # contraction depth (tau calibration)
    shape: Optional[OpShape] = None  # conv geometry (SS4.3 policy)
    stack: int = 0
    w_view: Optional[str] = None
    optional: bool = True            # skip silently when params lack it


@dataclasses.dataclass
class ProtectionSpec:
    """The ordered op sites plus the base ProtectConfig they start from."""
    sites: List[OpSite]
    base: ProtectConfig = DEFAULT_CONFIG
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _cnn_spec(arch_cfg, batch: int) -> ProtectionSpec:
    base = (DEFAULT_CONFIG if getattr(arch_cfg, "abft", True)
            else DEFAULT_CONFIG.replace(enabled=False))
    sites: List[OpSite] = []
    img, ch = arch_cfg.img, arch_cfg.in_ch
    for i, spec in enumerate(arch_cfg.convs):
        e = (img + 2 * spec.pad - spec.kernel) // spec.stride + 1
        out = arch_cfg.scaled(spec.out_ch)
        sites.append(OpSite(
            f"conv{i}", OpSpec("conv", stride=spec.stride, pad=spec.pad),
            k_dim=ch * spec.kernel ** 2,
            shape=OpShape(n=batch, m=out, ch=ch, r=spec.kernel, h=e),
            optional=False))
        img = e // spec.pool if spec.pool else e
        ch = out
    sites.append(OpSite("fc", OpSpec("matmul"), k_dim=ch,
                        shape=OpShape(n=batch,
                                      m=getattr(arch_cfg, "num_classes",
                                                1000), ch=ch)))
    meta = {"arch": getattr(arch_cfg, "name", "?"), "family": "cnn",
            "batch": batch, "img": arch_cfg.img, "in_ch": arch_cfg.in_ch}
    return ProtectionSpec(sites=sites, base=base, meta=meta)


def _block_sites(prefix: str, kind: str, cfg, stack: int,
                 rows: int) -> List[OpSite]:
    """GEMM sites of one transformer block, keyed by the exact param-tree
    paths models.transformer.init_params creates; `rows` (the planned
    batch*seq) gives each plain-matmul site its OpShape. grouped_matmul
    sites stay shapeless (their per-expert rows depend on the routing)."""
    d, hd = cfg.d_model, cfg.head_dim
    mm = OpSpec("matmul")

    def site(rel, k_dim, m=0, op=mm):
        shape = OpShape(n=rows, m=m, ch=k_dim) \
            if m and op.kind == "matmul" else None
        return OpSite(f"{prefix}/{rel}", op, k_dim, shape=shape, stack=stack)

    if kind.startswith("attn"):
        q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
        return [site("attn/wq", d, q), site("attn/wk", d, kv),
                site("attn/wv", d, kv), site("attn/wo", q, d)]
    if kind == "ffn":
        return [site("ffn/gate", d, cfg.d_ff), site("ffn/up", d, cfg.d_ff),
                site("ffn/down", cfg.d_ff, d)]
    if kind == "ssm":
        di = cfg.ssm_expand * d
        n_st = cfg.ssm_state
        heads = di // cfg.ssm_head_dim
        return [site("ssm/in_proj", d, 2 * di + 2 * n_st + heads),
                site("ssm/out_proj", di, d)]
    if kind == "rec":
        w = cfg.lru_width or d
        return [site("rec/in_x", d, w), site("rec/in_gate", d, w),
                site("rec/gate_a", w, w), site("rec/gate_i", w, w),
                site("rec/out", w, d)]
    if kind == "moe":
        ff = cfg.moe_d_ff or cfg.d_ff
        g = OpSpec("grouped_matmul")
        sites = [site("moe/router", d, cfg.num_experts),
                 site("moe/gate", d, op=g), site("moe/up", d, op=g),
                 site("moe/down", ff, op=g)]
        if cfg.n_shared_experts:
            sh = ff * cfg.n_shared_experts
            sites += [site("moe/shared/gate", d, sh),
                      site("moe/shared/up", d, sh),
                      site("moe/shared/down", sh, d)]
        return sites
    raise ValueError(f"unknown block kind {kind!r}")


DEFAULT_PLAN_SEQ = 128


def _transformer_spec(cfg, batch: int, seq: int) -> ProtectionSpec:
    base = ProtectConfig(enabled=cfg.abft, row_chunk=cfg.abft_row_chunk,
                         col_chunk=cfg.abft_col_chunk,
                         detect_only=cfg.abft_detect_only)
    pattern, reps, rem = cfg.stages()
    rows = batch * max(seq, 1)
    sites: List[OpSite] = []
    for i, kind in enumerate(cfg.prefix_pattern):
        sites += _block_sites(f"prefix/b{i}_{kind}", kind, cfg, stack=0,
                              rows=rows)
    if reps:
        for i, kind in enumerate(pattern):
            sites += _block_sites(f"stages/b{i}_{kind}", kind, cfg,
                                  stack=1, rows=rows)
    for i, kind in enumerate(rem):
        sites += _block_sites(f"rem/b{i}_{kind}", kind, cfg, stack=0,
                              rows=rows)
    head_shape = OpShape(n=rows, m=cfg.vocab_size * max(cfg.num_codebooks, 1),
                         ch=cfg.d_model)
    if cfg.tie_embeddings:
        sites.append(OpSite("embed/table", OpSpec("matmul"),
                            k_dim=cfg.d_model, shape=head_shape,
                            w_view="tied_head", optional=False))
    else:
        sites.append(OpSite("embed/head", OpSpec("matmul"),
                            k_dim=cfg.d_model, shape=head_shape,
                            optional=False))
    meta = {"arch": getattr(cfg, "name", "?"), "batch": batch, "seq": seq,
            "family": getattr(cfg, "family", "?"), "stage_repeats": reps}
    return ProtectionSpec(sites=sites, base=base, meta=meta)


def protection_spec(arch_cfg, batch: int = 8,
                    seq: int = DEFAULT_PLAN_SEQ) -> ProtectionSpec:
    """The ProtectionSpec of a models.cnn.CNNConfig (`.convs` walk), of a
    transformer configs.base.ModelConfig (`.stages()` walk; `seq` is the
    planned sequence length) or a spec as is."""
    if isinstance(arch_cfg, ProtectionSpec):
        return arch_cfg
    if hasattr(arch_cfg, "convs"):
        return _cnn_spec(arch_cfg, batch)
    if hasattr(arch_cfg, "stages"):
        return _transformer_spec(arch_cfg, batch, seq)
    raise TypeError(
        "protection_spec expects a CNNConfig (.convs), a transformer "
        f"ModelConfig (.stages) or a ProtectionSpec; got "
        f"{type(arch_cfg).__name__}")


# --------------------------------------------------------------------------
# the offline compiler
# --------------------------------------------------------------------------

def _fingerprint_of(w) -> Tuple[float, float]:
    """(sum, sum of |w|) of a weight in fp32. A leaf of more than
    ENCODE_SLAB elements (an expert stack) is summed a slab of leading
    rows at a time, so no fp32 copy of it is made."""
    w = w.detach()
    if w.numel() <= ENCODE_SLAB or w.dim() < 2:
        w32 = w.to(torch.float32)
        return float(torch.sum(w32)), float(torch.sum(torch.abs(w32)))
    flat = w.reshape(-1, w.shape[-1])
    per = max(1, ENCODE_SLAB // flat.shape[1])
    sums = torch.zeros(2, dtype=torch.float64, device=w.device)
    for r0 in range(0, flat.shape[0], per):
        w32 = flat[r0:r0 + per].to(torch.float32)
        sums += torch.stack([torch.sum(w32),
                             torch.sum(torch.abs(w32))]).double()
    return tuple(float(x) for x in sums.tolist())


# Offline checksums of a stacked (reps, K, M) stage weight or an (E, K, M)
# expert stack: one encode per leading-axis slice, stored with that axis so
# the stage loop hands each repeat its slice. It is the encode
# protected_grouped_matmul makes per call, and the audit re-encodes through
# it, so the recipes cannot drift.
stacked_weight_checksums_matmul = grouped_weight_checksums


def stacked_weight_locators_matmul(w, col_chunk: int) -> C.WeightLocators:
    """Offline locator sums of a stacked (reps, K, M) weight, one encode
    per repeat slice in float64 on the host, stacked on a leading reps
    axis."""
    per = [C.weight_locators_matmul(w[i], col_chunk)
           for i in range(int(w.shape[0]))]
    return C.WeightLocators(np.stack([p.r1 for p in per]),
                            np.stack([p.r2 for p in per]),
                            np.stack([p.c1 for p in per]),
                            np.stack([p.c2 for p in per]),
                            pick_chunk(int(w.shape[-1]), col_chunk))


def _site_entry(site: OpSite, w, cfg: ProtectConfig) -> PlanEntry:
    """Compile one OpSite against its (possibly absent) weight leaf."""
    if site.op.kind == "conv":
        e = conv_entry(site.path, w, cfg, stride=site.op.stride,
                       pad=site.op.pad, groups=site.op.groups)
    elif site.op.kind == "grouped_matmul":
        e = grouped_matmul_entry(site.path, w, cfg)
    elif w is None:
        e = PlanEntry(site.path, site.op, cfg)
    elif site.stack:
        e = PlanEntry(site.path, site.op, cfg,
                      wck=stacked_weight_checksums_matmul(w, cfg.col_chunk),
                      wlc=stacked_weight_locators_matmul(w, cfg.col_chunk),
                      w_shape=tuple(w.shape), w_dtype=_dtype_name(w.dtype))
    else:
        e = matmul_entry(site.path, w, cfg)
    e.stack = site.stack
    e.w_view = site.w_view
    if w is not None:
        e.w_sum, e.w_asum = _fingerprint_of(w)
    return e


def build_plan(params, arch_cfg, cost_model: Optional[CostModel] = None,
               batch: int = 8, seq: int = DEFAULT_PLAN_SEQ,
               profile_kernels: bool = False,
               calibrate_tau: bool = True,
               device: DeviceLike = None) -> ProtectionPlan:
    """Compile a model-level protection plan (the offline phase).

    `arch_cfg` is a CNNConfig, a transformer ModelConfig or a
    ProtectionSpec. Per site it decides RC/ClC from the SS4.3 cost model
    (conv sites), calibrates the per-layer detection threshold factor from
    the contraction depth, and - when `params` is given - precomputes the
    weight checksums on `device` (the card unless the caller asks for the
    CPU); stage sites are encoded per repeat slice and stored stacked.
    `params=None` builds a policy-only plan.

    `profile_kernels=True` runs the measured calibration pass
    (policy.profile_*_kernel) on `device`: per layer shape it times the
    plain route against the kernel route, both finished to the same
    detection sums, and pins the winner (`use_fused_kernel` +
    `kernel_tiles`) into the entry's config; the timings land in
    `meta["kernel_profile"]`. Transformer GEMM sites profile too (rows =
    batch*`seq`, in float32 as the JAX package profiles them); a matmul
    site that picks the kernel gets its chunking snapped to the tiles.
    Profiles are memoised per distinct (n, k, m) / conv (n, m, e) shape.

    A measured cost model (`cost_model=MeasuredCostModel.from_host()`,
    core.cost_model) prices every decision on this device's roofline:
    * RC/ClC enablement in real seconds, on matmul sites too;
    * detection chunking from `detect_chunk`;
    * the profile_kernels candidates pruned to shapes near the ridge
      (`should_profile`), each pruned site recording its skip reason;
    * direct-path CNN sites get a per-entry `execution` membership:
      compute-bound sites keep their immediate ladder ("per_layer"),
      bandwidth-bound ones ride the deferred carry - ProtectedModel
      (correction="deferred") honours the mix;
    * every verdict persists in `meta["roofline"]`."""
    dev = resolve_device(device)
    spec = protection_spec(arch_cfg, batch=batch, seq=seq)
    base = spec.base
    measured = hasattr(cost_model, "classify")     # MeasuredCostModel
    # mixed execution membership only applies to direct-path model walks
    # (the CNN family): stacked transformer sites merge their carries
    # through the stage loop, which cannot mix report types
    direct_family = spec.meta.get("family") == "cnn"
    entries: Dict[str, PlanEntry] = {}
    kprof: Dict[str, dict] = {}
    roofline: Dict[str, dict] = {}
    prof_cache: Dict[tuple, Any] = {}
    for site in spec.sites:
        w = None
        if params is not None:
            try:
                w = apply_w_view(weight_leaf(params, site.path),
                                 site.w_view)
            except KeyError:
                if site.optional:
                    continue
                raise KeyError(
                    f"build_plan: params have no leaf at {site.path!r} "
                    "(spec/params mismatch)")
            w = w.to(dev)
        cfg = base
        if calibrate_tau and cfg.enabled:
            cfg = cfg.replace(tau_factor=calibrate_tau_factor(site.k_dim))
        if site.op.kind == "conv" and site.shape is not None:
            rc, clc = decide_rc_clc(site.shape, cost_model)
            cfg = cfg.replace(rc_enabled=rc, clc_enabled=clc)
        cls = None
        execution = None
        if measured and site.shape is not None:
            cls = cost_model.classify(site.shape)
            if site.op.kind == "matmul":
                # rung selection in real seconds for GEMM sites too
                rc, clc = decide_rc_clc(site.shape, cost_model)
                cfg = cfg.replace(rc_enabled=rc, clc_enabled=clc)
            chunk = cost_model.detect_chunk(cfg.col_chunk)
            cfg = cfg.replace(row_chunk=chunk, col_chunk=chunk)
            if direct_family and not site.stack:
                execution = ("per_layer" if cls["bound"] == "compute"
                             else "deferred")
        if profile_kernels and cfg.enabled and site.shape is not None:
            s = site.shape
            if measured and not cost_model.should_profile(s):
                kprof[site.path] = {
                    "use_fused": False, "tiles": None, "plain_us": None,
                    "fused_us": None,
                    "skipped": "roofline prune: intensity "
                               f"{cls['intensity']:.2f} outside the "
                               "profile window around ridge "
                               f"{cls['ridge']:.2f}"}
                entries[site.path] = _compile_entry(site, w, cfg, execution)
                roofline[site.path] = _roofline_doc(cls, execution,
                                                    kprof[site.path])
                continue
            if site.op.kind == "conv":
                ckey = ("conv", s.n, s.m, s.h)
                prof = prof_cache.get(ckey)
                if prof is None:
                    prof = profile_conv_detect_kernel((s.n, s.m, s.h, s.h),
                                                      device=dev)
                    prof_cache[ckey] = prof
            else:
                m = w.shape[-1] if w is not None else s.m
                ckey = ("mm", s.n, s.ch, m)
                prof = prof_cache.get(ckey)
                if prof is None:
                    prof = profile_matmul_kernel(s.n, s.ch, m, device=dev)
                    prof_cache[ckey] = prof
            cfg = cfg.replace(use_fused_kernel=prof.use_fused,
                              kernel_tiles=prof.tiles)
            if (prof.use_fused and prof.tiles
                    and site.op.kind == "matmul"):
                # snap chunking to the kernel tiles (the JAX package's
                # single-launch detect path needs chunk == tile)
                cfg = cfg.replace(row_chunk=prof.tiles[0],
                                  col_chunk=prof.tiles[1])
            kprof[site.path] = prof.doc()
        entries[site.path] = _compile_entry(site, w, cfg, execution)
        if cls is not None:
            roofline[site.path] = _roofline_doc(cls, execution,
                                                kprof.get(site.path))
    meta = dict(spec.meta)
    meta["cost_model"] = cost_model_doc(cost_model or CostModel())
    if measured:
        meta["roofline"] = roofline
    if profile_kernels:
        meta["kernel_profile"] = kprof
        if not kprof and entries:
            # only shapeless sites (grouped/moe experts) in this spec -
            # say so instead of letting the caller believe the
            # calibration pass ran
            logging.getLogger("repro_torch.plan").warning(
                "build_plan(profile_kernels=True): no profilable sites "
                "in this spec (every site lacks an OpShape); plan built "
                "without kernel pinning")
    return ProtectionPlan(entries=entries, meta=meta)


def _compile_entry(site: OpSite, w, cfg: ProtectConfig,
                   execution: Optional[str]) -> PlanEntry:
    e = _site_entry(site, w, cfg)
    e.execution = execution
    return e


def _roofline_doc(cls: dict, execution: Optional[str],
                  prof_doc: Optional[dict]) -> dict:
    """One site's persisted roofline verdict: the classification inputs,
    the membership decision it produced, and - when the site was profiled
    - the measured plain/fused timings next to the prediction."""
    doc = {"intensity": cls["intensity"], "ridge": cls["ridge"],
           "bound": cls["bound"], "predicted_us": dict(cls["predicted_us"]),
           "execution": execution}
    if prof_doc is not None:
        doc["measured_us"] = {"plain": prof_doc.get("plain_us"),
                              "fused": prof_doc.get("fused_us")}
        if prof_doc.get("skipped"):
            doc["profile_skipped"] = prof_doc["skipped"]
    return doc


def force_fused_matmul(plan: ProtectionPlan,
                       tiles: Optional[Tuple[int, int, int]] = None
                       ) -> ProtectionPlan:
    """Pin the fused kernel route on every enabled plain-matmul entry
    regardless of any profile; `tiles` overrides the partial
    granularity. Grouped entries keep their route, as the JAX package's
    force_fused_matmul leaves them."""
    entries = {}
    for path, e in plan.entries.items():
        if e.op.kind == "matmul" and e.cfg.enabled:
            cfg = e.cfg.replace(use_fused_kernel=True,
                                kernel_tiles=tiles or e.cfg.kernel_tiles)
            e = dataclasses.replace(e, cfg=cfg)
        entries[path] = e
    return ProtectionPlan(entries=entries, meta=dict(plan.meta))
