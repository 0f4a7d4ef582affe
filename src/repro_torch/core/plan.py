"""Offline-compiled, model-level protection plans (twin of the CNN part of
repro.core.plan).

    plan = build_plan(params, cnn_cfg, batch=8)      # offline, once
    plan.save("plan.json")                           # JSON + sibling .npz
    plan = ProtectionPlan.load("plan.json")
    plan.validate(params)                            # stale plans fail
    logits, report = forward_cnn(params, x, cnn_cfg, plan=plan)

A plan maps param-tree paths to `PlanEntry`s: the op geometry (`OpSpec`),
the SS4.3 policy decision (a `ProtectConfig`) and the precomputed weight
checksums. The file format is the JAX package's `repro.plan/v1`, so a plan
saved by either package loads in the other; locator sums stay host numpy
float64.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import math
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from . import checksums as C
from .policy import CostModel, OpShape, cost_model_doc, decide_rc_clc
from .protected import (WeightChecksums, protect_matmul_output,
                        protected_conv, protected_matmul,
                        weight_checksums_matmul)
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
    stack: int = 0
    w_view: Optional[str] = None
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
    raise NotImplementedError(
        f"protect_op: op kind {op.kind!r} is not ported yet")


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
                w = weight_leaf(params, name)
            except KeyError:
                problems.append(f"{name}: not found in params")
                continue
            if e.w_view is not None:
                problems.append(f"{name}: weight view {e.w_view!r} is not "
                                "ported")
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


def protection_spec(arch_cfg, batch: int = 8) -> ProtectionSpec:
    """The ProtectionSpec of a models.cnn.CNNConfig (or a spec as is)."""
    if isinstance(arch_cfg, ProtectionSpec):
        return arch_cfg
    if hasattr(arch_cfg, "convs"):
        return _cnn_spec(arch_cfg, batch)
    raise TypeError(
        "protection_spec expects a CNNConfig (.convs) or a ProtectionSpec "
        f"(transformer configs are not ported yet); got "
        f"{type(arch_cfg).__name__}")


# --------------------------------------------------------------------------
# the offline compiler
# --------------------------------------------------------------------------

def _fingerprint_of(w) -> Tuple[float, float]:
    w32 = w.detach().to(torch.float32)
    return float(torch.sum(w32)), float(torch.sum(torch.abs(w32)))


def _site_entry(site: OpSite, w, cfg: ProtectConfig) -> PlanEntry:
    """Compile one OpSite against its (possibly absent) weight leaf."""
    if site.op.kind == "conv":
        e = conv_entry(site.path, w, cfg, stride=site.op.stride,
                       pad=site.op.pad, groups=site.op.groups)
    elif w is None:
        e = PlanEntry(site.path, site.op, cfg)
    else:
        e = matmul_entry(site.path, w, cfg)
    e.stack = site.stack
    e.w_view = site.w_view
    if w is not None:
        e.w_sum, e.w_asum = _fingerprint_of(w)
    return e


def build_plan(params, arch_cfg, cost_model: Optional[CostModel] = None,
               batch: int = 8, calibrate_tau: bool = True,
               device: DeviceLike = None) -> ProtectionPlan:
    """Compile a model-level protection plan (the offline phase).

    Per site it decides RC/ClC from the SS4.3 analytic cost model (conv
    sites), calibrates the per-layer detection threshold factor from the
    contraction depth, and - when `params` is given - precomputes the
    weight checksums on `device` (the card unless the caller asks for the
    CPU). `params=None` builds a policy-only plan. Profiling the kernels
    and the measured roofline cost model are not ported yet."""
    dev = resolve_device(device)
    spec = protection_spec(arch_cfg, batch=batch)
    base = spec.base
    entries: Dict[str, PlanEntry] = {}
    for site in spec.sites:
        w = None
        if params is not None:
            try:
                w = weight_leaf(params, site.path)
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
        entries[site.path] = _site_entry(site, w, cfg)
    meta = dict(spec.meta)
    meta["cost_model"] = cost_model_doc(cost_model or CostModel())
    return ProtectionPlan(entries=entries, meta=meta)


def force_fused_matmul(plan: ProtectionPlan,
                       tiles: Optional[Tuple[int, int, int]] = None
                       ) -> ProtectionPlan:
    """Pin the fused kernel route on every enabled plain-matmul entry
    regardless of any profile; `tiles` overrides the partial
    granularity."""
    entries = {}
    for path, e in plan.entries.items():
        if e.op.kind == "matmul" and e.cfg.enabled:
            cfg = e.cfg.replace(use_fused_kernel=True,
                                kernel_tiles=tiles or e.cfg.kernel_tiles)
            e = dataclasses.replace(e, cfg=cfg)
        entries[path] = e
    return ProtectionPlan(entries=entries, meta=dict(plan.meta))
