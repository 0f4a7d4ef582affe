"""Fault injection (paper SS6.1 'Error injection'); twin of
repro.core.injection.

The paper injects at source level: "randomly corrupt up to 100 elements in
one randomly selected row or column of inputs and output". This module
reproduces that, deterministically from a `torch.Generator`, as a pluggable
*fault-model registry* over the normalised block form O(N, M, P) (P = 1 for
matmul, E*E for conv):

  name                        span                     role
  --------------------------  -----------------------  -------------------
  none                        nothing                  error-free control
  burst_row                   one block-row            SS6.1, rows only
  burst_col                   one block-column         SS6.1, columns only
  burst                       random row or column     SS6.1 as written
  single_flip                 one element              CoC's regime
  scattered                   unconstrained positions  multi-fault regime
  subthreshold                one element, tiny delta  negative control
  weight_corrupt              1..max elements of W     stale-plan regime
  weight_corrupt_correctable  one locator block of W   in-place repair

Models are registered in the JAX package's order, so their `model_id`s are
equal in both packages. Each is a (plan, apply) pair: `plan(generator, n,
m, p, max_elems)` draws a `FaultSpec` and `apply(o3, spec)` materialises
the corruption. A spec's fields are int32/f32 tensors; `stack_specs` gives
them a leading trials axis, and `apply_spec`/`inject` then corrupt a batch
of outputs (o with the same leading axis) in one call.

Magnitudes emulate high-order bit flips (the corrupted value is scaled by
+-2^e, e in [4, 12]); the `subthreshold` model deliberately lives below the
thresholds.py floor to measure false positives of the threshold model.

The pre-registry single-shot helpers (`plan`, `inject_matmul`,
`inject_conv`, `inject_single_block`) keep the JAX package's corruption
patterns. Random streams differ between the packages, so parity with JAX
replays the spec or plan it drew (tests/test_torch_injection.py).

The ambient site-fault hooks (`fault_scope`/`site_fault`) are the serving
drills' seam, consulted by core.plan.protect_site.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import (Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

F32 = torch.float32
I32 = torch.int32


# --------------------------------------------------------------------------
# the fault-model registry
# --------------------------------------------------------------------------

class FaultSpec(NamedTuple):
    """One planned injection, as fixed-shape tensors (or a batch of them,
    each field with a leading trials axis).

    `axis` selects the span the offsets index into:
      0 -> block-row `index`    (span size M*P)
      1 -> block-column `index` (span size N*P)
      2 -> unconstrained        (span size N*M*P, `index` unused = -1)
    Slots >= nelem in `offsets` are ignored. The corruption applied to a
    selected element x is `x * scale + add` (add also carries the relative
    magnitude for the data-dependent subthreshold model).
    """
    model_id: torch.Tensor  # i32 registry id (for reporting)
    axis: torch.Tensor      # i32 in {0, 1, 2}
    index: torch.Tensor     # i32 block row/column (-1 when axis == 2)
    nelem: torch.Tensor     # i32 number of active offset slots
    scale: torch.Tensor     # f32 multiplicative corruption
    add: torch.Tensor       # f32 additive corruption
    offsets: torch.Tensor   # (max_elems,) i32 span-local positions

    def to(self, device) -> "FaultSpec":
        return FaultSpec(*(t.to(device) for t in self))


class FaultModel(NamedTuple):
    name: str
    model_id: int           # stable registration index
    detectable: bool        # should exceed the thresholds.py floor?
    plan: Callable[..., FaultSpec]      # (generator, n, m, p, max_elems)
    apply: Callable[[torch.Tensor, FaultSpec], torch.Tensor]  # (o3, spec)
    # what the spec corrupts: "output" models hit O after the op ran,
    # "weight" models hit W *after* the plan encoded its checksums (the
    # stale-plan / RowHammer regime - plan dims are then W's block dims)
    target: str = "output"
    # can the in-graph ladder restore the oracle output? Output-side
    # schemes cannot fix corrupted weights (runtime.ft reloads or repairs
    # them), so such cells gate on detection only
    correctable: bool = True


FAULT_MODELS: Dict[str, FaultModel] = {}
CONTROL_MODEL = "none"   # the error-free arm every campaign carries


def register_fault_model(name: str, detectable: bool = True,
                         apply: Optional[Callable] = None,
                         target: str = "output",
                         correctable: Optional[bool] = None):
    """Decorator registering `plan_fn(generator, n, m, p, max_elems) ->
    FaultSpec` under `name`. Ids are assigned in registration order.
    `correctable` defaults to True for output models and False for weight
    models. A custom `apply(o3, spec)` receives O as (..., N, M, P) with
    the spec's leading axes in front (see `position_mask`)."""
    if target not in ("output", "weight"):
        raise ValueError(f"unknown fault target {target!r}")

    def deco(plan_fn):
        if name in FAULT_MODELS:
            raise ValueError(f"fault model {name!r} already registered")
        FAULT_MODELS[name] = FaultModel(
            name, len(FAULT_MODELS), detectable, plan_fn,
            apply or apply_spec, target,
            target == "output" if correctable is None else correctable)
        return plan_fn
    return deco


def fault_model_names(include_control: bool = False) -> List[str]:
    return [n for n in FAULT_MODELS
            if include_control or n != CONTROL_MODEL]


def _randint(g: torch.Generator, lo: int, hi: int) -> int:
    """One integer uniform in [lo, hi)."""
    return int(torch.randint(lo, hi, (), generator=g))


def _span_offsets(g: torch.Generator, span: int,
                  max_elems: int) -> torch.Tensor:
    """max_elems distinct positions in [0, span) (wrapping only if the span
    is smaller than max_elems, where full coverage is the right answer)."""
    perm = torch.randperm(span, generator=g).to(I32)
    if span >= max_elems:
        return perm[:max_elems]
    return perm.repeat(math.ceil(max_elems / span))[:max_elems]


def _exponent_scale(g: torch.Generator) -> float:
    """Sign + exponent corruption: +-2^e, e in [4, 12]."""
    e = _randint(g, 4, 13)
    return (1.0 if _randint(g, 0, 2) else -1.0) * 2.0 ** e


def _spec(model_id, axis, index, nelem, scale, add, offsets) -> FaultSpec:
    """Dtype-normalised constructor: every model's spec has the same
    field dtypes, so specs of one cell stack into one batch."""
    return FaultSpec(torch.tensor(model_id, dtype=I32),
                     torch.tensor(axis, dtype=I32),
                     torch.tensor(index, dtype=I32),
                     torch.tensor(nelem, dtype=I32),
                     torch.tensor(scale, dtype=F32),
                     torch.tensor(add, dtype=F32),
                     torch.as_tensor(offsets).to(I32))


def stack_specs(specs: Sequence[FaultSpec]) -> FaultSpec:
    """Specs of one shape as one spec with a leading trials axis."""
    return FaultSpec(*(torch.stack(f) for f in zip(*specs)))


def _lead(spec: FaultSpec) -> int:
    """Number of leading (trials) axes of a spec."""
    return spec.nelem.dim()


def spec_positions(spec: FaultSpec, n: int, m: int, p: int) -> torch.Tensor:
    """Flat indices into O.reshape(N*M*P) for the active offset slots
    (int64, shape (..., max_elems)); inactive slots map to the
    out-of-bounds sentinel N*M*P."""
    total = n * m * p
    off = spec.offsets.to(torch.int64)
    idx = spec.index.to(torch.int64)[..., None]
    ax = spec.axis[..., None]
    slot = torch.arange(off.shape[-1], device=off.device)
    row_pos = idx * (m * p) + off % (m * p)
    off_c = off % (n * p)
    col_pos = (off_c // p) * (m * p) + idx * p + off_c % p
    free_pos = off % total
    pos = torch.where(ax == 0, row_pos,
                      torch.where(ax == 1, col_pos, free_pos))
    return torch.where(slot < spec.nelem[..., None], pos,
                       torch.full_like(pos, total))


def position_mask(spec: FaultSpec, n: int, m: int, p: int) -> torch.Tensor:
    """Boolean mask (..., N*M*P) over O.reshape(..., N*M*P) of the spec's
    target elements. The one place the sentinel semantics live: positions
    scatter into N*M*P + 1 slots and the sentinel's slot is cut off, so
    nothing is ever indexed out of bounds. Custom apply functions should
    build their masks here."""
    pos = spec_positions(spec, n, m, p)
    total = n * m * p
    mask = torch.zeros(pos.shape[:-1] + (total + 1,), dtype=torch.bool,
                       device=pos.device)
    mask.scatter_(-1, pos, True)
    return mask[..., :total]


def _per_trial(x: torch.Tensor, nd: int = 3) -> torch.Tensor:
    """A spec scalar field broadcast against (..., N, M, P)."""
    return x.reshape(x.shape + (1,) * nd)


def apply_spec(o3: torch.Tensor, spec: FaultSpec) -> torch.Tensor:
    """Corrupt O(..., N, M, P) according to the spec (shared by all models
    whose corruption is position + affine; data-dependent models
    override)."""
    n, m, p = o3.shape[-3:]
    mask = position_mask(spec, n, m, p).reshape(o3.shape)
    scale = _per_trial(spec.scale.to(o3.device))
    add = _per_trial(spec.add.to(o3.device))
    corrupted = (o3.to(F32) * scale + add).to(o3.dtype)
    return torch.where(mask, corrupted, o3)


def inject(o: torch.Tensor, spec: FaultSpec,
           model: Optional[FaultModel] = None) -> torch.Tensor:
    """Apply a spec to a matmul O[N,M] or conv O[N,M,E,E] output (or a
    weight, for weight models) through the normalised (N, M, P) block
    form. With a stacked spec, `o` carries the same leading trials axis."""
    apply_fn = model.apply if model is not None else apply_spec
    lead = _lead(spec)
    if o.dim() - lead == 2:
        return apply_fn(o[..., None], spec)[..., 0]
    shp = o.shape[:lead + 2]
    return apply_fn(o.reshape(shp + (-1,)), spec).reshape(o.shape)


# ---- the registered models (in the JAX package's order) -------------------

@register_fault_model(CONTROL_MODEL, detectable=False)
def plan_none(generator: torch.Generator, n: int, m: int, p: int,
              max_elems: int = 100) -> FaultSpec:
    """Error-free control arm: zero active slots, apply is the identity.
    Detections on this arm are by definition false positives."""
    del generator
    return _spec(FAULT_MODELS[CONTROL_MODEL].model_id, 2, -1, 0, 1.0, 0.0,
                 torch.zeros(max_elems, dtype=I32))


def _plan_burst(name: str, g: torch.Generator, n: int, m: int, p: int,
                max_elems: int, axis: Optional[int]) -> FaultSpec:
    ax = _randint(g, 0, 2) if axis is None else axis
    idx = _randint(g, 0, n if ax == 0 else m)
    # nelem is drawn uniform over the *selected* span so rectangular
    # shapes keep the paper's 1..min(max_elems, span) burst distribution
    span = m * p if ax == 0 else n * p
    nelem = _randint(g, 1, min(max_elems, span) + 1)
    scale = _exponent_scale(g)
    return _spec(FAULT_MODELS[name].model_id, ax, idx, nelem, scale, 1.0,
                 _span_offsets(g, span, max_elems))


@register_fault_model("burst_row")
def plan_burst_row(generator, n, m, p, max_elems: int = 100) -> FaultSpec:
    """Up to max_elems corrupted elements confined to one block-row (the
    paper's SS6.1 protocol with the axis pinned; RC's target regime)."""
    return _plan_burst("burst_row", generator, n, m, p, max_elems, 0)


@register_fault_model("burst_col")
def plan_burst_col(generator, n, m, p, max_elems: int = 100) -> FaultSpec:
    """One corrupted block-column (ClC's target regime)."""
    return _plan_burst("burst_col", generator, n, m, p, max_elems, 1)


@register_fault_model("burst")
def plan_burst(generator, n, m, p, max_elems: int = 100) -> FaultSpec:
    """The paper's SS6.1 model as written: a random row OR column."""
    return _plan_burst("burst", generator, n, m, p, max_elems, None)


@register_fault_model("single_flip")
def plan_single_flip(generator, n, m, p, max_elems: int = 100) -> FaultSpec:
    """Exactly one corrupted element anywhere (CoC's single-fault regime)."""
    off = torch.randint(0, n * m * p, (max_elems,), generator=generator)
    return _spec(FAULT_MODELS["single_flip"].model_id, 2, -1, 1,
                 _exponent_scale(generator), 1.0, off)


@register_fault_model("scattered")
def plan_scattered(generator, n, m, p, max_elems: int = 100) -> FaultSpec:
    """2..max_elems corrupted elements at unconstrained positions - the
    multi-fault regime that exercises FC and the recompute fallback."""
    span = n * m * p
    hi = min(max_elems, span)
    nelem = _randint(generator, min(2, hi), hi + 1)
    scale = _exponent_scale(generator)
    return _spec(FAULT_MODELS["scattered"].model_id, 2, -1, nelem, scale,
                 1.0, _span_offsets(generator, span, max_elems))


# relative magnitude of the subthreshold delta: tau_scalar's floor is
# factor * eps_out * ||O||_F (factor defaults to 32), so 0.25 * eps *
# ||O||_F sits 128x below the default threshold - yet it is ~sqrt(N*M)
# ulps of a typical element, so the corruption survives the addition
# instead of rounding away to the identity.
SUBTHRESHOLD_REL = 0.25


def _apply_subthreshold(o3: torch.Tensor, spec: FaultSpec) -> torch.Tensor:
    n, m, p = o3.shape[-3:]
    f = o3.to(F32)
    eps = torch.finfo(o3.dtype if o3.dtype.is_floating_point else F32).eps
    norm = torch.sqrt(torch.sum(f * f, dim=(-3, -2, -1)))
    delta = _per_trial(spec.add.to(o3.device) * eps * norm)
    mask = position_mask(spec, n, m, p).reshape(o3.shape)
    return torch.where(mask, f + delta, f).to(o3.dtype)


@register_fault_model("subthreshold", detectable=False,
                      apply=_apply_subthreshold)
def plan_subthreshold(generator, n, m, p, max_elems: int = 100) -> FaultSpec:
    """Negative control: one element shifted by SUBTHRESHOLD_REL * eps *
    ||O||_F - provably below the thresholds.py detection floor, so a
    detection here is a threshold-model bug, not a catch."""
    off = torch.randint(0, n * m * p, (max_elems,), generator=generator)
    return _spec(FAULT_MODELS["subthreshold"].model_id, 2, -1, 1,
                 1.0, SUBTHRESHOLD_REL, off)


@register_fault_model("weight_corrupt", target="weight")
def plan_weight_corrupt(generator, n, m, p, max_elems: int = 100
                        ) -> FaultSpec:
    """Post-encode weight corruption (the stale-plan / RowHammer regime):
    1..max_elems elements of W flipped at unconstrained positions AFTER
    the plan encoded its checksums. The n/m/p dims here are W's block
    dims ((K, M, 1) for matmul, (M, Ch, R*R) for conv), not O's. The
    in-graph ladder cannot correct it, hence `correctable=False`."""
    span = n * m * p
    nelem = _randint(generator, 1, min(max_elems, span) + 1)
    scale = _exponent_scale(generator)
    return _spec(FAULT_MODELS["weight_corrupt"].model_id, 2, -1, nelem,
                 scale, 1.0, _span_offsets(generator, span, max_elems))


@register_fault_model("weight_corrupt_correctable", target="weight",
                      correctable=True)
def plan_weight_corrupt_correctable(generator, n, m, p,
                                    max_elems: int = 100) -> FaultSpec:
    """Weight corruption confined to ONE locator block - the damage class
    the audit ladder's in-place repair rung (core.weight_repair) must
    solve at 100% with zero checkpoint restores. Matmul (K, M, 1): 1..K
    elements of a single column of W; conv (M, Ch, R*R): 1..Ch*R*R
    elements of a single filter. Values are OVERWRITTEN with +-2^e, e in
    [4, 12] (scale 0)."""
    ax = 1 if p == 1 else 0            # matmul: one column; conv: one filter
    span = n * p if ax == 1 else m * p
    nelem = _randint(generator, 1, min(max_elems, span) + 1)
    idx = _randint(generator, 0, m if ax == 1 else n)
    add = _exponent_scale(generator)
    return _spec(FAULT_MODELS["weight_corrupt_correctable"].model_id,
                 ax, idx, nelem, 0.0, add,
                 _span_offsets(generator, span, max_elems))


# --------------------------------------------------------------------------
# pre-registry single-shot helpers
# --------------------------------------------------------------------------

class InjectionPlan(NamedTuple):
    axis: torch.Tensor      # 0 = corrupt a row, 1 = corrupt a column
    index: torch.Tensor     # which row/column
    nelem: torch.Tensor     # how many elements within it
    scale: torch.Tensor     # multiplicative corruption factor
    offsets: torch.Tensor   # element positions within the row/column


def plan(generator: torch.Generator, n: int, m: int, max_elems: int = 100,
         axis: Optional[int] = None) -> InjectionPlan:
    ax = _randint(generator, 0, 2) if axis is None else int(axis)
    idx = _randint(generator, 0, n if ax == 0 else m)
    span = int(min(max_elems, max(n, m)))
    nelem = _randint(generator, 1, span + 1)
    # exponent-style corruption: multiply by 2^e, e in [4, 12]
    scale = _exponent_scale(generator)
    offsets = torch.randperm(max(n, m), generator=generator)[:span]
    return InjectionPlan(torch.tensor(ax, dtype=I32),
                         torch.tensor(idx, dtype=I32),
                         torch.tensor(nelem, dtype=I32),
                         torch.tensor(scale, dtype=F32), offsets.to(I32))


def inject_matmul(o: torch.Tensor, p: InjectionPlan) -> torch.Tensor:
    """Corrupt O[N,M] according to the plan (row- or column-confined)."""
    n, m = o.shape
    dev = o.device
    rows = torch.arange(n, device=dev)[:, None]
    cols = torch.arange(m, device=dev)[None, :]
    axis, index = p.axis.to(dev), p.index.to(dev)
    k = torch.minimum(p.nelem.to(dev),
                      torch.where(axis == 0, m, n).to(p.nelem.dtype))
    sel = torch.zeros(max(n, m), dtype=torch.bool, device=dev)
    sel[p.offsets.to(dev).long()] = (
        torch.arange(p.offsets.shape[0], device=dev) < k)
    in_row = (rows == index) & sel[:m][None, :]
    in_col = (cols == index) & sel[:n][:, None]
    mask = torch.where(axis == 0, in_row, in_col)
    corrupted = o * p.scale.to(dev, o.dtype) + torch.ones((), dtype=o.dtype,
                                                          device=dev)
    return torch.where(mask, corrupted, o)


def inject_conv(o: torch.Tensor, p: InjectionPlan) -> torch.Tensor:
    """Corrupt one block-row or block-column of O[N,M,E,E]: up to nelem
    distinct payload elements of every block of that row/column (the
    paper's corrupted row/column with multiple soft errors). The payload
    positions are a permutation drawn from a generator seeded by the
    block index, so at least one element is always hit."""
    n, m, e1, e2 = o.shape
    dev = o.device
    o3 = o.reshape(n, m, e1 * e2)
    pe = e1 * e2
    index = int(p.index)
    perm = torch.randperm(pe, generator=torch.Generator().manual_seed(index))
    pay = torch.zeros(pe, dtype=torch.bool)
    pay[perm] = torch.arange(pe) < max(min(int(p.nelem), pe), 1)
    pay = pay.to(dev)
    row_mask = (torch.arange(n, device=dev)[:, None, None] == index) \
        & pay[None, None, :]
    col_mask = (torch.arange(m, device=dev)[None, :, None] == index) \
        & pay[None, None, :]
    mask = row_mask if int(p.axis) == 0 else col_mask
    corrupted = o3 * p.scale.to(dev, o.dtype) + torch.ones(
        (), dtype=o.dtype, device=dev)
    return torch.where(mask, corrupted, o3).reshape(o.shape)


def inject_single_block(o: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        scale: float = 512.0, *,
                        block: Optional[Tuple[int, int]] = None
                        ) -> torch.Tensor:
    """Corrupt one block O[i][j] (CoC's regime): the element of a matmul,
    every payload element of a conv block. The block is drawn from
    `generator` unless `block=(i, j)` names it."""
    n, m = o.shape[0], o.shape[1]
    if block is None:
        block = (_randint(generator, 0, n), _randint(generator, 0, m))
    i, j = (int(b) for b in block)
    out = o.clone()
    if o.dim() == 2:
        out[i, j] = out[i, j] * scale
        out[i, j] = out[i, j] + 1.0
        return out
    out[i, j] = (o[i, j] * scale + 1.0).to(o.dtype)
    return out


# --------------------------------------------------------------------------
# ambient site-fault hooks (serving drills)
# --------------------------------------------------------------------------
#
# The campaign injects through protect_op(..., o=o_bad) on one isolated op;
# a serving drill needs the fault to land inside a full forward at one
# named plan path, so end-to-end per-request attribution can be tested.
# `fault_scope` registers a hook keyed by the exact param-tree path;
# core.plan.protect_site consults it and routes the corrupted output
# through the ordinary `o=` injection seam, so detection and the
# correction ladder see exactly what a campaign cell sees. Hooks fire at
# every call of the site inside the scope, in every repeat of a stage path.

Hook = Callable[[torch.Tensor], torch.Tensor]

_SITE_FAULTS: contextvars.ContextVar[Tuple[Tuple[str, Hook], ...]] = \
    contextvars.ContextVar("repro_torch_site_faults", default=())


@contextlib.contextmanager
def fault_scope(path: str, fn: Hook) -> Iterator[None]:
    """Corrupt the raw output of the protected matmul site at `path`
    (exact match against core.plan.current_path) with `fn(o) -> o_bad`.
    `o` arrives in the call site's natural shape (e.g. (B, S, V) for the
    LM head), so a hook can target one batch row or one position, and can
    leave a call alone by its shape (`o.shape[1] > 1` selects prefill)."""
    token = _SITE_FAULTS.set(_SITE_FAULTS.get() + ((path, fn),))
    try:
        yield
    finally:
        _SITE_FAULTS.reset(token)


def site_fault(path: str) -> Optional[Hook]:
    """Innermost registered hook for `path`, or None."""
    for p, fn in reversed(_SITE_FAULTS.get()):
        if p == path:
            return fn
    return None
