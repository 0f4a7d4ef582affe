"""Shared types for the ABFT core (twin of repro.core.types).

Scheme enum values follow the escalation order of the paper's multischeme
workflow (Fig. 7): CoC-D detects; CoC -> RC/ClC -> FC correct; full
recompute is the last resort.

Verdict fields are Python ints where the host already knows them (every
correction gate reads its flag on the host) and 0-d tensors where they
stay on the device (the detect-only carry of the deferred workflow).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

NONE = 0          # no fault detected
COC = 1           # corrected by checksum-of-checksums
RC = 2            # corrected by row checksum scheme
CLC = 3           # corrected by column checksum scheme
FC = 4            # corrected by full checksum scheme
CHECKSUM_REFRESH = 5  # detection was caused by a corrupted checksum; output clean
RECOMPUTE = 6     # recomputed the whole operation
W_REPAIR = 7      # at-rest weight corruption repaired in place

SCHEME_NAMES = {
    NONE: "none", COC: "coc", RC: "rc", CLC: "clc", FC: "fc",
    CHECKSUM_REFRESH: "checksum_refresh", RECOMPUTE: "recompute",
    W_REPAIR: "w_repair",
}


def _vmax(a, b):
    """max of two verdict fields, each an int or a 0-d tensor; stays on
    the device (no host read) when either side is a tensor."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.maximum(torch.as_tensor(a), torch.as_tensor(b))
    return max(a, b)


def _vmax_all(values):
    out = values[0]
    for v in values[1:]:
        out = _vmax(out, v)
    return out


class FaultReport(NamedTuple):
    """Verdict of one protected op."""
    detected: Any      # 1 if CoC-D flagged the op
    corrected_by: Any  # scheme enum that resolved it
    residual: Any      # 1 if inconsistency survived all schemes

    @staticmethod
    def clean() -> "FaultReport":
        return FaultReport(0, 0, 0)

    @staticmethod
    def merge(a: "FaultReport", b: "FaultReport") -> "FaultReport":
        return FaultReport(_vmax(a.detected, b.detected),
                           _vmax(a.corrected_by, b.corrected_by),
                           _vmax(a.residual, b.residual))


class DetectEvidence(NamedTuple):
    """Compact CoC-D carry of one protected op in detect-only execution:
    the flag (0-d int32) and the evidence strength (0-d f32, max
    |C - S| / tau, +inf on non-finite values), both left on the device so
    a deferred forward reads all of them in one host transfer."""
    flag: torch.Tensor
    score: torch.Tensor

    @staticmethod
    def clean() -> "DetectEvidence":
        return DetectEvidence(torch.zeros((), dtype=torch.int32),
                              torch.zeros((), dtype=torch.float32))

    @staticmethod
    def merge(a: "DetectEvidence", b: "DetectEvidence") -> "DetectEvidence":
        return DetectEvidence(_vmax(a.flag, b.flag), _vmax(a.score, b.score))


def clean_report(mode: Optional[str] = None):
    """Identity element for verdict merging in a given protect mode."""
    return DetectEvidence.clean() if mode == "detect_only" \
        else FaultReport.clean()


def merge_verdicts(a, b):
    """Merge two per-op carries of the SAME kind (ModelReports collapse to
    their scalar view first)."""
    if isinstance(a, ModelReport):
        a = a.merged()
    if isinstance(b, ModelReport):
        b = b.merged()
    if isinstance(a, DetectEvidence) or isinstance(b, DetectEvidence):
        if not (isinstance(a, DetectEvidence)
                and isinstance(b, DetectEvidence)):
            raise TypeError(
                "merge_verdicts: cannot mix DetectEvidence with "
                f"FaultReport ({type(a).__name__} vs {type(b).__name__}); "
                "a detect-only pass must stay detect-only end to end")
        return DetectEvidence.merge(a, b)
    return FaultReport.merge(a, b)


def _host_int(v) -> int:
    return int(np.max(np.asarray(v.detach().cpu()))) \
        if isinstance(v, torch.Tensor) else int(v)


def scheme_histogram(corrected_by) -> dict:
    """Histogram of a batched `corrected_by` field: scheme name -> count
    (every scheme appears, zero counts included)."""
    if isinstance(corrected_by, torch.Tensor):
        corrected_by = corrected_by.detach().cpu().numpy()
    arr = np.asarray(corrected_by).reshape(-1)
    return {name: int((arr == val).sum())
            for val, name in SCHEME_NAMES.items()}


class ModelReport:
    """Per-layer fault verdicts of one model pass. The merged-scalar view
    (`detected` / `corrected_by` / `residual`) is the max over layers.
    `mode` records the correction regime that produced the verdicts.
    `world_clean` is True where a deferred pass's one read showed no
    flag on any rank of the ambient mesh (on this rank alone without
    one), so every rank's verdict is clean; None where that is not
    known."""

    def __init__(self, by_layer: Optional[Mapping[str, Any]] = None,
                 mode: str = "per_layer",
                 world_clean: Optional[bool] = None):
        self.by_layer: Dict[str, Any] = dict(by_layer or {})
        self.mode = mode
        self.world_clean = world_clean

    def add(self, name: str, rep) -> "ModelReport":
        out = dict(self.by_layer)
        if isinstance(rep, ModelReport):
            for sub, r in rep.by_layer.items():
                out[f"{name}/{sub}"] = r
        else:
            out[name] = rep
        return ModelReport(out, mode=self.mode)

    def merge(self, other: "ModelReport") -> "ModelReport":
        out = dict(self.by_layer)
        for name, r in other.by_layer.items():
            out[name] = FaultReport.merge(out[name], r) if name in out else r
        return ModelReport(out, mode=self.mode)

    def __getitem__(self, name: str):
        return self.by_layer[name]

    def __len__(self) -> int:
        return len(self.by_layer)

    def layers(self) -> Tuple[str, ...]:
        return tuple(self.by_layer)

    def merged(self):
        if not self.by_layer:
            return FaultReport.clean()
        reps = list(self.by_layer.values())
        if isinstance(reps[0], DetectEvidence):
            return DetectEvidence(_vmax_all([r.flag for r in reps]),
                                  _vmax_all([r.score for r in reps]))
        return FaultReport(_vmax_all([r.detected for r in reps]),
                           _vmax_all([r.corrected_by for r in reps]),
                           _vmax_all([r.residual for r in reps]))

    @property
    def detected(self):
        return self.merged().detected

    @property
    def corrected_by(self):
        return self.merged().corrected_by

    @property
    def residual(self):
        return self.merged().residual

    def scheme_histogram(self) -> dict:
        return scheme_histogram(np.asarray(
            [_host_int(r.corrected_by) for r in self.by_layer.values()],
            dtype=np.int32))

    def summary(self) -> dict:
        """Host-side {layer: {detected, corrected_by, residual}} table."""
        return {name: {"detected": _host_int(r.detected),
                       "corrected_by": SCHEME_NAMES[
                           _host_int(r.corrected_by)],
                       "residual": _host_int(r.residual)}
                for name, r in self.by_layer.items()}

    def __repr__(self) -> str:
        return f"ModelReport({list(self.by_layer)}, mode={self.mode!r})"


def as_fault_report(rep):
    """Normalise FaultReport | ModelReport to the scalar FaultReport view."""
    return rep.merged() if isinstance(rep, ModelReport) else rep


@dataclasses.dataclass(frozen=True)
class ProtectConfig:
    """Static configuration of a protected op; field for field the JAX
    package's, so plan JSON written by either package loads in the other."""
    enabled: bool = True
    rc_enabled: bool = True
    clc_enabled: bool = True
    fc_enabled: bool = True
    row_chunk: int = 1024
    col_chunk: int = 1024
    tau_factor: float = 32.0
    detect_weighted: bool = True
    protect_backward: bool = True
    detect_only: bool = False
    # route O's summations through the CUDA kernels (kernels/ops.py)
    use_fused_kernel: bool = False
    # Pallas interpret flag of the JAX package: kept so its plans load,
    # and has no effect here
    kernel_interpret: Optional[bool] = None
    # (bm, bn, bk) partial granularity pinned by a plan; None = the
    # shape-derived defaults
    kernel_tiles: Optional[Tuple[int, int, int]] = None

    def __post_init__(self):
        if isinstance(self.kernel_tiles, list):
            object.__setattr__(self, "kernel_tiles", tuple(self.kernel_tiles))

    def replace(self, **kw) -> "ProtectConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = ProtectConfig()


class OutputSums(NamedTuple):
    """The seven output summations S_o1..S_o7 plus the sum of squares, in
    the normalised block form: O is (N, M, P)."""
    s1: torch.Tensor  # (M, P)  sum_n O[n,m]
    s2: torch.Tensor  # (N, P)  sum_m O[n,m]
    s3: torch.Tensor  # (M, P)  sum_n n*O[n,m]
    s4: torch.Tensor  # (N, P)  sum_m m*O[n,m]
    s5: torch.Tensor  # (P,)    sum_nm O
    s6: torch.Tensor  # (P,)    sum_nm n*O
    s7: torch.Tensor  # (P,)    sum_nm m*O
    sumsq: torch.Tensor  # ()   sum_nmp O^2 (threshold scale)


class OutputChecksums(NamedTuple):
    """Checksum-side predictions C_o1..C_o7 (paper Eq. 6); c6 is the
    n-weighted invariant and c7 the m-weighted one."""
    c1: Optional[torch.Tensor]
    c2: Optional[torch.Tensor]
    c3: Optional[torch.Tensor]
    c4: Optional[torch.Tensor]
    c5: torch.Tensor
    c6: torch.Tensor
    c7: torch.Tensor
