"""Campaign result tables (twin of repro.campaign.report; the paper's SS6
shape: one cell per (layer, scheme, fault model), rates over thousands of
trials).

JSON schema, shared with the JAX package (stable keys; an artifact written
by either package loads in the other):

{
  "schema": "repro.campaign/v1",
  "meta": {"trials": int, "seed": int, "max_elems": int,
           "torch_version": str, "device": str, "wall_seconds": float},
  "cells": [
    {"layer": "matmul", "scheme": "full", "fault": "burst_row",
     "trials": 1000,
     "detection_rate": 1.0,        # P(detected | this arm)
     "correction_rate": 0.999,     # P(output == oracle within tol)
     "residual_rate": 0.0,         # P(inconsistency survived the ladder)
     "false_positive_rate": 0.0,   # only meaningful on the "none" arm
     "recompute_rate": 0.004,      # P(ladder fell through to recompute)
     "corrected_by": {"coc": 412, "rc": 96, ...},   # trial counts
     "max_abs_err": 3.1e-5,        # vs the kernels/ref.py oracle
     "wall_seconds": 1.8}
  ]
}

The JAX package writes `jax_version` where the port writes
`torch_version` and `device`; the meta is free-form, the cells are not.
The "none" fault arm is the error-free control: its detection_rate IS the
false-positive rate of the detector. The "subthreshold" arm is the
negative control: detections there are threshold-model bugs.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np

from ..core import CONTROL_MODEL, scheme_histogram
from ..core.types import RECOMPUTE

SCHEMA = "repro.campaign/v1"


@dataclasses.dataclass
class CellResult:
    layer: str
    scheme: str
    fault: str
    trials: int
    detection_rate: float
    correction_rate: float
    residual_rate: float
    false_positive_rate: float
    recompute_rate: float
    corrected_by: Dict[str, int]
    max_abs_err: float
    wall_seconds: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def row(self) -> str:
        """benchmarks/run.py CSV shape: name,us_per_call,derived."""
        us = self.wall_seconds / max(self.trials, 1) * 1e6
        derived = (f"det={self.detection_rate:.4f};"
                   f"corr={self.correction_rate:.4f};"
                   f"resid={self.residual_rate:.4f};"
                   f"fp={self.false_positive_rate:.4f}")
        return (f"campaign/{self.layer}/{self.scheme}/{self.fault},"
                f"{us:.1f},{derived}")


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x).reshape(-1)


def summarize_cell(layer: str, scheme: str, fault: str,
                   detected, corrected_by, residual, corrected, max_err,
                   wall_seconds: float = 0.0) -> CellResult:
    """Aggregate per-trial arrays (numpy or tensors) into one table cell."""
    det, by, res = _host(detected), _host(corrected_by), _host(residual)
    corr, err = _host(corrected), _host(max_err)
    trials = det.shape[0]
    detection_rate = float(det.mean()) if trials else 0.0
    return CellResult(
        layer=layer, scheme=scheme, fault=fault, trials=trials,
        detection_rate=detection_rate,
        correction_rate=float(corr.mean()) if trials else 0.0,
        residual_rate=float(res.mean()) if trials else 0.0,
        false_positive_rate=detection_rate if fault == CONTROL_MODEL else 0.0,
        recompute_rate=float((by == RECOMPUTE).mean()) if trials else 0.0,
        corrected_by=scheme_histogram(by),
        max_abs_err=float(err.max()) if trials else 0.0,
        wall_seconds=wall_seconds,
    )


@dataclasses.dataclass
class CampaignResult:
    cells: List[CellResult]
    meta: Dict

    def to_dict(self) -> dict:
        return {"schema": SCHEMA, "meta": self.meta,
                "cells": [c.to_dict() for c in self.cells]}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    @staticmethod
    def load(path: str) -> "CampaignResult":
        with open(path) as f:
            raw = json.load(f)
        if raw.get("schema") != SCHEMA:
            raise ValueError(f"unknown campaign schema {raw.get('schema')!r}")
        return CampaignResult(
            cells=[CellResult(**c) for c in raw["cells"]],
            meta=raw["meta"])

    def cell(self, layer: str, scheme: str, fault: str
             ) -> Optional[CellResult]:
        for c in self.cells:
            if (c.layer, c.scheme, c.fault) == (layer, scheme, fault):
                return c
        return None
