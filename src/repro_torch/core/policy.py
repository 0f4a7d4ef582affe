"""Layerwise RC/ClC enablement (paper SS4.3); twin of the analytic part of
repro.core.policy.

The paper profiles t0 = t(CoC+FC), t1 = t(CoC+RC), t2 = t(CoC+RC+FC) per
layer offline and enables RC iff the expected saving p_r*(t0-t1) exceeds
the expected penalty p_c*(t2-t0), with p_r/p_c estimated from the operand
element counts. This module instantiates the paper's analytic runtime
model (Table 4) with alpha (compute) and beta (memory) coefficients.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class OpShape:
    """Shape of one protected op in the paper's notation."""
    n: int    # fmap blocks (batch / block-rows)
    m: int    # kernel blocks (out-channels / block-cols)
    ch: int   # contraction channels
    r: int = 1
    h: int = 1  # spatial extent (1 for matmul; conv: H ~ E)

    @property
    def d_elems(self) -> int:
        return self.n * self.ch * self.h * self.h

    @property
    def w_elems(self) -> int:
        return self.m * self.ch * self.r * self.r


@dataclasses.dataclass
class CostModel:
    alpha: float = 1.0   # per conv MAC (compute-bound coefficient)
    beta: float = 0.2    # per element moved (memory-bound coefficient)

    # paper Table 4 runtimes (kernel checksums precomputed)
    def t_fc(self, s: OpShape) -> float:
        a = self.alpha * (s.n + s.m) * s.ch * s.r ** 2 * s.h ** 2
        b = self.beta * (s.n * s.ch * s.h ** 2 + 2 * s.n * s.m * s.h ** 2)
        return a + b

    def t_rc(self, s: OpShape) -> float:
        a = self.alpha * 2 * s.m * s.ch * s.r ** 2 * s.h ** 2
        b = self.beta * (2 * s.n * s.ch * s.h ** 2 + 2 * s.n * s.m * s.h ** 2)
        return a + b

    def t_clc(self, s: OpShape) -> float:
        a = self.alpha * 2 * s.n * s.ch * s.r ** 2 * s.h ** 2
        b = self.beta * (2 * s.n * s.m * s.h ** 2)
        return a + b

    def t_coc(self, s: OpShape) -> float:
        a = self.alpha * 3 * s.ch * s.r ** 2 * s.h ** 2
        b = self.beta * (2 * s.n * s.ch * s.h ** 2 + 3 * s.n * s.m * s.h ** 2)
        return a + b


def row_col_probabilities(s: OpShape) -> Tuple[float, float]:
    """p_r / p_c from operand sizes (paper: p_r/p_c = |D| / |W|)."""
    d, w = s.d_elems, s.w_elems
    tot = d + w
    return d / tot, w / tot


def decide_rc_clc(s: OpShape, model: Optional[CostModel] = None
                  ) -> Tuple[bool, bool]:
    """Enable RC (and symmetrically ClC) iff expected saving > penalty."""
    model = model or CostModel()
    p_r, p_c = row_col_probabilities(s)
    t_coc = model.t_coc(s)
    t0 = t_coc + model.t_fc(s)
    t1 = t_coc + model.t_rc(s)
    t2 = t1 + model.t_fc(s)
    rc = p_r * max(t0 - t1, 0.0) > p_c * (t2 - t0)
    t1c = t_coc + model.t_clc(s)
    t2c = t1c + model.t_fc(s)
    clc = p_c * max(t0 - t1c, 0.0) > p_r * (t2c - t0)
    return rc, clc


def cost_model_doc(model: CostModel) -> dict:
    """Persistable description of a cost model: class name + parameters,
    in the layout of repro.core.cost_model.cost_model_doc."""
    return {"class": type(model).__name__, "alpha": model.alpha,
            "beta": model.beta,
            "params": {"alpha": model.alpha, "beta": model.beta}}
