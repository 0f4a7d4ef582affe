"""Fault-injection campaign subsystem (twin of repro.campaign): batched
draws, per-trial protected ops, differential oracles, and the paper's SS6
result tables (see engine.py / report.py)."""
from .engine import (LAYER_CASES, SCHEME_CONFIGS, TOL_REL, CampaignEngine,
                     ConvCase, MatmulCase, TransformerGemmCase, TrialOutcome,
                     run_campaign, score)
from .report import SCHEMA, CampaignResult, CellResult, summarize_cell

__all__ = [
    "LAYER_CASES", "SCHEME_CONFIGS", "TOL_REL", "CampaignEngine",
    "ConvCase", "MatmulCase", "TransformerGemmCase", "TrialOutcome",
    "run_campaign", "score",
    "SCHEMA", "CampaignResult", "CellResult", "summarize_cell",
]
