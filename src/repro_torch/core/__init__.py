"""ABFT core: checksum schemes + the multischeme workflow for convolution
and matmul, and the offline-compiled ProtectionPlan API (twin of
repro.core: the CNN and transformer slices)."""
from . import checksums, injection, plan, policy, protected, schemes
from . import thresholds, types, workflow
from .checksums import (WeightLocators, weight_locators_conv,
                        weight_locators_matmul)
from .plan import (W_VIEWS, OpSite, OpSpec, PlanEntry, PlanStaleError,
                   ProtectionPlan, ProtectionSpec, ambient_mode, ambient_plan,
                   apply_w_view, build_plan, calibrate_tau_factor,
                   conv_entry, correct_op, current_path, entry_overrides,
                   force_fused_matmul, matmul_entry, path_scope, plan_scope,
                   protect_op, protect_site, protection_spec, resolve_entry,
                   stacked_weight_checksums_matmul,
                   stacked_weight_locators_matmul, weight_leaf)
from .policy import CostModel, OpShape, cost_model_doc, decide_rc_clc
from .protected import (WeightChecksums, pick_chunk, protect_matmul_output,
                        protected_conv, protected_matmul,
                        weight_checksums_matmul)
from .types import (CHECKSUM_REFRESH, CLC, COC, DEFAULT_CONFIG, FC, NONE, RC,
                    RECOMPUTE, SCHEME_NAMES, W_REPAIR, DetectEvidence,
                    FaultReport, ModelReport, ProtectConfig, as_fault_report,
                    clean_report, merge_verdicts, scheme_histogram)
from .workflow import ProtectedModel, run_deferred, run_ladder

__all__ = [
    "checksums", "injection", "plan", "policy", "protected", "schemes",
    "thresholds", "types", "workflow",
    "WeightLocators", "weight_locators_conv", "weight_locators_matmul",
    "W_VIEWS", "OpSite", "OpSpec", "PlanEntry", "PlanStaleError",
    "ProtectionPlan", "ProtectionSpec", "ambient_mode", "ambient_plan",
    "apply_w_view", "build_plan", "calibrate_tau_factor", "conv_entry",
    "correct_op", "current_path", "entry_overrides", "force_fused_matmul",
    "matmul_entry", "path_scope", "plan_scope", "protect_op", "protect_site",
    "protection_spec", "resolve_entry", "stacked_weight_checksums_matmul",
    "stacked_weight_locators_matmul", "weight_leaf",
    "CostModel", "OpShape", "cost_model_doc", "decide_rc_clc",
    "WeightChecksums", "pick_chunk", "protect_matmul_output",
    "protected_conv", "protected_matmul", "weight_checksums_matmul",
    "CHECKSUM_REFRESH", "CLC", "COC", "DEFAULT_CONFIG", "FC", "NONE", "RC",
    "RECOMPUTE", "SCHEME_NAMES", "W_REPAIR", "DetectEvidence", "FaultReport",
    "ModelReport", "ProtectConfig", "as_fault_report", "clean_report",
    "merge_verdicts", "scheme_histogram",
    "ProtectedModel", "run_deferred", "run_ladder",
]
