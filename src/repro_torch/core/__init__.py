"""ABFT core: checksum schemes + the multischeme workflow for convolution
and matmul, the offline-compiled ProtectionPlan API with its measured
roofline cost model and kernel profiles, the fault-model registry and the
at-rest weight repair (twin of repro.core: the CNN and transformer
slices)."""
from . import checksums, cost_model, injection, plan, policy, protected
from . import schemes
from . import thresholds, types, weight_repair, workflow
from .checksums import (WeightLocators, weight_locators_conv,
                        weight_locators_matmul)
from .cost_model import (HostPeaks, MeasuredCostModel, cost_model_doc,
                         measure_peaks)
from .injection import (CONTROL_MODEL, FAULT_MODELS, FaultModel, FaultSpec,
                        fault_model_names, register_fault_model)
from .plan import (W_VIEWS, OpSite, OpSpec, PlanEntry, PlanStaleError,
                   ProtectionPlan, ProtectionSpec, ambient_mode, ambient_plan,
                   apply_w_view, apply_w_view_inv, build_plan,
                   calibrate_tau_factor,
                   conv_entry, correct_op, current_path, entry_overrides,
                   force_fused_matmul, matmul_entry, path_scope, plan_scope,
                   protect_op, protect_site, protection_spec, resolve_entry,
                   stacked_weight_checksums_matmul,
                   stacked_weight_locators_matmul, weight_leaf)
from .policy import (CostModel, KernelProfile, OpShape, calibrate,
                     decide_rc_clc, profile_conv_detect_kernel,
                     profile_matmul_kernel)
from .protected import (WeightChecksums, abft_matmul_vjp, pick_chunk,
                        protect_matmul_output, protected_conv,
                        protected_matmul, weight_checksums_matmul)
from .types import (CHECKSUM_REFRESH, CLC, COC, DEFAULT_CONFIG, FC, NONE, RC,
                    RECOMPUTE, SCHEME_NAMES, W_REPAIR, DetectEvidence,
                    FaultReport, ModelReport, ProtectConfig, as_fault_report,
                    clean_report, merge_verdicts, scheme_histogram)
from .workflow import ProtectedModel, run_deferred, run_ladder

__all__ = [
    "checksums", "cost_model", "injection", "plan", "policy", "protected",
    "schemes", "thresholds", "types", "weight_repair", "workflow",
    "HostPeaks", "MeasuredCostModel", "cost_model_doc", "measure_peaks",
    "CONTROL_MODEL", "FAULT_MODELS", "FaultModel", "FaultSpec",
    "fault_model_names", "register_fault_model",
    "WeightLocators", "weight_locators_conv", "weight_locators_matmul",
    "W_VIEWS", "OpSite", "OpSpec", "PlanEntry", "PlanStaleError",
    "ProtectionPlan", "ProtectionSpec", "ambient_mode", "ambient_plan",
    "apply_w_view", "apply_w_view_inv", "build_plan",
    "calibrate_tau_factor", "conv_entry",
    "correct_op", "current_path", "entry_overrides", "force_fused_matmul",
    "matmul_entry", "path_scope", "plan_scope", "protect_op", "protect_site",
    "protection_spec", "resolve_entry", "stacked_weight_checksums_matmul",
    "stacked_weight_locators_matmul", "weight_leaf",
    "CostModel", "KernelProfile", "OpShape", "calibrate", "decide_rc_clc",
    "profile_conv_detect_kernel", "profile_matmul_kernel",
    "WeightChecksums", "abft_matmul_vjp", "pick_chunk",
    "protect_matmul_output",
    "protected_conv", "protected_matmul", "weight_checksums_matmul",
    "CHECKSUM_REFRESH", "CLC", "COC", "DEFAULT_CONFIG", "FC", "NONE", "RC",
    "RECOMPUTE", "SCHEME_NAMES", "W_REPAIR", "DetectEvidence", "FaultReport",
    "ModelReport", "ProtectConfig", "as_fault_report", "clean_report",
    "merge_verdicts", "scheme_histogram",
    "ProtectedModel", "run_deferred", "run_ladder",
]
