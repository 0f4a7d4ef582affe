"""Campaign CLI (twin of repro.campaign.run):

    python -m repro_torch.campaign.run --trials 1000 --layers matmul,conv \
        --schemes full --out campaign.json [--device cpu]

Prints one CSV row per cell as it completes (name,us_per_call,derived)
and writes the `repro.campaign/v1` JSON artifact described in report.py.
Exit status is non-zero if any detectable-fault cell misses 100%
detection, if the control arm shows false positives, or if any
correction-mode cell leaves residual faults. It runs on the card unless
`--device` names another device.
"""
from __future__ import annotations

import argparse
import sys

from ..core import injection as inj
from .engine import LAYER_CASES, SCHEME_CONFIGS, run_campaign
from .report import CampaignResult


def _csv(arg: str):
    return [s for s in arg.split(",") if s]


def check(result: CampaignResult, min_correction: float = 0.99) -> list:
    """The acceptance gates (paper SS6: ABFT detects and corrects the
    injected soft errors). Returns a list of human-readable violations."""
    bad = []
    for c in result.cells:
        name = f"{c.layer}/{c.scheme}/{c.fault}"
        # fault models absent from this process's registry (e.g. custom
        # models from the campaign that wrote the artifact) get only the
        # registry-independent gates (residual)
        known = c.fault in inj.FAULT_MODELS
        detectable = known and inj.FAULT_MODELS[c.fault].detectable
        if c.fault == inj.CONTROL_MODEL and c.false_positive_rate > 0:
            bad.append(f"{name}: false_positive_rate="
                       f"{c.false_positive_rate:.4f} (want 0)")
        elif known and not detectable and c.detection_rate > 0:
            # negative-control arms (e.g. subthreshold) sit provably below
            # the detection floor: any detection is a threshold-model bug
            bad.append(f"{name}: detection_rate={c.detection_rate:.4f} "
                       "on an undetectable arm (want 0)")
        if detectable and c.detection_rate < 1.0:
            bad.append(f"{name}: detection_rate={c.detection_rate:.4f} "
                       "(want 1.0)")
        # correction gates only apply where in-graph correction is the
        # contract: not in detect-only serving mode, and not for arms the
        # ladder cannot fix by construction (weight_corrupt: the fix is
        # reloading weights, runtime.ft's job)
        correctable = (not known) or inj.FAULT_MODELS[c.fault].correctable
        weight_arm = known and inj.FAULT_MODELS[c.fault].target == "weight"
        if c.scheme != "detect" and correctable:
            # weight-correctable arms are scored by the audit ladder's
            # in-place repair rung, whose contract is absolute: 100%
            # recovery, and zero trials escalating to a checkpoint
            # restore (residual encodes "would restore" there)
            want = 1.0 if weight_arm else min_correction
            if detectable and c.correction_rate < want:
                bad.append(f"{name}: correction_rate="
                           f"{c.correction_rate:.4f} "
                           f"(want >= {want})")
            if c.residual_rate > 0:
                bad.append(f"{name}: residual_rate={c.residual_rate:.4f} "
                           "(want 0)"
                           + (" - repair escalated to restore"
                              if weight_arm else ""))
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.campaign.run",
        description="fault-injection campaign over the protected ops")
    ap.add_argument("--trials", type=int, default=1000,
                    help="trials per cell (default 1000)")
    ap.add_argument("--layers", type=_csv, default=["matmul", "conv"],
                    help=f"comma list of {sorted(LAYER_CASES)}")
    ap.add_argument("--schemes", type=_csv, default=["full"],
                    help=f"comma list of {sorted(SCHEME_CONFIGS)}")
    ap.add_argument("--faults", type=_csv, default=None,
                    help="comma list of fault models (default: all "
                         "registered); the error-free control arm always "
                         "rides along")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-elems", type=int, default=100,
                    help="paper SS6.1: corrupt up to this many elements")
    ap.add_argument("--out", default="campaign.json",
                    help="JSON artifact path (default campaign.json)")
    ap.add_argument("--no-check", action="store_true",
                    help="emit the artifact without the pass/fail gates")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs on the host)")
    args = ap.parse_args(argv)

    if args.trials < 1:
        ap.error(f"--trials must be >= 1, got {args.trials}")
    for layer in args.layers:
        if layer not in LAYER_CASES:
            ap.error(f"unknown layer {layer!r} (have {sorted(LAYER_CASES)})")
    for scheme in args.schemes:
        if scheme not in SCHEME_CONFIGS:
            ap.error(f"unknown scheme {scheme!r} "
                     f"(have {sorted(SCHEME_CONFIGS)})")
    for fault in args.faults or []:
        if fault not in inj.FAULT_MODELS:
            ap.error(f"unknown fault model {fault!r} "
                     f"(have {sorted(inj.FAULT_MODELS)})")

    print("name,us_per_call,derived", flush=True)
    result = run_campaign(layers=args.layers, schemes=args.schemes,
                          faults=args.faults, trials=args.trials,
                          seed=args.seed, max_elems=args.max_elems,
                          progress=lambda c: print(c.row(), flush=True),
                          device=args.device)
    result.save(args.out)
    print(f"# wrote {args.out} "
          f"({len(result.cells)} cells x {args.trials} trials, "
          f"{result.meta['wall_seconds']:.1f}s)", flush=True)

    if not args.no_check:
        violations = check(result)
        for v in violations:
            print(f"# FAIL {v}", file=sys.stderr, flush=True)
        return 1 if violations else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
