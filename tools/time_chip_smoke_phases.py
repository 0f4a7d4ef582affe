"""Run one tree's chip_smoke.py on the card with a timer around each of its
phases, to compare the phase times of two versions of the script.

For the chip_smoke.py under TREE (this checkout, or another commit unpacked
with `git archive` into a gitignored directory of it, such as
build/parent), wraps each phase function that the tree's script has
(phases 3, 3b-3h, 4-5b, 6-7b, 8, 9, 10, 11, 12-17; the build
is timed as phase 2; where the campaign runs in child processes beside
phases 6-7b, "8-start" is their start and "8" the wait for them and the
checks), runs the script's main with `--json OUT` when OUT is
given (the script is loaded as the module `chip_smoke` with TREE first on
sys.path, so the mesh ranks of phase 17, processes of their own, import
the same file), and prints, after the script's own output, one JSON line {"tree":
..., "phase_s": {phase: seconds}, "rc": exit code}. A failing phase is
timed to its failure. Both trees build their kernels into their own
build/:

    python3 tools/time_chip_smoke_phases.py build/parent \\
        build/parent_phases.json
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

# phase label -> the function of chip_smoke.py that runs it
PHASES = (("3", "check_checksum_reduce"), ("3", "check_abft_matmul"),
          ("3b", "check_serving_kernels"), ("3c", "check_mamba_kernels"),
          ("3d", "check_rg_kernels"), ("3e", "check_musicgen_kernels"),
          ("3f", "check_moe_kernels"), ("3g", "check_kimi_kernels"),
          ("3h", "check_yi_shard_kernels"),
          ("3i", "check_rec_shard_kernels"), ("17-18", "run_mesh_phase"),
          ("4-5b", "run_slice"),
          ("8-start", "start_campaign"), ("6-7b", "run_serving"),
          ("8", "run_campaign_phase"),
          ("9", "run_calibrated_plan"), ("10", "run_driver_phase"),
          ("11", "run_training_phase"), ("12", "run_mamba_serving"),
          ("13", "run_rg_serving"), ("14", "run_musicgen_serving"),
          ("15", "run_moe_serving"), ("16", "run_block_training"))


def main(tree: str, out: str = "") -> int:
    root = Path(tree).resolve()
    out = str(Path(out).resolve()) if out else ""
    script = root / "chip_smoke.py"
    if not script.is_file():
        print(f"time_chip_smoke_phases: no chip_smoke.py under {root}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", script)
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    phase_s = {}

    def timed(label, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                phase_s[label] = (phase_s.get(label, 0.0)
                                  + time.perf_counter() - t0)
        return run

    for label, name in PHASES:
        if hasattr(cs, name):
            setattr(cs, name, timed(label, getattr(cs, name)))
    os.chdir(root)
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build
    _build.build_all = timed("2", _build.build_all)
    try:
        rc = cs.main(["--json", out] if out else [])
    except SystemExit as e:
        rc = e.code
    print(json.dumps({"tree": str(tree), "phase_s": phase_s, "rc": rc}))
    return 0 if rc in (0, None) else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
