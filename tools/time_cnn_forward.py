"""Time the protected ResNet-18 forward of one tree's port on the card, to
compare two versions of the CNN path on one card.

For the port under TREE (this checkout, or another commit unpacked with
`git archive` into a gitignored directory of it, such as build/parent),
prints one JSON line: the median host milliseconds of the forward that
chip_smoke.py phase 4 times (ResNet-18 width 1.0, img 224, batch 8,
random weights from its seed), unprotected and protected in both
correction modes with the kernels pinned on and off, taken in turns
(chip_smoke.time_host), and the median host µs of one conv's detect_sums
call inside the kernel-route forward. Each tree builds its kernels into
its own build/. Run the trees in turns in one call, since a card's power
limit and its host's load differ between calls:

    for t in build/parent . . build/parent; do
        python3 tools/time_cnn_forward.py $t; done
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(tree: str) -> int:
    src = Path(tree).resolve() / "src"
    if not (src / "repro_torch").is_dir():
        print(f"time_cnn_forward: no port under {src}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(src), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("time_cnn_forward: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch import core
    from repro_torch.core import checksums
    from repro_torch.kernels import _build
    from repro_torch.models import cnn
    _build.build_all()
    cfg = cnn.resnet18(1.0)
    params = cnn.init_cnn(cfg, generator=torch.Generator().manual_seed(C.SEED),
                          device="cuda")
    x = torch.randn((C.BATCH, 3, C.IMG, C.IMG),
                    generator=torch.Generator().manual_seed(C.SEED + 1)
                    ).to("cuda")
    plan = core.build_plan(params, cfg, batch=C.BATCH, device="cuda")
    fused = C.pin_fused(plan)
    off = dataclasses.replace(cfg, abft=False)

    def fwd(p, mode="per_layer"):
        return lambda: cnn.forward_cnn(params, x, cfg, plan=p, correction=mode)

    ms = C.time_host({"unprotected": lambda: cnn.forward_cnn(params, x, off),
                      "per_layer": fwd(fused),
                      "deferred": fwd(fused, "deferred"),
                      "per_layer_unfused": fwd(plan),
                      "deferred_unfused": fwd(plan, "deferred")}, reps=20)
    # one conv's detect_sums on the kernel route, from a span around it
    spans, inner = [], checksums.detect_sums

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return inner(*a, **kw)
        finally:
            spans.append((time.perf_counter() - t0) * 1e6)

    checksums.detect_sums = timed
    try:
        for _ in range(5):
            fwd(fused)()
        torch.cuda.synchronize()
    finally:
        checksums.detect_sums = inner
    print(json.dumps({"tree": tree, "card": C.nvidia_smi(),
                      "forward_ms": ms,
                      "detect_sums_us": statistics.median(spans)}),
          flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
