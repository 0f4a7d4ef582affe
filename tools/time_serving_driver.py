"""Time the async ServingDriver against the synchronous ProtectedSession on
the card, on chip_smoke.py phase 6's serving cell.

For the port under TREE (this checkout, or another commit unpacked with
`git archive` into a gitignored directory of it, such as build/parent),
serves phase 6's 16 requests (full-width bf16 SmolLM-360M from its seed,
8 slots, 256 positions, deferred, the kernels pinned, 32 new tokens each)
four ways, in turns, ROUNDS rounds: the session on the main thread, the
same session on a worker thread, and the driver at sync_lag 1 and 0. Per
serve it records the decode step period (median ms between consecutive
decode launches), the median dispatch ms of the session's decode log
(the session: launch to the next tokens on the host; the driver: launch
to the forward's return), TTFT p50 and the wall seconds, and prints one
JSON line with every serve and the card's name and power limit:

    python3 tools/time_serving_driver.py . [ROUNDS]
"""
from __future__ import annotations

import json
import statistics
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(tree: str, rounds: int = 2) -> int:
    src = Path(tree).resolve() / "src"
    if not (src / "repro_torch").is_dir():
        print(f"time_serving_driver: no port under {src}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(src), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("time_serving_driver: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch import configs, core
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as M
    from repro_torch.serving import ProtectedSession, ServingDriver
    _build.build_all()
    cfg = configs.get(C.SERVE_ARCH)
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(C.SEED),
                           device="cuda")
    plan = core.force_fused_matmul(core.build_plan(
        params, cfg, batch=C.SLOTS, seq=C.MAX_LEN, device="cuda"))
    prompts = C.serve_prompts(cfg, C.N_REQ, C.SEED + 3)

    def session():
        s = ProtectedSession(params, cfg, plan, slots=C.SLOTS,
                             max_len=C.MAX_LEN, device="cuda")
        for p in prompts:
            s.submit(p, max_new_tokens=C.GEN)
        return s, s.run()

    def session_in_thread():
        box = {}
        t = threading.Thread(target=lambda: box.update(out=session()))
        t.start()
        t.join()
        return box["out"]

    def driver(lag):
        def serve():
            d = ServingDriver(params, cfg, plan, slots=C.SLOTS,
                              max_len=C.MAX_LEN, sync_lag=lag, device="cuda")
            try:
                for p in prompts:
                    d.submit(p, max_new_tokens=C.GEN)
                report = d.drain(timeout=900)
            finally:
                d.close()
            return d, report
        return serve

    ways = {"session": session, "session_in_thread": session_in_thread,
            "driver_lag1": driver(1), "driver_lag0": driver(0)}
    keys, out = list(ways), {k: [] for k in ways}
    for r in range(rounds):
        for k in keys[r % len(keys):] + keys[:r % len(keys)]:
            t0 = time.perf_counter()
            obj, report = ways[k]()
            log = obj.stats.decode_log
            out[k].append({
                "period_ms": C.step_period_ms(log),
                "dispatch_ms": statistics.median(e["dispatch_s"] * 1e3
                                                 for e in log),
                "ttft_p50_ms": report["ttft_p50_s"] * 1e3,
                "wall_s": time.perf_counter() - t0, "steps": len(log)})
    print(json.dumps({"tree": tree, "card": C.nvidia_smi(), "serves": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else ".",
                  int(sys.argv[2]) if len(sys.argv) > 2 else 2))
