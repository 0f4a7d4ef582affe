"""Time the sharded session's decode step of one tree on the card, to
compare two versions of the mesh's serving path on one card.

For the chip_smoke.py and the port under TREE (this checkout, or another
commit unpacked with `git archive` into a gitignored directory of it,
such as build/parent), serves phase 17a's cell twice on each rank: Yi-9B
at chip_smoke.YI_LAYERS layers, full width, bf16, params drawn on the
card from the seed, the plan pinned to the kernels, 16 requests over 8
slots, deferred, on a (2, 2) mesh of four gloo ranks that share the one
card (launch.mesh.run_ranks). Prints one JSON line: each rank's median
decode-step ms of each session, and a digest of rank 0's served tokens
(equal digests: the same tokens). Each tree builds its kernels into its
own build/. Run the trees in turns in one call, since a card's power
limit and its host's load differ between calls:

    for t in build/parent . . build/parent; do
        python3 tools/time_mesh_decode.py $t; done
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import sys
import time

# the ranks are spawned: they import this file again and find the tree
# through the environment
TREE = os.path.abspath(os.environ.setdefault(
    "TIME_MESH_DECODE_TREE", sys.argv[1] if len(sys.argv) > 1 else "."))
sys.path[:0] = [TREE, os.path.join(TREE, "src")]

import chip_smoke as CS  # noqa: E402

SESSIONS = 2


def rank_fn(rank: int) -> list:
    import torch
    from repro_torch import configs, core
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as M
    torch.cuda.set_device(0)
    mesh = make_host_mesh(*CS.YI_MESH, backend="gloo", device=CS.DEVICE)
    cfg = configs.get(CS.YI_ARCH).replace(num_layers=CS.YI_LAYERS)
    params = M.init_params(
        cfg, generator=torch.Generator(device=CS.DEVICE).manual_seed(
            CS.SEED), device=CS.DEVICE)
    plan = core.force_fused_matmul(core.build_plan(
        params, cfg, batch=CS.SLOTS, seq=CS.MAX_LEN, device=CS.DEVICE))
    prompts = CS.serve_prompts(cfg, CS.N_REQ, CS.SEED + 3)
    out = []
    for _ in range(SESSIONS):
        s, rids, _, ms = CS._mesh_session(params, cfg, plan, prompts,
                                          CS.GEN, mesh)
        out.append({"ms": ms, "tokens": [s.tokens_for(r) for r in rids]})
        del s
    return out


def main() -> int:
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_ranks
    _build.build_all()
    t0 = time.perf_counter()
    ranks = run_ranks(rank_fn, math.prod(CS.YI_MESH), "gloo",
                      CS.MESH_TIMEOUT_S)
    tokens = json.dumps(ranks[0][0]["tokens"]).encode()
    print(json.dumps({
        "tree": TREE,
        "decode_ms": [[s["ms"] for s in r] for r in ranks],
        "tokens_sha256": hashlib.sha256(tokens).hexdigest()[:16],
        "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
