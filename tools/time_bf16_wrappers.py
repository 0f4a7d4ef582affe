"""Time the port's bf16 wrappers of one tree on the card, to compare two
versions of the bf16 GEMM kernel on one card.

For the port under TREE (this checkout, or another commit unpacked with
`git archive` into a gitignored directory of it, such as build/parent),
prints one JSON line: the device µs per launch of abft_matmul_detect and
abft_matmul at every SmolLM-360M GEMM shape at 8 and 128 rows, timed as
chip_smoke.py phase 3b times them (one CUDA graph over copies of the
inputs, cold in L2), a digest of both wrappers' outputs at each shape
(equal digests: bitwise equal results on the same seeded inputs), and the
host µs of one wrapper call at the decode wq shape. Each tree builds its kernels into its own build/. Run the trees in
turns in one call, since a card's power limit and its host's load differ
between calls:

    for t in build/parent . . build/parent; do
        python3 tools/time_bf16_wrappers.py $t; done
"""
from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(tree: str) -> int:
    src = Path(tree).resolve() / "src"
    if not (src / "repro_torch").is_dir():
        print(f"time_bf16_wrappers: no port under {src}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(src), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("time_bf16_wrappers: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch import fp32_ieee
    from repro_torch.core.plan import calibrate_tau_factor
    from repro_torch.core.protected import pick_chunk
    from repro_torch.core.thresholds import tau_scalar_coeffs
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import abft_matmul as AM
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(C.SEED)
    bf16 = torch.bfloat16
    us = {}
    with torch.no_grad(), fp32_ieee():
        for n in C.TIMED_ROWS:
            for label, k, m, transposed, _ in C.SERVE_SITES:
                d = torch.randn((n, k), generator=gen, device="cuda").to(bf16)
                store = (torch.randn((m, k) if transposed else (k, m),
                                     generator=gen, device="cuda")
                         * k ** -0.5).to(bf16)
                view = (lambda t: t.T) if transposed else (lambda t: t)
                rb, cb = pick_chunk(n, 1024), pick_chunk(m, 1024)
                bm, bn = ops._tile(rb, 256), ops._tile(cb, 256)
                cs, _ = C.exact_chunk_checksums(d, view(store), rb, cb)
                ta, tb = tau_scalar_coeffs(k, bf16, calibrate_tau_factor(k))
                outs = [*AM.abft_matmul_detect(d, view(store), *cs, rb, cb, ta,
                                               tb)]
                o, parts = AM.abft_matmul(d, view(store), bm, bn)
                digest = hashlib.sha256()
                for t in outs + [o, *parts[:3]]:
                    digest.update(t.contiguous().view(torch.uint8).cpu()
                                  .numpy().tobytes())
                args = C.copies([d, store] + cs)
                det = C.time_device(lambda a, b, *c: AM.abft_matmul_detect(
                    a, view(b), *c, rb, cb, ta, tb), args)
                mm = C.time_device(lambda a, b, *c: AM.abft_matmul(
                    a, view(b), bm, bn), args)
                us[f"{label} {n}"] = {"detect": det * 1e3,
                                      "abft_matmul": mm * 1e3,
                                      "digest": digest.hexdigest()[:16]}
                del args
    print(json.dumps({"tree": tree, "card": C.nvidia_smi(),
                      "device_us": us,
                      "host_us": C.wrapper_host_us(AM)}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
