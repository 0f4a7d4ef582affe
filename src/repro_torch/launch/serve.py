"""Batched serving entry point - a thin shim over repro_torch.serving
(twin of repro.launch.serve).

`serve()` drives the async `ServingDriver` (bounded admission + the
controller/runner split, the deployment shape) and returns the tokens
array and summary stats, plus the full per-request report under
"report". Pass ``driver=False`` to route through the synchronous
`ProtectedSession` instead. It runs on the card unless `device="cpu"`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch \
      smollm-360m-smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import repro_torch.configs as C
import repro_torch.core as ft
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.serving import ProtectedSession, ServingDriver


def serve(arch: str, batch: int, prompt_len: int, gen: int, seed: int = 0,
          audit_every: int = 0, driver: bool = True,
          device: DeviceLike = None):
    cfg = C.get(arch)
    dev = resolve_device(device)
    # one generator for the params, a second for the prompts (a shared
    # stream would correlate the weights with the traffic)
    params = init_params(cfg, generator=torch.Generator().manual_seed(seed),
                         device=dev)
    max_len = prompt_len + gen
    tok_shape = ((batch, prompt_len, cfg.num_codebooks) if cfg.num_codebooks
                 else (batch, prompt_len))
    prompts = torch.randint(
        0, cfg.vocab_size, tok_shape,
        generator=torch.Generator().manual_seed(seed + 1)).numpy()

    plan = (ft.build_plan(params, cfg, batch=batch, seq=max_len, device=dev)
            if cfg.abft else None)
    t0 = time.time()
    if driver:
        d = ServingDriver(params, cfg, plan, slots=batch, max_len=max_len,
                          audit_every=audit_every,
                          queue_capacity=max(batch * 4, 8), device=dev)
        try:
            rids = [d.submit(prompts[i], max_new_tokens=gen).rid
                    for i in range(batch)]
            report = d.drain()
            tokens = {r: d.tokens_for(r) for r in rids}
        finally:
            d.close()
    else:
        sess = ProtectedSession(params, cfg, plan, slots=batch,
                                max_len=max_len, audit_every=audit_every,
                                device=dev)
        rids = [sess.submit(prompts[i], max_new_tokens=gen)
                for i in range(batch)]
        report = sess.run()
        tokens = {r: sess.tokens_for(r) for r in rids}
    wall = time.time() - t0

    tokens_out = np.stack([np.asarray(tokens[r], np.int32) for r in rids])
    recs = {r["id"]: r for r in report["requests"]}
    # prefill time = admission->first-token spans; decode is the rest of
    # the wall
    t_prefill = sum(recs[r]["ttft_s"] or 0.0 for r in rids)
    t_decode = max(wall - t_prefill, 0.0)
    prefill_detected = sum(recs[r]["prefill_detected"] for r in rids)
    return tokens_out, {
        "prefill_s": t_prefill, "decode_s": t_decode,
        # every emitted token counts, including each prefill's argmax
        "tok_per_s": batch * gen / max(wall, 1e-9),
        "prefill_detected": prefill_detected,
        "faults_detected": report["counters"]["faults_detected"],
        "report": report,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--sync", action="store_true",
                    help="use the synchronous ProtectedSession loop")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the card)")
    args = ap.parse_args(argv)
    toks, stats = serve(args.arch, args.batch, args.prompt_len, args.gen,
                        driver=not args.sync, device=args.device)
    rep = stats["report"]
    print(f"generated {toks.shape} tokens; "
          f"tok/s={stats['tok_per_s']:.1f} "
          f"ttft_p50={rep['ttft_p50_s']:.3f}s "
          f"faults={stats['faults_detected']}")


if __name__ == "__main__":
    main()
