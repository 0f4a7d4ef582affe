#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card, end to end.

    python3 chip_smoke.py [--json PATH]

Phases, each fatal on failure:
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build: nvcc builds every kernel under src/repro_torch/kernels/csrc;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the shapes ResNet-18 (width 1.0, img 224, batch 8) gives it, with
     its median time (CUDA events), the plain version's time, one PyTorch
     library call's time where one computes the same function, and the
     bound (the larger of bytes / 3.35 TB/s and flops / 67 TFLOP/s fp32):
     at each conv view the conv detection sums (the main path's launch),
     on O and on O rounded to bf16, beside the tile-partials entry point
     and the two PyTorch calls of the plain detection pass; the fc's
     abft_matmul and abft_matmul_detect; torch.profiler's count of device
     kernels in one conv-sums call and one f32 detect call (one each);
  3b. the serving path's kernels at every GEMM shape of a SmolLM-360M
     decode step (8 rows) and of every prefill bucket (16, 32, 64, 128
     rows), in bf16 (the tied head's weight read in place as the
     transposed embedding table), with the tiling the CUDA source chose:
     abft_matmul_detect against its plain version (flags exact, clear on
     exact checksums, exactly one chunk on a c5, c6 or c7 shifted by 10
     tau), its O bitwise equal to abft_matmul's, abft_matmul on bf16
     against its plain version; at 8 and 128 rows times beside
     torch.matmul and the bound (bf16 peak 989 TFLOP/s; the fp32-FMA
     bound beside it); the host us of one call of each wrapper at the
     decode wq shape;
  4. the slice: build_plan + forward_cnn on that ResNet-18 in per_layer
     and deferred mode with the kernels pinned (use_fused_kernel=True):
     zero clean flags, bitwise clean-path contracts, allclose to the
     port's own CPU run, 17 checksum_reduce + 1 abft_matmul launches and
     18 / 1 host reads per forward, median forward times (taken in
     turns), the host time of each layer of the kernel route (timing
     spans around the port's functions) and a torch.profiler trace;
  5. injected faults (conv5: one element; conv13: a burst over channels
     of one image at one payload position): detected, corrected, no
     residual, logits back to the clean ones, in both modes;
  5b. the paper's error-injected overhead: a `burst` fault drawn by the
     port's registry (up to 100 elements of one block-row or column,
     +-2^e) injected at each of the 17 convs in turn, with the plan as
     built and with RC/ClC off (Fig. 10b), each in per_layer and deferred
     mode: detected, no residual, no other layer flagged, logits back
     within rtol 1e-4; 17 conv-sums launches per faulted forward; the
     median faulted forward per layer timed in turns with the unprotected
     and the clean protected one, the error-injected overhead (mean over
     layers of the faulted medians / the unprotected median - 1) and the
     scheme histogram;
  6. the serving slice: SmolLM-360M at full width in bf16 (random params
     from a seed), a ProtectedSession of 8 slots and 256 positions in
     deferred mode with the kernels pinned, serving 16 requests (prompts
     of 16-128 tokens, 32 new tokens each): every request completes, zero
     flags, 225 abft_matmul_detect launches and 1 host read per forward;
     per_layer serves the first 8 requests' first 8 tokens bitwise alike;
     a teacher-forced check against the unprotected forward (every
     served token's reference logit within 0.1 of the reference's top);
     median decode-step ms and TTFT p50 of the unprotected session and
     the protected one with the kernels off and on, three rounds in
     turns, and a torch.profiler trace of one decode step of each;
  7. serving drills: +1e4 at one logit of slot 3 at every decode step
     (the tied head) and +1e3 at one element of a stage's wq in every
     prefill and repeat: detected, corrected, attributed to the right
     requests, no residual, tokens equal to the clean run's;
  7b. the serving weight audit: sessions with audit_every=1 and a
     restore_fn; one column of one repeat of a stage's wq overwritten
     between two steps is repaired in place (verdict `repaired`, no
     restore, the leaf bitwise clean), two corrupted blocks are restored;
     tokens equal to the clean run's; the audit's and the repair's ms;
  8. the campaign on the card: matmul and conv, scheme full, every
     registered fault arm, 1000 trials per cell (the paper's grid), and
     every layer x scheme x arm at 200: every gate of
     repro_torch.campaign.run.check, deferred == full per arm, and one
     cell per layer (64 trials per arm) against the port's own CPU run
     (no detected or residual mismatch; corrected_by may differ only
     between two correcting verdicts, in at most 1% of the trials);
     CSV rows and us per trial;
  9. the calibrated plan on phase 4's ResNet-18: the card's peaks measured
     (an IEEE-fp32 8192^3 GEMM and a 256 MiB-per-array triad; each within
     105% of the datasheet), the measured-roofline plan
     (MeasuredCostModel, profile_kernels=True: each site's intensity,
     bound, execution membership, profiled or pruned) and the analytic
     plan with every shape profiled (plain and kernel-route us, the
     winner, the tiling the CUDA source chose); the measured plan in
     deferred mode: zero clean flags, logits bitwise the unprotected
     ones, one host read per per_layer member plus one, a registry burst
     at a per_layer and at a deferred member detected and corrected; the
     new plans' launches per forward, their forwards timed in turns with
     the unprotected one and phase 4's pinned plan (error-free overhead);
     the profile's decisions for SmolLM-360M at batch 8 x seq 128;
  10. the async ServingDriver on phase 6's model, plan and 16 requests:
     every request completes with phase 6's tokens, 225 detect launches
     and 1 host read per forward; backpressure (capacity 4: 12 of 16
     rejected, the 4 accepted served) and a lapsed deadline (timeout,
     never a slot); phase 7's head drill under a fault_scope around
     submit/drain, attributed to slot 3's request only; phase 7b's
     one-column corruption repaired in place by the controller's audit
     while requests are admitted; the driver and the session timed in
     turns, three rounds (decode step period, TTFT p50).
It then prints the card's name and power limit, one {"kernels": [...]}
line, and as the last line {"ok": true, "device": {...}}. `--json PATH`
also writes the run's details (per-shape kernel times, per-layer scores,
profiles, serving counters and timings) to PATH. Without a CUDA card, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
SEED = 0
BATCH, IMG = 8, 224
# the serving slice: SmolLM-360M at full width, bf16
SERVE_ARCH = "smollm-360m"
SLOTS, MAX_LEN = 8, 256
N_REQ, GEN, PROMPT_LENS = 16, 32, (16, 128)
# trials per cell of the campaign's whole grid (3 layers x 5 schemes x
# every arm); the paper grid runs 1000
GRID_TRIALS = 200
# card vs CPU, the campaign's 64 trials per arm and layer: the share of
# trials whose corrected_by may differ (which rung first verifies a fix
# hangs on the order of a sum, ROADMAP 3.4); 9 of 1,728 were seen
RUNG_MISMATCH_SHARE = 0.01
DELTA = 0.1                    # teacher-forced logit margin
DEVICE = "cuda"
# (label, K, M, W read transposed, launches per forward) of the distinct
# GEMM shapes of one SmolLM-360M forward: 32 layers of wq/wo, wk/wv,
# gate/up and down, then the tied head read in place
SERVE_SITES = (("wq/wo", 960, 960, False, 64), ("wk/wv", 960, 320, False, 64),
               ("gate/up", 960, 2560, False, 64),
               ("down", 2560, 960, False, 32),
               ("head", 960, 49152, True, 1))
# the row counts the session gives them: a decode step's slots and the
# prefill buckets; all are checked, the first and last also timed
SERVE_ROWS = (SLOTS, 16, 32, 64, 128)
TIMED_ROWS = (SLOTS, 128)


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi exited {r.returncode}: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def copies(tensors, min_bytes: float = 128e6, most: int = 256):
    """Enough copies of the input tensors that a round over them reads
    from device memory, not from the 50 MB L2."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    k = int(min(most, max(2, -(-min_bytes // size))))
    return [tuple(t.clone() for t in tensors) for _ in range(k)]


def time_device(fn, args_list, rounds: int = 5) -> float:
    """Device milliseconds per call of fn(*args): one call per entry of
    args_list, captured into one CUDA graph so that no host overhead sits
    between the launches; median over `rounds` replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in args_list[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in args_list:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / len(args_list))
    del graph
    return statistics.median(per_call)


def time_turns(fns: dict, reps: int = 10, warmup: int = 2) -> dict:
    """Milliseconds of each fn() + synchronize on the host clock, `reps`
    samples each. The functions take turns within each round, in an
    order rotated from round to round, so that a drift of the shared host
    falls on all of them alike."""
    import torch
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    keys, times = list(fns), {k: [] for k in fns}
    for r in range(reps):
        for k in keys[r % len(keys):] + keys[:r % len(keys)]:
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return times


def time_host(fns: dict, reps: int = 10, warmup: int = 2) -> dict:
    """Median milliseconds of each fn() + synchronize (time_turns)."""
    return {k: statistics.median(v)
            for k, v in time_turns(fns, reps, warmup).items()}


def bound_ms(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# --------------------------------------------------------------------------

def conv_output_shapes(cfg):
    """(N, M, E, E) of every conv output of the forward, in order."""
    shapes, img = [], cfg.img
    for spec in cfg.convs:
        e = (img + 2 * spec.pad - spec.kernel) // spec.stride + 1
        shapes.append((BATCH, cfg.scaled(spec.out_ch), e, e))
        img = e // spec.pool if spec.pool else e
    return shapes


def device_kernels(fn) -> dict:
    """The device kernels one call of fn launches, by name, with their
    counts (torch.profiler, after a warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("Activity Buffer")}


def check_checksum_reduce(cfg, gen, report):
    """At each conv view: the conv detection sums (one launch, what the
    main path runs) on O and on O rounded to bf16 against their plain
    version, and, through ops.conv_detect_sums, against the plain
    detection pass; the tile-partials entry point on both against its
    plain version. Times per view and per forward: the conv sums, the tile
    partials alone and finished by PyTorch ops as PR 13's main path did,
    the conv sums' plain version, and the two PyTorch calls of the plain
    detection pass (enc @ O, torch.dot)."""
    import torch
    from repro_torch.kernels import checksum_reduce as CR
    from repro_torch.kernels import ops
    from repro_torch.core import checksums as C
    shapes = conv_output_shapes(cfg)
    names = ("s5", "s6", "s7", "sumsq")
    rows, err_all = [], 0.0
    tot = {k: 0.0 for k in ("ms", "partials_ms", "route_ms", "plain_ms",
                            "library_ms", "bytes", "flops")}
    for shape in sorted(set(shapes), key=shapes.index):
        count = shapes.count(shape)
        layer = shapes.index(shape)
        n, m, e1, e2 = shape
        p = e1 * e2
        o4 = torch.randn(shape, generator=gen, device="cuda")
        o2 = o4.reshape(n * m, p)
        bm, bn = ops.conv_tiles(m, p, on_card=True)
        errs = {}
        for dt, x in (("f32", o4), ("bf16", o4.to(torch.bfloat16))):
            # the tile partials: fp32 reassociation over at most bm*bn terms
            got = CR.checksum_reduce(x.reshape(n * m, p), bm, bn, segments=n)
            want = CR.checksum_reduce_plain(x.reshape(n * m, p), bm, bn,
                                            segments=n)
            torch.cuda.synchronize()
            for name, g, w in zip(("colsum", "rowsum", "sumsq", "wcolsum"),
                                  got, want):
                err = max_err(g, w) if g.shape == w.shape else float("inf")
                tol = 1e-5 * (float(w.abs().max()) + 1.0)
                if not err <= tol:
                    fail(f"checksum_reduce {dt} {shape} {name}: max |err| "
                         f"{err:.3g} > {tol:.3g} (shape {tuple(g.shape)} vs "
                         f"plain {tuple(w.shape)})")
                errs[f"partials_{dt}_{name}"] = err
            # the conv sums: reassociation over up to N*M terms per payload
            # position and N*M*P for the sum of squares
            got = CR.conv_sums(x)
            want = CR.conv_sums_plain(x, bm, bn)
            torch.cuda.synchronize()
            for name, g, w in zip(names, got, want):
                err = max_err(g, w) if g.shape == w.shape else float("inf")
                tol = 1e-4 * (float(w.abs().max()) + 1.0)
                if not err <= tol:
                    fail(f"conv_sums {dt} {shape} {name}: max |err| "
                         f"{err:.3g} > {tol:.3g}")
                errs[f"conv_sums_{dt}_{name}"] = err
        # the main path's route against the plain detection pass it replaces
        for name, g, w in zip(names, ops.conv_detect_sums(o4),
                              C.detect_sums(o4)):
            err = max_err(g, w)
            tol = 1e-4 * (float(w.abs().max()) + 1.0)
            if not err <= tol:
                fail(f"conv_detect_sums {shape} {name}: max |err| {err:.3g} "
                     f"> {tol:.3g}")
            errs["detect_" + name] = err
        err_all = max(err_all, *(v for k, v in errs.items()
                                 if not k.startswith("detect")))
        # inputs cold in L2
        args = copies([o4])
        dev = o4.device
        enc = torch.stack([torch.ones(n * m, device=dev),
                           torch.arange(n, device=dev).float()
                           .repeat_interleave(m),
                           torch.arange(m, device=dev).float().repeat(n)])

        def library(t):
            flat = t.reshape(-1)
            return enc @ t.reshape(n * m, p), torch.dot(flat, flat)

        ms = time_device(CR.conv_sums, args)
        partials_ms = time_device(lambda t: CR.checksum_reduce(
            t.reshape(n * m, p), bm, bn, segments=n, rowsum=False), args)

        def partials_route(t):
            # PR 13's main path: the tile partials, finished by PyTorch ops
            c, _, sq, w = CR.checksum_reduce(t.reshape(n * m, p), bm, bn,
                                             segments=n, rowsum=False)
            return CR.finish_conv_sums(c, sq, w, m, bm)

        route_ms = time_device(partials_route, args)
        plain_ms = time_device(lambda t: CR.conv_sums_plain(t, bm, bn), args)
        lib_ms = time_device(library, args)
        del args
        nbytes = 4.0 * (n * m * p + 3 * p + 1)
        flops = 7.0 * n * m * p
        b, by = bound_ms(nbytes, flops)
        rows.append({"shape": list(shape), "first_layer": f"conv{layer}",
                     "count": count, "ms": ms, "partials_ms": partials_ms,
                     "partials_tiles": [bm, bn],
                     "partials_route_ms": route_ms, "plain_ms": plain_ms,
                     "library_two_calls_ms": lib_ms, "bound_ms": b,
                     "bound_by": by, "max_abs_err": errs})
        log(f"  conv{layer} O{shape} x{count}: conv_sums ms {ms:.4f} "
            f"(tile partials ({bm},{bn}) {partials_ms:.4f}, finished by "
            f"PyTorch ops {route_ms:.4f}) plain "
            f"{plain_ms:.4f} enc@O + torch.dot (two calls) {lib_ms:.4f} "
            f"bound {b:.4f} ({by}); max|err| conv_sums "
            f"{max(v for k, v in errs.items() if k.startswith('conv')):.3g}"
            f" partials "
            f"{max(v for k, v in errs.items() if k.startswith('partials')):.3g}"
            f" vs plain pass "
            f"{max(v for k, v in errs.items() if k.startswith('detect')):.3g}")
        for k, v in (("ms", ms), ("partials_ms", partials_ms),
                     ("route_ms", route_ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                     ("bytes", nbytes), ("flops", flops)):
            tot[k] += count * v
    b, by = bound_ms(tot["bytes"], tot["flops"])
    # one device kernel per call, at conv0's view
    o4 = torch.randn(shapes[0], generator=gen, device="cuda")
    kernels = device_kernels(lambda: CR.conv_sums(o4))
    if sum(kernels.values()) != 1:
        fail(f"one conv_sums call launched {kernels}")
    report["checksum_reduce"] = {
        "per_shape": rows, "forward_ms": tot["ms"],
        "forward_partials_ms": tot["partials_ms"],
        "forward_partials_route_ms": tot["route_ms"],
        "forward_plain_ms": tot["plain_ms"],
        "forward_library_two_calls_ms": tot["library_ms"],
        "forward_bound_ms": b, "bytes_per_forward": tot["bytes"],
        "device_kernels_per_call": kernels}
    log(f"  per forward (17 launches): conv_sums ms {tot['ms']:.4f} (tile "
        f"partials {tot['partials_ms']:.4f}, finished by PyTorch ops "
        f"{tot['route_ms']:.4f}) plain {tot['plain_ms']:.4f} "
        f"enc@O + torch.dot (two calls) {tot['library_ms']:.4f} bound "
        f"{b:.4f} ({by}), {tot['bytes'] / 1e6:.1f} MB; device kernels per "
        f"call {kernels}")
    return {"name": "checksum_reduce", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/checksum_reduce.cu",
            "replaces": "src/repro/kernels/checksum_reduce.py:37",
            "max_abs_err": err_all, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b, "bound_by": by,
            # the plain detection pass takes two PyTorch calls (timed above
            # as library_two_calls_ms); no one call gives these sums
            "library_ms": None}


def check_abft_matmul(cfg, gen, report):
    import torch
    from repro_torch.core.protected import pick_chunk
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import abft_matmul_detect_ref, abft_matmul_ref
    fc_k = cfg.scaled(cfg.convs[-1].out_ch)
    shapes = {"fc": (BATCH, fc_k, cfg.num_classes),
              "ragged": (37, 520, 1000)}
    out = {}
    for label, (n, k, m) in shapes.items():
        d = torch.randn((n, k), generator=gen, device="cuda")
        w = torch.randn((k, m), generator=gen, device="cuda") * k ** -0.5
        if label == "fc":
            # the partial tiles protected_matmul asks for at this site
            rb, cb = pick_chunk(n, 1024), pick_chunk(m, 1024)
            gm = ops._tile(n, ops._tile(rb, 256))
            gn = ops._tile(m, ops._tile(cb, 256))
        else:
            gm, gn = ops._granularity(n, k, m, 256, 256, 256)
        o, parts = AM.abft_matmul(d, w, gm, gn)
        o_ref, parts_ref = abft_matmul_ref(d, w, gm, gn)
        torch.cuda.synchronize()
        errs = {"o": max_err(o, o_ref)}
        # fp32 reassociation: K-step order differs from cuBLAS
        if not torch.allclose(o, o_ref, rtol=1e-5, atol=1e-4 * k ** 0.5):
            fail(f"abft_matmul {label} O: max |err| {errs['o']:.3g}")
        for name, g, r in zip(("colsum", "rowsum", "sumsq"), parts[:3],
                              parts_ref[:3]):
            if g.shape != r.shape:
                fail(f"abft_matmul {label} {name}: shape {tuple(g.shape)} "
                     f"vs plain {tuple(r.shape)}")
            errs[name] = max_err(g, r)
            if not torch.allclose(g, r, rtol=1e-5, atol=1e-3 * k ** 0.5):
                fail(f"abft_matmul {label} {name}: max |err| "
                     f"{errs[name]:.3g}")
        if label == "fc":
            # the partial granularity must divide the fc's detection
            # chunking, so the partials recombine without the element path
            if rb % gm or cb % gn:
                fail(f"fc partial tiles {(gm, gn)} do not divide the chunk "
                     f"{(rb, cb)}")
            ops.chunk_sums_from_partials(parts, rb, cb)   # raises if not
            # the detect entry point on the same mainloop: one kernel, O
            # bitwise abft_matmul's, flags the plain version's (clear on
            # exact checksums)
            cs, _ = exact_chunk_checksums(d, w, rb, cb)
            o_d, flag, _ = AM.abft_matmul_detect(d, w, *cs, rb, cb, 1e-3,
                                                 1e-3)
            flag_r = abft_matmul_detect_ref(d, w, *cs, rb, cb, 1e-3, 1e-3)[1]
            torch.cuda.synchronize()
            if not torch.equal(o_d, o):
                fail(f"fc: abft_matmul_detect and abft_matmul round O "
                     f"differently (max |diff| {max_err(o_d, o):.3g})")
            if not torch.equal(flag, flag_r) or int(flag.sum()):
                fail(f"fc detect flags {flag.tolist()} vs plain "
                     f"{flag_r.tolist()}")
            kernels = device_kernels(lambda: AM.abft_matmul_detect(
                d, w, *cs, rb, cb, 1e-3, 1e-3))
            if sum(kernels.values()) != 1:
                fail(f"one f32 abft_matmul_detect call launched {kernels}")
            report["fc_detect_device_kernels_per_call"] = kernels
            t = AM.kernel_tiling(n, k, m, torch.float32, cb)
            log(f"  fc tiling: tile {t.tm}x{t.tn}, {t.splits} splits, "
                f"{t.tiles(n, m) * t.splits} blocks; abft_matmul_detect: one "
                f"device kernel per call {kernels}")
        args = copies([d, w])
        ms = time_device(lambda a, b: AM.abft_matmul(a, b, gm, gn), args)
        plain_ms = time_device(lambda a, b: abft_matmul_ref(a, b, gm, gn),
                               args)
        lib_ms = time_device(torch.matmul, args)
        del args
        nbytes = 4.0 * (n * k + k * m + n * m + -(-n // gm) * m
                        + n * -(-m // gn) + -(-n // gm) * -(-m // gn))
        flops = 2.0 * n * k * m + 4.0 * n * m
        b, by = bound_ms(nbytes, flops)
        out[label] = {"shape": [n, k, m], "tiles": [gm, gn], "ms": ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": b, "bound_by": by, "max_abs_err": errs}
        log(f"  abft_matmul {label} ({n}x{k})@({k}x{m}) tiles ({gm},{gn}): "
            f"ms {ms:.4f} plain {plain_ms:.4f} torch.matmul {lib_ms:.4f} "
            f"bound {b:.4f} ({by}) max|err| "
            f"{max(errs.values()):.3g}")
    report["abft_matmul"] = out
    fc = out["fc"]
    return {"name": "abft_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/abft_matmul.cu",
            "replaces": "src/repro/kernels/abft_matmul.py:54",
            "max_abs_err": max(max(v["max_abs_err"].values())
                               for v in out.values()),
            "ms": fc["ms"], "plain_ms": fc["plain_ms"],
            "bound_ms": fc["bound_ms"], "bound_by": fc["bound_by"],
            "library_ms": fc["library_ms"]}


# --------------------------------------------------------------------------
# phase 3b: the serving path's kernels at its own shapes (bf16)
# --------------------------------------------------------------------------

def exact_chunk_checksums(d, w, rb, cb):
    """c5/c6/c7/absdot per (rb x cb) chunk of the fp32 product (the
    offline-exact predictions a clean chunk must meet), and the chunks'
    sums of squares."""
    from repro_torch.kernels.ref import chunk_sums_ref
    d32, w32 = d.float(), w.float()
    c5, c6, c7, sq = chunk_sums_ref(d32 @ w32, rb, cb)
    absdot = chunk_sums_ref(d32.abs() @ w32.abs(), rb, cb)[0]
    return [c5, c6, c7, absdot], sq


def within_bf16_ulp(a, b) -> bool:
    """Every element of a within one bf16 ulp of b (two roundings of fp32
    sums that differ by reassociation only)."""
    a32, b32 = a.float(), b.float()
    return bool(((a32 - b32).abs() <= b32.abs() * 2.0 ** -7 + 1e-6).all())


def wrapper_host_us(AM, reps: int = 200, rounds: int = 5) -> dict:
    """Host microseconds of one call of each bf16 wrapper of the kernel
    module AM at the decode wq shape, (8 x 960) @ (960 x 960): `reps`
    calls back to back without a synchronize (issue time: checks,
    allocations, the ctypes launch), median over `rounds`."""
    import torch
    from repro_torch import fp32_ieee
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16 = torch.bfloat16
    d = torch.randn((8, 960), generator=gen, device="cuda").to(bf16)
    w = (torch.randn((960, 960), generator=gen, device="cuda")
         * 960 ** -0.5).to(bf16)
    cs = [torch.randn((1, 1), generator=gen, device="cuda") for _ in range(4)]
    fns = {"abft_matmul_detect": lambda: AM.abft_matmul_detect(
               d, w, *cs, 8, 960, 1e-3, 1e-3),
           "abft_matmul": lambda: AM.abft_matmul(d, w, 8, 256)}
    out = {}
    with torch.no_grad(), fp32_ieee():
        for name, fn in fns.items():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            per = []
            for _ in range(rounds):
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                per.append((time.perf_counter() - t0) * 1e6 / reps)
                torch.cuda.synchronize()
            out[name] = statistics.median(per)
    return out


def check_serving_kernels(gen, report):
    """abft_matmul_detect against its plain version, and abft_matmul on
    bf16 operands, at every GEMM shape of a decode step (8 rows) and a
    128-row prefill of SmolLM-360M: flags exact, scores and O allclose, O
    bitwise equal between the two kernels, exact checksums clear and a c5
    shifted by 10 tau flagging exactly its chunk. Times per decode step
    and per prefill sum the shapes by their launch counts."""
    import torch
    from repro_torch import fp32_ieee
    from repro_torch.core.plan import calibrate_tau_factor
    from repro_torch.core.protected import pick_chunk
    from repro_torch.core.thresholds import tau_scalar_coeffs
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import abft_matmul_detect_ref, abft_matmul_ref
    bf16 = torch.bfloat16
    rows, err_det, err_mm = [], 0.0, 0.0
    tot = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
               "flops": 0.0, "mm_ms": 0.0, "mm_plain_ms": 0.0,
               "mm_bytes": 0.0, "mm_flops": 0.0}
           for n in TIMED_ROWS}
    with torch.no_grad(), fp32_ieee():
        for n in SERVE_ROWS:
            for label, k, m, transposed, count in SERVE_SITES:
                d = torch.randn((n, k), generator=gen, device="cuda").to(bf16)
                store = (torch.randn((m, k) if transposed else (k, m),
                                     generator=gen, device="cuda")
                         * k ** -0.5).to(bf16)
                view = (lambda t: t.T) if transposed else (lambda t: t)
                w = view(store)
                rb, cb = pick_chunk(n, 1024), pick_chunk(m, 1024)
                bm, bn = ops._tile(rb, 256), ops._tile(cb, 256)
                tiling = AM.kernel_tiling(n, k, m, bf16, cb)
                blocks = tiling.tiles(n, m) * tiling.splits
                cs, sq = exact_chunk_checksums(d, w, rb, cb)
                ta, tb = tau_scalar_coeffs(k, bf16, calibrate_tau_factor(k))
                o, flag, score = AM.abft_matmul_detect(d, w, *cs, rb, cb, ta, tb)
                o_r, flag_r, score_r = abft_matmul_detect_ref(d, w, *cs, rb, cb,
                                                              ta, tb)
                o_mm, parts = AM.abft_matmul(d, w, bm, bn)
                o_mr, parts_r = abft_matmul_ref(d, w, bm, bn)
                torch.cuda.synchronize()
                what = f"{label} ({n}x{k})@({k}x{m})"
                if not torch.equal(flag, flag_r) or int(flag.sum()):
                    fail(f"abft_matmul_detect {what}: flags {flag.tolist()} vs "
                         f"plain {flag_r.tolist()}")
                # a score is |c - s| / tau; the kernel's s and the plain
                # version's differ by fp32 reassociation over K products and
                # rb*cb terms, whose random-walk size in units of tau (at
                # least tau_a * sqrt(sumsq)) is eps32 (sqrt K + sqrt(rb cb))
                # / tau_a
                noise = 2.0 ** -24 * (k ** 0.5 + (rb * cb) ** 0.5) / ta
                e_s = max_err(score, score_r)
                if not torch.allclose(score, score_r, rtol=1e-3, atol=noise):
                    fail(f"abft_matmul_detect {what}: clean scores differ by "
                         f"{e_s:.3g} (limit {noise:.3g})")
                if not within_bf16_ulp(o, o_r):
                    fail(f"abft_matmul_detect {what}: O beyond one bf16 ulp of "
                         f"the plain version (max |err| {max_err(o, o_r):.3g})")
                if not torch.equal(o, o_mm):
                    fail(f"{what}: abft_matmul_detect and abft_matmul round O "
                         f"differently (max |diff| {max_err(o, o_mm):.3g})")
                if not within_bf16_ulp(o_mm, o_mr):
                    fail(f"abft_matmul bf16 {what}: O beyond one bf16 ulp")
                e_p = 0.0
                for g_, r_, nm in zip(parts[:3], parts_r[:3],
                                      ("colsum", "rowsum", "sumsq")):
                    if g_.shape != r_.shape or not torch.allclose(
                            g_, r_, rtol=1e-5, atol=1e-3 * k ** 0.5):
                        fail(f"abft_matmul bf16 {what} {nm}: max |err| "
                             f"{max_err(g_, r_):.3g}")
                    e_p = max(e_p, max_err(g_, r_))
                # c5, c6 or c7 of the last chunk shifted by 10 of its taus:
                # that chunk alone flags, with the plain version's score
                # (about 10, so rtol 1e-3 holds the threshold and the
                # division to the plain version's)
                tau5 = ta * float(sq[-1, -1].sqrt()) + tb * float(cs[3][-1, -1])
                e_t = 0.0
                for q, wq in enumerate((1, max(rb - 1, 1), max(cb - 1, 1))):
                    ct = [c.clone() for c in cs]
                    ct[q][-1, -1] += 10.0 * tau5 * wq
                    _, flag_t, score_t = AM.abft_matmul_detect(d, w, *ct, rb,
                                                               cb, ta, tb)
                    _, flag_tr, score_tr = abft_matmul_detect_ref(
                        d, w, *ct, rb, cb, ta, tb)
                    want = torch.zeros_like(flag_t)
                    want[-1, -1] = 1
                    e_t = max(e_t, max_err(score_t, score_tr))
                    if not (torch.equal(flag_t, want)
                            and torch.equal(flag_tr, want)
                            and torch.allclose(score_t, score_tr, rtol=1e-3,
                                               atol=noise)
                            and 9.9 < float(score_tr[-1, -1]) < 10.1):
                        fail(f"abft_matmul_detect {what}: c{q + 5} shifted by "
                             f"10 tau flags {flag_t.tolist()} (plain "
                             f"{flag_tr.tolist()}), score "
                             f"{float(score_t[-1, -1]):.6g} vs plain "
                             f"{float(score_tr[-1, -1]):.6g}")
                err_det = max(err_det, e_s, e_t, max_err(o, o_r))
                err_mm = max(err_mm, max_err(o_mm, o_mr), e_p)
                tile_txt = (f"tile {tiling.tm}x{tiling.tn}, {tiling.splits} "
                            f"splits, {blocks} blocks")
                row = {"site": label, "shape": [n, k, m], "chunks": [rb, cb],
                       "w_transposed": transposed, "per_forward": count,
                       "tiling": {**tiling._asdict(), "blocks": blocks},
                       "clean_score": float(score.max()),
                       "max_abs_err": {"score": e_s, "tampered_score": e_t,
                                       "o": max_err(o, o_r)}}
                rows.append(row)
                if n not in TIMED_ROWS:
                    log(f"  {what} chunks ({rb},{cb}): {tile_txt}; clean "
                        f"score {float(score.max()):.3g} (err {e_s:.3g}, "
                        f"limit {noise:.3g}); shifted c5/c6/c7 score err "
                        f"{e_t:.3g}")
                    continue
                args = copies([d, store] + cs)
                ms = time_device(lambda a, b, *c: AM.abft_matmul_detect(
                    a, view(b), *c, rb, cb, ta, tb), args)
                plain_ms = time_device(lambda a, b, *c: abft_matmul_detect_ref(
                    a, view(b), *c, rb, cb, ta, tb), args)
                lib_ms = time_device(lambda a, b, *c: torch.matmul(a, view(b)),
                                     args)
                mm_ms = time_device(lambda a, b, *c: AM.abft_matmul(
                    a, view(b), bm, bn), args)
                mm_plain = time_device(lambda a, b, *c: abft_matmul_ref(
                    a, view(b), bm, bn), args)
                del args
                nb, mb = n // rb, m // cb
                nbytes = 2.0 * (n * k + k * m + n * m) + 4.0 * 6 * nb * mb
                flops = 2.0 * n * k * m + 5.0 * n * m
                b, by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
                b32, _ = bound_ms(nbytes, flops, FP32_FLOPS_PER_S)
                pm, pn = -(-n // bm), -(-m // bn)
                mm_bytes = (2.0 * (n * k + k * m + n * m)
                            + 4.0 * (pm * m + n * pn + pm * pn))
                mm_flops = 2.0 * n * k * m + 4.0 * n * m
                mm_b, mm_by = bound_ms(mm_bytes, mm_flops, BF16_FLOPS_PER_S)
                row.update({"ms": ms, "plain_ms": plain_ms,
                            "library_ms": lib_ms, "abft_matmul_ms": mm_ms,
                            "abft_matmul_plain_ms": mm_plain,
                            "abft_matmul_bound_ms": mm_b,
                            "abft_matmul_bound_by": mm_by,
                            "bound_ms": b, "bound_by": by,
                            "bound_fp32_fma_ms": b32})
                log(f"  {what} chunks ({rb},{cb}) x{count}: {tile_txt}; "
                    f"detect ms {ms:.4f} "
                    f"plain {plain_ms:.4f} torch.matmul {lib_ms:.4f} "
                    f"bound {b:.4f} ({by}; fp32-FMA {b32:.4f}); abft_matmul "
                    f"{mm_ms:.4f} plain {mm_plain:.4f} bound {mm_b:.4f} "
                    f"({mm_by}); clean score {float(score.max()):.3g} (err "
                    f"{e_s:.3g}, limit {noise:.3g}); shifted c5/c6/c7 score "
                    f"err {e_t:.3g}")
                t = tot[n]
                t["ms"] += count * ms
                t["plain_ms"] += count * plain_ms
                t["library_ms"] += count * lib_ms
                t["mm_ms"] += count * mm_ms
                t["mm_plain_ms"] += count * mm_plain
                t["bytes"] += count * nbytes
                t["flops"] += count * flops
                t["mm_bytes"] += count * mm_bytes
                t["mm_flops"] += count * mm_flops
    for n, t in tot.items():
        t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["flops"],
                                                BF16_FLOPS_PER_S)
        t["bound_fp32_fma_ms"] = bound_ms(t["bytes"], t["flops"])[0]
        t["mm_bound_ms"], t["mm_bound_by"] = bound_ms(
            t["mm_bytes"], t["mm_flops"], BF16_FLOPS_PER_S)
        log(f"  per {'decode step' if n == SLOTS else 'prefill of 128'} "
            f"(225 launches): detect ms {t['ms']:.4f} plain {t['plain_ms']:.4f}"
            f" torch.matmul {t['library_ms']:.4f} bound {t['bound_ms']:.4f} "
            f"({t['bound_by']}; fp32-FMA {t['bound_fp32_fma_ms']:.4f}), "
            f"{t['bytes'] / 1e6:.1f} MB; abft_matmul {t['mm_ms']:.4f} plain "
            f"{t['mm_plain_ms']:.4f} bound {t['mm_bound_ms']:.4f} "
            f"({t['mm_bound_by']})")
    host = wrapper_host_us(AM)
    log(f"  host us per wrapper call at the decode wq shape (8x960)@(960x960):"
        f" abft_matmul_detect {host['abft_matmul_detect']:.1f}, abft_matmul "
        f"{host['abft_matmul']:.1f}")
    report["serving_kernels"] = {"per_shape": rows, "decode_step": tot[SLOTS],
                                 "prefill_128": tot[128],
                                 "wrapper_host_us": host}
    dec = tot[SLOTS]
    src = "src/repro_torch/kernels/csrc/abft_matmul.cu"
    # both rows' times are per decode step (225 launches over its shapes)
    detect = {"name": "abft_matmul_detect", "route": "cuda", "source": src,
              "replaces": "src/repro/kernels/abft_matmul.py:131",
              "max_abs_err": err_det, "ms": dec["ms"],
              "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
              "bound_by": dec["bound_by"], "library_ms": dec["library_ms"]}
    mm = {"name": "abft_matmul/serving_bf16", "route": "cuda", "source": src,
          "replaces": "src/repro/kernels/abft_matmul.py:54",
          "max_abs_err": err_mm, "ms": dec["mm_ms"],
          "plain_ms": dec["mm_plain_ms"], "bound_ms": dec["mm_bound_ms"],
          "bound_by": dec["mm_bound_by"], "library_ms": dec["library_ms"]}
    return detect, mm


# --------------------------------------------------------------------------
# phases 4 and 5: the slice
# --------------------------------------------------------------------------

def profile_forward(fn) -> dict:
    """One call of fn under torch.profiler: wall time, device busy time
    (the sum of the kernels' own device times), the idle share of the
    wall, and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    # the device-side events only: an aten op's own device time repeats
    # the time of the kernels it launched
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and dev(e) > 0 and not e.key.startswith("Activity Buffer")]
    busy = sum(dev(e) for e in kern) / 1e3
    top = sorted(kern, key=dev, reverse=True)[:12]
    return {"wall_ms": wall, "device_ms": busy,
            "kernels": sum(e.count for e in kern),
            "idle_share": max(0.0, 1.0 - busy / wall),
            "top": [{"name": e.key, "calls": e.count, "ms": dev(e) / 1e3}
                    for e in top]}


def host_split(fwds: dict, reps: int = 5) -> dict:
    """Host microseconds per forward spent inside the detection route's
    layers, from timing spans wrapped around the port's own functions for
    the length of `reps` forwards of each fwds entry. The spans nest:
    detect_sums > conv_detect_sums > the conv-sums wrapper > (its counter
    lookup, then its ctypes launch), so each layer's own cost is its span
    less the ones inside it. Issue time only: nothing inside the spans
    synchronizes."""
    import torch
    from repro_torch.core import checksums as C
    from repro_torch.kernels import _build, _counters, ops
    spans = {"detect_sums": (C, "detect_sums"),
             "conv_detect_sums": (ops, "conv_detect_sums"),
             "conv_sums": (ops, "_conv_sums_kernel"),
             "counters": (_counters, "counters"),
             "abft_matmul": (ops, "_abft_matmul_kernel"),
             "chunk_sums_from_partials": (ops, "chunk_sums_from_partials"),
             "launch": (_build, "launch")}
    acc = {}

    def timed(key, f):
        def g(*a, **kw):
            k = f"launch {a[0].__name__}" if key == "launch" else key
            t0 = time.perf_counter()
            try:
                return f(*a, **kw)
            finally:
                v = acc.setdefault(k, [0.0, 0])
                v[0] += time.perf_counter() - t0
                v[1] += 1
        return g

    saved = {k: getattr(mod, name) for k, (mod, name) in spans.items()}
    out = {}
    try:
        for k, (mod, name) in spans.items():
            setattr(mod, name, timed(k, saved[k]))
        for label, fwd in fwds.items():
            fwd()
            torch.cuda.synchronize()
            acc.clear()
            t0 = time.perf_counter()
            for _ in range(reps):
                fwd()
            torch.cuda.synchronize()
            out[label] = {"forward_ms": (time.perf_counter() - t0) * 1e3 / reps,
                          "spans": {k: {"calls": c / reps,
                                        "us_per_forward": t * 1e6 / reps,
                                        "us_per_call": t * 1e6 / c}
                                    for k, (t, c) in sorted(acc.items())}}
    finally:
        for k, (mod, name) in spans.items():
            setattr(mod, name, saved[k])
    return out


def pin_fused(plan):
    from repro_torch.core import ProtectionPlan
    return ProtectionPlan(
        {n: dataclasses.replace(e, cfg=e.cfg.replace(use_fused_kernel=True))
         if e.cfg.enabled else e for n, e in plan.entries.items()},
        dict(plan.meta))


def run_slice(report):
    import torch
    from repro_torch.core import plan_scope, workflow
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.kernels import checksum_reduce as CR
    from repro_torch.models import cnn
    from repro_torch import core, fp32_ieee

    if torch.backends.cudnn.benchmark:
        fail("cudnn.benchmark is on: two forwards may pick different "
             "algorithms and the bitwise contracts would not hold")
    cfg = cnn.resnet18(1.0)
    params = cnn.init_cnn(cfg, generator=torch.Generator().manual_seed(SEED),
                          device="cuda")
    x = torch.randn((BATCH, 3, IMG, IMG),
                    generator=torch.Generator().manual_seed(SEED + 1)
                    ).to("cuda")
    t0 = time.perf_counter()
    plan = core.build_plan(params, cfg, batch=BATCH, device="cuda")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    plan.validate(params)
    fused = pin_fused(plan)
    n_conv = len(cfg.convs)
    names = list(fused.names())
    log(f"  ResNet-18 width 1.0 img {IMG} batch {BATCH}: {len(names)} "
        f"protected sites, build_plan {plan_s:.2f} s")

    off = dataclasses.replace(cfg, abft=False)
    unprot = lambda: cnn.forward_cnn(params, x, off)[0]
    l0 = unprot()

    # clean flags and scores: the detect-only pass, site by site
    with torch.no_grad(), fp32_ieee(), plan_scope(fused, mode="detect_only"):
        _, det_names, evs = cnn._forward_pass(params, x, cfg, None, -1, None)
    scores = {n: float(e.score) for n, e in zip(det_names, evs)}
    flags = {n: int(e.flag) for n, e in zip(det_names, evs)}
    log("  clean detection scores |c-s|/tau: " + " ".join(
        f"{n}={s:.3g}" for n, s in scores.items()))
    if any(flags.values()):
        fail(f"clean forward flagged: {flags} scores {scores}")

    res = {"scores": scores}
    logits = {}
    for mode in ("per_layer", "deferred"):
        CR.LAUNCHES = AM.LAUNCHES = workflow.HOST_READS = 0
        lg, rep = cnn.forward_cnn(params, x, cfg, plan=fused, correction=mode)
        torch.cuda.synchronize()
        launches = {"checksum_reduce": CR.LAUNCHES,
                    "abft_matmul": AM.LAUNCHES}
        reads = workflow.HOST_READS
        summ = rep.summary()
        bad = {n: v for n, v in summ.items()
               if v["detected"] or v["residual"]}
        if bad:
            fail(f"{mode}: clean forward reported {bad}")
        want_reads = len(names) if mode == "per_layer" else 1
        if launches != {"checksum_reduce": n_conv, "abft_matmul": 1}:
            fail(f"{mode}: launches {launches}, want {n_conv} + 1")
        if reads != want_reads:
            fail(f"{mode}: {reads} host reads, want {want_reads}")
        if not torch.isfinite(lg).all() or tuple(lg.shape) != (BATCH, 1000):
            fail(f"{mode}: logits {tuple(lg.shape)} not finite/shaped")
        logits[mode] = lg
        res[mode] = {"launches": launches, "host_reads": reads}
        log(f"  {mode}: launches {launches}, host reads {reads}, "
            f"flags 0/{len(summ)}")
    if not torch.equal(logits["per_layer"], logits["deferred"]):
        fail("per_layer and deferred clean logits differ")
    # the protected clean path leaves every conv output untouched: with
    # the fc left unprotected, the logits are bitwise the unprotected ones
    convs_only = core.ProtectionPlan(
        {n: e for n, e in fused.entries.items() if n != "fc"}, fused.meta)
    for mode in ("per_layer", "deferred"):
        lc, _ = cnn.forward_cnn(params, x, cfg, plan=convs_only,
                                correction=mode)
        if not torch.equal(lc, l0):
            fail(f"{mode}: protected convs changed the logits "
                 f"(max |diff| {max_err(lc, l0):.3g})")
    # the unfused plan: every layer's output, the fc's too, is bitwise
    # the unprotected forward's
    for mode in ("per_layer", "deferred"):
        lu, _ = cnn.forward_cnn(params, x, cfg, plan=plan, correction=mode)
        if not torch.equal(lu, l0):
            fail(f"{mode}: unfused protected logits differ from the "
                 "unprotected forward")
    # with the fc's product taken by the kernel, the logits differ from
    # cuBLAS's only by fp32 reassociation
    d_fc = max_err(logits["per_layer"], l0)
    scale = float(l0.abs().max()) + 1.0
    if not d_fc <= 1e-5 * scale:
        fail(f"fused logits vs unprotected: max |diff| {d_fc:.3g}")
    log(f"  bitwise: per_layer == deferred; convs-only protected == "
        f"unprotected; unfused plan == unprotected; fused fc vs cuBLAS "
        f"max |diff| {d_fc:.3g}")

    # the port's own CPU run of the same params and input
    params_cpu = {k: {kk: vv.cpu() for kk, vv in v.items()}
                  for k, v in params.items()}
    plan_cpu = pin_fused(core.build_plan(params_cpu, cfg, batch=BATCH,
                                         device="cpu"))
    t0 = time.perf_counter()
    l_cpu, rep_cpu = cnn.forward_cnn(params_cpu, x.cpu(), cfg, plan=plan_cpu,
                                     device="cpu")
    cpu_s = time.perf_counter() - t0
    d_cpu = max_err(logits["per_layer"].cpu(), l_cpu)
    # cuDNN vs the CPU's convs: fp32 reassociation through 17 layers
    if not torch.allclose(logits["per_layer"].cpu(), l_cpu, rtol=1e-4,
                          atol=1e-4 * scale) or int(rep_cpu.detected):
        fail(f"card vs CPU logits: max |diff| {d_cpu:.3g}")
    log(f"  card vs CPU run: max |diff| {d_cpu:.3g} (CPU forward "
        f"{cpu_s:.1f} s)")
    res.update({"fused_fc_vs_cublas_max_diff": d_fc,
                "card_vs_cpu_max_diff": d_cpu})

    # median forward times
    times = time_host({
        "unprotected": unprot,
        "per_layer": lambda: cnn.forward_cnn(params, x, cfg, plan=fused),
        "deferred": lambda: cnn.forward_cnn(params, x, cfg, plan=fused,
                                            correction="deferred"),
        "per_layer_unfused": lambda: cnn.forward_cnn(params, x, cfg,
                                                     plan=plan),
        "deferred_unfused": lambda: cnn.forward_cnn(
            params, x, cfg, plan=plan, correction="deferred"),
    })
    res["forward_ms"] = times
    log("  median forward ms: " + " ".join(f"{k}={v:.3f}"
                                            for k, v in times.items()))
    for k in ("per_layer", "deferred"):
        log(f"  error-free overhead {k}: "
            f"{(times[k] / times['unprotected'] - 1) * 100:.1f}%")

    split = host_split({
        "per_layer": lambda: cnn.forward_cnn(params, x, cfg, plan=fused),
        "per_layer_unfused": lambda: cnn.forward_cnn(params, x, cfg,
                                                     plan=plan)})
    res["host_split"] = split
    for k, v in split.items():
        log(f"  host us per forward, {k} (forward {v['forward_ms']:.3f} ms): "
            + ", ".join(f"{n} {d['us_per_forward']:.1f} ({d['calls']:g} "
                        f"calls, {d['us_per_call']:.1f}/call)"
                        for n, d in v["spans"].items()))
    sp = split["per_layer"]["spans"]
    us = lambda k: sp[k]["us_per_call"]
    launch = us("launch repro_conv_detect_sums_f32")
    log("  conv sums route, host us per call: detect_sums "
        f"{us('detect_sums'):.1f} = own "
        f"{us('detect_sums') - us('conv_detect_sums'):.1f} + dispatch "
        f"{us('conv_detect_sums') - us('conv_sums'):.1f} + checks, "
        "allocation and views "
        f"{us('conv_sums') - us('counters') - launch:.1f} + counters "
        f"{us('counters'):.1f} + ctypes launch {launch:.1f}; the plain pass "
        f"{split['per_layer_unfused']['spans']['detect_sums']['us_per_call']:.1f}")

    res["profile"] = {
        "unprotected": profile_forward(unprot),
        "per_layer": profile_forward(lambda: cnn.forward_cnn(
            params, x, cfg, plan=fused)),
        "deferred": profile_forward(lambda: cnn.forward_cnn(
            params, x, cfg, plan=fused, correction="deferred")),
    }
    for k, v in res["profile"].items():
        log(f"  profile {k}: wall {v['wall_ms']:.3f} ms, device busy "
            f"{v['device_ms']:.3f} ms ({v['kernels']} kernels), idle share "
            f"{v['idle_share']:.3f}; top: " + ", ".join(
                f"{t['name'][:40]} {t['ms']:.3f}" for t in v["top"][:4]))

    # phase 5: injected faults
    log("phase 5: injected faults")
    rng = __import__("numpy").random.default_rng(SEED + 2)
    faults = {}
    for layer in (5, 13):
        _, o_clean = cnn.conv_output_at(params, x, cfg, layer)
        n_, m_, e1, e2 = o_clean.shape
        delta = torch.zeros(o_clean.shape, dtype=torch.float32)
        if layer == 5:
            idx = (int(rng.integers(n_)), int(rng.integers(m_)),
                   int(rng.integers(e1)), int(rng.integers(e2)))
            delta[idx] = float(rng.uniform(5.0, 50.0))
            what = f"one element at {idx}"
        else:
            img, yy, xx = (int(rng.integers(n_)), int(rng.integers(e1)),
                           int(rng.integers(e2)))
            chans = rng.choice(m_, size=6, replace=False)
            for c in chans:
                delta[img, int(c), yy, xx] = float(rng.uniform(5.0, 50.0))
            what = (f"burst: image {img}, channels {sorted(map(int, chans))}"
                    f", position ({yy},{xx})")
        o_bad = o_clean + delta.to("cuda")
        for mode in ("per_layer", "deferred"):
            lg, rep = cnn.forward_cnn(params, x, cfg, plan=fused,
                                      correction=mode, inject_layer=layer,
                                      inject_o=o_bad)
            summ = rep.summary()
            site = summ[f"conv{layer}"]
            others = {n: v for n, v in summ.items()
                      if n != f"conv{layer}" and v["detected"]}
            d_l = max_err(lg, logits["per_layer"])
            ok = (site["detected"] == 1 and site["residual"] == 0
                  and site["corrected_by"] != "none" and not others
                  and torch.allclose(lg, logits["per_layer"], rtol=1e-4,
                                     atol=1e-4 * scale))
            log(f"  conv{layer} {what} [{mode}]: detected "
                f"{site['detected']} corrected_by {site['corrected_by']} "
                f"residual {site['residual']}, logits max |diff| {d_l:.3g}")
            if not ok:
                fail(f"conv{layer} {mode}: {site} others {others} "
                     f"logit diff {d_l:.3g}")
            faults[f"conv{layer}/{mode}"] = {**site, "what": what,
                                             "logit_max_diff": d_l}
    res["faults"] = faults
    res["erroneous"] = run_erroneous(params, x, cfg, fused, logits, scale,
                                     unprot, times)
    report["slice"] = res
    return res, {"params": params, "x": x, "cfg": cfg, "fused": fused,
                 "unprot": unprot, "l0": l0}


def run_erroneous(params, x, cfg, fused, logits, scale, unprot,
                  clean_times) -> dict:
    """Phase 5b: the paper's error-injected overhead at full width, after
    benchmarks/bench_erroneous.py. The port's registry draws a `burst`
    spec (up to 100 elements in one block-row or block-column, +-2^e) for
    each of the 17 convs in turn, injected through forward_cnn's
    inject_layer/inject_o into the clean output conv_output_at gives.
    Two plan variants (as built, with the layerwise RC/ClC choice; RC/ClC
    off, the paper's Fig. 10b), each in per_layer and deferred mode: the
    injected layer detected with no residual, no other layer flagged,
    logits back to the clean ones (rtol 1e-4). Each faulted forward is
    timed in turns with the unprotected and the clean protected forward;
    the error-injected overhead is the mean over layers of the median
    faulted forward over the median unprotected forward, minus 1."""
    import torch
    from repro_torch.core import ProtectionPlan
    from repro_torch.core import injection as inj
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.kernels import checksum_reduce as CR
    from repro_torch.models import cnn

    log("phase 5b: the error-injected overhead")
    model = inj.FAULT_MODELS["burst"]
    gen = torch.Generator().manual_seed(SEED + 5)
    n_conv = len(cfg.convs)
    o_bad, specs = [], []
    for layer in range(n_conv):
        _, o_clean = cnn.conv_output_at(params, x, cfg, layer)
        n_, m_ = o_clean.shape[0], o_clean.shape[1]
        spec = model.plan(gen, n_, m_, o_clean.shape[2] * o_clean.shape[3],
                          100)
        o_bad.append(inj.inject(o_clean, spec.to(o_clean.device), model))
        specs.append({"axis": int(spec.axis), "index": int(spec.index),
                      "nelem": int(spec.nelem), "scale": float(spec.scale)})
    variants = {
        "layerwise": fused,
        "no_rcclc": ProtectionPlan(
            {n: dataclasses.replace(e, cfg=e.cfg.replace(
                rc_enabled=False, clc_enabled=False))
             for n, e in fused.entries.items()}, dict(fused.meta)),
    }
    out = {"specs": specs}
    for vname, vplan in variants.items():
        for mode in ("per_layer", "deferred"):
            fwd = lambda i=-1: cnn.forward_cnn(
                params, x, cfg, plan=vplan, correction=mode,
                inject_layer=i, inject_o=o_bad[i] if i >= 0 else None)
            by, launches, diffs = [], [], []
            for i in range(n_conv):
                CR.LAUNCHES = AM.LAUNCHES = 0
                lg, rep = fwd(i)
                torch.cuda.synchronize()
                launches.append((CR.LAUNCHES, AM.LAUNCHES))
                summ = rep.summary()
                site = summ[f"conv{i}"]
                others = {k: v for k, v in summ.items()
                          if k != f"conv{i}" and v["detected"]}
                d_l = max_err(lg, logits["per_layer"])
                diffs.append(d_l)
                by.append(site["corrected_by"])
                if not (site["detected"] == 1 and site["residual"] == 0
                        and site["corrected_by"] != "none"
                        and not others and torch.isfinite(lg).all()
                        and torch.allclose(lg, logits["per_layer"],
                                           rtol=1e-4, atol=1e-4 * scale)):
                    fail(f"5b {vname}/{mode} conv{i} {specs[i]}: {site}, "
                         f"others {others}, logits max |diff| {d_l:.3g}")
                if CR.LAUNCHES != n_conv or AM.LAUNCHES < 1:
                    fail(f"5b {vname}/{mode} conv{i}: launches "
                         f"{launches[-1]}, want {n_conv} conv sums and "
                         "the fc's abft_matmul")
            faulted, unp, clean = [], [], []
            for i in range(n_conv):
                t = time_turns({"unprotected": unprot,
                                "clean": lambda: fwd(),
                                "faulted": lambda i=i: fwd(i)},
                               reps=5, warmup=1)
                faulted.append(statistics.median(t["faulted"]))
                unp += t["unprotected"]
                clean += t["clean"]
            u, c = statistics.median(unp), statistics.median(clean)
            overhead = statistics.mean(faulted) / u - 1
            hist = dict(collections.Counter(by))
            key = f"{vname}/{mode}"
            out[key] = {"corrected_by": by, "histogram": hist,
                        "launches_per_forward": launches,
                        "logit_max_diff": diffs,
                        "faulted_ms": faulted, "unprotected_ms": u,
                        "clean_ms": c, "error_injected_overhead": overhead,
                        "error_free_overhead": c / u - 1}
            log(f"  {key}: 17/17 detected, residual 0, logits within "
                f"rtol 1e-4 (max |diff| {max(diffs):.3g}); schemes {hist}; "
                f"launches per faulted forward (conv sums, abft_matmul) "
                f"{sorted(set(launches))}")
            log(f"  {key}: median ms unprotected {u:.3f}, clean protected "
                f"{c:.3f}, faulted per layer "
                + " ".join(f"{f:.2f}" for f in faulted))
            log(f"  {key}: error-injected overhead {overhead * 100:.1f}% "
                f"(error-free in the same turns {(c / u - 1) * 100:.1f}%; "
                f"phase 4: {(clean_times[mode] / clean_times['unprotected'] - 1) * 100:.1f}%)")
    return out


# --------------------------------------------------------------------------
# phases 6 and 7: the serving slice
# --------------------------------------------------------------------------

def serve_prompts(cfg, n: int, seed: int):
    rng = __import__("numpy").random.default_rng(seed)
    lo, hi = PROMPT_LENS
    return [rng.integers(0, cfg.vocab_size, int(k))
            for k in rng.integers(lo, hi + 1, n)]


def serve(params, cfg, plan, prompts, gen: int, correction="auto",
          hook=None):
    """One ProtectedSession over `prompts`: (session, request ids,
    report, per-step records). The records are the session's decode log:
    each decode step's host milliseconds (they end in the read of the
    next tokens, which synchronizes) and its localizer hit vector;
    `hook` is (path, fn) of a fault_scope."""
    import contextlib
    from repro_torch.core import injection
    from repro_torch.serving import ProtectedSession
    sess = ProtectedSession(params, cfg, plan, slots=SLOTS, max_len=MAX_LEN,
                            correction=correction, device=DEVICE)
    rids = [sess.submit(p, max_new_tokens=gen) for p in prompts]
    scope = injection.fault_scope(*hook) if hook else contextlib.nullcontext()
    with scope:
        report = sess.run()
    log_ = sess.stats.decode_log
    steps = {"ms": [e["dispatch_s"] * 1e3 for e in log_],
             "hits": [e["hit"] for e in log_]}
    return sess, rids, report, steps


def run_serving(report):
    """Phase 6: full-width bf16 SmolLM-360M served in deferred mode
    through the kernels, checked for zero flags, 225 detect launches and
    one host read per forward, per_layer parity, a teacher-forced check
    against the unprotected forward, timings of three sessions and a
    profile. Phase 7: a decode fault at the tied head and a prefill fault
    at a stage site, detected, corrected and attributed."""
    import torch
    from repro_torch import configs, core, fp32_ieee
    from repro_torch.core import workflow
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.models import transformer as M

    cfg = configs.get(SERVE_ARCH)
    t0 = time.perf_counter()
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(SEED),
                           device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = core.build_plan(params, cfg, batch=SLOTS, seq=MAX_LEN,
                           device=DEVICE)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    plan.validate(params)
    fused = core.force_fused_matmul(plan)
    n_sites = cfg.stages()[1] * 7 + 1
    if len(fused) != 8:
        fail(f"plan has {len(fused)} entries, want 8")
    log(f"  {SERVE_ARCH}: {M.count_params(cfg) / 1e6:.1f} M params bf16, "
        f"{n_sites} protected GEMMs per forward; init {init_s:.1f} s, "
        f"build_plan {plan_s:.1f} s")
    res = {"init_s": init_s, "build_plan_s": plan_s}
    prompts = serve_prompts(cfg, N_REQ, SEED + 3)

    # -- the main path: deferred, kernels pinned -----------------------------
    AM.LAUNCHES = AM.DETECT_LAUNCHES = workflow.HOST_READS = 0
    sess, rids, rep, steps = serve(params, cfg, fused, prompts, GEN)
    c = rep["counters"]
    forwards = c["prefills"] + c["decode_steps"]
    launches = {"abft_matmul_detect": AM.DETECT_LAUNCHES,
                "abft_matmul": AM.LAUNCHES}
    reads = workflow.HOST_READS
    tokens = {r: sess.tokens_for(r) for r in rids}
    reasons = [r["finish_reason"] for r in rep["requests"]]
    log(f"  deferred, kernels on: {rep['completed']} requests, {c['prefills']} "
        f"prefills + {c['decode_steps']} decode steps, launches {launches}, "
        f"host reads {reads}, faults {c['faults_detected']}")
    if reasons != ["length"] * N_REQ or rep["completed"] != N_REQ:
        fail(f"requests finished with {reasons}")
    if c["faults_detected"] or c["dropped"] or c["faults_unattributed"]:
        fail(f"clean serving counted {c}")
    if any(any(h) for h in steps["hits"]):
        fail("the slot localizer hit on a clean step")
    if launches != {"abft_matmul_detect": n_sites * forwards,
                    "abft_matmul": 0} or reads != forwards:
        fail(f"{forwards} clean forwards launched {launches} with {reads} host "
             f"reads; want {n_sites} detect launches and 1 read each")
    res["deferred"] = {"counters": c, "launches": launches, "host_reads": reads,
                       "forwards": forwards}

    # -- per_layer serves the same tokens ------------------------------------
    workflow.HOST_READS = 0
    AM.LAUNCHES = AM.DETECT_LAUNCHES = 0
    s_pl, r_pl, rep_pl, _ = serve(params, cfg, fused, prompts[:8], 8,
                                  correction="per_layer")
    f_pl = rep_pl["counters"]["prefills"] + rep_pl["counters"]["decode_steps"]
    got = [s_pl.tokens_for(r) for r in r_pl]
    want = [tokens[r][:8] for r in rids[:8]]
    log(f"  per_layer, first 8 requests x 8 tokens: host reads "
        f"{workflow.HOST_READS} over {f_pl} forwards, abft_matmul launches "
        f"{AM.LAUNCHES}; tokens == deferred: {got == want}")
    if got != want:
        fail(f"per_layer tokens {got} differ from deferred's {want}")
    if workflow.HOST_READS != n_sites * f_pl or AM.LAUNCHES != n_sites * f_pl:
        fail(f"per_layer: {workflow.HOST_READS} reads, {AM.LAUNCHES} launches")
    res["per_layer"] = {"host_reads": workflow.HOST_READS, "forwards": f_pl,
                        "launches": AM.LAUNCHES}

    # -- teacher-forced check against the unprotected forward ----------------
    ucfg = cfg.replace(abft=False)
    gap, worst = 0.0, 0.0
    with torch.no_grad(), fp32_ieee():
        for r, p in zip(rids, prompts):
            seq = torch.as_tensor(list(p) + tokens[r], device=DEVICE)[None]
            ref, _, _ = M._forward(params, seq, ucfg)
            with core.plan_scope(fused, mode="detect_only"):
                kern, _, _ = M._forward(params, seq, cfg)
            plen = len(p)
            pos = torch.arange(plen - 1, seq.shape[1] - 1, device=DEVICE)
            served = seq[0, plen:]
            ref_p = ref[0, pos]
            gap = max(gap, max_err(kern[0, pos], ref_p))
            margin = ref_p.max(dim=-1).values - ref_p.gather(
                1, served[:, None])[:, 0]
            worst = max(worst, float(margin.max()))
    log(f"  teacher-forced vs the unprotected forward: largest logit gap "
        f"{gap:.4g}; served tokens at most {worst:.4g} below the reference's "
        f"top logit (limit {DELTA})")
    if not worst <= DELTA:
        fail(f"a served token's reference logit is {worst:.4g} below the top")
    res["teacher_forced"] = {"max_logit_gap": gap, "max_margin": worst}

    # -- timings: three sessions in turns, three rounds ----------------------
    sessions = {"unprotected": (ucfg, None), "kernels_off": (cfg, plan),
                "kernels_on": (cfg, fused)}
    times = {k: {"decode_ms": [], "ttft_ms": []} for k in sessions}
    for rnd in range(3):
        keys = list(sessions)
        for k in keys[rnd:] + keys[:rnd]:
            kcfg, kplan = sessions[k]
            _, _, rp, st = serve(params, kcfg, kplan, prompts, GEN)
            times[k]["decode_ms"].append(statistics.median(st["ms"]))
            times[k]["ttft_ms"].append(rp["ttft_p50_s"] * 1e3)
    for k, v in times.items():
        log(f"  {k}: median decode step ms {v['decode_ms']}, TTFT p50 ms "
            f"{v['ttft_ms']}")
    med = {k: {m: statistics.median(v[m]) for m in v} for k, v in times.items()}
    over = {k: {m: med[k][m] / med["unprotected"][m] - 1 for m in med[k]}
            for k in ("kernels_off", "kernels_on")}
    for k, v in over.items():
        log(f"  error-free overhead, {k}: decode step "
            f"{v['decode_ms'] * 100:.1f}%, TTFT p50 {v['ttft_ms'] * 100:.1f}%")
    res["times"], res["overhead"] = times, over

    # -- profile of one decode step of each session ---------------------------
    res["profile"] = {}
    for k, (kcfg, kplan) in sessions.items():
        from repro_torch.serving import ProtectedSession
        ps = ProtectedSession(params, kcfg, kplan, slots=SLOTS,
                              max_len=MAX_LEN, device=DEVICE)
        for p in prompts[:SLOTS]:
            ps.submit(p, max_new_tokens=GEN)
        ps.step()                     # admits all 8, one decode step
        prof = profile_forward(ps.step)
        res["profile"][k] = prof
        log(f"  profile, one decode step {k}: wall {prof['wall_ms']:.3f} ms, "
            f"device busy {prof['device_ms']:.3f} ms ({prof['kernels']} "
            f"kernels), idle share {prof['idle_share']:.3f}; top: " + ", ".join(
                f"{t['name'][:40]} {t['ms']:.3f}" for t in prof["top"][:4]))

    # -- phase 7: injected faults ---------------------------------------------
    log("phase 7: serving drills")
    drill_prompts, drill_ids = prompts[:SLOTS], rids[:SLOTS]
    clean = [tokens[r][:8] for r in drill_ids]
    target = 3

    def decode_hook(o):
        if o.dim() == 3 and o.shape[0] == SLOTS and o.shape[1] == 1:
            o = o.clone()
            o[target, 0, 1234 % o.shape[-1]] += 1e4
        return o

    s_d, r_d, rep_d, st_d = serve(params, cfg, fused, drill_prompts, 8,
                                  hook=("embed/table", decode_hook))
    recs = {r["id"]: r for r in rep_d["requests"]}
    by_slot = {recs[r]["slot"]: recs[r] for r in r_d}
    cd = rep_d["counters"]
    hit_slots = sorted({i for h in st_d["hits"] for i, x in enumerate(h) if x})
    ok = (by_slot[target]["faults_detected"] == cd["decode_steps"]
          and by_slot[target]["corrections_applied"] == cd["decode_steps"]
          and by_slot[target]["residuals"] == 0
          and all(v["faults_detected"] == 0 for sl, v in by_slot.items()
                  if sl != target)
          and cd["faults_unattributed"] == 0 and cd["residual_steps"] == 0
          and hit_slots == [target])
    same = [s_d.tokens_for(r) for r in r_d] == clean
    log(f"  decode fault at embed/table, slot {target}: {cd['faults_detected']} "
        f"detected / {cd['faults_corrected']} corrected over "
        f"{cd['decode_steps']} steps, localizer hit slots {hit_slots}, "
        f"unattributed {cd['faults_unattributed']}, residual steps "
        f"{cd['residual_steps']}; tokens == clean: {same}")
    if not (ok and same):
        fail(f"decode drill: {by_slot} counters {cd} tokens equal {same}")

    def prefill_hook(o):
        if o.shape[0] == 1 and o.shape[1] > 1:
            o = o.clone()
            o[0, 5, 17] += 1e3
        return o

    s_p, r_p, rep_p, _ = serve(params, cfg, fused, drill_prompts, 8,
                               hook=("stages/b0_attn_full/attn/wq",
                                     prefill_hook))
    recs = {r["id"]: r for r in rep_p["requests"]}
    cp_ = rep_p["counters"]
    ok = all(recs[r]["prefill_detected"] == 1 and recs[r]["residuals"] == 0
             for r in r_p) and cp_["residual_steps"] == 0
    same = [s_p.tokens_for(r) for r in r_p] == clean
    log(f"  prefill fault at stages/b0_attn_full/attn/wq (every repeat): "
        f"prefill_detected {[recs[r]['prefill_detected'] for r in r_p]}, "
        f"residuals {[recs[r]['residuals'] for r in r_p]}, corrected "
        f"{cp_['faults_corrected']}/{cp_['faults_detected']}; tokens == clean: "
        f"{same}")
    if not (ok and same):
        fail(f"prefill drill: {recs} counters {cp_} tokens equal {same}")
    res["drills"] = {"decode": {"counters": cd, "target": by_slot[target],
                                "hit_slots": hit_slots},
                     "prefill": {"counters": cp_}}
    res["audit"] = run_audit_drills(params, cfg, fused, drill_prompts,
                                    clean)
    report["serving"] = res
    return res, {"params": params, "cfg": cfg, "fused": fused,
                 "prompts": prompts, "tokens": [tokens[r] for r in rids]}


AUDIT_ENTRY = "stages/b0_attn_full/attn/wq"


def corrupt_one_column(w, gen) -> str:
    """The weight_corrupt_correctable damage class, drawn by the
    registry: 1..100 elements of one column of the middle repeat of a
    stacked (reps, K, M) leaf overwritten in place."""
    from repro_torch.core import injection as inj
    model = inj.FAULT_MODELS["weight_corrupt_correctable"]
    r = int(w.shape[0]) // 2
    k, m = int(w.shape[1]), int(w.shape[2])
    spec = model.plan(gen, k, m, 1, 100)
    w[r].copy_(inj.inject(w[r], spec.to(w.device), model))
    return (f"repeat {r}, column {int(spec.index)}: {int(spec.nelem)} "
            f"elements set to {float(spec.add):g}")


def run_audit_drills(params, cfg, plan, prompts, clean) -> dict:
    """Phase 7b: the plan-trusted weight audit of a serving session at
    full width. Sessions with audit_every=1 and a restore_fn that returns
    a saved copy of the clean params serve `prompts` (8 new tokens each).
    Drill 1 overwrites 1..K elements of one column of one repeat of a
    stage's wq in place between two steps (the weight_corrupt_correctable
    damage class, drawn by the registry): the next audit repairs it in
    place - verdict `repaired`, no restore, the leaf bitwise the clean
    one. Drill 2 corrupts two blocks: the ladder restores. Both serve the
    clean run's tokens; the deferred detect kernel carries every forward."""
    import torch
    from repro_torch.core import weight_leaf, workflow
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.runtime import ft
    from repro_torch.serving import ProtectedSession

    log("phase 7b: the serving weight audit")
    name = AUDIT_ENTRY
    if name not in plan:
        fail(f"the plan has no entry {name}")
    clone = lambda t: ({k: clone(v) for k, v in t.items()}
                       if isinstance(t, dict) else t.clone())
    saved = clone(params)
    bits = lambda t: t.contiguous().view(torch.int16)
    n_sites = cfg.stages()[1] * 7 + 1
    # the audit alone on clean weights, and the repair rung on a flagged
    # leaf, timed on the host (each reads its verdicts back)
    aud_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        ok, bad = ft.audit_weights_against_plan(params, plan)
        aud_ms.append((time.perf_counter() - t0) * 1e3)
        if not ok:
            fail(f"clean weights fail the audit: {bad[:3]}")
    gen = torch.Generator().manual_seed(SEED + 7)
    out = {"audit_ms": aud_ms, "entry": name}

    def drill(label, corrupt):
        sp = clone(params)
        sess = ProtectedSession(sp, cfg, plan, slots=SLOTS, max_len=MAX_LEN,
                                audit_every=1, restore_fn=lambda: saved,
                                device=DEVICE)
        rids = [sess.submit(p, max_new_tokens=8) for p in prompts]
        AM.LAUNCHES = AM.DETECT_LAUNCHES = workflow.HOST_READS = 0
        for _ in range(2):
            sess.step()
        what = corrupt(weight_leaf(sess.params, name))
        while sess.step():
            pass
        torch.cuda.synchronize()
        rep = sess.stats.report()
        c = rep["counters"]
        forwards = c["prefills"] + c["decode_steps"]
        verdicts = sorted({v for r in rep["requests"]
                           for v in r["audit_verdicts"]})
        same = [sess.tokens_for(r) for r in rids] == clean
        leaf_ok = torch.equal(bits(weight_leaf(sess.params, name)),
                              bits(weight_leaf(saved, name)))
        res = {"what": what, "counters": {k: c[k] for k in (
                   "weight_audits", "weight_repairs", "weight_restores",
                   "faults_detected", "dropped")},
               "verdicts": verdicts, "tokens_equal": same,
               "leaf_bitwise_clean": leaf_ok,
               "repair_ms": [r * 1e3 for r in sess.stats.repair_s],
               "detect_launches": AM.DETECT_LAUNCHES, "forwards": forwards}
        log(f"  {label}: {what}; audits {c['weight_audits']}, repairs "
            f"{c['weight_repairs']}, restores {c['weight_restores']}, "
            f"verdicts {verdicts}; leaf bitwise clean {leaf_ok}; tokens == "
            f"clean: {same}; detect launches {AM.DETECT_LAUNCHES} over "
            f"{forwards} forwards")
        if AM.DETECT_LAUNCHES != n_sites * forwards or c["faults_detected"]:
            fail(f"{label}: {AM.DETECT_LAUNCHES} detect launches over "
                 f"{forwards} forwards, faults {c['faults_detected']}")
        if not same or not leaf_ok or c["dropped"]:
            fail(f"{label}: {res}")
        return res

    one_column = lambda w: corrupt_one_column(w, gen)

    def two_blocks(w):
        reps, k, m = (int(d) for d in w.shape)
        w[0, 11, 40] += 977.0
        w[reps - 1, k - 5, m - 7] -= 977.0
        return (f"repeat 0 (11, 40) and repeat {reps - 1} ({k - 5}, "
                f"{m - 7}) moved by 977")

    r1 = drill("drill 1, one column", one_column)
    if not (r1["counters"]["weight_repairs"] == 1
            and r1["counters"]["weight_restores"] == 0
            and "repaired" in r1["verdicts"]):
        fail(f"drill 1 did not repair in place: {r1}")
    r2 = drill("drill 2, two blocks", two_blocks)
    if not (r2["counters"]["weight_restores"] == 1
            and r2["counters"]["weight_repairs"] == 0
            and "restored" in r2["verdicts"]):
        fail(f"drill 2 did not restore: {r2}")
    # the repair alone, warm: the float64 solve of the flagged stacked
    # leaf and the write-back of the repaired one, on a fresh one-column
    # damage of drill 1's class
    bad = clone(params)
    one_column(weight_leaf(bad, name))
    ok, flagged = ft.audit_weights_against_plan(bad, plan)
    rep_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        fixed, repaired = ft.repair_weights_against_plan(bad, plan, flagged)
        torch.cuda.synchronize()
        rep_ms.append((time.perf_counter() - t0) * 1e3)
        if ok or repaired != [name] or not torch.equal(
                bits(weight_leaf(fixed, name)), bits(weight_leaf(saved, name))):
            fail(f"warm repair: flagged {flagged}, repaired {repaired}")
    log(f"  audit ms (clean, 8 entries): median "
        f"{statistics.median(aud_ms):.2f} of {[round(a, 2) for a in aud_ms]}; "
        f"repair rung ms in drill 1 (repair + re-audit, first float64 "
        f"solve of the process) {r1['repair_ms']}; the repair alone, warm: "
        f"median {statistics.median(rep_ms):.2f} of "
        f"{[round(a, 2) for a in rep_ms]}")
    out.update({"repair": r1, "restore": r2, "warm_repair_ms": rep_ms})
    return out


# --------------------------------------------------------------------------
# phase 9: the calibrated plan
# --------------------------------------------------------------------------

def conv_sums_tiling(n: int, m: int, p: int):
    """(column tiles, row groups) of a conv-sums launch over fp32
    O[n, m, p] as the CUDA source tiles it, read back from its layout
    (counters: one per column tile and one more; scratch: rg * (3p +
    column tiles) floats when rg > 1, one per column tile otherwise)."""
    import torch
    from repro_torch.kernels import checksum_reduce as CR
    floats, counters = CR.conv_sums_layout(n, m, p, torch.float32)
    ct, scratch = counters - 1, floats - 3 * p - 1
    return ct, (1 if scratch == ct else scratch // (3 * p + ct))


def fmt_us(v) -> str:
    """A profile's microseconds; None where the kernel route cannot run."""
    return "no kernel route" if v is None else f"{v:.1f} us"


def profile_key(site):
    """build_plan's memo key of a site's kernel profile: a conv's output
    view (n, m, e), a GEMM's (n, k, m)."""
    s = site.shape
    return ("conv", s.n, s.m, s.h) if site.op.kind == "conv" \
        else ("mm", s.n, s.ch, s.m)


def log_profiles(plan, spec) -> list:
    """One line per distinct profile key of a profiled plan: the sites,
    plain and kernel-route us, the winner, and the tiling the CUDA source
    chose for the kernel route (f32, as profiled)."""
    import torch
    from repro_torch.kernels import abft_matmul as AM
    kp = plan.meta["kernel_profile"]
    groups = {}
    for site in spec.sites:
        if site.path in kp:
            groups.setdefault(profile_key(site), []).append(site.path)
    rows = []
    for key, paths in groups.items():
        d = kp[paths[0]]
        if d.get("skipped"):
            continue
        if key[0] == "conv":
            _, n, m, e = key
            ct, rg = conv_sums_tiling(n, m, e * e)
            tiling = f"conv sums {ct} column tiles x {rg} row groups"
        else:
            _, n, k, m = key
            t = AM.kernel_tiling(n, k, m, torch.float32)
            tiling = f"abft_matmul tile {t.tm}x{t.tn}, {t.splits} splits"
        winner = "kernel" if d["use_fused"] else "plain"
        names = [q.split("/")[-1] for q in paths]
        log(f"    {key}: {', '.join(dict.fromkeys(names))} ({len(paths)} "
            f"sites): plain {fmt_us(d['plain_us'])}, kernel route "
            f"{fmt_us(d['fused_us'])} -> {winner}; {tiling}")
        rows.append({"key": list(key), "sites": paths, **d,
                     "winner": winner, "tiling": tiling})
    return rows


def run_calibrated_plan(report, slice_ctx) -> dict:
    """Phase 9: the paper's offline profiling step on full-width
    ResNet-18. The card's peaks measured (refresh, cache under build/);
    the measured-roofline plan (MeasuredCostModel, profile_kernels=True:
    per-site roofline verdict, execution membership, the prune) and the
    analytic plan with every shape profiled, each printed; the measured
    plan checked in deferred mode (clean: no flag, logits bitwise the
    unprotected ones, one host read per per_layer member plus one; a
    registry burst at a per_layer member and at a deferred member:
    detected, residual 0, logits back within rtol 1e-4); the new plans'
    launches per forward, their forwards timed in turns with the
    unprotected one and phase 4's pinned plan; and the decisions of
    build_plan(profile_kernels=True) for SmolLM-360M (policy only)."""
    import torch
    from repro_torch import configs, core
    from repro_torch.core import injection as inj
    from repro_torch.core import workflow
    from repro_torch.core.cost_model import MeasuredCostModel, measure_peaks
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.kernels import checksum_reduce as CR
    from repro_torch.models import cnn

    log("phase 9: the calibrated plan")
    params, x, cfg = slice_ctx["params"], slice_ctx["x"], slice_ctx["cfg"]
    fused, unprot, l0 = (slice_ctx["fused"], slice_ctx["unprot"],
                         slice_ctx["l0"])
    cache = str(ROOT / "build" / "roofline_cache.json")
    t0 = time.perf_counter()
    peaks = measure_peaks(cache_path=cache, refresh=True, device=DEVICE)
    peaks_s = time.perf_counter() - t0
    log(f"  measured peaks ({peaks_s:.1f} s): IEEE-fp32 GEMM "
        f"{peaks.peak_flops / 1e12:.2f} TFLOP/s ({peaks.peak_flops / FP32_FLOPS_PER_S * 100:.1f}% "
        f"of the datasheet's 67), triad {peaks.hbm_bw / 1e12:.3f} TB/s "
        f"({peaks.hbm_bw / HBM_BYTES_PER_S * 100:.1f}% of 3.35); ridge "
        f"{peaks.ridge:.2f} FLOP/B (datasheet "
        f"{FP32_FLOPS_PER_S / HBM_BYTES_PER_S:.2f})")
    if peaks.source != "measured":
        fail(f"peaks not measured: source {peaks.source}")
    if (peaks.peak_flops > 1.05 * FP32_FLOPS_PER_S
            or peaks.hbm_bw > 1.05 * HBM_BYTES_PER_S):
        fail(f"peaks above 105% of the datasheet: {peaks.doc()}")
    mcm = MeasuredCostModel.from_host(cache_path=cache, device=DEVICE)
    res = {"peaks": peaks.doc(), "peaks_s": peaks_s,
           "detect_chunk": mcm.detect_chunk(1024)}

    spec = core.protection_spec(cfg, batch=BATCH)
    t0 = time.perf_counter()
    measured = core.build_plan(params, cfg, cost_model=mcm, batch=BATCH,
                               profile_kernels=True, device=DEVICE)
    torch.cuda.synchronize()
    res["measured_build_s"] = time.perf_counter() - t0
    roof, kpm = measured.meta["roofline"], measured.meta["kernel_profile"]
    inline = [n for n in measured.names()
              if measured[n].execution == "per_layer"]
    deferred = [n for n in measured.names()
                if measured[n].execution == "deferred"]
    log(f"  measured plan ({res['measured_build_s']:.1f} s): "
        f"{len(inline)} per_layer + {len(deferred)} deferred members, "
        f"detection chunk {res['detect_chunk']}")
    sites = []
    for site in spec.sites:
        n, r, d = site.path, roof[site.path], kpm[site.path]
        what = ("pruned" if d.get("skipped") else
                f"profiled: plain {fmt_us(d['plain_us'])}, kernel route "
                f"{fmt_us(d['fused_us'])} -> "
                f"{'kernel' if d['use_fused'] else 'plain'}")
        log(f"    {n}: intensity {r['intensity']:.1f} FLOP/B, "
            f"{r['bound']}-bound, {measured[n].execution}, {what}")
        sites.append({"site": n, "intensity": r["intensity"],
                      "bound": r["bound"],
                      "execution": measured[n].execution, **d})
    res["measured"] = {"sites": sites, "inline": inline,
                       "deferred": deferred}

    t0 = time.perf_counter()
    profiled = core.build_plan(params, cfg, batch=BATCH,
                               profile_kernels=True, device=DEVICE)
    torch.cuda.synchronize()
    res["profiled_build_s"] = time.perf_counter() - t0
    log(f"  analytic plan, every shape profiled "
        f"({res['profiled_build_s']:.1f} s; {len(spec.sites)} sites):")
    res["profiled"] = log_profiles(profiled, spec)
    pruned_wins = [n for n in measured.names()
                   if kpm[n].get("skipped")
                   and profiled.meta["kernel_profile"][n]["use_fused"]]
    res["pruned_where_kernel_wins"] = pruned_wins
    log(f"  sites the roofline prune keeps on the plain route where the "
        f"analytic profile picks the kernel: {pruned_wins or 'none'}")

    # -- the measured plan in deferred mode: clean ---------------------------
    CR.LAUNCHES = AM.LAUNCHES = workflow.HOST_READS = 0
    lm, rep = cnn.forward_cnn(params, x, cfg, plan=measured,
                              correction="deferred")
    torch.cuda.synchronize()
    launches = {"measured/deferred": (CR.LAUNCHES, AM.LAUNCHES)}
    reads = workflow.HOST_READS
    bad = {n: v for n, v in rep.summary().items()
           if v["detected"] or v["residual"]}
    want_reads = len(inline) + (1 if deferred else 0)
    scale = float(l0.abs().max()) + 1.0
    fc_kernel = measured["fc"].cfg.use_fused_kernel
    same = torch.equal(lm, l0)
    log(f"  measured plan, deferred, clean: flags "
        f"{sum(v['detected'] for v in rep.summary().values())}/"
        f"{len(measured)}, host reads {reads} (want {want_reads}), "
        f"launches (conv sums, abft_matmul) {launches['measured/deferred']}, "
        f"logits bitwise the unprotected ones: {same}")
    if bad:
        fail(f"measured plan: clean forward reported {bad}")
    if reads != want_reads:
        fail(f"measured plan: {reads} host reads, want {want_reads}")
    if not (same or (fc_kernel and max_err(lm, l0) <= 1e-5 * scale)):
        fail(f"measured plan: logits differ from the unprotected forward "
             f"(max |diff| {max_err(lm, l0):.3g})")

    # -- a registry burst at a per_layer member and at a deferred member -----
    model = inj.FAULT_MODELS["burst"]
    gen = torch.Generator().manual_seed(SEED + 9)
    drills = {}
    targets = [("per_layer", inline), ("deferred", deferred)]
    for membership, members in targets:
        if not members:
            fail(f"the measured plan has no {membership} member")
        site = members[len(members) // 2]
        if site.startswith("conv"):
            layer = int(site[len("conv"):])
            _, o_clean = cnn.conv_output_at(params, x, cfg, layer)
            sp = model.plan(gen, o_clean.shape[0], o_clean.shape[1],
                            o_clean.shape[2] * o_clean.shape[3], 100)
            o_bad = inj.inject(o_clean, sp.to(o_clean.device), model)
            lg, rep = cnn.forward_cnn(params, x, cfg, plan=measured,
                                      correction="deferred",
                                      inject_layer=layer, inject_o=o_bad)
        else:
            sp = model.plan(gen, BATCH, cfg.num_classes, 1, 100)
            hook = lambda o, sp=sp: inj.inject(o, sp.to(o.device), model)
            with inj.fault_scope(site, hook):
                lg, rep = cnn.forward_cnn(params, x, cfg, plan=measured,
                                          correction="deferred")
        summ = rep.summary()
        v = summ[site]
        others = {k: w for k, w in summ.items()
                  if k != site and w["detected"]}
        d_l = max_err(lg, lm)
        log(f"  burst at {site} ({membership}; axis {int(sp.axis)}, "
            f"{int(sp.nelem)} elements, scale {float(sp.scale):g}): "
            f"detected {v['detected']}, corrected_by {v['corrected_by']}, "
            f"residual {v['residual']}, logits max |diff| {d_l:.3g}")
        if not (v["detected"] == 1 and v["residual"] == 0
                and v["corrected_by"] != "none" and not others
                and torch.allclose(lg, lm, rtol=1e-4, atol=1e-4 * scale)):
            fail(f"measured plan, burst at {site}: {v}, others {others}, "
                 f"logit diff {d_l:.3g}")
        drills[site] = {**v, "membership": membership,
                        "logit_max_diff": d_l}
    res["drills"] = drills

    # -- launches per forward and times in turns ------------------------------
    for mode in ("per_layer", "deferred"):
        CR.LAUNCHES = AM.LAUNCHES = 0
        cnn.forward_cnn(params, x, cfg, plan=profiled, correction=mode)
        torch.cuda.synchronize()
        launches[f"profiled/{mode}"] = (CR.LAUNCHES, AM.LAUNCHES)
    res["launches"] = launches
    log("  launches per clean forward (conv sums, abft_matmul): " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    fwd = lambda plan, mode: (lambda: cnn.forward_cnn(params, x, cfg,
                                                      plan=plan,
                                                      correction=mode))
    times = time_host({
        "unprotected": unprot,
        "pinned/per_layer": fwd(fused, "per_layer"),
        "pinned/deferred": fwd(fused, "deferred"),
        "measured/deferred": fwd(measured, "deferred"),
        "profiled/per_layer": fwd(profiled, "per_layer"),
        "profiled/deferred": fwd(profiled, "deferred"),
    })
    res["forward_ms"] = times
    log("  median forward ms in turns: " + " ".join(
        f"{k}={v:.3f}" for k, v in times.items()))
    log("  error-free overhead: " + ", ".join(
        f"{k} {(v / times['unprotected'] - 1) * 100:.1f}%"
        for k, v in times.items() if k != "unprotected"))

    # -- SmolLM-360M: the profile's decisions ---------------------------------
    scfg = configs.get(SERVE_ARCH)
    sspec = core.protection_spec(scfg, batch=SLOTS, seq=128)
    t0 = time.perf_counter()
    splan = core.build_plan(None, scfg, batch=SLOTS, seq=128,
                            profile_kernels=True, device=DEVICE)
    torch.cuda.synchronize()
    res["smollm_build_s"] = time.perf_counter() - t0
    log(f"  {SERVE_ARCH} at batch {SLOTS} x seq 128, every GEMM profiled "
        f"in float32 as the reference does ({res['smollm_build_s']:.1f} s; "
        f"{len(sspec.sites)} sites):")
    res["smollm"] = log_profiles(splan, sspec)
    report["calibrated"] = res
    return res


# --------------------------------------------------------------------------
# phase 10: the async serving driver
# --------------------------------------------------------------------------

def step_period_ms(decode_log) -> float:
    """Median milliseconds between consecutive decode launches."""
    at = [e["launched_at"] for e in decode_log]
    return statistics.median((b - a) * 1e3 for a, b in zip(at, at[1:]))


def drive(params, cfg, plan, prompts, gen: int, paused=False, hook=None,
          **kw):
    """One ServingDriver over `prompts`: (driver, verdicts, report). The
    requests are submitted from this thread (inside `paused()` when
    `paused`, so they are admitted together) under `hook`'s fault_scope,
    which the driver's threads inherit; drain, then close."""
    import contextlib
    from repro_torch.core import injection
    from repro_torch.serving import ServingDriver
    d = ServingDriver(params, cfg, plan, slots=SLOTS, max_len=MAX_LEN,
                      device=DEVICE, **kw)
    scope = injection.fault_scope(*hook) if hook else contextlib.nullcontext()
    try:
        with scope:
            with d.paused() if paused else contextlib.nullcontext():
                verdicts = [d.submit(p, max_new_tokens=gen) for p in prompts]
            report = d.drain(timeout=900)
    finally:
        d.close()
    return d, verdicts, report


def run_driver_phase(report, serve_ctx) -> dict:
    """Phase 10: phase 6's SmolLM-360M served by the async ServingDriver
    (8 slots, 256 positions, deferred, the kernels pinned) on the same 16
    requests: every request completes with phase 6's tokens, 225 detect
    launches and one host read per forward; backpressure (capacity 4, 16
    submitted at once: the rest rejected, the accepted served) and a
    lapsed deadline (timeout, never a slot); phase 7's head drill under a
    fault_scope around submit/drain, attributed to the requests of slot 3
    only; phase 7b's one-column corruption repaired in place by the
    controller's audit while requests are admitted; and the driver timed
    against the synchronous session in turns (step period, TTFT p50)."""
    import torch
    from repro_torch.core import weight_leaf, workflow
    from repro_torch.kernels import abft_matmul as AM

    log("phase 10: the async serving driver")
    params, cfg, fused = (serve_ctx["params"], serve_ctx["cfg"],
                          serve_ctx["fused"])
    prompts, tokens = serve_ctx["prompts"], serve_ctx["tokens"]
    n_sites = cfg.stages()[1] * 7 + 1
    res = {}

    # -- the main path ---------------------------------------------------------
    AM.LAUNCHES = AM.DETECT_LAUNCHES = workflow.HOST_READS = 0
    d, vs, rep = drive(params, cfg, fused, prompts, GEN)
    c = rep["counters"]
    forwards = c["prefills"] + c["decode_steps"]
    launches = {"abft_matmul_detect": AM.DETECT_LAUNCHES,
                "abft_matmul": AM.LAUNCHES}
    reads = workflow.HOST_READS
    same = [d.tokens_for(v.rid) for v in vs] == tokens
    reasons = [r["finish_reason"] for r in rep["requests"]]
    log(f"  driver: {rep['completed']} requests, {c['prefills']} prefills + "
        f"{c['decode_steps']} decode steps, launches {launches}, host reads "
        f"{reads}, faults {c['faults_detected']}; tokens == phase 6: {same}")
    if not all(v.accepted for v in vs) or reasons != ["length"] * N_REQ:
        fail(f"driver: verdicts {vs}, finished {reasons}")
    if c["faults_detected"] or c["dropped"] or not same:
        fail(f"driver: counters {c}, tokens equal {same}")
    if launches != {"abft_matmul_detect": n_sites * forwards,
                    "abft_matmul": 0} or reads != forwards:
        fail(f"driver: {forwards} forwards launched {launches} with {reads} "
             f"host reads; want {n_sites} detect launches and 1 read each")
    res["main"] = {"counters": c, "launches": launches, "host_reads": reads,
                   "forwards": forwards}

    # -- backpressure and a lapsed deadline ----------------------------------------
    from repro_torch.serving import ServingDriver
    d = ServingDriver(params, cfg, fused, slots=SLOTS, max_len=MAX_LEN,
                      queue_capacity=4, device=DEVICE)
    try:
        with d.paused():
            dead = d.submit(prompts[0], max_new_tokens=8, deadline_s=1e-3)
            t0 = time.monotonic()
            while d.stats.record(dead.rid).finish_reason != "timeout":
                if time.monotonic() - t0 > 30:
                    fail("the lapsed request was not swept")
                time.sleep(0.01)
            vs = [d.submit(p, max_new_tokens=8) for p in prompts]
        rep = d.drain(timeout=900)
    finally:
        d.close()
    acc = [i for i, v in enumerate(vs) if v.accepted]
    rej = [v.reason for v in vs if not v.accepted]
    recs = {r["id"]: r for r in rep["requests"]}
    dr = recs[dead.rid]
    ok = (len(acc) == 4 and rej == ["queue_full"] * (N_REQ - 4)
          and rep["completed"] == 4
          and all(d.tokens_for(vs[i].rid) == tokens[i][:8] for i in acc)
          and dr["finish_reason"] == "timeout" and dr["slot"] is None
          and dr["admitted_at"] is None
          and rep["counters"]["timeouts"] == 1)
    log(f"  capacity 4, {N_REQ} submitted at once: accepted {len(acc)}, "
        f"rejected {len(rej)} ({set(rej)}), completed {rep['completed']} "
        f"with phase 6's tokens; lapsed deadline: {dr['finish_reason']}, "
        f"slot {dr['slot']}")
    if not ok:
        fail(f"backpressure/deadline: accepted {acc}, rejected {rej}, "
             f"lapsed {dr}, counters {rep['counters']}")
    res["backpressure"] = {"accepted": len(acc), "rejected": len(rej),
                           "lapsed": dr["finish_reason"]}

    # -- phase 7's head drill under a fault_scope around submit/drain -------------
    target = 3
    drill_prompts, clean = prompts[:SLOTS], [t[:8] for t in tokens[:SLOTS]]

    def decode_hook(o):
        if o.dim() == 3 and o.shape[0] == SLOTS and o.shape[1] == 1:
            o = o.clone()
            o[target, 0, 1234 % o.shape[-1]] += 1e4
        return o

    d, vs, rep = drive(params, cfg, fused, drill_prompts, 8, paused=True,
                       hook=("embed/table", decode_hook))
    recs = {r["id"]: r for r in rep["requests"]}
    by_slot = {recs[v.rid]["slot"]: recs[v.rid] for v in vs}
    cd = rep["counters"]
    hit_slots = sorted({i for e in d.stats.decode_log
                        for i, h in enumerate(e["hit"]) if h})
    t_rec = by_slot[target]
    ok = (t_rec["faults_detected"] >= 1
          and t_rec["corrections_applied"] == t_rec["faults_detected"]
          and t_rec["residuals"] == 0
          and all(v["faults_detected"] == 0 for sl, v in by_slot.items()
                  if sl != target)
          and cd["residual_steps"] == 0 and hit_slots == [target])
    same = [d.tokens_for(v.rid) for v in vs] == clean
    log(f"  decode fault at embed/table, slot {target}, scope around "
        f"submit/drain: {cd['faults_detected']} detected / "
        f"{cd['faults_corrected']} corrected over {cd['decode_steps']} "
        f"steps; slot {target}'s request {t_rec['faults_detected']} "
        f"detected, the others 0; localizer hit slots {hit_slots}, "
        f"unattributed {cd['faults_unattributed']} (steps launched after "
        f"the last request finished), residual steps "
        f"{cd['residual_steps']}; tokens == clean: {same}")
    if not (ok and same):
        fail(f"driver decode drill: {by_slot} counters {cd} tokens {same}")
    res["drill"] = {"counters": cd, "target": t_rec, "hit_slots": hit_slots}

    # -- phase 7b's one-column corruption, repaired by the controller's audit --
    clone = lambda t: ({k: clone(v) for k, v in t.items()}
                       if isinstance(t, dict) else t.clone())
    bits = lambda t: t.contiguous().view(torch.int16)
    sp = clone(params)
    d = ServingDriver(sp, cfg, fused, slots=SLOTS, max_len=MAX_LEN,
                      audit_every=1, restore_fn=lambda: params,
                      device=DEVICE)
    try:
        first = [d.submit(p, max_new_tokens=8) for p in drill_prompts[:4]]
        t0 = time.monotonic()
        while d.tokens_generated(first[0].rid) < 2:
            if time.monotonic() - t0 > 300:
                fail("the audit drill made no progress")
            time.sleep(0.01)
        with d.paused():
            what = corrupt_one_column(weight_leaf(d.params, AUDIT_ENTRY),
                                      torch.Generator().manual_seed(SEED + 7))
            later = [d.submit(p, max_new_tokens=8)
                     for p in drill_prompts[4:]]
        rep = d.drain(timeout=900)
    finally:
        d.close()
    c = rep["counters"]
    vs = first + later
    verdicts = sorted({v for r in rep["requests"] for v in r["audit_verdicts"]})
    same = [d.tokens_for(v.rid) for v in vs] == clean
    leaf_ok = torch.equal(bits(weight_leaf(d.params, AUDIT_ENTRY)),
                          bits(weight_leaf(params, AUDIT_ENTRY)))
    log(f"  audit drill ({what}, corrupted between two steps, 4 requests "
        f"submitted meanwhile): audits {c['weight_audits']}, repairs "
        f"{c['weight_repairs']}, restores {c['weight_restores']}, verdicts "
        f"{verdicts}, repair ms {[round(r * 1e3, 2) for r in d.stats.repair_s]}; "
        f"leaf bitwise clean {leaf_ok}; {rep['completed']} completed, "
        f"tokens == clean: {same}")
    if not (c["weight_repairs"] == 1 and c["weight_restores"] == 0
            and "repaired" in verdicts and leaf_ok and same
            and all(v.accepted for v in later) and rep["completed"] == 8
            and not c["faults_detected"]):
        fail(f"driver audit drill: counters {c}, verdicts {verdicts}, leaf "
             f"{leaf_ok}, tokens {same}")
    res["audit"] = {"what": what, "counters": c, "verdicts": verdicts,
                    "repair_ms": [r * 1e3 for r in d.stats.repair_s]}
    del sp

    # -- the driver against the synchronous session, in turns --------------------
    times = {k: {"step_ms": [], "ttft_ms": []} for k in ("session", "driver")}
    for rnd in range(3):
        for k in (("session", "driver") if rnd % 2 == 0
                  else ("driver", "session")):
            if k == "session":
                sess, _, rp, _ = serve(params, cfg, fused, prompts, GEN)
                dlog = sess.stats.decode_log
            else:
                dd, _, rp = drive(params, cfg, fused, prompts, GEN)
                dlog = dd.stats.decode_log
            times[k]["step_ms"].append(step_period_ms(dlog))
            times[k]["ttft_ms"].append(rp["ttft_p50_s"] * 1e3)
    med = {k: {m: statistics.median(v[m]) for m in v} for k, v in times.items()}
    for k, v in times.items():
        log(f"  {k}: decode step period ms {[round(t, 3) for t in v['step_ms']]}, "
            f"TTFT p50 ms {[round(t, 2) for t in v['ttft_ms']]}")
    log(f"  driver / session: step period "
        f"{med['driver']['step_ms'] / med['session']['step_ms']:.3f}, TTFT "
        f"p50 {med['driver']['ttft_ms'] / med['session']['ttft_ms']:.3f}")
    res["times"], res["medians"] = times, med
    report["driver"] = res
    return res


# --------------------------------------------------------------------------
# phase 8: the campaign
# --------------------------------------------------------------------------

def run_campaign_phase(report) -> dict:
    """Phase 8: the fault-injection campaign on the card. The JAX CLI's
    default grid (matmul and conv, scheme full, every registered arm) at
    1000 trials per cell, and the whole grid (three layers x five
    schemes x every arm) at GRID_TRIALS: every gate of the port's check
    holds, and deferred gives full's detection rate and scheme histogram
    per arm.
    One cell per layer (64 trials per arm, scheme full) is run again on
    the CPU: the per-trial verdicts are compared; a detected or residual
    mismatch fails. corrected_by may differ (which rung first verifies
    depends on the order of the sums, ROADMAP 3.4), but only between two
    correcting verdicts and in at most RUNG_MISMATCH_SHARE of the
    trials."""
    import numpy as np
    from repro_torch.campaign import (LAYER_CASES, SCHEME_CONFIGS,
                                      CampaignEngine)
    from repro_torch.campaign.run import check
    from repro_torch.core import types as T
    correcting = [T.COC, T.RC, T.CLC, T.FC, T.RECOMPUTE]

    log("phase 8: the campaign")
    eng = CampaignEngine(device=DEVICE)
    rows = lambda c: log(f"  {c.row()}")
    t0 = time.perf_counter()
    paper = eng.run(["matmul", "conv"], ["full"], trials=1000, seed=SEED,
                    progress=rows)
    paper_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid = eng.run(list(LAYER_CASES), list(SCHEME_CONFIGS),
                   trials=GRID_TRIALS, seed=SEED, progress=rows)
    grid_s = time.perf_counter() - t0
    bad = check(paper) + check(grid)
    if bad:
        fail(f"campaign gates: {bad}")
    for c in grid.cells:
        if c.scheme == "deferred":
            f = grid.cell(c.layer, "full", c.fault)
            if (c.detection_rate, c.corrected_by) != \
                    (f.detection_rate, f.corrected_by):
                fail(f"{c.layer}/{c.fault}: deferred {c.detection_rate} "
                     f"{c.corrected_by} vs full {f.detection_rate} "
                     f"{f.corrected_by}")
    cpu = CampaignEngine(device="cpu")
    mism = {}
    for layer in LAYER_CASES:
        for fault in [c.fault for c in grid.cells
                      if c.layer == layer and c.scheme == "full"]:
            a, _ = eng.run_trials(layer, "full", fault, 64, seed=SEED)
            b, _ = cpu.run_trials(layer, "full", fault, 64, seed=SEED)
            n = {f: int(np.sum(getattr(a, f) != getattr(b, f)))
                 for f in ("detected", "corrected_by", "residual")}
            mism[f"{layer}/{fault}"] = n
            if n["detected"] or n["residual"]:
                fail(f"card vs CPU {layer}/{fault}: {n}")
            rung = a.corrected_by != b.corrected_by
            if not (np.isin(a.corrected_by[rung], correcting).all()
                    and np.isin(b.corrected_by[rung], correcting).all()):
                fail(f"card vs CPU {layer}/{fault}: corrected_by "
                     f"{a.corrected_by[rung]} vs {b.corrected_by[rung]}")
    by = sum(v["corrected_by"] for v in mism.values())
    if by > RUNG_MISMATCH_SHARE * 64 * len(mism):
        fail(f"card vs CPU: {by} corrected_by mismatches in "
             f"{64 * len(mism)} trials")
    trials = sum(c.trials for c in paper.cells + grid.cells)
    wall = paper.meta["wall_seconds"] + grid.meta["wall_seconds"]
    log(f"  gates hold on {len(paper.cells)} paper cells x "
        f"{paper.meta['trials']} and {len(grid.cells)} grid cells x "
        f"{grid.meta['trials']} trials; deferred == full per "
        f"arm; card vs CPU (64 trials per arm, scheme full): 0 detected / "
        f"0 residual mismatches, {by} corrected_by mismatches of "
        f"{64 * len(mism)}")
    log(f"  {trials} trials, {wall:.1f} s in the trial loops "
        f"({wall / trials * 1e6:.0f} us per trial on the host clock); "
        f"phase {paper_s + grid_s:.1f} s")
    res = {"paper": paper.to_dict(), "grid": grid.to_dict(),
           "card_vs_cpu_mismatches": mism,
           "us_per_trial": wall / trials * 1e6,
           "paper_s": paper_s, "grid_s": grid_s}
    report["campaign"] = res
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", metavar="PATH",
                    help="also write the run's details as JSON to PATH")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has nothing to run without one", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    report = {}

    log("phase 1: environment")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"  python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind} x{torch.cuda.device_count()}")
    log(f"  {smi}")
    report["env"] = {"torch": torch.__version__, "cuda": torch.version.cuda,
                     "nvidia_smi": smi, "device": kind}

    log("phase 2: build")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"  built {', '.join(_build.SOURCES)} in {build_s:.1f} s")
    for name, text in _build.PTXAS_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  [{name}] {line.strip()}")
    report["build_s"] = build_s

    log("phase 3: kernels vs their plain versions")
    from repro_torch.models import cnn
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cfg = cnn.resnet18(1.0)
    kernels = [check_checksum_reduce(cfg, gen, report),
               check_abft_matmul(cfg, gen, report)]
    log("phase 3b: the serving path's kernels at SmolLM-360M's shapes")
    kernels += check_serving_kernels(gen, report)

    log("phase 4: the slice")
    res, slice_ctx = run_slice(report)
    for k in kernels[:2]:
        k["launches"] = res["per_layer"]["launches"][k["name"]]
        k["launches_from"] = "phase 4: one clean per_layer forward"

    log("phase 6: the serving slice")
    serving, serve_ctx = run_serving(report)
    # the detect kernel's count is the deferred main path's; the serving
    # abft_matmul row's is the per_layer path's (0 launches when deferred
    # and clean)
    kernels[2]["launches"] = serving["deferred"]["launches"][
        "abft_matmul_detect"]
    kernels[2]["launches_from"] = "phase 6: the deferred session's forwards"
    kernels[3]["launches"] = serving["per_layer"]["launches"]
    kernels[3]["launches_from"] = "phase 6: the per_layer session's forwards"
    run_campaign_phase(report)
    run_calibrated_plan(report, slice_ctx)
    del slice_ctx
    run_driver_phase(report, serve_ctx)
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    log(f"total {report['seconds']:.1f} s")
    if args.json:
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=2))
        log(f"details in {out}")
    print(nvidia_smi())
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_from", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kk[k] for k in keys}
                                  for kk in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
