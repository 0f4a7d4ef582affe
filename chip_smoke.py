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
     bound (the larger of bytes / 3.35 TB/s and flops / 67 TFLOP/s fp32);
  4. the slice: build_plan + forward_cnn on that ResNet-18 in per_layer
     and deferred mode with the kernels pinned (use_fused_kernel=True):
     zero clean flags, bitwise clean-path contracts, allclose to the
     port's own CPU run, 17 checksum_reduce + 1 abft_matmul launches and
     18 / 1 host reads per forward, median forward times (taken in
     turns), the host time of each layer of the kernel route (timing
     spans around the port's functions) and a torch.profiler trace;
  5. injected faults (conv5: one element; conv13: a burst over channels
     of one image at one payload position): detected, corrected, no
     residual, logits back to the clean ones, in both modes.
It then prints the card's name and power limit, one {"kernels": [...]}
line, and as the last line {"ok": true, "device": {...}}. `--json PATH`
also writes the run's details (per-shape kernel times, per-layer scores,
profiles) to PATH. Without a CUDA card, or outside a checkout of the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
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
SEED = 0
BATCH, IMG = 8, 224


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


def time_host(fns: dict, reps: int = 10, warmup: int = 2) -> dict:
    """Median milliseconds of each fn() + synchronize on the host clock.
    The functions take turns within each round, in an order rotated from
    round to round, so that a drift of the shared host falls on all of
    them alike."""
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
    return {k: statistics.median(v) for k, v in times.items()}


def bound_ms(nbytes: float, flops: float):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
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


def check_checksum_reduce(cfg, gen, report):
    import torch
    from repro_torch.kernels import checksum_reduce as CR
    from repro_torch.kernels import ops
    from repro_torch.core import checksums as C
    shapes = conv_output_shapes(cfg)
    rows, tot = [], {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0}
    err_all = 0.0
    for shape in sorted(set(shapes), key=shapes.index):
        count = shapes.count(shape)
        layer = shapes.index(shape)
        n, m, e1, e2 = shape
        p = e1 * e2
        o4 = torch.randn(shape, generator=gen, device="cuda")
        o2 = o4.reshape(n * m, p)
        bm, bn = ops.conv_tiles(m, p, on_card=True)
        got = CR.checksum_reduce(o2, bm, bn, segments=n, rowsum=True)
        want = CR.checksum_reduce_plain(o2, bm, bn, segments=n, rowsum=True)
        torch.cuda.synchronize()
        errs = {}
        for name, g, w in zip(("colsum", "rowsum", "sumsq", "wcolsum"),
                              got, want):
            if g.shape != w.shape:
                fail(f"checksum_reduce {shape} {name}: shape {tuple(g.shape)}"
                     f" vs plain {tuple(w.shape)}")
            err = max_err(g, w)
            # fp32 reassociation over at most bm*bn terms
            tol = 1e-5 * (float(w.abs().max()) + 1.0)
            if not err <= tol:
                fail(f"checksum_reduce {shape} {name}: max |err| {err:.3g} "
                     f"> {tol:.3g}")
            errs[name] = err
        # the finished detection sums of the conv route vs the plain pass
        k_sums = ops.conv_detect_sums(o4)
        p_sums = C.detect_sums(o4)
        for name, g, w in zip(("s5", "s6", "s7", "sumsq"), k_sums, p_sums):
            err = max_err(g, w)
            tol = 1e-4 * (float(w.abs().max()) + 1.0)
            if not err <= tol:
                fail(f"conv_detect_sums {shape} {name}: max |err| {err:.3g} "
                     f"> {tol:.3g}")
            errs["detect_" + name] = err
        err_all = max(err_all, *(errs[k] for k in ("colsum", "rowsum",
                                                   "sumsq", "wcolsum")))
        # the main path's launch (rowsum skipped), on inputs cold in L2
        args = copies([o2])
        ms = time_device(lambda t: CR.checksum_reduce(
            t, bm, bn, segments=n, rowsum=False), args)
        plain_ms = time_device(lambda t: CR.checksum_reduce_plain(
            t, bm, bn, segments=n, rowsum=False), args)
        del args
        t = n * -(-m // bm)
        nbytes = 4.0 * (n * m * p + 2 * t * p + t * -(-p // bn))
        flops = 5.0 * n * m * p
        b, by = bound_ms(nbytes, flops)
        rows.append({"shape": list(shape), "first_layer": f"conv{layer}",
                     "count": count, "tiles": [bm, bn], "ms": ms,
                     "plain_ms": plain_ms,
                     "bound_ms": b, "bound_by": by,
                     "max_abs_err": errs})
        log(f"  checksum_reduce conv{layer} O{shape} x{count} tiles "
            f"({bm},{bn}): ms {ms:.4f} plain {plain_ms:.4f} bound {b:.4f} ({by}) max|err| partials "
            f"{max(errs[k] for k in ('colsum', 'rowsum', 'sumsq', 'wcolsum')):.3g}"
            f" detect sums "
            f"{max(v for k, v in errs.items() if k.startswith('detect')):.3g}")
        tot["ms"] += count * ms
        tot["plain_ms"] += count * plain_ms
        tot["bytes"] += count * nbytes
        tot["flops"] += count * flops
    b, by = bound_ms(tot["bytes"], tot["flops"])
    report["checksum_reduce"] = {"per_shape": rows, "forward_ms": tot["ms"],
                                 "forward_plain_ms": tot["plain_ms"],
                                 "forward_bound_ms": b,
                                 "bytes_per_forward": tot["bytes"]}
    log(f"  checksum_reduce per forward (17 launches): ms {tot['ms']:.4f} "
        f"plain {tot['plain_ms']:.4f} bound {b:.4f} ({by}), "
        f"{tot['bytes'] / 1e6:.1f} MB")
    return {"name": "checksum_reduce", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/checksum_reduce.cu",
            "replaces": "src/repro/kernels/checksum_reduce.py:37",
            "max_abs_err": err_all, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b, "bound_by": by,
            # no single PyTorch call computes colsum/wcolsum/sumsq tiles
            "library_ms": None}


def check_abft_matmul(cfg, gen, report):
    import torch
    from repro_torch.core.protected import pick_chunk
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import abft_matmul_ref
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
    detect_sums > conv_detect_sums > (the checksum_reduce wrapper > its
    ctypes launch, then finish_conv_sums), so each layer's own cost is its
    span less the ones inside it. Issue time only: nothing inside the spans synchronizes."""
    import torch
    from repro_torch.core import checksums as C
    from repro_torch.kernels import _build, ops
    spans = {"detect_sums": (C, "detect_sums"),
             "conv_detect_sums": (ops, "conv_detect_sums"),
             "checksum_reduce": (ops, "_checksum_reduce_kernel"),
             "finish_conv_sums": (ops, "finish_conv_sums"),
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
    log("  checksum_reduce route, host us per call: detect_sums "
        f"{us('detect_sums'):.1f} = own "
        f"{us('detect_sums') - us('conv_detect_sums'):.1f} + tile choice "
        f"{us('conv_detect_sums') - us('checksum_reduce') - us('finish_conv_sums'):.1f}"
        f" + finishing glue {us('finish_conv_sums'):.1f} + checks and "
        f"allocation {us('checksum_reduce') - us('launch repro_checksum_reduce_f32'):.1f}"
        f" + ctypes launch {us('launch repro_checksum_reduce_f32'):.1f}; the "
        "plain pass "
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
    report["slice"] = res
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
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cfg = cnn.resnet18(1.0)
    kernels = [check_checksum_reduce(cfg, gen, report),
               check_abft_matmul(cfg, gen, report)]

    log("phase 4: the slice")
    res = run_slice(report)
    for k in kernels:
        k["launches"] = res["per_layer"]["launches"][k["name"]]
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    log(f"total {report['seconds']:.1f} s")
    if args.json:
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=2))
        log(f"details in {out}")
    print(nvidia_smi())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kk[k] for k in keys}
                                  for kk in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
