"""End-to-end fault-tolerant training driver (twin of repro.launch.train).

Wires the full stack: config registry -> data pipeline -> ABFT-protected
model -> optimizer -> FT runtime (verdict-driven step retry, weight
audits, straggler deadline) -> checksummed async checkpoints with restart.
It runs on the card unless `device="cpu"` (`--device cpu`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch \
      smollm-360m-smoke --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt \
      [--device cpu]
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import Optional

import torch

import repro_torch.configs as C
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, host_batch
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.optim import OptConfig
from repro_torch.runtime.ft import FTPolicy, StepRunner, audit_weights, \
    weight_checksums
from repro_torch.runtime.straggler import StragglerMonitor

log = logging.getLogger("repro_torch.train")


def train(arch: str, steps: int, batch: int, seq: int,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          microbatches: int = 1, lr: float = 3e-4, resume: bool = True,
          audit_every: int = 0, seed: int = 0,
          inject_fault_at: int = -1, device: DeviceLike = None):
    """Train `arch` for `steps` steps; returns (state, the loss per step,
    the StepRunner's stats)."""
    cfg = C.get(arch)
    dev = resolve_device(device)
    opt_cfg = OptConfig(lr=lr)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch,
                      num_codebooks=cfg.num_codebooks)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    state = init_train_state(torch.Generator().manual_seed(seed), cfg,
                             opt_cfg, device=dev)
    if mgr and resume and mgr.latest_step() is not None:
        start_step = mgr.latest_step()
        log.info("resuming from checkpoint step %d", start_step)
        state = mgr.restore(start_step, state)

    step_fn = make_train_step(cfg, opt_cfg, microbatches=microbatches)

    def restore_fn():
        if mgr is None or mgr.latest_step() is None:
            raise RuntimeError("no checkpoint to restore from")
        return mgr.restore(mgr.latest_step(), state)

    runner = StepRunner(step_fn, FTPolicy(),
                        restore_fn=restore_fn if mgr else None)
    monitor = StragglerMonitor()
    trusted = weight_checksums(state["params"]) if audit_every else None

    history = []
    for step in range(start_step, steps):
        tokens, labels = host_batch(dcfg, step)
        if step == inject_fault_at:
            # simulate an SDC striking the activations mid-step: corrupt
            # the batch so the ABFT layer sees a corrupted GEMM input
            tokens = tokens.clone()
            tokens[0, 0] = 0
        monitor.start_step()
        state, metrics = runner.run(state, {"tokens": tokens.to(dev),
                                            "labels": labels.to(dev)})
        dt = monitor.end_step()
        loss = float(metrics["loss"])
        history.append(loss)
        if step % max(steps // 20, 1) == 0 or step == steps - 1:
            log.info("step %4d loss %.4f gnorm %.3f (%.2fs) report=%s",
                     step, loss, float(metrics["gnorm"]), dt,
                     [int(x) for x in metrics["report"]])
        if audit_every and step % audit_every == audit_every - 1:
            ok, bad = audit_weights(state["params"], trusted, rtol=1e9)
            # (rtol=1e9: weights legitimately change every step; the audit
            # only hunts NaN/Inf at-rest corruption during training)
            if not ok:
                log.error("weight audit failed: %s - restoring", bad[:5])
                state = restore_fn()
            trusted = weight_checksums(state["params"])
        if mgr and (step % ckpt_every == ckpt_every - 1 or step == steps - 1):
            mgr.save(step + 1, state, blocking=False)
    if mgr:
        mgr.wait()
    return state, history, runner.stats


def main():
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    t0 = time.time()
    _, history, stats = train(args.arch, args.steps, args.batch, args.seq,
                              ckpt_dir=args.ckpt_dir,
                              ckpt_every=args.ckpt_every,
                              microbatches=args.microbatches, lr=args.lr,
                              seed=args.seed, device=args.device)
    print(f"trained {args.steps} steps in {time.time()-t0:.1f}s; "
          f"loss {history[0]:.4f} -> {history[-1]:.4f}; ft stats {stats}")


if __name__ == "__main__":
    main()
