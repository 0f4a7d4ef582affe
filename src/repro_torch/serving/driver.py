"""Async serving driver: controller/runner split over the protected
continuous-batching session (twin of repro.serving.driver).

`ProtectedSession` is the single-stream building block: one synchronous
host loop that admits, prefills, steps the device and reads every token
back to back. `ServingDriver` runs the same forwards and bookkeeping in
the shape live traffic needs:

- a **controller** thread owns the front door: a bounded admission queue
  with explicit backpressure verdicts (`submit` returns a `SubmitVerdict`
  - "queued" or "rejected", never unbounded growth), per-request
  deadlines (a request whose deadline passes while still queued finishes
  as `"timeout"` and never occupies a slot), and the plan-trusted weight
  audits (`PlanAuditor` runs on the controller thread against a quiesced
  pipeline, so an in-place repair never blocks `submit`);
- a **runner** thread launches the decode steps: step N's host half
  (token copy, emission, EOS/length bookkeeping, eviction) runs after
  step N+1 was launched (`sync_lag`), decode inputs stay on the device
  between steps (step N+1 consumes step N's `next` tensor directly), and
  prefill prep (bucket and padded prompt buffer) happens at submit time
  on the caller's thread.

The deferred forward reads its flags on the host inside the forward, so
launching step N+1 waits for its detect pass: `sync_lag` overlaps only
the token copy and the bookkeeping with the next step.

Every protection invariant of the session holds: every forward goes
through `ProtectedModel(correction="deferred")`, faults are attributed
per slot from the launch-time snapshot (a speculative step computed for
an already-finished slot is discarded), audits trust the plan's
persisted checksums, and clean traffic is per request the tokens of the
session: the driver runs the session's forwards on the same values, so
the one-step lag changes *when* bookkeeping happens, never *what* the
device computes. A speculative step of a slot that finished at the end
of its KV capacity writes its cache at the last position (positions are
clamped there, as the JAX package's dynamic_update_slice clamps); the
next admission overwrites the whole slot.

Both threads start in copies of the context of the thread that starts
them (the first `submit`, `paused` or `with driver:`), so an ambient plan
scope or `injection.fault_scope` active there reaches every forward of
the driver's life. Both use the device's default stream; the audit's
in-place repair runs only while no decode step is in flight.

    driver = ServingDriver(params, cfg, plan, slots=4, max_len=64,
                           queue_capacity=32, audit_every=50)
    v = driver.submit(prompt, max_new_tokens=16, deadline_s=2.0)
    ...                                  # submit() never blocks
    report = driver.drain()              # stop admitting, finish, flush
    driver.close()
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import threading
import time
from typing import Deque, Optional

import numpy as np
import torch

from .scheduler import Request
from .session import ProtectedSession
from .stats import RequestRecord


@dataclasses.dataclass(frozen=True)
class SubmitVerdict:
    """The admission answer `submit` returns instead of blocking:
    `accepted` requests are queued (rid keys the stats ledger);
    rejections carry the backpressure reason ("queue_full" while the
    bounded queue is at capacity, "draining" after drain() started) and
    are accounted in the report (`finish_reason="rejected"`)."""
    rid: int
    accepted: bool
    verdict: str                       # "queued" | "rejected" | "dropped"
    queue_depth: int
    reason: Optional[str] = None


@dataclasses.dataclass
class _Queued:
    req: Request
    deadline: Optional[float]          # absolute, driver clock; None = no TTL
    bucket: int
    buf: np.ndarray                    # padded prompt, prepped at submit


class ServingDriver(ProtectedSession):
    """Controller/runner split over ProtectedSession's forwards.

    Extra knobs over the session: `queue_capacity` (bounded admission
    queue; full queue => "rejected" verdicts), `default_deadline_s`
    (TTL applied when submit passes none; deadlines only govern queue
    wait - an admitted request always runs to completion), `sync_lag`
    (how many decode steps may be in flight before their host
    bookkeeping runs; 1 = double-buffered, 0 = synchronous semantics),
    `audit_every` (cadence in decode launches; audits execute on the
    controller thread against a quiesced pipeline).

    Thread contract: `submit` is safe from any thread and never blocks
    on device work. `drain` stops admission ("rejected"/"draining"
    verdicts), serves everything already queued, waits for in-flight
    slots to finish, and returns the ServingStats report; admission then
    reopens (a drained driver is reusable). `close` shuts the threads
    down. `paused()` quiesces the pipeline at a step boundary (every
    in-flight step finalized, nothing launching) so callers can mutate
    `params` mid-stream - the corruption drills' seam; with audits on, the
    first launch after a pause waits for an audit.
    """

    def __init__(self, params, cfg, plan=None, *, slots: int = 4,
                 max_len: int = 64, queue_capacity: int = 64,
                 default_deadline_s: Optional[float] = None,
                 sync_lag: int = 1, correction: str = "auto",
                 mesh=None, audit_every: int = 0, restore_fn=None,
                 slot_tol: float = 1e-3, bucket_floor: int = 8,
                 idle_wait_s: float = 0.005, device=None):
        if queue_capacity < 1:
            raise ValueError("ServingDriver: queue_capacity must be >= 1 "
                             f"(got {queue_capacity})")
        if sync_lag < 0:
            raise ValueError(f"ServingDriver: sync_lag >= 0 (got {sync_lag})")
        super().__init__(params, cfg, plan, slots=slots, max_len=max_len,
                         correction=correction, mesh=mesh,
                         audit_every=audit_every, restore_fn=restore_fn,
                         slot_tol=slot_tol, bucket_floor=bucket_floor,
                         device=device)
        self.queue_capacity = queue_capacity
        self.default_deadline_s = default_deadline_s
        self.sync_lag = sync_lag
        self.idle_wait_s = idle_wait_s

        self._mu = threading.RLock()
        self._work = threading.Condition(self._mu)    # wakes the runner
        self._ctrl = threading.Condition(self._mu)    # wakes the controller
        self._done = threading.Condition(self._mu)    # wakes waiters
        self._queue: Deque[_Queued] = collections.deque()
        self._inflight: Deque = collections.deque()
        self._draining = False
        self._closing = False
        self._started = False
        self._pause = 0                 # paused() nesting count (requests)
        self._paused = False            # runner acked quiescence
        self._audit_req = False
        self._error: Optional[BaseException] = None
        self._launches = 0              # decode launches (audit cadence)
        self._audits = 0
        self._audit_mark = 0
        self._busy_since: Optional[float] = None
        self._runner_t: Optional[threading.Thread] = None
        self._ctrl_t: Optional[threading.Thread] = None
        # decode inputs stay on the device between steps; a prefill's
        # token is merged into a copy (the in-flight step keeps its own)
        self._d_tokens = torch.as_tensor(self._h_tokens, device=self.device)

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self):
        with self._mu:
            self._ensure_started_locked()
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _ensure_started_locked(self) -> None:
        if self._started:
            return
        self._started = True
        # each thread runs in its own copy of the starter's context: the
        # plan scope and fault_scope hooks are context variables, which a
        # new thread would otherwise start without
        self._runner_t = threading.Thread(
            target=contextvars.copy_context().run,
            args=(self._runner_main,), name="repro-serving-runner",
            daemon=True)
        self._ctrl_t = threading.Thread(
            target=contextvars.copy_context().run,
            args=(self._controller_main,), name="repro-serving-controller",
            daemon=True)
        self._runner_t.start()
        self._ctrl_t.start()

    def close(self) -> None:
        """Stop both threads (ungraceful for queued work - call drain()
        first for a clean finish)."""
        with self._mu:
            if not self._started:
                return
            self._closing = True
            self._work.notify_all()
            self._ctrl.notify_all()
            self._done.notify_all()
        for t in (self._runner_t, self._ctrl_t):
            t.join(timeout=60)
            if t.is_alive():
                raise RuntimeError(f"ServingDriver: thread {t.name} did "
                                   "not stop within 60 s")

    # the synchronous surface makes no sense on a threaded driver
    def step(self):
        raise RuntimeError("ServingDriver is asynchronous: use submit()/"
                           "drain(); ProtectedSession.step() is the "
                           "synchronous building block")

    run = step

    def _raise_if_failed_locked(self) -> None:
        if self._error is not None:
            raise RuntimeError("ServingDriver failed") from self._error

    # -- the front door ----------------------------------------------------
    def submit(self, tokens, max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None) -> SubmitVerdict:
        """Offer one request to the bounded admission queue; returns the
        verdict immediately (never blocks on device work). Rejections and
        oversized-prompt drops are recorded in the stats ledger under
        their rid like every other request."""
        now = self._now()
        with self._mu:
            self._raise_if_failed_locked()
            self._ensure_started_locked()
            req, ok = self.scheduler.make_request(tokens, max_new_tokens,
                                                  eos_id)
            rec = self.stats.add(RequestRecord(req.id, req.prompt_len,
                                               req.max_new_tokens))
            rec.submitted_at = now
            if not ok:
                rec.finish_reason = "dropped"
                self.stats.counters["dropped"] += 1
                return SubmitVerdict(req.id, False, "dropped",
                                     len(self._queue), "oversized_prompt")
            if self._draining or self._closing:
                rec.finish_reason = "rejected"
                self.stats.counters["rejected"] += 1
                return SubmitVerdict(req.id, False, "rejected",
                                     len(self._queue), "draining")
            if len(self._queue) >= self.queue_capacity:
                rec.finish_reason = "rejected"
                self.stats.counters["rejected"] += 1
                return SubmitVerdict(req.id, False, "rejected",
                                     len(self._queue), "queue_full")
            ttl = (deadline_s if deadline_s is not None
                   else self.default_deadline_s)
            rec.deadline_s = ttl
            bucket, buf = self._prep_prefill(req)
            self._queue.append(_Queued(
                req, now + ttl if ttl is not None else None, bucket, buf))
            depth = len(self._queue)
            self._work.notify_all()
            self._ctrl.notify_all()
        return SubmitVerdict(req.id, True, "queued", depth)

    @property
    def queue_depth(self) -> int:
        with self._mu:
            return len(self._queue)

    def tokens_generated(self, rid: int) -> int:
        """Poll-safe progress probe for a request (len of its ledger)."""
        with self._mu:
            return self.stats.record(rid).tokens_generated

    def drain(self, timeout: Optional[float] = None) -> dict:
        """Graceful drain: stop admitting (new submits get "rejected"
        verdicts), serve everything already queued, finish every
        in-flight slot, flush + return the stats report. Admission
        reopens afterwards."""
        with self._mu:
            self._raise_if_failed_locked()
            if not self._started:
                return self.stats.report()
            self._draining = True
            self._work.notify_all()
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            try:
                while (not self._idle_locked() and self._error is None
                       and not self._closing):
                    if deadline is not None and time.monotonic() > deadline:
                        raise TimeoutError(
                            f"drain: work remains after {timeout}s "
                            f"(queue={len(self._queue)} "
                            f"active={len(self.scheduler.active)})")
                    self._done.wait(timeout=0.05)
            finally:
                self._draining = False
            self._raise_if_failed_locked()
            return self.stats.report()

    @contextlib.contextmanager
    def paused(self):
        """Quiesce the pipeline at a step boundary: every in-flight step
        finalized, nothing launching or admitting, controller audits
        held. Inside the context `params` may be swapped or corrupted
        (the fault-drill seam); the runner resumes on exit, auditing first
        when audits are on."""
        with self._mu:
            self._raise_if_failed_locked()
            self._ensure_started_locked()
            self._pause += 1
            self._work.notify_all()
            while (not self._paused and self._error is None
                   and not self._closing):
                self._done.wait(timeout=0.05)
            self._raise_if_failed_locked()
        try:
            yield self
        finally:
            with self._mu:
                self._pause -= 1
                if self.audit_every and self._audits:
                    # the params may have changed inside the pause: the
                    # next launch waits for an audit
                    self._audit_mark = min(
                        self._audit_mark, self._launches - self.audit_every)
                self._work.notify_all()

    # -- shared predicates (call with _mu held) ----------------------------
    def _idle_locked(self) -> bool:
        return (not self._queue and not self.scheduler.active
                and not self._inflight)

    def _audit_due_locked(self) -> bool:
        if self.plan is None or not self.audit_every or self._audit_req:
            return False
        if self._idle_locked():
            return False
        if self._audits == 0:
            return True            # trusted root: audit before first serve
        return self._launches - self._audit_mark >= self.audit_every

    # -- the runner: launch / finalize / admit -----------------------------
    def _runner_main(self) -> None:
        try:
            self._runner_loop()
        except Exception as e:       # surfaced on the caller's thread
            with self._mu:
                self._error = e
                self._done.notify_all()

    def _runner_loop(self) -> None:
        while True:
            with self._mu:
                if self._closing or self._error is not None:
                    break
                pause_req = self._pause > 0
                audit_due = self._audit_due_locked()
            if pause_req:
                self._finalize_all()
                with self._mu:
                    self._paused = True
                    self._done.notify_all()
                    while self._pause > 0 and not self._closing:
                        self._work.wait(timeout=0.05)
                    self._paused = False
                continue
            if audit_due:
                self._finalize_all()
                with self._mu:
                    self._audit_req = True
                    self._ctrl.notify_all()
                    while (self._audit_req and self._error is None
                           and not self._closing):
                        self._done.wait(timeout=0.05)
                continue

            launched = False
            if self.scheduler.active:
                snap = self._snapshot_active()
                at = self._now()
                t0 = time.perf_counter()
                out = self._dispatch_decode(
                    self._d_tokens,
                    np.minimum(self._h_positions, self.max_len - 1))
                out["dispatch_s"] = time.perf_counter() - t0
                out["launched_at"] = at
                self._d_tokens = out["next"]
                for slot, _, _ in snap:
                    self._h_positions[slot] += 1
                self._inflight.append(("decode", out, snap))
                with self._mu:
                    self._launches += 1
                    self.stats.counters["steps"] += 1
                launched = True

            # double-buffer: step N's host bookkeeping runs after step N+1
            # was launched; with nothing launched, flush everything
            lag = self.sync_lag if launched else 0
            while len(self._inflight) > lag:
                self._finalize_one()

            self._admit_ready()

            with self._mu:
                if self._idle_locked():
                    if self._busy_since is not None:
                        self.stats.wall_s += (time.perf_counter()
                                              - self._busy_since)
                        self._busy_since = None
                    self._done.notify_all()
                    if self._closing:
                        break
                    if not (self._pause or self._queue):
                        self._work.wait(timeout=self.idle_wait_s)
                elif self._busy_since is None:
                    self._busy_since = time.perf_counter()
        self._finalize_all()
        with self._mu:
            if self._busy_since is not None:
                self.stats.wall_s += time.perf_counter() - self._busy_since
                self._busy_since = None
            self._done.notify_all()

    def _finalize_all(self) -> None:
        while self._inflight:
            self._finalize_one()

    def _finalize_one(self) -> None:
        kind, out, info = self._inflight.popleft()
        if kind == "decode":
            nxt, hit = self._host_decode(out)
            with self._mu:
                self.stats.log_decode(out["dispatch_s"], hit,
                                      out["launched_at"])
                self._apply_decode_outputs(nxt, hit, out["stats"], info)
        else:   # prefill: first-token emission + verdict attribution
            slot, req = info
            nxt = out["next"].cpu().numpy()
            with self._mu:
                if self.scheduler.active.get(slot) is req:
                    self._apply_prefill_outputs(nxt, out["stats"], slot,
                                                req)

    def _admit_ready(self) -> None:
        """Move queued requests into free slots: deadline check, place,
        prefill dispatch, device-side token merge. Pop+place happen under
        the lock (so drain's idle predicate never sees a request in
        neither queue nor slot); device work runs outside it."""
        while True:
            with self._mu:
                if not self._queue or not self.scheduler.free_slots():
                    return
                now = self._now()
                q = self._queue.popleft()
                if q.deadline is not None and now > q.deadline:
                    self._expire_locked(q)
                    continue
                slot = self.scheduler.place(q.req)
            out = self._dispatch_prefill(slot, q.req, q.bucket, q.buf)
            tokens = self._d_tokens.clone()
            tokens[slot] = out["next"][0].to(tokens.dtype)
            self._d_tokens = tokens
            self._h_positions[slot] = q.req.prompt_len
            self._inflight.append(("prefill", out, (slot, q.req)))

    def _expire_locked(self, q: _Queued) -> None:
        """A deadline passed while the request was still queued: it
        finishes as "timeout" and never occupies a slot."""
        rec = self.stats.record(q.req.id)
        rec.finish_reason = "timeout"
        self.stats.counters["timeouts"] += 1

    # -- the controller: deadlines + plan-trusted audits -------------------
    def _controller_main(self) -> None:
        try:
            while True:
                with self._mu:
                    if self._closing:
                        return
                    do_audit = self._audit_req
                    if not do_audit:
                        self._ctrl.wait(
                            timeout=self._ctrl_wait_locked())
                        do_audit = self._audit_req
                        if self._closing:
                            return
                if do_audit:
                    err = None
                    try:
                        self._controller_audit()
                    except Exception as e:   # surfaced by the runner's
                        err = e              # waiters and drain()
                    with self._mu:
                        self._audit_req = False
                        self._audits += 1
                        self._audit_mark = self._launches
                        if err is not None:
                            self._error = err
                        self._done.notify_all()
                self._sweep_deadlines()
        except Exception as e:
            with self._mu:
                self._error = e
                self._done.notify_all()

    def _ctrl_wait_locked(self) -> float:
        """Sleep until the earliest queued deadline (or a coarse tick)."""
        now = self._now()
        nxt = min((q.deadline - now for q in self._queue
                   if q.deadline is not None), default=0.05)
        return float(min(max(nxt, 0.001), 0.05))

    def _sweep_deadlines(self) -> None:
        """Expire queued requests whose TTL lapsed, even while the
        runner is busy elsewhere."""
        with self._mu:
            if not self._queue:
                return
            now = self._now()
            kept: Deque[_Queued] = collections.deque()
            for q in self._queue:
                if q.deadline is not None and now > q.deadline:
                    self._expire_locked(q)
                else:
                    kept.append(q)
            self._queue = kept

    def _controller_audit(self) -> None:
        """The full audit ladder (audit -> in-place repair -> restore ->
        refuse), on the controller thread. The runner finalized every
        in-flight step before it asked, and waits until this returns;
        the device is synchronized first, so the repair never races a
        decode step. `submit` keeps answering throughout."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        params = self.auditor.audit_or_restore(self.params)
        verdict = self.auditor.last_verdict
        with self._mu:
            self.params = params
            if verdict == "repaired":
                self.stats.repair_s.append(self.auditor.last_repair_s)
            for req in self.scheduler.active.values():
                self.stats.record(req.id).audit_verdicts.append(verdict)
