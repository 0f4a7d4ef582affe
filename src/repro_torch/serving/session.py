"""ProtectedSession: continuous-batching serving through the deferred
ProtectedModel path (twin of repro.serving.session).

One decode step runs at a fixed (slots, 1) token shape ((slots, 1, K) for
a multi-codebook arch, whose requests are emitted K-lists of tokens and
whose prompts are (S, K) arrays of length S): the slot scheduler
admits queued requests into free slots, each admission runs a batch-1
prefill (bucketed prompt length, the last real row as an argument; the
prompt's own length for recurrent models) whose caches - KV rows, or an
ssm or rec block's recurrent state - are written into the slot of the
slot-indexed buffers in place, and eviction on EOS/max-len frees the slot
for the next queued request.
Every forward routes through `ProtectedModel` with `correction="deferred"`:
a detect-only pass, one host read of every site's flag, and a corrective
rerun only when one is set.

Fault attribution is per slot: the deferred workflow's detect-pass output
(`with_detect_out=True`) is the served output on the clean path and holds
the uncorrected values after a corrective rerun, so comparing the two
localizes which slot's logits a correction changed. On the card the rerun
takes the kernel route's partials kernel (abft_matmul) where the detect
pass took abft_matmul_detect; both round O identically, so clean slots
differ by exactly 0.

Per-request parity caveat (the JAX session's): batch rows are
independent through attention (per-slot positions), dense FFN and the
recurrent blocks, so clean-traffic tokens match the unbatched forward
(`greedy_reference`); moe blocks couple a batch's rows through expert
capacity (one request's assignments can displace another's) and void that
guarantee. Their prompts are bucketed like any non-recurrent model's, so
padded prefill rows take part in the routing, as in the JAX session.

Plan-trusted weight audits run on the step cadence (`audit_every`):
divergence from the plan's persisted checksums climbs runtime.ft's ladder
- in-place repair from the plan's locator sums, then `restore_fn`, then
WeightDivergenceError - before any forward of that step runs.

Each decode step has a device half (`_step_fn`: the forward, its verdict,
the next tokens left on the device) and a host half (`_host_decode`, then
`_apply_decode_outputs`: the token copy, emission, attribution and
eviction). The session runs them back to back; serving.driver's
ServingDriver runs the host half of step N after launching step N+1.

Not ported yet, and refused: `mesh=` (ROADMAP item 1.12).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, fp32_ieee, resolve_device
from ..core import ProtectedModel, as_fault_report
from ..models import transformer as M
from ..runtime.ft import PlanAuditor
from .scheduler import SlotScheduler
from .stats import RequestRecord, ServingStats

F32 = torch.float32


def _host_ints(*vals) -> np.ndarray:
    """Verdict fields (host ints, or 0-d device tensors in per_layer
    mode's merged view) as one host int vector."""
    return np.array([int(v) for v in vals], dtype=np.int64)


class ProtectedSession:
    """A protected continuous-batching serving session.

        plan = core.build_plan(params, cfg, batch=slots, seq=max_len)
        sess = ProtectedSession(params, cfg, plan, slots=4, max_len=64)
        rid = sess.submit(prompt_tokens, max_new_tokens=16, eos_id=2)
        report = sess.run()            # drain queue; ServingStats report
        sess.tokens_for(rid)           # generated token ids

    Knobs: `slots` (decode batch width), `max_len` (KV capacity per
    slot), `correction` ("deferred" by default when a plan is present),
    `audit_every` (plan-trusted weight-audit cadence in session steps, 0
    = off; divergence climbs the ladder: in-place repair from the plan's
    locator sums, then restore via `restore_fn`, then
    WeightDivergenceError), `slot_tol` (relative tolerance of the
    per-slot correction localizer; clean slots differ by exactly 0),
    `device` (the card unless the caller asks for the CPU; params and
    plan must lie there, and so must what `restore_fn` returns).
    """

    def __init__(self, params, cfg, plan=None, *, slots: int = 4,
                 max_len: int = 64, correction: str = "auto",
                 mesh=None, audit_every: int = 0, restore_fn=None,
                 slot_tol: float = 1e-3, bucket_floor: int = 8,
                 device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(
                "ProtectedSession(mesh=...) is not ported yet (ROADMAP "
                "item 1.12)")
        if correction == "auto":
            correction = "deferred" if plan is not None else "per_layer"
        if correction == "deferred" and plan is None:
            raise ValueError("ProtectedSession: correction='deferred' "
                             "needs a ProtectionPlan")
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"ProtectedSession runs on {self.device} but "
                             f"params lie on {table.device}")
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.correction = correction
        self.audit_every = audit_every
        self.slot_tol = slot_tol
        self.params = params
        self.plan = plan

        self.scheduler = SlotScheduler(slots, max_len, cfg=cfg,
                                       bucket_floor=bucket_floor)
        self.stats = ServingStats()
        self.auditor = PlanAuditor(plan, restore_fn=restore_fn,
                                   params_fn=lambda s: s,
                                   stats=self.stats.counters)
        self._caches = M.init_caches(cfg, slots, max_len, self.device)
        k = cfg.num_codebooks
        self._h_tokens = np.zeros((slots, 1, k) if k else (slots, 1),
                                  np.int64)
        self._h_positions = np.zeros((slots,), np.int64)
        self._t0 = time.perf_counter()
        self._step_count = 0
        self._decode_pm = ProtectedModel(M.decode_apply(cfg), plan)
        self._prefill_pm = ProtectedModel(M.prefill_apply_at(cfg, max_len),
                                          plan)

    # -- time --------------------------------------------------------------
    def _now(self) -> float:
        return time.perf_counter() - self._t0

    # -- the device pieces ---------------------------------------------------
    def _step_fn(self, tokens, positions) -> Dict:
        """Device half of one decode step over all slots: the next tokens
        (left on the device, so a pipelined caller can feed them to the
        next step as they are), the caches, the localizer's per-slot hit
        vector (on the device; None when nothing was detected) and the
        (detected, corrected_by, residual) verdict as host ints (the
        deferred workflow reads its flags inside the forward)."""
        hit = None
        with torch.no_grad(), fp32_ieee():
            if self.correction == "deferred":
                (logits, caches), rep, (logits_d, _) = self._decode_pm(
                    self.params, tokens, self._caches, positions,
                    correction="deferred", with_detect_out=True)
                fr = as_fault_report(rep)
                if int(fr.detected):
                    # the corrective rerun ran: only rows the ladder
                    # touched move, so the rows that differ localize the
                    # fault to its slot (a clean path differs by 0)
                    b = logits.shape[0]
                    l32 = logits.to(F32).reshape(b, -1)
                    d32 = logits_d.to(F32).reshape(b, -1)
                    diff = torch.amax(torch.abs(l32 - d32), dim=-1)
                    hit = (diff > self.slot_tol
                           * (torch.amax(torch.abs(d32)) + 1.0)
                           ).to(torch.int64)
            else:
                (logits, caches), rep = self._decode_pm(
                    self.params, tokens, self._caches, positions,
                    correction=self.correction)
                fr = as_fault_report(rep)
            nxt = torch.argmax(logits, dim=-1)
        return {"next": nxt, "caches": caches, "hit": hit,
                "stats": _host_ints(fr.detected, fr.corrected_by,
                                    fr.residual)}

    def _host_decode(self, out: Dict) -> Tuple[np.ndarray, np.ndarray]:
        """Host half of one decode step's outputs: the next tokens and the
        hit vector as host arrays (the token copy waits for the device)."""
        nxt = out["next"].cpu().numpy()
        hit = (np.zeros((nxt.shape[0],), np.int64) if out["hit"] is None
               else out["hit"].cpu().numpy())
        return nxt, hit

    def _prefill_fn(self, tokens, last: int) -> Dict:
        with torch.no_grad(), fp32_ieee():
            (li, caches), rep = self._prefill_pm(self.params, tokens, last,
                                                 correction=self.correction)
            fr = as_fault_report(rep)
            nxt = torch.argmax(li, dim=-1)
        return {"next": nxt, "caches": caches,
                "stats": _host_ints(fr.detected, fr.corrected_by,
                                    fr.residual)}

    def _insert(self, small: Dict, slot: int, big: Optional[Dict] = None,
                stacked: bool = False) -> None:
        """Write a batch-1 prefill's caches into `slot` of the session's
        caches, in place, in the buffers' types (as the JAX session's
        insert casts). Stage caches carry a leading repeats axis; the slot
        axis sits behind it. A float32 model's ssm or rec conv tail is made
        bfloat16 and comes back float32 from every forward, so it is
        rounded where it is inserted before the session's first decode
        step and kept after it, as in the JAX session (ROADMAP 3.6)."""
        big = self._caches if big is None else big
        for key, b in big.items():
            s = small[key]
            if isinstance(b, dict):
                self._insert(s, slot, b, stacked or key == "stages")
            elif stacked:
                b[:, slot] = s[:, 0].to(b.dtype)
            else:
                b[slot] = s[0].to(b.dtype)

    # -- request surface ---------------------------------------------------
    def submit(self, tokens, max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> int:
        """Enqueue one request; returns its id (served on later step()s)."""
        now = self._now()
        req = self.scheduler.submit(tokens, max_new_tokens, eos_id)
        if req is None:
            req = self.scheduler.dropped[-1]
            rec = self.stats.add(RequestRecord(
                req.id, req.prompt_len, req.max_new_tokens))
            rec.submitted_at = now
            rec.finish_reason = "dropped"
            self.stats.counters["dropped"] += 1
            return req.id
        rec = self.stats.add(RequestRecord(req.id, req.prompt_len,
                                           req.max_new_tokens))
        rec.submitted_at = now
        return req.id

    def tokens_for(self, rid: int) -> List:
        return list(self.stats.record(rid).tokens)

    # -- the serving loop --------------------------------------------------
    def _attr(self, rec: RequestRecord, s: np.ndarray,
              prefill: bool = False) -> None:
        """Attribute one (detected, corrected_by, residual) verdict to a
        request's ledger (session counters are kept by the callers)."""
        if not int(s[0]):
            return
        rec.faults_detected += 1
        if prefill:
            rec.prefill_detected += 1
        if int(s[1]) > 0:
            rec.corrections_applied += 1
        if int(s[2]):
            rec.residuals += 1

    def _count_event(self, s: np.ndarray) -> None:
        if not int(s[0]):
            return
        self.stats.counters["faults_detected"] += 1
        if int(s[1]) > 0:
            self.stats.counters["faults_corrected"] += 1

    def _finish(self, slot: int, reason: str) -> None:
        req = self.scheduler.evict(slot)
        rec = self.stats.record(req.id)
        rec.completed_at = self._now()
        rec.finish_reason = reason

    def _emit(self, req, tok, next_pos: int) -> Optional[str]:
        """Append one emitted token (a K-list for a multi-codebook arch);
        returns a finish reason or None. `next_pos` is the cache position
        the next decode write would use. EOS stops scalar tokens only."""
        rec = self.stats.record(req.id)
        rec.tokens.append(int(tok) if np.ndim(tok) == 0 else
                          np.asarray(tok).tolist())
        if (req.eos_id is not None and np.ndim(tok) == 0
                and int(tok) == req.eos_id):
            return "eos"
        if rec.tokens_generated >= req.max_new_tokens:
            return "length"
        if next_pos >= self.max_len:
            return "max_len"
        return None

    def _prep_prefill(self, req):
        """Host-side prefill prep: the bucket and the padded token buffer."""
        plen = req.prompt_len
        bucket = self.scheduler.bucket(plen)
        toks = np.zeros((1, bucket) + req.tokens.shape[1:], np.int64)
        toks[0, :plen] = req.tokens
        return bucket, toks

    def _dispatch_prefill(self, slot: int, req, bucket: int,
                          buf: np.ndarray) -> Dict:
        """Device half of one admission: the bucketed prefill, its caches
        written into the slot."""
        rec = self.stats.record(req.id)
        rec.slot = slot
        rec.admitted_at = self._now()
        out = self._prefill_fn(torch.as_tensor(buf, device=self.device),
                               req.prompt_len - 1)
        self._insert(out["caches"], slot)
        self.stats.counters["prefills"] += 1
        return out

    def _apply_prefill_outputs(self, nxt: np.ndarray, s: np.ndarray,
                               slot: int, req):
        """Host half of one admission: attribute the prefill verdict and
        emit the first token. Returns the token when the request keeps
        decoding, None when the prefill already finished it."""
        rec = self.stats.record(req.id)
        self._count_event(s)
        self._attr(rec, s, prefill=True)
        tok = nxt[0, 0]
        rec.first_token_at = self._now()
        reason = self._emit(req, tok, next_pos=req.prompt_len)
        if reason is not None:
            self._finish(slot, reason)
            return None
        return tok

    def _prefill_into(self, slot: int, req) -> None:
        bucket, buf = self._prep_prefill(req)
        out = self._dispatch_prefill(slot, req, bucket, buf)
        tok = self._apply_prefill_outputs(out["next"].cpu().numpy(),
                                          out["stats"], slot, req)
        if tok is None:
            return
        self._h_tokens[slot, 0] = tok
        self._h_positions[slot] = req.prompt_len

    def _run_audit(self) -> str:
        """One plan-trusted weight audit through the full ladder; swaps
        repaired/restored params in and records the verdict on every
        active request's ledger. Returns the verdict."""
        self.params = self.auditor.audit_or_restore(self.params)
        verdict = self.auditor.last_verdict
        if verdict == "repaired":
            # single-block weight corruption was solved in place
            # mid-session: record the repair time and keep serving
            # without dropping a request
            self.stats.repair_s.append(self.auditor.last_repair_s)
        for req in self.scheduler.active.values():
            self.stats.record(req.id).audit_verdicts.append(verdict)
        return verdict

    def step(self) -> bool:
        """One scheduler tick: audit cadence, admit+prefill, then one
        decode step over all slots. Returns True while work remains."""
        if (self.plan is not None and self.audit_every
                and self._step_count % self.audit_every == 0):
            self._run_audit()
        self._step_count += 1
        self.stats.counters["steps"] += 1

        for slot, req in self.scheduler.admit():
            self._prefill_into(slot, req)

        if self.scheduler.active:
            snap = self._snapshot_active()
            launched = self._now()
            t0 = time.perf_counter()
            out = self._dispatch_decode(
                torch.as_tensor(self._h_tokens, device=self.device))
            nxt, hit = self._host_decode(out)
            self.stats.log_decode(time.perf_counter() - t0, hit, launched)
            for slot, _, _ in snap:
                self._h_positions[slot] += 1
            self._apply_decode_outputs(nxt, hit, out["stats"], snap)
        return self.scheduler.busy()

    def _snapshot_active(self):
        """(slot, request, position-after-this-step) of every occupied
        slot, the launch-time view the host bookkeeping applies against."""
        return [(slot, self.scheduler.active[slot],
                 int(self._h_positions[slot]) + 1)
                for slot in self.scheduler.active_slots()]

    def _dispatch_decode(self, tokens, positions=None) -> Dict:
        """One decode step over all slots at `positions` (the slots' own
        by default); the session's caches become the step's."""
        pos = self._h_positions if positions is None else positions
        out = self._step_fn(tokens, torch.as_tensor(pos))
        self._caches = out["caches"]
        self.stats.counters["decode_steps"] += 1
        return out

    def _apply_decode_outputs(self, nxt: np.ndarray, hit: np.ndarray,
                              s: np.ndarray, snap) -> None:
        """Host half of one decode step: fault attribution, token emission
        and EOS/length eviction, against the launch-time snapshot."""
        self._count_event(s)
        detected = bool(int(s[0]))
        attributed = False
        for slot, req, pos_after in snap:
            if self.scheduler.active.get(slot) is not req:
                continue
            if detected and hit[slot]:
                self._attr(self.stats.record(req.id), s)
                attributed = True
            tok = nxt[slot, 0]
            reason = self._emit(req, tok, next_pos=pos_after)
            if reason is not None:
                self._finish(slot, reason)
            else:
                self._h_tokens[slot, 0] = tok
        if detected and not attributed:
            # evidence with no active-slot logit movement stays in the
            # tally but is not pinned on any request
            self.stats.counters["faults_unattributed"] += 1
        if int(s[2]):
            self.stats.counters["residual_steps"] += 1

    def run(self) -> dict:
        """Drain the queue; returns the ServingStats report dict."""
        t0 = time.perf_counter()
        while self.step():
            pass
        self.stats.wall_s += time.perf_counter() - t0
        return self.stats.report()


# ---------------------------------------------------------------------------
# the parity oracle
# ---------------------------------------------------------------------------

def greedy_reference(params, cfg, prompt, max_new_tokens: int,
                     max_len: int, eos_id: Optional[int] = None) -> List:
    """Unbatched, unprotected greedy continuation (the clean-traffic
    parity oracle): batch-1 prefill at the exact prompt length + scalar-
    position decode, mirroring the session's emit/stop rules. Run it with
    a cfg whose abft=False to compare against protected serving. It runs
    on the device the params lie on."""
    dev = params["embed"]["table"].device
    toks = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                           device=dev)[None]
    plen = int(toks.shape[1])

    def host(t):
        t = t[0, 0]
        return int(t) if t.dim() == 0 else t.tolist()

    logits, _, caches = M.prefill(params, toks, cfg, max_len)
    nxt = torch.argmax(logits, dim=-1)
    out = [host(nxt)]
    pos = plen
    while True:
        if (eos_id is not None and np.ndim(out[-1]) == 0
                and out[-1] == eos_id):
            break
        if len(out) >= max_new_tokens or pos >= max_len:
            break
        logits, _, caches = M.decode_step(params, nxt, caches, pos, cfg)
        nxt = torch.argmax(logits, dim=-1)
        out.append(host(nxt))
        pos += 1
    return out
