"""The ranks of the port's mesh tests (tests/test_torch_sharding.py and
tests/test_torch_distributed.py): module-level functions that
launch.mesh.run_ranks starts in processes of their own, one rank each, on
a gloo mesh of CPU tensors (or the card, for tests/test_torch_gpu.py).

This module imports numpy, torch and the port only (no JAX, no pytest):
every spawned rank imports it. Each function returns plain host values
(numpy arrays, lists, numbers) for the test to hold against its
references."""
from __future__ import annotations

import contextlib
import hashlib

import numpy as np
import torch

ARCH = "yi-9b-smoke"
MAX_LEN = 24
SLOTS = 4
GEN = 5
DRILL_SITE = "stages/b0_attn_full/attn/wo"
DRILL_TRAIN_SITE = "stages/b1_ffn/ffn/up"
AUDIT_LEAF = ("stages", "b0_attn_full", "attn", "wq", "w")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _mesh(data: int, model: int, backend: str, device: str):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(data, model, backend=backend, device=device)


def _model(np_params, device: str, dtype=None):
    import repro_torch.configs as TCF
    from repro_torch.models import transformer as TM
    cfg = TCF.get(ARCH)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    if np_params is None:
        params = TM.init_params(cfg, device=device)
    else:
        params = TM.params_from_numpy(np_params, device=device)
    return cfg, params


# --------------------------------------------------------------------------
# ProtectionPlan.shard and allreduce_compressed (test_torch_sharding.py)
# --------------------------------------------------------------------------

def plan_shard_rank(rank: int, data: int, model: int, compress_in=None):
    """ProtectionPlan.shard on yi-9b-smoke (the port's seed-0 params):
    for every entry, how it came to this rank (replicated, sliced or
    encoded) and the largest gap between its checksums and locator sums
    and those encoded from this rank's shard; then whether a shard that
    disagrees with the plan on one rank is refused on every rank; and,
    given (G, E) of shape (ranks, ...), allreduce_compressed of this
    rank's row."""
    import repro_torch.core as tcore
    from repro_torch.core import checksums as C
    from repro_torch.core.plan import (PlanStaleError, apply_w_view,
                                       stacked_weight_checksums_matmul,
                                       stacked_weight_locators_matmul,
                                       weight_leaf)
    from repro_torch.core.protected import weight_checksums_matmul
    from repro_torch.runtime import sharding as SH
    mesh = _mesh(data, model, "gloo", "cpu")
    cfg, params = _model(None, "cpu")
    plan = tcore.build_plan(params, cfg, batch=4, seq=16, device="cpu")
    specs = SH.param_shardings(params, mesh, cfg)
    local = SH.shard_tree(params, specs, mesh)
    lplan = plan.shard(mesh, cfg, params=local, specs=specs)
    rows = []
    for name, e in lplan.entries.items():
        full = plan.entries[name]
        w = apply_w_view(weight_leaf(local, name), e.w_view)
        if e.wck is None:
            continue
        cb = e.wck.col_chunk
        if e.stack:
            want = stacked_weight_checksums_matmul(w, cb)
            wl = stacked_weight_locators_matmul(w, cb)
        else:
            want = weight_checksums_matmul(w, cb)
            wl = C.weight_locators_matmul(w, cb)
        how = ("replicated" if e is full else
               "sliced" if cb == full.wck.col_chunk else "encoded")
        gap_ck = max(float((a - b).abs().max())
                     for a, b in ((e.wck.cw1, want.cw1),
                                  (e.wck.cw2, want.cw2)))
        gap_lc = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                     for a, b in zip(e.wlc[:4], wl[:4]))
        rows.append({"name": name, "how": how, "gap_ck": gap_ck,
                     "gap_lc": gap_lc, "cb": int(cb),
                     "shape": list(e.w_shape),
                     "cw1_shape": list(e.wck.cw1.shape),
                     "wlc_cb": int(e.wlc.cb)})
    # one shard off by a little on the last rank: the leaf's sum over the
    # mesh no longer matches the plan on any rank of its model group
    from repro_torch._tree import tree_map
    bad = tree_map(lambda t: t, local)
    up = bad["stages"]["b1_ffn"]["ffn"]["up"]
    up["w"] = up["w"].clone()
    if rank == mesh.size - 1:
        up["w"][0, 0, 0] += 1.0
    try:
        plan.shard(mesh, cfg, params=bad, specs=specs)
        stale = False
    except PlanStaleError:
        stale = True
    out = {"rows": rows, "stale": stale, "meta": lplan.meta["mesh"]}
    if compress_in is not None:
        from repro_torch.optim import allreduce_compressed
        g, e = (torch.as_tensor(a[rank]) for a in compress_in)
        red, err = allreduce_compressed(g, e, mesh.group("world"))
        out["compressed"] = (_np(red), _np(err))
    return out


# --------------------------------------------------------------------------
# the sharded session and train step (test_torch_distributed.py)
# --------------------------------------------------------------------------

def _serve(params, cfg, plan, prompts, mesh=None, correction="auto",
           hook_step=None, hook=None, audit_every=0, corrupt=None,
           device="cpu"):
    """(tokens per request, host reads per forward, counters, per-request
    faults_detected, the session). `hook` (path, fn) is a fault_scope
    around session step `hook_step` only; `corrupt(session)` runs before
    the first step."""
    from repro_torch.core import injection as inj
    from repro_torch.core import workflow as WF
    from repro_torch.serving import ProtectedSession
    s = ProtectedSession(params, cfg, plan, slots=SLOTS, max_len=MAX_LEN,
                         mesh=mesh, correction=correction,
                         audit_every=audit_every,
                         device=None if mesh is not None else device)
    if corrupt is not None:
        corrupt(s)
    rids = [s.submit(p, GEN) for p in prompts]
    r0 = WF.HOST_READS
    i = 0
    while True:
        if hook is not None and i == hook_step:
            with inj.fault_scope(*hook):
                busy = s.step()
        else:
            busy = s.step()
        i += 1
        if not busy:
            break
    c = s.stats.counters
    forwards = c["prefills"] + c["decode_steps"]
    return ([s.tokens_for(r) for r in rids], (WF.HOST_READS - r0) / forwards,
            dict(c), [s.stats.record(r).faults_detected for r in rids], s)


def session_rank(rank: int, data: int, model: int, backend: str,
                 device: str, np_params, prompts, train_in=None,
                 dtype=None, unsharded: bool = False, drills: bool = True):
    """What the distributed tests hold one mesh to, from one rank: the
    deferred session's tokens (and, with `unsharded`, the unsharded
    session's beside them), the reads per forward, the forward's logits
    against the unsharded forward's, with `drills` a decode drill at this
    mesh's last rank's wo partial and an audit drill at rank 0's shard of
    a wq, and (given `train_in`: a JAX train state and batch as numpy) one
    sharded train step gathered back to full leaves."""
    import repro_torch.core as tcore
    from repro_torch.models import transformer as TM
    from repro_torch.runtime import sharding as SH
    mesh = _mesh(data, model, backend, device)
    cfg, params = _model(np_params, device, dtype)
    plan = tcore.build_plan(params, cfg, batch=SLOTS, seq=MAX_LEN,
                            device=device)
    if device != "cpu":
        plan = tcore.force_fused_matmul(plan)
    out = {}
    if unsharded:
        out["tokens_ref"] = _serve(params, cfg, plan, prompts,
                                   device=device)[0]
    from repro_torch.kernels import abft_matmul as AM
    AM.DETECT_LAUNCHES = 0
    got = _serve(params, cfg, plan, prompts, mesh=mesh)
    out["detect_launches"] = AM.DETECT_LAUNCHES
    out["forwards"] = got[2]["prefills"] + got[2]["decode_steps"]
    out["tokens"] = got[0]
    out["reads_per_forward"] = got[1]
    out["faults_clean"] = got[2]["faults_detected"]
    # the forward's logits, gathered over the mesh, against the unsharded
    toks = torch.as_tensor(np.stack([p[:4] for p in prompts[:SLOTS]]),
                           device=device)
    specs = SH.param_shardings(params, mesh, cfg)
    local = SH.shard_tree(params, specs, mesh)
    with torch.no_grad():
        want = TM.forward_train(params, toks, cfg)[0]
        n = mesh.axis_size("data")
        b = toks.shape[0] // n
        r = mesh.index("data")
        with SH.parallel_scope(mesh, specs):
            lg = TM.forward_train(local, toks[r * b:(r + 1) * b], cfg)[0]
        lg = SH.axis_gather(SH.axis_gather(lg, mesh, "model", -1), mesh,
                            "data", 0)
    out["logits_gap"] = float((lg - want).abs().max())
    out["logits_scale"] = float(want.abs().max())
    if drills:
        out.update(_drills(rank, mesh, params, cfg, plan, prompts))
    if train_in is not None:
        out["train"] = _train(mesh, cfg, train_in, device)
    return out


def _drills(rank, mesh, params, cfg, plan, prompts):
    out = {}

    # a +1e3 drill at the last rank's row-parallel wo partial, in the
    # decode step after the admissions (every repeat's wo, slot 0 of its
    # data shard)
    last = mesh.size - 1
    local_slots = SLOTS // mesh.axis_size("data")

    def hook(o):
        if o.shape[0] == local_slots and o.dim() == 3 and o.shape[1] == 1:
            o = o.clone()
            o[0, 0, 3] += 1e3
        return o

    dr = _serve(params, cfg, plan, prompts, mesh=mesh, hook_step=2,
                hook=(DRILL_SITE, hook) if rank == last else None)
    out["drill"] = {"tokens": dr[0], "counters": dr[2],
                    "per_request": dr[3],
                    "slot": mesh.index("data") * local_slots
                    if rank == last else None}

    # an audit drill: one element of rank 0's shard of a wq, repaired in
    # place from rank 0's locator sums before the first forward
    def corrupt(s):
        leaf = s.params
        for k in AUDIT_LEAF:
            leaf = leaf[k]
        out["audit_clean_leaf"] = leaf.clone()
        if rank == 0:
            leaf[0, 3, 5] += 4.0

    au = _serve(params, cfg, plan, prompts, mesh=mesh, audit_every=100,
                corrupt=corrupt)
    leaf = au[4].params
    for k in AUDIT_LEAF:
        leaf = leaf[k]
    out["audit"] = {"tokens": au[0], "counters": au[2],
                    "restored_bitwise": bool(torch.equal(
                        leaf, out.pop("audit_clean_leaf")))}
    return out


def _train(mesh, cfg, train_in, device):
    """One sharded AdamW step (2 microbatches, remat on) from the JAX
    package's train state: the loss, the full new params (gathered) and a
    digest of every replicated leaf, which must be bitwise the same on
    every rank; then the same step with +1e3 at the last rank's shard of
    the first repeat's ffn/up output (in the forward and in remat's
    recompute): its world-reduced verdict, loss and gathered params."""
    import repro_torch.core as tcore
    from repro_torch._tree import tree_flatten_with_path
    from repro_torch.core import injection as inj
    from repro_torch.core.plan import current_repeat
    from repro_torch.launch import steps as TS
    from repro_torch.models import transformer as TM
    from repro_torch.optim import OptConfig
    from repro_torch.runtime import sharding as SH
    state_np, batch_np, lr = train_in
    state = TM.train_state_from_numpy(state_np, device=device)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in batch_np.items()}
    opt = OptConfig(lr=lr)
    pspecs = SH.param_shardings(state["params"], mesh, cfg)
    sspecs = SH.param_shardings(state, mesh, cfg)
    local = SH.shard_tree(state, sspecs, mesh)
    step = TS.make_train_step(cfg, opt, microbatches=2, warmup=0,
                              mesh_axes=("data", "model"))
    with SH.parallel_scope(mesh, pspecs):
        new, m = step(local, batch)
    full = SH.unshard_tree(new["params"], pspecs, mesh)
    flat = SH.flat_specs(pspecs)
    digest = {p: hashlib.sha256(_np(t).tobytes()).hexdigest()
              for p, t in tree_flatten_with_path(new["params"])
              if not SH.is_sharded(flat[p])}

    def up_hook(o):
        if current_repeat() == 0:
            o = o.clone()
            o[0, 5, 7] += 1e3
        return o

    hook = (DRILL_TRAIN_SITE, up_hook) if mesh.rank == mesh.size - 1 else None
    with SH.parallel_scope(mesh, pspecs), tcore.plan_scope(mode="correct"):
        with inj.fault_scope(*hook) if hook else contextlib.nullcontext():
            dnew, dm = step(local, batch)
    dfull = SH.unshard_tree(dnew["params"], pspecs, mesh)
    return {"loss": float(m["loss"]),
            "params": {p: _np(t) for p, t in tree_flatten_with_path(full)},
            "replicated_digest": digest,
            "drill": {"report": [int(x) for x in dm["report"]],
                      "loss": float(dm["loss"]),
                      "params": {p: _np(t) for p, t in
                                 tree_flatten_with_path(dfull)}}}


# --------------------------------------------------------------------------
# the ssm and rec families and context-parallel decode
# (test_torch_distributed_recurrent.py, test_torch_gpu.py)
# --------------------------------------------------------------------------

def _case_model(case, device):
    """(cfg, params) of a case dict: `arch`, optional `layers`, `dtype`,
    `np_params` (None: the port's seed-0 params) and `table_scale` (the
    tied table scaled, as the rec tests' references scale it)."""
    import repro_torch.configs as TCF
    from repro_torch.models import transformer as TM
    cfg = TCF.get(case["arch"])
    if case.get("layers"):
        cfg = cfg.replace(num_layers=case["layers"])
    if case.get("dtype"):
        cfg = cfg.replace(dtype=case["dtype"])
    if case.get("np_params") is None:
        params = TM.init_params(cfg, device=device)
        if case.get("table_scale"):
            params["embed"]["table"] = (params["embed"]["table"]
                                        * case["table_scale"])
    else:
        params = TM.params_from_numpy(case["np_params"], device=device)
    return cfg, params


def _session(params, cfg, plan, case, mesh, device, hook_step=None,
             hook=None):
    """_serve with the case's slots, cache length and new tokens."""
    from repro_torch.core import injection as inj
    from repro_torch.core import workflow as WF
    from repro_torch.serving import ProtectedSession
    s = ProtectedSession(params, cfg, plan, slots=case["slots"],
                         max_len=case["max_len"], mesh=mesh,
                         device=None if mesh is not None else device)
    rids = [s.submit(p, case["gen"]) for p in case["prompts"]]
    r0 = WF.HOST_READS
    i = 0
    while True:
        with (inj.fault_scope(*hook) if hook is not None and i == hook_step
              else contextlib.nullcontext()):
            busy = s.step()
        i += 1
        if not busy:
            break
    c = dict(s.stats.counters)
    return {"tokens": [s.tokens_for(r) for r in rids],
            "reads_per_forward": (WF.HOST_READS - r0)
            / (c["prefills"] + c["decode_steps"]),
            "forwards": c["prefills"] + c["decode_steps"], "counters": c,
            "per_request": [s.stats.record(r).faults_detected
                            for r in rids]}, s


def recurrent_rank(rank: int, data: int, model: int, backend: str,
                   device: str, cases=(), cp_cases=(), train_cases=()):
    """One rank's view of the ssm and rec families on the mesh and of
    context-parallel decode, as host values.

    Each of `cases` (dicts: the model as _case_model takes it, `prompts`,
    `slots`, `max_len`, `gen`, `drill` a site path or None, `drill_row`:
    the drill spans the site's whole local output row) gives the
    deferred session's tokens, reads per forward and detect launches on
    the mesh, with `unsharded` the unsharded session's tokens beside
    them, the forward's logits gathered over the mesh against the
    unsharded forward's, and a +1e3 drill at the site's output on the
    mesh's last rank in the decode step after the admissions. Each of
    `cp_cases` (slots that do not divide the data axes) gives the
    session's tokens, the local shapes of its caches, and the logits of
    a context-parallel prefill of the first prompt and `gen` decode steps
    against the unsharded ones (their gap, whether all are finite). Each
    of `train_cases` (`arch`, `state` and `batch` as numpy, `lr`,
    `microbatches`) gives one sharded AdamW step's loss, its params
    gathered, and a digest of each replicated leaf."""
    import repro_torch.core as tcore
    from repro_torch._tree import tree_flatten_with_path
    from repro_torch.kernels import abft_matmul as AM
    from repro_torch.models import transformer as TM
    from repro_torch.runtime import sharding as SH
    mesh = _mesh(data, model, backend, device)
    out = {"cases": [], "cp": [], "train": []}
    for case in cases:
        cfg, params = _case_model(case, device)
        plan = tcore.build_plan(params, cfg, batch=case["slots"],
                                seq=case["max_len"], device=device)
        if device != "cpu":
            plan = tcore.force_fused_matmul(plan)
        reps = cfg.stages()[1]
        res = {"sites": sum(reps if e.stack else 1
                            for e in plan.entries.values())}
        if case.get("unsharded"):
            res["tokens_ref"] = _session(params, cfg, plan, case, None,
                                         device)[0]["tokens"]
        AM.DETECT_LAUNCHES = 0
        res.update(_session(params, cfg, plan, case, mesh, device)[0])
        res["detect_launches"] = AM.DETECT_LAUNCHES
        n = min(len(p) for p in case["prompts"])
        toks = torch.as_tensor(np.stack([p[:n] for p in
                                         (case["prompts"] * 4)[:4]]),
                               device=device)
        specs = SH.param_shardings(params, mesh, cfg)
        local = SH.shard_tree(params, specs, mesh)
        with torch.no_grad():
            want = TM.forward_train(params, toks, cfg)[0]
            b = toks.shape[0] // mesh.axis_size("data")
            r = mesh.index("data")
            with SH.parallel_scope(mesh, specs):
                lg = TM.forward_train(local, toks[r * b:(r + 1) * b],
                                      cfg)[0]
            lg = SH.axis_gather(SH.axis_gather(lg, mesh, "model", -1),
                                mesh, "data", 0)
        res["logits_gap"] = float((lg.float() - want.float()).abs().max())
        res["logits_scale"] = float(want.float().abs().max())
        if case.get("drill"):
            last = mesh.size - 1
            local_slots = case["slots"] // mesh.axis_size("data")
            cols = slice(None) if case.get("drill_row") else 3

            def hook(o):
                if (o.dim() == 3 and o.shape[0] == local_slots
                        and o.shape[1] == 1):
                    o = o.clone()
                    o[0, 0, cols] += 1e3
                return o

            dr = _session(params, cfg, plan, case, mesh, device,
                          hook_step=2,
                          hook=(case["drill"], hook) if rank == last
                          else None)[0]
            dr["slot"] = mesh.index("data") * local_slots
            res["drill"] = dr
        out["cases"].append(res)

    for case in cp_cases:
        cfg, params = _case_model(case, device)
        plan = tcore.build_plan(params, cfg, batch=case["slots"],
                                seq=case["max_len"], device=device)
        res, sess = _session(params, cfg, plan, case, mesh, device)
        res["cache_shapes"] = {p: list(t.shape) for p, t in
                               tree_flatten_with_path(sess._caches)}
        del sess
        # a context-parallel prefill and decode of the first prompt
        specs = SH.param_shardings(params, mesh, cfg)
        local = SH.shard_tree(params, specs, mesh)
        ucfg = cfg.replace(abft=False)
        prompt = torch.as_tensor(case["prompts"][0], device=device)[None]
        gaps, finite = [], True
        with torch.no_grad():
            lu, _, cu = TM.prefill(params, prompt, ucfg, case["max_len"])
            with SH.parallel_scope(mesh, specs, context_parallel=True):
                ls, _, cs = TM.prefill(local, prompt, ucfg, case["max_len"])
            pos = prompt.shape[1]
            for _ in range(case["gen"]):
                ls = SH.axis_gather(ls, mesh, "model", -1)
                gaps.append(float((ls.float() - lu.float()).abs().max()))
                finite = finite and bool(torch.isfinite(ls).all())
                nxt = torch.argmax(lu, dim=-1)
                lu, _, cu = TM.decode_step(params, nxt, cu, pos, ucfg)
                with SH.parallel_scope(mesh, specs, context_parallel=True):
                    ls, _, cs = TM.decode_step(local, nxt, cs, pos, ucfg)
                pos += 1
        res["cp_logits_gap"] = max(gaps)
        res["cp_finite"] = finite
        res["cp_scale"] = float(lu.float().abs().max())
        out["cp"].append(res)

    for case in train_cases:
        from repro_torch.launch import steps as TS
        from repro_torch.optim import OptConfig
        import repro_torch.configs as TCF
        cfg = TCF.get(case["arch"])
        state = TM.train_state_from_numpy(case["state"], device=device)
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in case["batch"].items()}
        pspecs = SH.param_shardings(state["params"], mesh, cfg)
        sspecs = SH.param_shardings(state, mesh, cfg)
        local = SH.shard_tree(state, sspecs, mesh)
        step = TS.make_train_step(cfg, OptConfig(lr=case["lr"]),
                                  microbatches=case["microbatches"],
                                  warmup=0, mesh_axes=("data", "model"))
        with SH.parallel_scope(mesh, pspecs):
            new, m = step(local, batch)
        full = SH.unshard_tree(new["params"], pspecs, mesh)
        flat = SH.flat_specs(pspecs)
        out["train"].append({
            "loss": float(m["loss"]),
            "report": [int(x) for x in m["report"]],
            "params": {p: _np(t) for p, t in tree_flatten_with_path(full)},
            "replicated_digest": {
                p: hashlib.sha256(_np(t).tobytes()).hexdigest()
                for p, t in tree_flatten_with_path(new["params"])
                if not SH.is_sharded(flat[p])}})
    return out


def cp_cache_rank(rank: int, data: int, model: int):
    """Context-parallel caches executed on a gloo mesh of CPU ranks: the
    local shapes init_caches gives a session's slots (3 and 1 rows) and a
    batch-1 prefill in a context-parallel scope, shard_tree / unshard_tree
    round trips of full caches under cache_shardings' specs, and the
    refusals: a param tree sharded over 'data' (fsdp=True), a cache tree
    taken as params, context-parallel rows that divide the data axes."""
    from repro_torch._tree import tree_flatten_with_path
    from repro_torch.runtime import sharding as SH
    import repro_torch.configs as TCF
    from repro_torch.models import transformer as TM
    mesh = _mesh(data, model, "gloo", "cpu")
    out = {"shapes": {}, "round_trip": {}, "local_shapes": {},
           "refused": {}}
    for arch in ("yi-9b-smoke", "recurrentgemma-2b-smoke",
                 "mamba2-1.3b-smoke"):
        cfg = TCF.get(arch)
        params = TM.init_params(cfg, device="cpu")
        specs = SH.param_shardings(params, mesh, cfg)
        for rows in (3, 1):
            with SH.parallel_scope(mesh, specs, context_parallel=True):
                c = TM.init_caches(cfg, rows, MAX_LEN, "cpu",
                                   shard_batch=True)
            out["shapes"][f"{arch}/{rows}"] = {
                p: list(t.shape) for p, t in tree_flatten_with_path(c)}
        full = TM.init_caches(cfg, 1, MAX_LEN, "cpu")
        g = torch.Generator().manual_seed(0)     # the same on every rank
        full = {sec: {blk: {k: torch.randn(t.shape, generator=g).to(t.dtype)
                            for k, t in leaves.items()}
                      for blk, leaves in blocks.items()}
                for sec, blocks in full.items()}
        cspecs = SH.cache_shardings(full, mesh, 1)
        local = SH.shard_tree(full, cspecs, mesh, cache=True)
        back = SH.unshard_tree(local, cspecs, mesh, cache=True)
        out["round_trip"][arch] = all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                tree_flatten_with_path(full), tree_flatten_with_path(back)))
        out["local_shapes"][arch] = {p: list(t.shape) for p, t in
                                     tree_flatten_with_path(local)}
        for what, fn in (
                ("fsdp_params", lambda: SH.shard_tree(
                    params, SH.param_shardings(params, mesh, cfg,
                                               fsdp=True), mesh)),
                ("cache_as_params", lambda: SH.shard_tree(full, cspecs,
                                                          mesh)),
                ("dividing_rows", lambda: _cp_caches(cfg, specs, mesh,
                                                     data))):
            try:
                fn()
                out["refused"][f"{arch}/{what}"] = None
            except (NotImplementedError, ValueError) as e:
                out["refused"][f"{arch}/{what}"] = f"{type(e).__name__}: {e}"
    return out


def _cp_caches(cfg, specs, mesh, rows):
    from repro_torch.runtime import sharding as SH
    from repro_torch.models import transformer as TM
    with SH.parallel_scope(mesh, specs, context_parallel=True):
        return TM.init_caches(cfg, rows, MAX_LEN, "cpu", shard_batch=True)
