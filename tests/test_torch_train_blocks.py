"""The port's training through the Mamba-2 (ssm), RG-LRU (rec) and MoE
blocks (launch.steps.make_train_step, models.transformer.forward_train
with `cfg.remat`, layers.moe under autograd, the gradient of the
protected and grouped GEMMs, optim's AdamW and Adafactor on expert
stacks, runtime.ft.StepRunner and launch.train.train) against the JAX
package's, on the reduced configs: `mamba2-1.3b-smoke`,
`recurrentgemma-2b-smoke`, `kimi-k2-1t-a32b-smoke` (top-2 of 8 experts,
a shared expert, a dense prefix layer) and
`llama4-maverick-400b-a17b-smoke` (top-1, moe every other layer), all
fp32, d 64, two stage repeats, with the JAX package's initial state
carried across and tokens made with numpy from a seed.

The JAX side is computed once per pytest run per config
(torch_parity.shared_reference) and runs unprotected: its train step is
spelled from the reference's own functions (forward_train,
cross_entropy, jax.value_and_grad, clip_by_global_norm, apply_updates,
cosine_schedule), inside plan_scope(None, mode="detect_only"), where
every JAX site takes the unprotected route. Its moe block passes `abft`
by position (ROADMAP 3.8), so an abft=False model would still protect its
grouped GEMMs under DEFAULT_CONFIG, a ladder whose jit costs half a
minute a program; launch.steps.make_train_step's microbatch scan merges
FaultReports, which that scope's detect-only carries are not; and a
protected JAX gradient costs 25-95 s eager. The port side runs protected
with remat on (the configs' default), and is held bitwise to its own
abft=False and remat=False twins.

Tolerances: loss and gnorm rtol 1e-5; gradients rtol 1e-4 with an atol of
1e-4 of each leaf's largest |g| (the two packages' fp32 sums differ by
reassociation); optimizer
moments rtol 1e-4 with an atol of 1e-4 of each leaf's scale; params rtol
1e-4 (atol 1e-4 lr) where every step's |g| > 1e-3 max|g| and Adam's first
moment does not cancel, and within 2 lr a step elsewhere (Adam's and an
unfactored Adafactor leaf's first step is about sign(g), and the sign of a
near-zero gradient follows rounding).
Inside the port the contracts are bitwise."""
import contextlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as JCF  # noqa: E402
import repro.core as jcore  # noqa: E402
from repro import optim as JO  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JM  # noqa: E402
import repro_torch.configs as TCF  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch._tree import (tree_flatten_with_path,  # noqa: E402
                               tree_leaves, tree_unflatten)
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.core import injection as tinj  # noqa: E402
from repro_torch.core import protected as TP  # noqa: E402
from repro_torch.core import workflow as TW  # noqa: E402
from repro_torch.core.plan import current_repeat  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import transformer as TM  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.runtime.ft import FTPolicy, StepRunner  # noqa: E402
from torch_parity import (assert_close, shared_reference,  # noqa: E402
                          tree_np, verdict)

ARCHS = ("mamba2-1.3b-smoke", "recurrentgemma-2b-smoke",
         "kimi-k2-1t-a32b-smoke", "llama4-maverick-400b-a17b-smoke")
MOE_ARCHS = ARCHS[2:]
# a stage site of each family, the fault drills' target: the ssm's
# in_proj, the rec block's in_x, the moe block's grouped gate (a (G, N, M)
# output) and the router
STAGE_SITE = {"mamba2-1.3b-smoke": "stages/b0_ssm/ssm/in_proj",
              "recurrentgemma-2b-smoke": "stages/b0_rec/rec/in_x",
              "kimi-k2-1t-a32b-smoke": "stages/b1_moe/moe/gate",
              "llama4-maverick-400b-a17b-smoke": "stages/b3_moe/moe/router"}
# the experts' gate (a (G, N, M) output; the hook's element lies in
# expert 0)
GATE_SITE = {"kimi-k2-1t-a32b-smoke": "stages/b1_moe/moe/gate",
             "llama4-maverick-400b-a17b-smoke": "stages/b3_moe/moe/gate"}
LR = 1e-3
BATCH, SEQ = 4, 16
# Adafactor factors a leaf whose last two dims are both at least this: the
# smokes' expert stacks (2, 8, 64, 48) and (2, 8, 48, 64) factor
FACTORED_MIN = 32


def _batches(cfg, n=2):
    """n numpy batches of (tokens, labels), (BATCH, SEQ) each."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        ex = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1))
        out.append((ex[:, :-1].astype(np.int32), ex[:, 1:].astype(np.int32)))
    return out


def _opt(kind):
    return OptConfig(lr=LR, kind=kind, factored_min=FACTORED_MIN)


def _jax_step(cfg, opt, mb):
    """The JAX package's train step from its own functions (see the module
    docstring), returning the full batch's gradients beside its metrics."""
    lr_fn = JO.cosine_schedule(opt.lr, 0, 10000)

    def loss_fn(params, tokens, labels):
        logits, _, aux = JM.forward_train(params, tokens, cfg)
        loss = JS.cross_entropy(logits, labels)
        return loss + 0.01 * aux if cfg.num_experts else loss

    def step(state, tokens, labels):
        n = tokens.shape[0] // mb
        loss, grads = 0.0, jax.tree.map(jnp.zeros_like, state["params"])
        for i in range(mb):
            sl = slice(i * n, (i + 1) * n)
            l_i, g_i = jax.value_and_grad(loss_fn)(state["params"],
                                                   tokens[sl], labels[sl])
            loss, grads = loss + l_i, jax.tree.map(jnp.add, grads, g_i)
        loss, grads = loss / mb, jax.tree.map(lambda g: g / mb, grads)
        clipped, gnorm = JO.clip_by_global_norm(grads, opt.grad_clip)
        params, new_opt = JO.apply_updates(state["params"], clipped,
                                           state["opt"], opt,
                                           lr_fn(state["step"]))
        return ({"params": params, "opt": new_opt, "step": state["step"] + 1},
                {"loss": loss, "gnorm": gnorm, "grads": grads})

    return step


def _build_reference(arch):
    """Per optimizer: the JAX initial state, and per microbatch count the
    state, loss, gnorm and gradients after each step (two AdamW steps on
    two batches; one Adafactor step, moe configs only)."""
    cfg = JCF.get(arch).replace(abft=False, remat=False)
    batches = _batches(cfg)
    out = {"batches": batches}
    runs = [("adamw", mb, 2) for mb in (1, 2)]
    if cfg.num_experts:
        runs.append(("adafactor", 1, 1))
    with jcore.plan_scope(None, mode="detect_only"):
        for kind, mb, steps in runs:
            opt = JO.OptConfig(lr=LR, kind=kind, factored_min=FACTORED_MIN)
            state = JS.init_train_state(jax.random.PRNGKey(0), cfg, opt)
            out.setdefault(kind, {"init": tree_np(state)})
            step = jax.jit(_jax_step(cfg, opt, mb))
            seq = []
            for tk, lb in batches[:steps]:
                state, m = step(state, jnp.asarray(tk), jnp.asarray(lb))
                seq.append({"state": tree_np(state),
                            "loss": float(m["loss"]),
                            "gnorm": float(m["gnorm"]),
                            "grads": tree_np(m["grads"])})
            out[kind][mb] = seq
    return out


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """Lazily built JAX references, one per config per pytest run."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = shared_reference(
                tmp_path_factory, f"train_blocks_{arch}",
                lambda: _build_reference(arch))
        return cache[arch]
    return get


def _state_t(ref, kind):
    return TM.train_state_from_numpy(ref[kind]["init"], device="cpu")


def _batch_t(tk, lb):
    return {"tokens": torch.as_tensor(tk), "labels": torch.as_tensor(lb)}


def _flat(tree):
    return dict(tree_flatten_with_path(tree))


def _stage_hook(calls, repeat=1):
    """+1e4 at one element of the site's output in stage repeat `repeat`
    alone (core.plan.current_repeat), recording each call's repeat."""
    def hook(o):
        calls.append(current_repeat())
        if current_repeat() != repeat:
            return o
        o = o.clone()
        o.reshape(-1)[5] += 1e4
        return o
    return hook


def _grads_t(cfg, params, tk, lb, site=None):
    """(loss, gradients by path, report, the hook's calls, host reads, the
    recompute's host reads) of the train step's loss. With `site` the
    forward runs with a _stage_hook there, inside plan_scope(mode=
    "correct"), which routes every site through protect_site, where hooks
    fire; the backward runs after the scopes have exited."""
    calls = []
    scope = contextlib.ExitStack()
    if site is not None:
        scope.enter_context(tcore.plan_scope(mode="correct"))
        scope.enter_context(tinj.fault_scope(site, _stage_hook(calls)))
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    TW.HOST_READS = TW.RECOMPUTE_READS = 0
    with scope:
        logits, rep, aux = TM.forward_train(tree_unflatten(params, leaves),
                                            torch.as_tensor(tk), cfg)
        loss = TS.cross_entropy(logits, torch.as_tensor(lb))
        if cfg.num_experts:
            loss = loss + 0.01 * aux
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), _flat(tree_unflatten(params, grads)), rep, calls,
            TW.HOST_READS, TW.RECOMPUTE_READS)


def _bitwise(a, b, what=""):
    fa, fb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    assert [n for n, _ in fa] == [n for n, _ in fb], what
    diff = [n for (n, x), (_, y) in zip(fa, fb)
            if not (x.dtype == y.dtype and torch.equal(x, y))]
    assert not diff, f"{what}: {diff[:5]}"


def _close_leaves(got, want, rtol, what):
    """Every leaf of the tree `want` within rtol, atol rtol x its scale,
    of the leaf of the tree `got` at its path."""
    got = _flat(got)
    for n, w in tree_flatten_with_path(want):
        scale = float(np.abs(w).max()) if w.size else 0.0
        assert_close(got[n], w, rtol, rtol * scale, f"{what} {n}")


def _close_params(got, want, runs, what):
    """New params after the reference's step records `runs`: tight where
    every step's |g| > 1e-3 max|g| and the first moment does not cancel
    (|m| > 0.1 of the sum of its terms' sizes: a moment summed from
    gradients of opposite signs carries their reassociation noise
    relative to the smaller sum), within 2 lr a step elsewhere (see the
    module docstring)."""
    got = _flat(tree_np(got))
    b1 = OptConfig().b1
    n_steps = len(runs)
    for n, wp in tree_flatten_with_path(want):
        big = np.ones(wp.shape, dtype=bool)
        m = mabs = 0.0
        for i, r in enumerate(runs):
            g = _flat(r["grads"])[n]
            big &= np.abs(g) > 1e-3 * np.abs(g).max()
            # Adam's first moment of the clipped gradients
            w = (1 - b1) * b1 ** (n_steps - 1 - i) \
                * min(1.0, 1.0 / (r["gnorm"] + 1e-9))
            m, mabs = m + w * g, mabs + w * np.abs(g)
        big &= np.abs(m) > 0.1 * mabs
        np.testing.assert_allclose(got[n][big], wp[big], rtol=1e-4,
                                   atol=1e-4 * LR, err_msg=f"{what} {n}")
        assert np.abs(got[n] - wp).max() <= 2 * LR * n_steps * (1 + 1e-5), \
            f"{what} {n}"


# --------------------------------------------------------------------------
# gradients against the JAX package's jax.value_and_grad
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(refs, arch):
    """The loss and every leaf's gradient of the first batch against the
    reference's (rtol 1e-5 and 1e-4, atol 1e-4 of each leaf's scale), the
    port protected and rematerialised, its report clean."""
    ref = refs(arch)
    want = ref["adamw"][1][0]
    tk, lb = ref["batches"][0]
    loss, grads, rep = _grads_t(TCF.get(arch), _state_t(ref, "adamw")[
        "params"], tk, lb)[:3]
    assert verdict(rep) == (0, 0, 0)
    assert_close(loss, want["loss"], 1e-5, 0.0, "loss")
    _close_leaves(grads, want["grads"], 1e-4, "grad")
    assert sorted(grads) == sorted(_flat(want["grads"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_protected_grads_bitwise_unprotected(refs, arch):
    """The protected clean path is the plain product plus reads, and the
    workflow's output carries the plain product's gradient: the protected
    gradients (remat on and off) are the abft=False model's bitwise."""
    ref = refs(arch)
    tk, lb = ref["batches"][0]
    params = _state_t(ref, "adamw")["params"]
    cfg = TCF.get(arch)
    plain = _grads_t(cfg.replace(abft=False), params, tk, lb)
    for remat in (True, False):
        got = _grads_t(cfg.replace(remat=remat), params, tk, lb)
        assert torch.equal(got[0], plain[0])
        _bitwise(got[1], plain[1], f"remat={remat}")


# --------------------------------------------------------------------------
# train steps against the JAX package's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_adamw_steps_match_jax(refs, arch, microbatches):
    """Two protected AdamW steps (warmup 0) on two batches against the
    reference's: each step taken from the reference's state before it
    (the carried JAX state, then its state after step 1) gives its loss,
    gnorm, params, moments m and v and step counters; the port's own two
    steps in a row end within 2 lr a step of the reference's params, the
    loss and gnorm within rtol 1e-5 (a param that step 1 moved by the
    sign of a near-zero gradient shifts step 2's gradients)."""
    ref = refs(arch)
    step = TS.make_train_step(TCF.get(arch), _opt("adamw"),
                              microbatches=microbatches, warmup=0)
    runs = ref["adamw"][microbatches]
    chained = _state_t(ref, "adamw")
    for i, want in enumerate(runs):
        what = f"mb {microbatches} step {i + 1}"
        batch = _batch_t(*ref["batches"][i])
        start = _state_t(ref, "adamw") if i == 0 else \
            TM.train_state_from_numpy(runs[i - 1]["state"], device="cpu")
        new, m = step(start, batch)
        assert verdict(m["report"]) == (0, 0, 0), what
        assert_close(m["loss"], want["loss"], 1e-5, 0.0, f"{what} loss")
        assert_close(m["gnorm"], want["gnorm"], 1e-5, 0.0, f"{what} gnorm")
        _close_params(new["params"], want["state"]["params"], runs[:i + 1],
                      what)
        for mom in ("m", "v"):
            _close_leaves(new["opt"][mom], want["state"]["opt"][mom],
                          1e-4, f"{what} {mom}")
        assert int(new["step"]) == int(new["opt"]["step"]) == i + 1
        chained, mc = step(chained, batch)
        assert_close(mc["loss"], want["loss"], 1e-5, 0.0, f"{what} loss")
        assert_close(mc["gnorm"], want["gnorm"], 1e-5, 0.0, f"{what} gnorm")
        got = _flat(tree_np(chained["params"]))
        for n, wp in tree_flatten_with_path(want["state"]["params"]):
            assert np.abs(got[n] - wp).max() <= 2 * LR * (i + 1) * (
                1 + 1e-5), f"{what} chained {n}"


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_adafactor_step_on_expert_stacks_matches_jax(refs, arch):
    """One protected Adafactor step with the expert stacks factored by
    their last two dims ((reps, E, K, M) -> r (reps, E, K), c (reps, E,
    M)): the loss, the params and the factored moments against the
    reference's."""
    ref = refs(arch)
    state = _state_t(ref, "adafactor")
    v = _flat(state["opt"]["v"])
    for name in ("gate", "up", "down"):
        leaf = [n for n in v if n.endswith(f"moe/{name}/r")]
        assert leaf and v[leaf[0]].dim() == 3, (name, sorted(v)[:8])
    step = TS.make_train_step(TCF.get(arch), _opt("adafactor"), warmup=0)
    new, m = step(state, _batch_t(*ref["batches"][0]))
    want = ref["adafactor"][1][0]
    assert verdict(m["report"]) == (0, 0, 0)
    assert_close(m["loss"], want["loss"], 1e-5, 0.0, "loss")
    _close_params(new["params"], want["state"]["params"],
                  [ref["adamw"][1][0]], "adafactor")
    _close_leaves(new["opt"]["v"], want["state"]["opt"]["v"], 1e-4,
                  "adafactor v")


# --------------------------------------------------------------------------
# remat: the recompute replays the forward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fault", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_grads_bitwise(arch, fault):
    """Remat on and off give bitwise-equal loss and gradients, clean and
    with +1e4 injected at one element of a stage site's output in repeat
    1. With remat the backward recomputes each repeat: the hook fires
    again in the recompute of repeat 1 (and the workflow corrects it
    again), the recompute's host reads are counted apart
    (workflow.RECOMPUTE_READS), and the report is the forward's."""
    cfg = TCF.get(arch)
    state = TS.init_train_state(torch.Generator().manual_seed(3), cfg,
                                _opt("adamw"), device="cpu")
    tk, lb = _batches(cfg, 1)[0]
    site = STAGE_SITE[arch] if fault else None
    on = _grads_t(cfg, state["params"], tk, lb, site)
    off = _grads_t(cfg.replace(remat=False), state["params"], tk, lb,
                         site)
    assert torch.equal(on[0], off[0])
    _bitwise(on[1], off[1], "remat on vs off")
    assert verdict(on[2]) == verdict(off[2])
    assert on[5] > 0 and off[5] == 0
    assert on[4] - on[5] == off[4]
    if fault:
        det, by, resid = verdict(on[2])
        assert det == 1 and by != 0 and resid == 0, verdict(on[2])
        # the forward calls the site once per repeat, the recompute again
        assert off[3] == [0, 1] and sorted(on[3]) == [0, 0, 1, 1], on[3]
    else:
        assert verdict(on[2]) == (0, 0, 0)


# --------------------------------------------------------------------------
# the moe block under autograd
# --------------------------------------------------------------------------

def test_moe_dispatch_backward_sums_token_copies():
    """The dispatch gather's spelling (tokens repeated k times, then
    permuted) gives the values and the gradient of a gather by token
    index: the k copies of a token summed."""
    rng = np.random.default_rng(2)
    t, k, d = 12, 3, 5
    xt = torch.as_tensor(rng.standard_normal((t, d)).astype(np.float32))
    order = torch.as_tensor(rng.permutation(t * k))
    g = torch.as_tensor(rng.standard_normal((t * k, d)).astype(np.float32))
    a = xt.clone().requires_grad_(True)
    got = a[:, None].expand(t, k, d).reshape(t * k, d)[order]
    b = xt.clone().requires_grad_(True)
    want = b[order // k]
    assert torch.equal(got, want)
    (ga,), (gb,) = (torch.autograd.grad(y, x, g) for y, x in
                    ((got, a), (want, b)))
    torch.testing.assert_close(ga, gb, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_corrected_expert_passes_its_gradient(arch, monkeypatch):
    """+1e4 at one element of expert 0's gate output: the grouped ladder
    runs for that expert alone (one protect_matmul_output call with the
    carried flag), the report says corrected, and the gradients are the
    clean run's within the fix's rounding (rtol 1e-4 of each leaf's
    scale): the corrected output carries the plain grouped product's
    gradient."""
    cfg = TCF.get(arch).replace(remat=False)
    state = TS.init_train_state(torch.Generator().manual_seed(4), cfg,
                                _opt("adamw"), device="cpu")
    tk, lb = _batches(cfg, 1)[0]
    ladders = []
    inner = TP.protect_matmul_output

    def counting(*a, **kw):
        if kw.get("detected") is True:
            ladders.append(a[0].shape)
        return inner(*a, **kw)

    monkeypatch.setattr(TP, "protect_matmul_output", counting)
    clean = _grads_t(cfg, state["params"], tk, lb, None)
    assert not ladders
    hit = _grads_t(cfg, state["params"], tk, lb, GATE_SITE[arch])
    assert len(ladders) == 1, ladders
    det, by, resid = verdict(hit[2])
    assert det == 1 and by != 0 and resid == 0
    assert_close(hit[0], clean[0], 1e-5, 0.0, "loss")
    for n, g in clean[1].items():
        scale = float(g.abs().max())
        assert_close(hit[1][n], g, 1e-4, 1e-4 * scale, n)


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_step_runner_counts_a_stage_fault_and_retries(arch):
    """StepRunner over the port's train step (2 microbatches, remat on):
    a fault at the stage site in repeat 1 of every forward is detected,
    corrected and counted, with no retry, the loss within rtol 1e-4 of
    the clean step's; a fake bad verdict on a first attempt is recomputed
    once from the same state, and the accepted step is a clean step
    bitwise."""
    cfg = TCF.get(arch)
    state = TS.init_train_state(torch.Generator().manual_seed(5), cfg,
                                _opt("adamw"), device="cpu")
    step = TS.make_train_step(cfg, _opt("adamw"), microbatches=2, warmup=0)
    batch = _batch_t(*_batches(cfg, 1)[0])
    clean, mc = step(state, batch)
    calls = []
    runner = StepRunner(step, FTPolicy())
    with tcore.plan_scope(mode="correct"), \
            tinj.fault_scope(STAGE_SITE[arch], _stage_hook(calls)):
        _, m = runner.run(state, batch)
    det, by, resid = verdict(m["report"])
    assert det == 1 and by != 0 and resid == 0
    assert runner.stats["faults_detected"] == 1
    assert runner.stats["faults_corrected"] == 1
    assert runner.stats["retries"] == 0
    assert calls.count(1) == 4, calls      # 2 forwards, 2 recomputes
    assert_close(m["loss"], mc["loss"], 1e-4, 0.0, "loss")

    tries = {"n": 0}

    def flaky(state, batch):
        tries["n"] += 1
        new, m = step(state, batch)
        if tries["n"] == 1:
            m = {**m, "report": tcore.FaultReport(1, 0, 1)}
        return new, m

    runner = StepRunner(flaky, FTPolicy(max_step_retries=2))
    new, m = runner.run(state, batch)
    assert tries["n"] == 2 and runner.stats["retries"] == 1
    assert verdict(m["report"]) == (0, 0, 0)
    _bitwise(new, clean, "accepted step")


def test_train_driver_restarts_a_bf16_moe_model_bitwise(tmp_path):
    """launch.train.train on a bf16 Kimi-K2 smoke whose prefix holds a moe
    block too (3-D expert leaves beside the stages' 4-D ones): 6 steps
    with a checkpoint every 3; a run stopped at step 3 and resumed by a
    fresh train() ends bitwise where the uninterrupted run ends, every
    bf16 expert leaf saved as a '<V2' file."""
    name = "kimi-k2-bf16-moe-prefix"
    tarchs.ARCH_BUILDERS[name] = lambda: TCF.get(
        "kimi-k2-1t-a32b-smoke").replace(
            name=name, dtype="bfloat16", prefix_pattern=("attn_full", "moe"))
    kw = dict(batch=BATCH, seq=SEQ, ckpt_every=3, lr=LR, microbatches=2,
              device="cpu")
    try:
        full, hist, stats = train(name, 6, ckpt_dir=str(tmp_path / "a"),
                                  **kw)
        assert stats["retries"] == 0 and stats["faults_detected"] == 0
        _, h1, _ = train(name, 3, ckpt_dir=str(tmp_path / "b"), **kw)
        resumed, h2, _ = train(name, 6, ckpt_dir=str(tmp_path / "b"), **kw)
    finally:
        tarchs.ARCH_BUILDERS.pop(name, None)
    assert h1 + h2 == hist and all(np.isfinite(hist))
    _bitwise(resumed, full, "resumed run")
    mgr = CheckpointManager(str(tmp_path / "b"))
    step3 = tmp_path / "b" / "step_00000003"
    man = json.loads((step3 / "manifest.json").read_text())["leaves"]
    experts = {n: e for n, e in man.items()
               if n.startswith("params/") and n.rsplit("/", 1)[-1] in
               ("gate", "up", "down") and "moe" in n}
    ndims = {len(e["shape"]) for e in experts.values()}
    assert ndims == {3, 4}, experts
    for e in experts.values():
        assert e["dtype"] == "bfloat16"
        assert b"'<V2'" in (step3 / e["file"]).read_bytes()[:128]
    assert mgr.all_steps() == [3, 6]
