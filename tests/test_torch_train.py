"""The port's single-card training path (core.protected.abft_matmul_vjp,
models.transformer.forward_train / train_apply / train_state_from_numpy,
launch.steps, checkpoint.manager, launch.train) against the JAX
package's, on the reduced SmolLM-360M with 2 layers (fp32, d 64; the
model of tests/test_train_ft.py), the JAX initial state carried across
and the JAX package's batches replayed as numpy arrays.

Tolerances, each stated where it is used: the backward products and the
logits agree to fp32 reassociation (rtol 1e-5, atol 1e-5 of the scale);
loss and gnorm rtol 1e-5; grads rtol 1e-4; updated params rtol 1e-4 where
|g| > 1e-3 max|g| and within 2 lr elsewhere (Adam's first step is about
sign(g), and the sign of a near-zero grad follows rounding). Inside the
port the contracts are bitwise: a protected step equals its abft=False
twin, and a restart from a checkpoint ends where the uninterrupted run
ends."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as JCF  # noqa: E402
import repro.core as jcore  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.data import DataConfig as JData  # noqa: E402
from repro.data import host_batch as j_host_batch  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JM  # noqa: E402
from repro.optim import OptConfig as JOpt  # noqa: E402
import repro_torch.configs as TCF  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch._tree import tree_flatten_with_path  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import injection as tinj  # noqa: E402
from repro_torch.data import DataConfig, host_batch  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import transformer as TM  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.runtime.ft import FTPolicy, StepRunner  # noqa: E402
from torch_parity import (assert_close, normal,  # noqa: E402
                          shared_reference, to_np, tree_np, verdict)

LR = 1e-3
BATCH, SEQ = 4, 16
HEAD = "embed/table"


def _cfgs():
    mk = lambda C: C.reduced(C.get("smollm-360m")).replace(
        num_layers=2, remat=False)
    return mk(JCF), mk(TCF)


def _flat(tree):
    return tree_flatten_with_path(tree_np(tree))


def _batch_t(tokens, labels):
    return {"tokens": torch.as_tensor(np.asarray(tokens)),
            "labels": torch.as_tensor(np.asarray(labels))}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's initial state and batch as numpy arrays, made once
    per pytest run and shared with every xdist worker
    (torch_parity.shared_reference), and both packages' configs."""
    def build():
        cfg_j, _ = _cfgs()
        state_j = JS.init_train_state(jax.random.PRNGKey(0), cfg_j,
                                      JOpt(lr=LR))
        tk, lb = j_host_batch(JData(vocab_size=cfg_j.vocab_size,
                                    seq_len=SEQ, global_batch=BATCH), 0)
        return {"state": tree_np(state_j), "tokens": np.array(tk),
                "labels": np.array(lb)}

    out = shared_reference(tmp_path_factory, "train_state", build)
    out["cfg_j"], out["cfg_t"] = _cfgs()
    return out


@pytest.fixture(scope="module")
def ref_steps(ref, tmp_path_factory):
    """One JAX train step from `ref`'s state at microbatches 1 and 2
    (warmup 0, so the first step's lr is LR), once per pytest run.

    The step at microbatches 1 runs protected. The one at 2 runs
    abft=False: a protected clean step is the plain one plus reads (the
    port holds its own twin bitwise in
    test_protected_step_bitwise_equals_unprotected), and the JAX ladder
    costs half a minute of compile per jitted step. The full batch's
    grads are read back from the protected step's first moment: after one
    step m = (1 - b1) * clip(g), clip's scale from the step's gnorm."""
    def build():
        cfg_j, opt_j = ref["cfg_j"], JOpt(lr=LR)
        state_j = jax.tree.map(jnp.asarray, ref["state"])
        batch = {"tokens": jnp.asarray(ref["tokens"]),
                 "labels": jnp.asarray(ref["labels"])}
        out = {}
        for mb, abft in ((1, True), (2, False)):
            step = jax.jit(JS.make_train_step(cfg_j.replace(abft=abft),
                                              opt_j, microbatches=mb,
                                              warmup=0))
            new, m = step(state_j, batch)
            out[mb] = {"state": tree_np(new), "loss": float(m["loss"]),
                       "gnorm": float(m["gnorm"]), "lr": float(m["lr"]),
                       "report": verdict(m["report"])}
        scale = min(1.0, opt_j.grad_clip / (out[1]["gnorm"] + 1e-9))
        out["grads"] = {n: g / (1.0 - opt_j.b1) / scale for n, g in
                        tree_flatten_with_path(out[1]["state"]["opt"]["m"])}
        return out

    return shared_reference(tmp_path_factory, "train_steps", build)


@pytest.fixture(scope="module")
def ref_logits(ref, tmp_path_factory):
    """The JAX package's jitted protected forward_train on `ref`'s params
    and batch: logits and verdict, once per pytest run."""
    def build():
        cfg_j = ref["cfg_j"]
        params = jax.tree.map(jnp.asarray, ref["state"]["params"])
        logits, rep, _ = jax.jit(
            lambda p, t: JM.forward_train(p, t, cfg_j))(
                params, jnp.asarray(ref["tokens"]))
        return {"logits": np.asarray(logits), "report": verdict(rep)}

    return shared_reference(tmp_path_factory, "train_logits", build)


def _state_t(ref):
    return TM.train_state_from_numpy(ref["state"], device="cpu")


# --------------------------------------------------------------------------
# abft_matmul_vjp
# --------------------------------------------------------------------------

def _vjp_grads_jax(d, w, cfg):
    f = lambda d, w: jnp.sum(jcore.abft_matmul_vjp(d, w, cfg) ** 2)
    return jax.grad(f, argnums=(0, 1))(jnp.asarray(d), jnp.asarray(w))


def _vjp_grads_torch(d, w, fn):
    dt = torch.as_tensor(d).requires_grad_(True)
    wt = torch.as_tensor(w).requires_grad_(True)
    return torch.autograd.grad(torch.sum(fn(dt, wt) ** 2), (dt, wt))


@pytest.mark.parametrize("protect_backward", [True, False])
def test_abft_matmul_vjp_matches_jax_and_plain_autograd(protect_backward):
    """dD and dW of sum(O^2) through abft_matmul_vjp (the setup of
    tests/test_train_ft.py::test_backward_protection_grads_match) against
    the JAX package's and against autograd of the plain product: rtol 1e-5,
    atol 1e-5 of the scale. The clean backward's two reports are clean."""
    d, w = normal(0, (64, 32)), normal(1, (32, 48))
    cj = jcore.DEFAULT_CONFIG.replace(protect_backward=protect_backward)
    ct = tcore.DEFAULT_CONFIG.replace(protect_backward=protect_backward)
    reports = []
    got = _vjp_grads_torch(d, w, lambda a, b: tcore.abft_matmul_vjp(
        a, b, ct, reports))
    want = _vjp_grads_jax(d, w, cj)
    plain = _vjp_grads_torch(d, w, lambda a, b: a @ b)
    for g, wj, p, what in zip(got, want, plain, ("dD", "dW")):
        scale = float(np.abs(np.asarray(wj)).max())
        assert_close(g, wj, 1e-5, 1e-5 * scale, f"{what} vs JAX")
        assert_close(g, p, 1e-5, 1e-5 * scale, f"{what} vs plain autograd")
    assert [verdict(r) for r in reports] == \
        ([(0, 0, 0)] * 2 if protect_backward else [])


@pytest.mark.parametrize("product", ["dD", "dW"])
def test_abft_matmul_vjp_corrects_a_fault_in_the_backward(product):
    """One element of one backward product corrupted by a fault hook at
    the call site's path + "/dD" or "/dW": that product's report says
    detected, corrected, residual 0, the other's is clean, and both
    gradients are back within the clean tolerance of plain autograd."""
    d, w = normal(2, (64, 32)), normal(3, (32, 48))

    def hook(o):
        o = o.clone()
        o[3, 5] = o[3, 5] * 512.0 + 1.0
        return o

    reports, calls = [], []
    hooked = lambda o: (calls.append(o.shape), hook(o))[1]
    with tcore.plan_scope(), tcore.path_scope("site"), \
            tinj.fault_scope(f"site/{product}", hooked):
        fn = lambda a, b: tcore.abft_matmul_vjp(a, b, tcore.DEFAULT_CONFIG,
                                                reports)
        dt = torch.as_tensor(d).requires_grad_(True)
        wt = torch.as_tensor(w).requires_grad_(True)
        o = fn(dt, wt)
    got = torch.autograd.grad(torch.sum(o ** 2), (dt, wt))
    plain = _vjp_grads_torch(d, w, lambda a, b: a @ b)
    assert len(calls) == 1
    hit = 0 if product == "dD" else 1
    v = [verdict(r) for r in reports]
    assert v[hit][0] == 1 and v[hit][1] != 0 and v[hit][2] == 0, v
    assert v[1 - hit] == (0, 0, 0), v
    for g, p, what in zip(got, plain, ("dD", "dW")):
        scale = float(p.abs().max())
        assert_close(g, p, 1e-5, 1e-5 * scale, what)


# --------------------------------------------------------------------------
# forward_train, train_apply, the carry-across
# --------------------------------------------------------------------------

def test_forward_train_matches_jax(ref, ref_logits):
    """Logits within rtol 1e-5, atol 1e-5 of the scale; both reports
    clean; aux 0; train_apply under ProtectedModel gives the same logits
    bitwise, per_layer and deferred."""
    st = _state_t(ref)
    tokens = torch.as_tensor(ref["tokens"])
    logits, rep, aux = TM.forward_train(st["params"], tokens, ref["cfg_t"])
    scale = float(np.abs(ref_logits["logits"]).max())
    assert_close(logits, ref_logits["logits"], 1e-5, 1e-5 * scale, "logits")
    assert verdict(rep) == ref_logits["report"] == (0, 0, 0)
    assert float(aux) == 0.0 and logits.dtype == torch.float32
    pm = tcore.ProtectedModel(TM.train_apply(ref["cfg_t"]))
    for mode in ("per_layer", "deferred"):
        (lg, a), r = pm(st["params"], tokens, correction=mode)
        assert torch.equal(lg, logits), mode


def test_forward_train_backward_under_anomaly_detection(ref):
    """One backward through the protected forward with autograd's anomaly
    detection on: no in-place write to a saved tensor, every gradient
    finite."""
    st = _state_t(ref)
    params = {k: v for k, v in st["params"].items()}
    leaves = [(n, p.requires_grad_(True))
              for n, p in tree_flatten_with_path(params)]
    with torch.autograd.set_detect_anomaly(True):
        logits, rep, _ = TM.forward_train(
            params, torch.as_tensor(ref["tokens"]), ref["cfg_t"])
        loss = TS.cross_entropy(logits, torch.as_tensor(ref["labels"]))
        grads = torch.autograd.grad(loss, [p for _, p in leaves])
    assert verdict(rep) == (0, 0, 0)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_train_state_from_numpy_carries_bits():
    """Every leaf of a JAX train state crosses bit for bit, bf16 params
    and an Adafactor tree included."""
    cfg_j = JCF.reduced(JCF.get("smollm-360m")).replace(
        num_layers=2, dtype="bfloat16")
    for kind in ("adamw", "adafactor"):
        sj = tree_np(JS.init_train_state(jax.random.PRNGKey(1), cfg_j,
                                         JOpt(kind=kind)))
        st = TM.train_state_from_numpy(sj, device="cpu")
        fj, ft = tree_flatten_with_path(sj), tree_flatten_with_path(st)
        assert [n for n, _ in fj] == [n for n, _ in ft]
        for (n, a), (_, b) in zip(fj, ft):
            if a.dtype.name == "bfloat16":
                assert b.dtype == torch.bfloat16, n
                assert np.array_equal(a.view(np.uint16),
                                      b.view(torch.int16).numpy()
                                      .view(np.uint16)), n
            else:
                assert np.array_equal(a, b.numpy()), n
    with pytest.raises(KeyError, match="train state"):
        TM.train_state_from_numpy({"params": {}}, device="cpu")


def test_cross_entropy_matches_jax():
    logits = normal(4, (2, 5, 3, 11), 3.0)
    labels = np.random.default_rng(5).integers(0, 11, (2, 5, 3))
    for lg, lb in ((logits, labels), (logits[:, :, 0], labels[:, :, 0])):
        got = TS.cross_entropy(torch.as_tensor(lg), torch.as_tensor(lb))
        want = JS.cross_entropy(jnp.asarray(lg), jnp.asarray(lb))
        assert_close(got, want, 1e-6, 0.0, "cross_entropy")
        # the vocab-parallel form (iota == label, each reduction over
        # 'model'), here outside a mesh: one slice holds the vocabulary
        got = TS.cross_entropy(torch.as_tensor(lg), torch.as_tensor(lb),
                               mesh_axes=("data", "model"))
        assert_close(got, want, 1e-6, 0.0, "cross_entropy(mesh_axes)")


# --------------------------------------------------------------------------
# one train step against the JAX package's
# --------------------------------------------------------------------------

def test_grads_match_jax(ref, ref_steps):
    """Grads of the full batch's loss against the JAX step's (read back
    from its first moment), rtol 1e-4 (atol 1e-4 of each leaf's scale)."""
    st = _state_t(ref)
    leaves = [(n, p.requires_grad_(True))
              for n, p in tree_flatten_with_path(st["params"])]
    logits, _, _ = TM.forward_train(st["params"],
                                    torch.as_tensor(ref["tokens"]),
                                    ref["cfg_t"])
    loss = TS.cross_entropy(logits, torch.as_tensor(ref["labels"]))
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    want = ref_steps["grads"]
    for (n, _), g in zip(leaves, grads):
        scale = float(np.abs(want[n]).max())
        assert_close(g, want[n], 1e-4, 1e-4 * scale, f"grad {n}")


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(ref, ref_steps, microbatches):
    """One protected step from the carried JAX state on the replayed JAX
    batch (the JAX step: see `ref_steps`): loss and gnorm within rtol
    1e-5, the report clean, the new params within rtol 1e-4 (atol 1e-4
    lr) where |g| > 1e-3 max|g| and within 2 lr elsewhere, and the step
    counters equal."""
    want = ref_steps[microbatches]
    step = TS.make_train_step(ref["cfg_t"], OptConfig(lr=LR),
                              microbatches=microbatches, warmup=0)
    new, m = step(_state_t(ref), _batch_t(ref["tokens"], ref["labels"]))
    assert_close(m["loss"], want["loss"], 1e-5, 0.0, "loss")
    assert_close(m["gnorm"], want["gnorm"], 1e-5, 0.0, "gnorm")
    assert_close(m["lr"], want["lr"], 1e-6, 0.0, "lr")
    assert verdict(m["report"]) == want["report"] == (0, 0, 0)
    got = dict(tree_flatten_with_path(tree_np(new["params"])))
    for n, wp in tree_flatten_with_path(want["state"]["params"]):
        g = np.abs(ref_steps["grads"][n])
        big = g > 1e-3 * g.max()
        # atol 1e-4 of the step's size for a param the step takes to ~0
        np.testing.assert_allclose(got[n][big], wp[big], rtol=1e-4,
                                   atol=1e-4 * LR, err_msg=n)
        assert np.abs(got[n] - wp).max() <= 2 * LR * (1 + 1e-5), n
    assert int(new["step"]) == int(want["state"]["step"]) == 1
    assert int(new["opt"]["step"]) == 1


# --------------------------------------------------------------------------
# the port's own contracts
# --------------------------------------------------------------------------

def _smoke_state(cfg, seed=0, opt=None):
    return TS.init_train_state(torch.Generator().manual_seed(seed), cfg,
                               opt or OptConfig(lr=LR), device="cpu")


def _assert_bitwise(a, b, what=""):
    fa, fb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    assert [n for n, _ in fa] == [n for n, _ in fb], what
    for (n, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what} {n}"


def test_loss_decreases_and_reports_clean():
    """Twin of tests/test_train_ft.py::test_loss_decreases_and_reports_
    clean: 12 steps over three cycled batches, every report clean."""
    _, cfg = _cfgs()
    opt = OptConfig(lr=3e-3)
    state = _smoke_state(cfg, opt=opt)
    step = TS.make_train_step(cfg, opt, microbatches=2)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    losses = []
    for i in range(12):
        tokens, labels = host_batch(dcfg, i % 3)
        state, m = step(state, {"tokens": tokens, "labels": labels})
        losses.append(float(m["loss"]))
        assert verdict(m["report"]) == (0, 0, 0)
    assert losses[-1] < losses[0] - 0.05, losses


def test_train_step_is_functional():
    """The state a step is given is left as it was (no write, no .grad),
    so recomputing the step from it gives the same new state bitwise."""
    _, cfg = _cfgs()
    state = _smoke_state(cfg)
    before = {n: v.clone() for n, v in tree_flatten_with_path(state)}
    step = TS.make_train_step(cfg, OptConfig(lr=LR), warmup=0)
    tokens, labels = host_batch(DataConfig(cfg.vocab_size, SEQ, BATCH), 0)
    batch = {"tokens": tokens, "labels": labels}
    new1, _ = step(state, batch)
    for n, v in tree_flatten_with_path(state):
        assert torch.equal(v, before[n]), n
        assert v.grad is None and not v.requires_grad, n
    new2, _ = step(state, batch)
    _assert_bitwise(new1, new2, "recomputed step")
    assert not torch.equal(new1["params"]["final_norm"],
                           state["params"]["final_norm"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_protected_step_bitwise_equals_unprotected(dtype, microbatches):
    """The protected clean path is the plain product plus reads, so the
    gradients, loss and updated state of a protected step equal the
    abft=False step's bitwise."""
    _, cfg = _cfgs()
    cfg = cfg.replace(dtype=dtype)
    state = _smoke_state(cfg)
    tokens, labels = host_batch(DataConfig(cfg.vocab_size, SEQ, BATCH), 1)
    outs = []
    for abft in (True, False):
        step = TS.make_train_step(cfg.replace(abft=abft), OptConfig(lr=LR),
                                  microbatches=microbatches, warmup=0)
        outs.append(step(state, {"tokens": tokens, "labels": labels}))
    (a, ma), (b, mb) = outs
    _assert_bitwise(a, b, "state")
    assert torch.equal(ma["loss"], mb["loss"])
    assert torch.equal(ma["gnorm"], mb["gnorm"])


def test_train_step_corrects_a_forward_fault():
    """One element of the tied head's output corrupted during one step:
    injection.fault_scope at "embed/table", which the training forward
    reaches through protect_site once an empty plan_scope() makes the
    paths live (no plan, no mode: the step runs as without it). The
    ladder corrects it, StepRunner counts one fault detected and
    corrected and no retry, and the loss equals the clean step's within
    rtol 1e-4."""
    _, cfg = _cfgs()
    state = _smoke_state(cfg)
    step = TS.make_train_step(cfg, OptConfig(lr=LR), warmup=0)
    tokens, labels = host_batch(DataConfig(cfg.vocab_size, SEQ, BATCH), 2)
    batch = {"tokens": tokens, "labels": labels}
    _, clean = step(state, batch)

    def hook(o):
        o = o.clone()
        o[1, 3, 7] = o[1, 3, 7] * 512.0 + 1.0
        return o

    runner = StepRunner(step, FTPolicy())
    with tcore.plan_scope(), tinj.fault_scope(HEAD, hook):
        new, m = runner.run(state, batch)
    det, by, resid = verdict(m["report"])
    assert det == 1 and by != 0 and resid == 0
    assert runner.stats["faults_detected"] == 1
    assert runner.stats["faults_corrected"] == 1
    assert runner.stats["retries"] == 0
    assert_close(m["loss"], clean["loss"], 1e-4, 0.0, "loss")
    assert all(bool(torch.isfinite(v).all())
               for _, v in tree_flatten_with_path(new["params"]))


def test_step_runner_retries_the_port_step():
    """Twin of tests/test_train_ft.py::test_step_runner_retries_on_
    residual over the port's own train step: a fake bad verdict on the
    first attempt is recomputed once, from the same state, and the
    accepted step equals a clean step bitwise."""
    _, cfg = _cfgs()
    state = _smoke_state(cfg)
    step = TS.make_train_step(cfg, OptConfig(lr=LR), warmup=0)
    tokens, labels = host_batch(DataConfig(cfg.vocab_size, SEQ, BATCH), 0)
    batch = {"tokens": tokens, "labels": labels}
    calls = {"n": 0}

    def flaky(state, batch):
        calls["n"] += 1
        new, m = step(state, batch)
        if calls["n"] == 1:
            m = {**m, "report": tcore.FaultReport(1, 0, 1)}
        return new, m

    runner = StepRunner(flaky, FTPolicy(max_step_retries=2))
    new, m = runner.run(state, batch)
    assert calls["n"] == 2
    assert runner.stats["retries"] == 1
    assert runner.stats["faults_detected"] == 1
    assert verdict(m["report"]) == (0, 0, 0)
    _assert_bitwise(new, step(state, batch)[0], "accepted step")


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _run(step, dcfg, state, n0, n1):
    for i in range(n0, n1):
        tokens, labels = host_batch(dcfg, i)
        state, _ = step(state, {"tokens": tokens, "labels": labels})
    return state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_restart_determinism(tmp_path, dtype):
    """Twin of tests/test_train_ft.py::test_checkpoint_restart_
    determinism: 6 steps; a restart from the step-3 checkpoint ends
    bitwise where the uninterrupted run ends, params and AdamW state
    (bf16 leaves through their '<V2' files)."""
    _, cfg = _cfgs()
    cfg = cfg.replace(dtype=dtype)
    step = TS.make_train_step(cfg, OptConfig(lr=LR), warmup=1)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                      global_batch=BATCH)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    state = _run(step, dcfg, _smoke_state(cfg), 0, 3)
    mgr.save(3, state, blocking=True)
    full = _run(step, dcfg, state, 3, 6)
    restored = mgr.restore(3, _smoke_state(cfg, seed=9))
    _assert_bitwise(restored, state, "restored")
    _assert_bitwise(_run(step, dcfg, restored, 3, 6), full, "resumed")


def test_checkpoint_corruption_detected(tmp_path):
    """One byte of one saved leaf flipped: restore raises IOError."""
    _, cfg = _cfgs()
    state = _smoke_state(cfg.replace(dtype="bfloat16"))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, state, blocking=True)
    d = tmp_path / "ck" / "step_00000001"
    victim = sorted(p for p in d.iterdir() if p.suffix == ".npy")[0]
    raw = bytearray(victim.read_bytes())
    raw[-7] ^= 0xFF
    victim.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corruption"):
        mgr.restore(1, state)


def test_async_checkpoint_and_gc(tmp_path):
    """Non-blocking saves, joined by wait(); GC keeps the newest `keep`
    (3 by default); a torn save (no COMMITTED) is not a step."""
    _, cfg = _cfgs()
    state = _smoke_state(cfg)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    for s in (1, 2, 3, 4, 5):
        mgr.save(s, state, blocking=False)
    mgr.wait()
    assert mgr.all_steps() == [3, 4, 5] and mgr.latest_step() == 5
    mgr2 = CheckpointManager(str(tmp_path / "ck2"), keep=2)
    for s in (1, 2, 3, 4):
        mgr2.save(s, state, blocking=False)
        mgr2.wait()
    assert mgr2.all_steps() == [3, 4]
    os.makedirs(tmp_path / "ck2" / "step_00000009")
    assert mgr2.latest_step() == 4
    _assert_bitwise(mgr.restore(5, state), state, "restored")


def test_checkpoints_cross_between_the_packages_in_f32(ref, tmp_path):
    """A float32 train state saved by the JAX manager restores in the
    port, and the port's save of it restores in the JAX manager, leaf for
    leaf bitwise; the manifests agree but for nothing."""
    jstate = jax.tree.map(jnp.asarray, ref["state"])
    JManager(str(tmp_path / "j")).save(7, jstate, blocking=True)
    st = _state_t(ref)
    got = CheckpointManager(str(tmp_path / "j")).restore(
        7, _smoke_state(ref["cfg_t"], seed=5))
    _assert_bitwise(got, st, "JAX file in the port")
    CheckpointManager(str(tmp_path / "t")).save(7, st, blocking=True)
    back = JManager(str(tmp_path / "t")).restore(7, jstate)
    for (n, a), (_, b) in zip(_flat(back), _flat(jstate)):
        assert a.dtype == b.dtype and np.array_equal(a, b), n
    man = lambda d: json.loads((tmp_path / d / "step_00000007" /
                                "manifest.json").read_text())
    assert man("j") == man("t")


def test_bf16_leaf_file_is_the_jax_managers(tmp_path):
    """A bf16 leaf (and a scalar) saved by the port: the .npy is byte for
    byte the JAX manager's file for the same values, the manifests are
    equal, and the port restores both files bitwise."""
    bits = np.random.default_rng(6).integers(0, 1 << 16, (3, 5, 7),
                                             dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0x3F80      # no NaN or inf payloads
    jtree = {"w": jnp.asarray(bits.view(jnp.bfloat16)),
             "step": jnp.asarray(3, jnp.int32)}
    ttree = {"w": torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16),
             "step": torch.tensor(3, dtype=torch.int32)}
    JManager(str(tmp_path / "j")).save(1, jtree, blocking=True)
    CheckpointManager(str(tmp_path / "t")).save(1, ttree, blocking=True)
    d = lambda s: tmp_path / s / "step_00000001"
    for f in ("w.npy", "step.npy", "manifest.json"):
        assert d("j").joinpath(f).read_bytes() == \
            d("t").joinpath(f).read_bytes(), f
    assert json.loads(d("t").joinpath("manifest.json").read_text())[
        "leaves"]["w"]["dtype"] == "bfloat16"
    for src in ("j", "t"):
        got = CheckpointManager(str(tmp_path / src)).restore(1, ttree)
        _assert_bitwise(got, ttree, src)


# --------------------------------------------------------------------------
# the driver
# --------------------------------------------------------------------------

def test_train_driver_resumes_bitwise(tmp_path):
    """repro_torch.launch.train.train on the CPU: 6 steps with a
    checkpoint every 3; a run stopped at step 3 and resumed by a fresh
    train() call ends bitwise where the uninterrupted run ends."""
    kw = dict(batch=BATCH, seq=SEQ, ckpt_every=3, lr=LR, device="cpu")
    full, hist, stats = train("smollm-360m-smoke", 6,
                              ckpt_dir=str(tmp_path / "a"), **kw)
    assert len(hist) == 6 and stats["retries"] == 0
    assert CheckpointManager(str(tmp_path / "a")).all_steps() == [3, 6]
    _, h1, _ = train("smollm-360m-smoke", 3, ckpt_dir=str(tmp_path / "b"),
                     **kw)
    resumed, h2, _ = train("smollm-360m-smoke", 6,
                           ckpt_dir=str(tmp_path / "b"), **kw)
    assert len(h1) == 3 and len(h2) == 3 and h1 + h2 == hist
    _assert_bitwise(resumed, full, "resumed run")
    _, h3, _ = train("smollm-360m-smoke", 2, audit_every=1,
                     inject_fault_at=1, **kw)
    assert len(h3) == 2 and all(np.isfinite(h3))


def test_prefill_and_serve_steps_wrap_the_model():
    _, cfg = _cfgs()
    params = _smoke_state(cfg)["params"]
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 5)))
    out = TS.make_prefill_step(cfg, 8)(params, {"tokens": toks})
    lg, rep, caches = TM.prefill(params, toks, cfg, 8)
    assert torch.equal(out["logits"], lg)
    nxt = torch.argmax(lg, dim=-1).to(torch.int32)
    srv = TS.make_serve_step(cfg)(params, {"tokens": nxt, "caches": caches,
                                          "positions": 5})
    lg2, _, _ = TM.decode_step(params, nxt, caches, 5, cfg)
    assert torch.equal(srv["logits"], lg2) and srv["positions"] == 6
    assert torch.equal(srv["next_tokens"],
                       torch.argmax(lg2, dim=-1).to(torch.int32))


# --------------------------------------------------------------------------
# registry bursts on a bf16 product (ROADMAP 3.5)
# --------------------------------------------------------------------------

def burst_study(n, k, m, dtype, trials, seed=0):
    """Registry `burst` faults on one (n x k) @ (k x m) product of
    `dtype`, through both packages' protect_matmul_output (default
    config) on the same operands and corrupted output. Per trial: (port
    verdict, JAX verdict, port |err| / scale, JAX |err| / scale), the
    error of the returned output against the clean product."""
    from repro.core import protected as JP
    from repro_torch.core import protected as TP
    model = tinj.FAULT_MODELS["burst"]
    gen = torch.Generator().manual_seed(seed)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    to_j = lambda x: jnp.asarray(x.float().numpy()).astype(jdt)
    out = []
    for _ in range(trials):
        d = torch.randn((n, k), generator=gen).to(dtype)
        w = (torch.randn((k, m), generator=gen) * k ** -0.5).to(dtype)
        o = TP.matmul_raw(d, w)
        bad = tinj.inject(o, model.plan(gen, n, m, 1, 100), model)
        ot, rt = TP.protect_matmul_output(d, w, bad, cfg=tcore.DEFAULT_CONFIG)
        oj, rj = JP.protect_matmul_output(to_j(d), to_j(w), to_j(bad),
                                          cfg=jcore.DEFAULT_CONFIG)
        clean, scale = o.double().numpy(), float(o.abs().max())
        err = lambda x: float(np.abs(np.asarray(x, np.float64) - clean)
                              .max()) / scale
        out.append((verdict(rt), verdict(rj), err(ot.float().numpy()),
                    err(jnp.asarray(oj, jnp.float32))))
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_burst_verdicts_match_jax(dtype):
    """The port's ladder gives the JAX package's verdict on every registry
    burst, bf16 included, where the reference's own thresholds miss some
    and accept wrong fixes (ROADMAP 3.5); in fp32 every burst is detected
    and corrected with residual 0."""
    rows = burst_study(256, 64, 128, dtype, 6)
    assert [r[0] for r in rows] == [r[1] for r in rows]
    if dtype == torch.float32:
        assert all(r[0][0] == 1 and r[0][2] == 0 for r in rows), rows


if __name__ == "__main__":
    # the study behind ROADMAP 3.5: python tests/test_torch_train.py
    # [--trials 16] [--shape 2048 320 960]
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=16)
    ap.add_argument("--shape", type=int, nargs=3, default=(2048, 320, 960))
    args = ap.parse_args()
    for dt in (torch.bfloat16, torch.float32):
        rows = burst_study(*args.shape, dt, args.trials)
        for r in rows:
            print(str(dt)[6:], *r)
        det = [r for r in rows if r[0][0] == 1 and r[0][2] == 0]
        print(f"{str(dt)[6:]} {tuple(args.shape)}: {len(rows) - len(det)} "
              f"of {len(rows)} missed or residual; {len(det)} detected with "
              f"residual 0, errors {min(r[2] for r in det):.3g}-"
              f"{max(r[2] for r in det):.3g} of the scale; verdicts equal "
              f"to JAX's in {sum(r[0] == r[1] for r in rows)}")
