"""The port's optimizer, data pipeline and straggler monitor
(repro_torch.optim.adamw, data.pipeline, runtime.straggler) against the
JAX package's, on numpy-made trees.

Optimizer values agree to fp32 reassociation: rtol 1e-6, with an atol of
1e-6 of each leaf's scale for elements near zero. The pipeline's stream
is the port's own (torch generators, not jax.random), so it is held to
the reference's contracts: determinism, host-disjoint shards, the shifted
labels and the repeated-token structure."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.runtime import straggler as jstrag  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch._tree import tree_flatten_with_path  # noqa: E402
from repro_torch.data import DataConfig, DataIterator, host_batch  # noqa: E402
from repro_torch.runtime.straggler import (StragglerMonitor,  # noqa: E402
                                           StragglerPolicy)
from torch_parity import assert_close, normal, to_np  # noqa: E402

# a stacked stage weight (factored by Adafactor), a matrix, a vector and a
# matrix below Adafactor's factoring size
SHAPES = {"stages": {"w": (2, 160, 136), "norm": (136,)},
          "head": {"w": (136, 144)}, "small": (4, 8)}


def _np_tree(seed, scale=1.0):
    out, i = {}, 0
    for k, v in SHAPES.items():
        if isinstance(v, dict):
            out[k] = {}
            for kk, shape in v.items():
                out[k][kk] = normal(seed + i, shape, scale)
                i += 1
        else:
            out[k] = normal(seed + i, v, scale)
            i += 1
    return out


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} \
        if isinstance(tree, dict) else fn(tree)


def _assert_trees(a, b, rtol=1e-6, what=""):
    fa, fb = tree_flatten_with_path(_map(to_np, a)), \
        tree_flatten_with_path(_map(to_np, b))
    assert [n for n, _ in fa] == [n for n, _ in fb], what
    for (n, x), (_, y) in zip(fa, fb):
        scale = float(np.abs(np.asarray(y, np.float64)).max()) or 1.0
        assert_close(x, y, rtol, rtol * scale, f"{what} {n}")


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_apply_updates_matches_jax(kind):
    """Three steps of clip + schedule + update from the same trees: params
    and optimizer state agree with the JAX package's at every step."""
    cfg_j = jopt.OptConfig(kind=kind, lr=1e-2)
    cfg_t = topt.OptConfig(kind=kind, lr=1e-2)
    p_np = _np_tree(0, 0.1)
    pj = _map(jnp.asarray, p_np)
    pt = _map(torch.as_tensor, p_np)
    sj, st = jopt.init_opt_state(pj, cfg_j), topt.init_opt_state(pt, cfg_t)
    _assert_trees(st, sj, what="init")
    lr_j = jopt.cosine_schedule(cfg_j.lr, 1, 10)
    lr_t = topt.cosine_schedule(cfg_t.lr, 1, 10)
    for i in range(3):
        g_np = _np_tree(100 + 10 * i)
        gj, gnj = jopt.clip_by_global_norm(_map(jnp.asarray, g_np), 1.0)
        gt, gnt = topt.clip_by_global_norm(_map(torch.as_tensor, g_np), 1.0)
        assert_close(gnt, gnj, 1e-6, 0.0, "gnorm")
        pj, sj = jopt.apply_updates(pj, gj, sj, cfg_j, lr_j(sj["step"]))
        pt, st = topt.apply_updates(pt, gt, st, cfg_t, lr_t(st["step"]))
        _assert_trees(pt, pj, what=f"step {i} params")
        _assert_trees(st, sj, what=f"step {i} state")


@pytest.mark.parametrize("max_norm", [1.0, 1e4])
def test_global_norm_and_clip_match_jax(max_norm):
    g_np = _np_tree(7)
    gj, nj = jopt.clip_by_global_norm(_map(jnp.asarray, g_np), max_norm)
    gt, nt = topt.clip_by_global_norm(_map(torch.as_tensor, g_np), max_norm)
    assert_close(nt, nj, 1e-6, 0.0, "clip's norm")
    assert_close(topt.global_norm(_map(torch.as_tensor, g_np)),
                 jopt.global_norm(_map(jnp.asarray, g_np)), 1e-6, 0.0,
                 "global_norm")
    _assert_trees(gt, gj, what="clipped grads")
    assert all(v.dtype == torch.float32
               for _, v in tree_flatten_with_path(gt))


@pytest.mark.parametrize("warmup,total", [(0, 10), (1, 12), (10, 100)])
def test_cosine_schedule_matches_jax(warmup, total):
    fj = jopt.cosine_schedule(3e-4, warmup, total)
    ft = topt.cosine_schedule(3e-4, warmup, total)
    # near the end of the cosine 1 + cos(pi * prog) cancels, so the atol
    # is 1e-6 of the base lr, as for the trees' near-zero elements
    for s in range(0, total + 3):
        assert_close(ft(torch.tensor(s, dtype=torch.int32)),
                     fj(jnp.asarray(s, jnp.int32)), 1e-6, 1e-6 * 3e-4,
                     f"step {s}")


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_apply_updates_leaves_its_arguments_alone(kind):
    """Functional: the old params, grads and state are unchanged, so a
    failed step can be recomputed from them."""
    cfg = topt.OptConfig(kind=kind)
    p = _map(torch.as_tensor, _np_tree(1))
    g = _map(torch.as_tensor, _np_tree(2))
    s = topt.init_opt_state(p, cfg)
    p1, s1 = topt.apply_updates(p, g, s, cfg, 1e-2)
    before = [(n, v.clone()) for n, v in tree_flatten_with_path(
        {"p": p, "g": g, "s": s})]
    topt.apply_updates(p1, g, s1, cfg, 1e-2)
    topt.apply_updates(p, g, s, cfg, 1e-2)
    after = dict(tree_flatten_with_path({"p": p, "g": g, "s": s}))
    for n, v in before:
        assert torch.equal(after[n], v), n
    assert int(s1["step"]) == 1 and int(s["step"]) == 0


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_reduces_quadratic(kind):
    """Twin of tests/test_runtime.py::test_optimizer_reduces_quadratic."""
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    cfg = topt.OptConfig(kind=kind, lr=0.1, weight_decay=0.0)
    state = topt.init_opt_state(params, cfg)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        grads, _ = topt.clip_by_global_norm(grads, 10.0)
        params, state = topt.apply_updates(params, grads, state, cfg,
                                           torch.tensor(0.05))
    assert float(torch.sum(params["w"] ** 2)) < 0.5


def test_adafactor_state_is_factored():
    params = {"big": torch.zeros((256, 512)), "small": torch.zeros((4, 8)),
              "stack": torch.zeros((3, 128, 256))}
    st = topt.init_opt_state(params, topt.OptConfig(kind="adafactor"))
    assert set(st["v"]["big"]) == {"r", "c"}
    assert st["v"]["big"]["r"].shape == (256,)
    assert st["v"]["big"]["c"].shape == (512,)
    assert set(st["v"]["small"]) == {"v"}
    assert st["v"]["stack"]["r"].shape == (3, 128)
    assert st["v"]["stack"]["c"].shape == (3, 256)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_state_dtype(state_dtype):
    cfg = topt.OptConfig(state_dtype=state_dtype)
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    st = topt.init_opt_state(p, cfg)
    p1, st1 = topt.apply_updates(p, {"w": torch.ones((4, 4))}, st, cfg, 1e-3)
    assert p1["w"].dtype == torch.bfloat16
    assert st1["m"]["w"].dtype == getattr(torch, state_dtype)
    assert st1["step"].dtype == torch.int32


def test_data_deterministic_and_host_disjoint():
    """Twin of tests/test_runtime.py::test_data_deterministic_and_host_
    disjoint."""
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=8)
    t1, l1 = host_batch(cfg, 5)
    t2, l2 = host_batch(cfg, 5)
    assert torch.equal(t1, t2) and torch.equal(l1, l2)
    assert t1.dtype == torch.int32 and t1.shape == (8, 16)
    # labels are the shifted stream
    assert torch.equal(t1[:, 1:], l1[:, :-1])
    # two hosts see disjoint example indices covering the global batch
    a, _ = host_batch(cfg, 5, host_id=0, num_hosts=2)
    b, _ = host_batch(cfg, 5, host_id=1, num_hosts=2)
    assert a.shape[0] == 4 and b.shape[0] == 4
    assert not torch.equal(a, b)
    assert torch.equal(t1, torch.cat([a, b]))
    # another step or seed is another batch
    assert not torch.equal(t1, host_batch(cfg, 6)[0])
    assert not torch.equal(
        t1, host_batch(DataConfig(100, 16, 8, seed=1), 5)[0])


def test_data_structure():
    """Every odd position repeats its predecessor as (x * 31 + 7) % V (the
    learnable structure); the codebook variant stacks K streams."""
    cfg = DataConfig(vocab_size=97, seq_len=32, global_batch=3)
    tok, lab = host_batch(cfg, 2)
    ex = torch.cat([tok, lab[:, -1:]], dim=1).long()
    assert torch.equal(ex[:, 1::2], (ex[:, 0:-1:2] * 31 + 7) % 97)
    assert int(ex.min()) >= 0 and int(ex.max()) < 97
    cb = DataConfig(vocab_size=97, seq_len=8, global_batch=2,
                    num_codebooks=4)
    t, l = host_batch(cb, 0)
    assert t.shape == (2, 8, 4) and l.shape == (2, 8, 4)
    assert torch.equal(t[:, 1:], l[:, :-1])


def test_data_iterator_restarts_where_it_left():
    cfg = DataConfig(vocab_size=50, seq_len=8, global_batch=2)
    it = DataIterator(cfg)
    seen = [next(it) for _ in range(4)]
    again = next(DataIterator(cfg, start_step=2))
    assert torch.equal(again[0], seen[2][0])
    assert torch.equal(again[0], host_batch(cfg, 2)[0])


def test_straggler_monitor_flags_slow_host():
    """Twin of tests/test_runtime.py::test_straggler_monitor_flags_slow_
    host, beside the JAX monitor on the same timings."""
    mons = [StragglerMonitor(StragglerPolicy(min_samples=4)),
            jstrag.StragglerMonitor(jstrag.StragglerPolicy(min_samples=4))]
    for mon in mons:
        assert mon.deadline() == float("inf") and mon.check_hosts() == []
        for _ in range(10):
            mon.record(1.0, host_id=0)
            mon.record(1.05, host_id=1)
            mon.record(3.5, host_id=2)   # straggler
    assert mons[0].check_hosts() == mons[1].check_hosts() == [2]
    assert mons[0].deadline() == mons[1].deadline() > 3.0
    mons[0].start_step()
    assert mons[0].end_step(host_id=0) >= 0.0
