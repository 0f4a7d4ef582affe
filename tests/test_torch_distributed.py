"""The port's sharded serving and training (ProtectedSession(mesh=) and
make_train_step(mesh_axes=)) on gloo meshes of CPU ranks, held to the JAX
package and to the port's own unsharded paths.

yi-9b-smoke in float32 (16 query heads on 2 KV heads of 16, d_ff 96, an
untied 512 head) runs on a (2, 2) mesh, where every projection shards, and
on a (1, 4) mesh, where wq shards and wk/wv replicate (2 KV heads on 4
ranks: each rank attends with the KV head its 4 query heads use). The
JAX package's sharded programs do not run on this host (ROADMAP, Ground
rules: Reference state); sharding does not change what a program
computes, so the sharded paths are held to the JAX package's unsharded
functions on the same params and inputs: the served tokens to a
steady_jax_session's, the train step to make_train_step's, in fp32 within
the tolerances stated per test. A (1, 1) mesh is bitwise the unsharded
path.

Each mesh runs once per pytest run (launch.mesh.run_ranks over a
FileStore, 120 s join limit, one thread per rank; the rank function is
tests/torch_mesh_ranks.py::session_rank), and every xdist worker reads
its results (torch_parity.shared_reference)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as JCF  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JM  # noqa: E402
from repro.optim import OptConfig as JOpt  # noqa: E402
from repro_torch._tree import tree_flatten_with_path  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from torch_parity import (shared_reference, steady_jax_session,  # noqa: E402
                          tree_np)
import torch_mesh_ranks as R  # noqa: E402

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
LR = 1e-3
BATCH, SEQ = 8, 16
PROMPT_LENS = (5, 8, 6, 11, 4, 9)
JOIN_S = 120


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 512, n) for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's yi-9b-smoke params, the tokens its session
    serves on the prompts, and one unsharded AdamW step
    (microbatches 2, warmup 0) from its train state on a numpy batch;
    once per pytest run."""
    def build():
        cfg = JCF.get(R.ARCH)
        params = JM.init_params(jax.random.PRNGKey(0), cfg)
        # unprotected: a clean protected session serves the same tokens,
        # and its programs compile in a fraction of the time
        sess = steady_jax_session(params, cfg.replace(abft=False),
                                  slots=R.SLOTS, max_len=R.MAX_LEN)
        rids = [sess.submit(p, R.GEN) for p in _prompts()]
        sess.run()
        tokens = [sess.tokens_for(r) for r in rids]
        opt = JOpt(lr=LR)
        state = JS.init_train_state(jax.random.PRNGKey(0), cfg, opt)
        rng = np.random.default_rng(2)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)),
                 "labels": rng.integers(0, cfg.vocab_size, (BATCH, SEQ))}
        step = jax.jit(JS.make_train_step(cfg.replace(abft=False), opt,
                                          microbatches=2, warmup=0))
        new, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        return {"params": tree_np(params), "tokens": tokens,
                "state": tree_np(state), "batch": batch,
                "new_params": tree_np(new["params"]),
                "m": tree_np(new["opt"]["m"]), "loss": float(m["loss"])}

    return shared_reference(tmp_path_factory, "distributed_jax_ref", build)


@pytest.fixture(scope="module")
def meshes(jax_ref, tmp_path_factory):
    """session_rank's results from every rank of the (2, 2), (1, 4) and
    (1, 1) gloo meshes, once per pytest run."""
    def build():
        train_in = (jax_ref["state"], jax_ref["batch"], LR)
        out = {}
        for name, (d, m) in MESHES.items():
            out[name] = run_ranks(
                R.session_rank, d * m, "gloo", JOIN_S,
                (d, m, "gloo", "cpu", jax_ref["params"], _prompts(),
                 train_in))
        out["1x1"] = run_ranks(
            R.session_rank, 1, "gloo", JOIN_S,
            (1, 1, "gloo", "cpu", jax_ref["params"], _prompts(), None,
             None, True, False))
        return out

    return shared_reference(tmp_path_factory, "distributed_meshes", build)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_session_serves_the_jax_tokens(jax_ref, meshes, mesh_name):
    """Every rank's deferred session serves the JAX package's tokens,
    which the port's unsharded session serves too (on the (1, 1) run); no
    fault is detected on the clean run."""
    want = [list(t) for t in jax_ref["tokens"]]
    assert meshes["1x1"][0]["tokens_ref"] == want
    for res in meshes[mesh_name]:
        assert res["tokens"] == want
        assert res["faults_clean"] == 0


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_logits_match_unsharded(meshes, mesh_name):
    """The forward's logits, gathered over the mesh, against the port's
    unsharded forward: the row-parallel partial sums reassociate the fp32
    contraction, so within atol 1e-5 of the logits' scale."""
    for res in meshes[mesh_name]:
        assert res["logits_gap"] <= 1e-5 * (1.0 + res["logits_scale"]), res


def test_one_rank_mesh_is_bitwise_the_unsharded_path(meshes):
    """A (1, 1) mesh runs every collective as a no-op: logits bitwise,
    tokens equal, one read per forward."""
    (res,) = meshes["1x1"]
    assert res["logits_gap"] == 0.0
    assert res["tokens"] == res["tokens_ref"]
    assert res["reads_per_forward"] == 1.0


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_deferred_reads_once_per_forward_per_rank(meshes, mesh_name):
    """The deferred workflow's one read per forward on every rank (its
    flags max-reduced over the world inside that read)."""
    for res in meshes[mesh_name]:
        assert res["reads_per_forward"] == 1.0


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_drill_on_one_rank_is_corrected_on_all(meshes, mesh_name):
    """+1e3 at the last rank's row-parallel wo partial in one decode step:
    every rank counts one detection and one correction, attributes it to
    the request in the faulty rank's slot, and serves the clean tokens."""
    ranks = meshes[mesh_name]
    slot = ranks[-1]["drill"]["slot"]
    for res in ranks:
        dr = res["drill"]
        assert dr["tokens"] == res["tokens"]
        c = dr["counters"]
        assert (c["faults_detected"], c["faults_corrected"]) == (1, 1), c
        assert c["faults_unattributed"] == 0 and c["residual_steps"] == 0
        want = [0] * len(PROMPT_LENS)
        want[slot] = 1     # the first SLOTS requests take slots in order
        assert dr["per_request"] == want


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_audit_repairs_in_place_on_its_rank(meshes, mesh_name):
    """One element of rank 0's shard of a wq, damaged before the first
    step: rank 0's audit repairs it in place from its own locator sums
    (bitwise), no other rank repairs or restores, and every rank serves
    the clean tokens."""
    for rank, res in enumerate(meshes[mesh_name]):
        au = res["audit"]
        assert au["restored_bitwise"]
        assert au["tokens"] == res["tokens"]
        c = au["counters"]
        assert c["weight_repairs"] == (1 if rank == 0 else 0), (rank, c)
        assert c["weight_restores"] == 0


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_train_step_matches_jax(jax_ref, meshes, mesh_name):
    """One sharded AdamW step (2 microbatches, remat on) from the JAX
    package's train state against its unsharded make_train_step: the loss
    within rtol 1e-5; the new params, gathered, within rtol 1e-4 (atol
    1e-4 lr) where the first moment is above 1e-3 of its leaf's max and
    within 2 lr elsewhere (a near-zero gradient's sign may flip); every
    replicated leaf bitwise the same on every rank."""
    ranks = meshes[mesh_name]
    want = jax_ref["new_params"]
    mom = dict(tree_flatten_with_path(jax_ref["m"]))
    for res in ranks:
        tr = res["train"]
        np.testing.assert_allclose(tr["loss"], jax_ref["loss"], rtol=1e-5)
        for n, wp in tree_flatten_with_path(want):
            got = tr["params"][n]
            g = np.abs(mom[n])
            big = g > 1e-3 * g.max()
            np.testing.assert_allclose(got[big], wp[big], rtol=1e-4,
                                       atol=1e-4 * LR, err_msg=n)
            assert np.abs(got - wp).max() <= 2 * LR * (1 + 1e-5), n
        assert tr["replicated_digest"] == ranks[0]["train"][
            "replicated_digest"]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_train_drill_is_corrected(jax_ref, meshes, mesh_name):
    """The same sharded step with +1e3 at the last rank's shard of the
    first repeat's ffn/up output, in the forward and in remat's
    recompute: every rank's world-reduced verdict is detected, corrected,
    no residual; the loss equals the clean sharded step's within rtol
    1e-5, and the new params, gathered, equal the clean sharded step's
    within the tolerances that hold that step to the JAX step (a fixed
    element keeps an fp32 residue of the fix)."""
    ranks = meshes[mesh_name]
    mom = dict(tree_flatten_with_path(jax_ref["m"]))
    for res in ranks:
        tr = res["train"]
        dr = tr["drill"]
        det, by, resid = dr["report"]
        assert det == 1 and by != 0 and resid == 0, dr["report"]
        np.testing.assert_allclose(dr["loss"], tr["loss"], rtol=1e-5)
        for n, clean in tr["params"].items():
            got = dr["params"][n]
            g = np.abs(mom[n])
            big = g > 1e-3 * g.max()
            np.testing.assert_allclose(got[big], clean[big], rtol=1e-4,
                                       atol=1e-4 * LR, err_msg=n)
            assert np.abs(got - clean).max() <= 2 * LR * (1 + 1e-5), n
