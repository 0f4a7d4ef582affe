"""The port's ssm and rec block families on the (data, model) mesh, and
context-parallel decode (ProtectedSession(mesh=) with slots that do not
divide the data axes), on gloo meshes of CPU ranks, held to the JAX
package's unsharded sessions and train steps and to the port's own
unsharded paths.

mamba2-1.3b-smoke (in_proj's 296 columns: 148 a rank at model 2, 74 at
model 4, where they split inside the block's [z, x, B, C, dt] segments)
and recurrentgemma-2b-smoke (5 layers, the tied table scaled by 1/16 as
tests/test_torch_rglru.py scales it; wq shards at model 2 and replicates
at model 4 by head_ok, its one KV head replicates) run on (2, 2) and
(1, 4) meshes with 2 slots, and on a (1, 1) mesh, which is bitwise the
unsharded path. Context-parallel decode serves yi-9b-smoke and
recurrentgemma-2b-smoke with 1 slot on (2, 2) and 3 slots on (2, 1): each
data rank holds 12 of the 24 cache positions, and the prompts (up to 12
tokens, then 4-5 new ones) put the attention's window across the
boundary and leave a rank's block masked whole in some rows.

The JAX package's sharded programs do not run on this host (ROADMAP,
Ground rules: Reference state), and sharding does not change what a
program computes, so the tokens are the JAX package's unsharded
sessions' (the references of tests/test_torch_ssm.py,
tests/test_torch_rglru.py and tests/test_torch_distributed.py, read
through the same shared_reference names) and the sharded train step is
held to the JAX step of tests/test_torch_train_blocks.py, all in fp32.

Each mesh runs once per pytest run (launch.mesh.run_ranks, the rank
function tests/torch_mesh_ranks.py::recurrent_rank), and every xdist
worker reads its results (torch_parity.shared_reference)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as JCF  # noqa: E402
from repro.models import transformer as JM  # noqa: E402
import repro_torch.configs as TCF  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import transformer as TM  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from torch_parity import shared_reference, tree_np  # noqa: E402
import test_torch_distributed as TD  # noqa: E402
import test_torch_rglru as TRG  # noqa: E402
import test_torch_ssm as TSSM  # noqa: E402
import test_torch_train_blocks as TB  # noqa: E402
from test_torch_distributed import jax_ref  # noqa: E402,F401
import torch_mesh_ranks as R  # noqa: E402

MAMBA, RG, YI = ("mamba2-1.3b-smoke", "recurrentgemma-2b-smoke",
                 "yi-9b-smoke")
ARCHS = (MAMBA, RG)
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
CP_MESHES = {"2x2": (2, 2, 1), "2x1": (2, 1, 3)}      # (data, model, slots)
DRILL = {MAMBA: "stages/b0_ssm/ssm/in_proj",
         RG: "stages/b0_rec/rec/gate_a"}
MAX_LEN = 24
JOIN_S = 180
# the forward's logits, gathered, against the unsharded forward's
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def refs(tmp_path_factory, jax_ref):
    """Per arch the JAX package's params, the prompts and new-token count
    its unsharded session served and its tokens, read through the names
    the single-card test files build them under (once per pytest run),
    and for the two recurrent smokes the JAX train step's records."""
    out = {}
    cfg_j, cfg_t = JCF.get(MAMBA), TCF.get(MAMBA)
    pn = shared_reference(
        tmp_path_factory, "ssm_params",
        lambda: tree_np(JM.init_params(jax.random.PRNGKey(0), cfg_j)))
    model = (cfg_j, cfg_t, jax.tree.map(jnp.asarray, pn), None)
    out[MAMBA] = {"params": pn, "layers": None, "gen": TSSM.GEN,
                  "prompts": TSSM._prompts(cfg_t),
                  "tokens": shared_reference(
                      tmp_path_factory, "ssm_session",
                      lambda: TSSM._jax_session_tokens(model))}
    cfg_j, cfg_t = TRG._cfgs()
    pn = shared_reference(tmp_path_factory, "rglru_params",
                          lambda: TRG._jax_params(cfg_j))
    model = (cfg_j, cfg_t, jax.tree.map(jnp.asarray, pn), None)
    out[RG] = {"params": pn, "layers": TRG.LAYERS, "gen": TRG.GEN,
               "prompts": TRG._prompts(cfg_t),
               "tokens": shared_reference(
                   tmp_path_factory, "rglru_session",
                   lambda: TRG._jax_session_tokens(model))}
    out[YI] = {"params": jax_ref["params"], "layers": None, "gen": R.GEN,
               "prompts": TD._prompts(), "tokens": jax_ref["tokens"]}
    for arch in ARCHS:
        out[arch]["train"] = shared_reference(
            tmp_path_factory, f"train_blocks_{arch}",
            lambda: TB._build_reference(arch))
    return out


def _case(ref, arch, slots, **kw):
    return {"arch": arch, "layers": ref[arch]["layers"],
            "np_params": ref[arch]["params"], "prompts": ref[arch]["prompts"],
            "slots": slots, "max_len": MAX_LEN, "gen": ref[arch]["gen"],
            **kw}


def _train_case(ref, arch):
    tr = ref[arch]["train"]
    tk, lb = tr["batches"][0]
    return {"arch": arch, "state": tr["adamw"]["init"],
            "batch": {"tokens": tk, "labels": lb}, "lr": TB.LR,
            "microbatches": 2}


@pytest.fixture(scope="module")
def rec_meshes(refs, tmp_path_factory):
    """recurrent_rank's results on (2, 2) and (1, 4) (sessions, logits,
    drills and a train step of both recurrent smokes) and on (1, 1) (the
    sessions beside the unsharded ones), once per pytest run."""
    def build():
        out = {}
        for name, (d, m) in MESHES.items():
            out[name] = run_ranks(
                R.recurrent_rank, d * m, "gloo", JOIN_S,
                (d, m, "gloo", "cpu",
                 [_case(refs, a, 2, drill=DRILL[a], drill_row=a == RG)
                  for a in ARCHS], (),
                 [_train_case(refs, a) for a in ARCHS]))
        out["1x1"] = run_ranks(
            R.recurrent_rank, 1, "gloo", JOIN_S,
            (1, 1, "gloo", "cpu",
             [_case(refs, a, 2, unsharded=True) for a in ARCHS]))
        return out

    return shared_reference(tmp_path_factory, "distributed_recurrent",
                            build)


@pytest.fixture(scope="module")
def cp_meshes(refs, tmp_path_factory):
    """recurrent_rank's context-parallel cases (yi-9b-smoke and
    recurrentgemma-2b-smoke) on (2, 2) with 1 slot and on (2, 1) with 3,
    once per pytest run."""
    def build():
        return {name: run_ranks(
            R.recurrent_rank, d * m, "gloo", JOIN_S,
            (d, m, "gloo", "cpu", (),
             [_case(refs, a, slots) for a in (YI, RG)]))
            for name, (d, m, slots) in CP_MESHES.items()}

    return shared_reference(tmp_path_factory, "distributed_context_parallel",
                            build)


def _res(meshes, mesh_name, arch):
    return [r["cases"][ARCHS.index(arch)] for r in meshes[mesh_name]]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_recurrent_session_serves_the_jax_tokens(refs, rec_meshes,
                                                         mesh_name, arch):
    """Every rank's deferred session serves the JAX package's unsharded
    session's tokens, with no fault detected on the clean run."""
    want = [list(t) for t in refs[arch]["tokens"]]
    for res in _res(rec_meshes, mesh_name, arch):
        assert res["tokens"] == want
        assert res["counters"]["faults_detected"] == 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_recurrent_logits_match_unsharded(rec_meshes, mesh_name,
                                                  arch):
    """The forward's logits, gathered over the mesh, within rtol 1e-4 and
    atol 1e-5 of the port's unsharded forward's (the row-parallel partial
    sums and the gated norm's sum of squares over 'model' reassociate the
    fp32 sums)."""
    for res in _res(rec_meshes, mesh_name, arch):
        assert res["logits_gap"] <= ATOL + RTOL * res["logits_scale"], res


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_one_rank_mesh_is_bitwise_the_unsharded_path(
        refs, rec_meshes, arch):
    """A (1, 1) mesh: logits bitwise the unsharded forward's, the tokens
    the unsharded session's and the JAX package's, one read per
    forward."""
    (res,) = _res(rec_meshes, "1x1", arch)
    assert res["logits_gap"] == 0.0
    assert res["tokens"] == res["tokens_ref"]
    assert res["tokens"] == [list(t) for t in refs[arch]["tokens"]]
    assert res["reads_per_forward"] == 1.0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_recurrent_deferred_reads_once_per_forward_per_rank(
        rec_meshes, mesh_name, arch):
    for res in _res(rec_meshes, mesh_name, arch):
        assert res["reads_per_forward"] == 1.0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_recurrent_drill_on_one_rank_is_corrected_on_all(rec_meshes,
                                                         mesh_name, arch):
    """+1e3 at the last rank's shard of an ssm in_proj output (one
    element) or of a rec gate_a output (its whole local row: one
    element's change of a decay gate moves the smoke's logits by less than
    the localizer's tolerance at this step) in one decode step: every
    rank counts one detection and one
    correction, attributes it to the request in the faulty rank's slot
    and serves the clean tokens."""
    ranks = _res(rec_meshes, mesh_name, arch)
    slot = ranks[-1]["drill"]["slot"]
    for res in ranks:
        dr = res["drill"]
        assert dr["tokens"] == res["tokens"]
        c = dr["counters"]
        assert (c["faults_detected"], c["faults_corrected"]) == (1, 1), c
        assert c["faults_unattributed"] == 0 and c["residual_steps"] == 0
        want = [0] * len(res["tokens"])
        want[slot] = 1      # the first requests take the slots in order
        assert dr["per_request"] == want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_recurrent_train_step_matches_jax(refs, rec_meshes,
                                                  mesh_name, arch):
    """One sharded AdamW step (2 microbatches) from the JAX package's
    train state against its unsharded step (test_torch_train_blocks'
    reference): a clean report, the loss within rtol 1e-5, the new
    params, gathered, within that file's tolerances, the replicated
    A_log, D, dt_bias and norm leaves included; every replicated leaf
    bitwise the same on every rank."""
    want = refs[arch]["train"]["adamw"][2][:1]
    ranks = rec_meshes[mesh_name]
    for r in ranks:
        tr = r["train"][ARCHS.index(arch)]
        assert tr["report"] == [0, 0, 0]
        np.testing.assert_allclose(tr["loss"], want[0]["loss"], rtol=1e-5)
        TB._close_params(tr["params"], want[0]["state"]["params"], want,
                         f"{arch} {mesh_name}")
        assert tr["replicated_digest"] == \
            ranks[0]["train"][ARCHS.index(arch)]["replicated_digest"]
    if arch == MAMBA:
        digest = ranks[0]["train"][0]["replicated_digest"]
        for leaf in ("A_log", "D", "dt_bias", "norm"):
            assert f"stages/b0_ssm/ssm/{leaf}" in digest


def _cp(cp_meshes, mesh_name, arch):
    return [r["cp"][(YI, RG).index(arch)] for r in cp_meshes[mesh_name]]


@pytest.mark.parametrize("arch", (YI, RG))
@pytest.mark.parametrize("mesh_name", sorted(CP_MESHES))
def test_context_parallel_session_serves_the_jax_tokens(refs, cp_meshes,
                                                        mesh_name, arch):
    """Slots that do not divide the data axes: every rank serves the JAX
    package's unsharded session's tokens, one read per forward, no fault
    detected."""
    want = [list(t) for t in refs[arch]["tokens"]]
    for res in _cp(cp_meshes, mesh_name, arch):
        assert res["tokens"] == want
        assert res["reads_per_forward"] == 1.0
        assert res["counters"]["faults_detected"] == 0


@pytest.mark.parametrize("arch", (YI, RG))
@pytest.mark.parametrize("mesh_name", sorted(CP_MESHES))
def test_context_parallel_caches_hold_their_block(cp_meshes, mesh_name,
                                                  arch):
    """Each data rank's session caches hold every slot and its L/D block
    of each KV cache's sequence (12 of 24); the rec states hold every
    slot."""
    d, m, slots = CP_MESHES[mesh_name]
    for res in _cp(cp_meshes, mesh_name, arch):
        # (slots, ...) behind a stage's leading repeats axis
        shapes = {p: s[1:] if p.startswith("stages/") else s
                  for p, s in res["cache_shapes"].items()}
        kv = [s for p, s in shapes.items() if p.endswith(("/k", "/v"))]
        assert kv
        for s in kv:
            assert s[:2] == [slots, MAX_LEN // d], shapes
        for p, s in shapes.items():
            if p.endswith(("/h", "/conv")):
                assert s[0] == slots, (p, s)


@pytest.mark.parametrize("arch", (YI, RG))
@pytest.mark.parametrize("mesh_name", sorted(CP_MESHES))
def test_context_parallel_logits_are_finite_and_match(cp_meshes, mesh_name,
                                                      arch):
    """A context-parallel prefill and decode steps of the first prompt,
    whose window crosses the ranks' boundary and leaves one rank's block
    masked whole in the early rows: every logit finite, within rtol 1e-4
    and atol 1e-5 of the unsharded ones (the softmax merged over 'data'
    reassociates its fp32 sums)."""
    for res in _cp(cp_meshes, mesh_name, arch):
        assert res["cp_finite"]
        assert res["cp_logits_gap"] <= ATOL + RTOL * res["cp_scale"], res


@pytest.mark.parametrize("arch", ARCHS + (YI,))
def test_mesh_support_admits_ssm_and_rec(arch):
    """check_mesh_support admits the attention, ffn, ssm and rec
    families, and make_train_step(mesh_axes=) builds for them."""
    cfg = TCF.get(arch)
    TM.check_mesh_support(cfg)
    assert callable(TS.make_train_step(cfg, OptConfig(),
                                       mesh_axes=("data", "model")))


@pytest.mark.parametrize("arch", ("kimi-k2-1t-a32b-smoke",
                                  "llama4-maverick-400b-a17b-smoke",
                                  "musicgen-large-smoke"))
def test_mesh_support_refuses_moe_and_codebooks(arch):
    """The moe family and multi-codebook models under a mesh still raise,
    naming ROADMAP item 1.12."""
    with pytest.raises(NotImplementedError, match="1.12"):
        TM.check_mesh_support(TCF.get(arch))
