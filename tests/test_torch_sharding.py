"""The port's sharding rules and their execution (repro_torch.runtime
.sharding, ProtectionPlan.shard, optim.allreduce_compressed) against the
JAX package's.

The spec functions are held to the JAX rule functions leaf for leaf, for
every arch smoke, on (2, 2) and (1, 4) meshes: the JAX side runs in a
subprocess with 4 emulated host devices (conftest strips XLA_FLAGS, so an
in-process mesh has one device) and computes NamedShardings only; the
port's rules take a launch.mesh.AbstractMesh. The one stated difference:
a stacked (stage) checksum entry, which the JAX package replicates to get
round its partitioner, is sliced per repeat in the port, whose local GEMMs
need local checksums.

ProtectionPlan.shard and allreduce_compressed run on gloo meshes of 4 CPU
ranks (launch.mesh.run_ranks; the rank functions in
tests/torch_mesh_ranks.py), once per pytest run (shared_reference)."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro_torch.configs as TCF  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.optim.compression import allreduce_compressed as jax_arc  # noqa: E402
from repro_torch.configs.archs import ARCH_BUILDERS  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, run_ranks  # noqa: E402
from repro_torch.models import transformer as TM  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402
from torch_parity import shared_reference  # noqa: E402
import torch_mesh_ranks as R  # noqa: E402

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
ARCHS = sorted(ARCH_BUILDERS)
CACHE_BATCHES = (4, 1)
JOIN_S = 120

_SPEC_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import sys
    sys.path.insert(0, %r)
    import json
    import jax
    import repro.configs as C
    import repro.core as ft
    from repro.models import transformer as M
    from repro.runtime import sharding as SH

    def spec(s):
        return [list(x) if isinstance(x, tuple) else x for x in s.spec]

    def flat(tree):
        return {SH._path_str(p): spec(s)
                for p, s in jax.tree_util.tree_flatten_with_path(tree)[0]}

    res = {}
    meshes = {n: jax.make_mesh(s, ("data", "model"))
              for n, s in %r.items()}
    for arch in %r:
        cfg = C.get(arch + "-smoke")
        params = M.init_params(jax.random.PRNGKey(0), cfg)
        caches = jax.eval_shape(lambda: M.init_caches(cfg, 4, 16))
        plan = ft.build_plan(params, cfg, batch=4, seq=16)
        for mn, mesh in meshes.items():
            r = res.setdefault(arch, {}).setdefault(mn, {})
            for var, kw in (("none", {}), ("cfg", {"cfg": cfg}),
                            ("dp_only", {"cfg": cfg, "dp_only": True}),
                            ("fsdp", {"cfg": cfg, "fsdp": True})):
                r["params/" + var] = flat(
                    SH.param_shardings(params, mesh, **kw))
            for b in %r:
                r["caches/%%d" %% b] = flat(
                    SH.cache_shardings(caches, mesh, b))
            for var, c in (("none", None), ("cfg", cfg)):
                r["checksums/" + var] = {
                    n: [spec(a), spec(b)] for n, (a, b) in
                    SH.checksum_shardings(plan, mesh, cfg=c).items()}
    print(json.dumps(res))
""")


def _jax_specs():
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    script = _SPEC_SCRIPT % (src, MESHES, ARCHS, CACHE_BATCHES)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return {"json": out.stdout.strip().splitlines()[-1]}


@pytest.fixture(scope="module")
def jax_specs(tmp_path_factory):
    """{arch: {mesh: {what: {path: spec}}}} from the JAX package's rule
    functions, once per pytest run."""
    ref = shared_reference(tmp_path_factory, "sharding_jax_specs",
                           _jax_specs)
    return json.loads(ref["json"])


def _norm(spec):
    """A spec as JSON gives it back: lists for tuples of axis names."""
    return [list(x) if isinstance(x, tuple) else x for x in spec]


def _port_specs(arch, mesh_name):
    cfg = TCF.get(arch + "-smoke")
    mesh = AbstractMesh(MESHES[mesh_name], ("data", "model"))
    params = TM.init_params(cfg, device="cpu")
    caches = TM.init_caches(cfg, 4, 16, device="meta")
    plan = tcore.build_plan(params, cfg, batch=4, seq=16, device="cpu")
    r = {}
    for var, kw in (("none", {}), ("cfg", {"cfg": cfg}),
                    ("dp_only", {"cfg": cfg, "dp_only": True}),
                    ("fsdp", {"cfg": cfg, "fsdp": True})):
        r["params/" + var] = {p: _norm(s) for p, s in SH.flat_specs(
            SH.param_shardings(params, mesh, **kw)).items()}
    for b in CACHE_BATCHES:
        r[f"caches/{b}"] = {p: _norm(s) for p, s in SH.flat_specs(
            SH.cache_shardings(caches, mesh, b)).items()}
    for var, c in (("none", None), ("cfg", cfg)):
        r["checksums/" + var] = {
            n: [_norm(a), _norm(b)]
            for n, (a, b) in SH.checksum_shardings(plan, mesh, c).items()}
    return r, plan


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax_rules(jax_specs, arch, mesh_name):
    """param_shardings (plain, head-aware, dp_only, fsdp), cache_shardings
    (a batch that divides the data axis and one that does not) and
    checksum_shardings (with and without cfg) equal the JAX package's leaf
    for leaf; a stacked checksum entry is the stated difference: the JAX
    side replicates it, the port keeps the repeats axis replicated and
    shards the rest as a plain entry's."""
    got, plan = _port_specs(arch, mesh_name)
    mesh = AbstractMesh(MESHES[mesh_name], ("data", "model"))
    want = jax_specs[arch][mesh_name]
    assert sorted(got) == sorted(want)
    stacked_seen = 0
    for what in sorted(want):
        g, w = got[what], want[what]
        assert sorted(g) == sorted(w), what
        if not what.startswith("checksums/"):
            for path in w:
                assert g[path] == w[path], (what, path)
            continue
        for name in w:
            e = plan.entries[name]
            if e.stack:
                stacked_seen += 1
                assert w[name] == [[], []], (what, name)
                if g[name] == [[], []]:      # head_ok replicates it
                    continue
                # the port's: the plain entry's rule behind the repeats
                # axis, on the (M/chunk, K) slice of one repeat
                ws = list(SH.spec_for_param(name + "/w", 2, mesh))
                ws += [None] * (2 - len(ws))
                one = SH._legalize((ws[1], ws[0]),
                                   tuple(e.wck.cw1.shape[1:]), mesh)
                assert g[name] == [_norm((None,) + one)] * 2, (what, name)
            else:
                assert g[name] == w[name], (what, name)
    if any(e.stack and e.wck is not None and e.op.kind == "matmul"
           and e.w_view is None for e in plan.entries.values()):
        assert stacked_seen


def test_stacked_checksum_specs_slice_per_repeat():
    """The stated difference, spelled out on yi-9b-smoke at model 2: a
    stage entry's (reps, M/chunk, K) checksums carry (None, model, None)
    for a column-sharded weight and (None, None, model) for a row-sharded
    one; a 1-chunk (wk, wv) entry cannot split its chunk axis and
    replicates (ProtectionPlan.shard encodes it from the local shard)."""
    cfg = TCF.get("yi-9b-smoke")
    plan = tcore.build_plan(TM.init_params(cfg, device="cpu"), cfg, batch=4,
                            seq=16, device="cpu")
    specs = SH.checksum_shardings(plan, AbstractMesh((1, 2),
                                                     ("data", "model")), cfg)
    assert specs["stages/b0_attn_full/attn/wq"][0] == (None, "model", None)
    assert specs["stages/b0_attn_full/attn/wo"][0] == (None, None, "model")
    assert specs["stages/b1_ffn/ffn/down"][0] == (None, None, "model")
    assert specs["stages/b0_attn_full/attn/wk"][0] == (None, None, None)
    assert specs["embed/head"][0] == ("model", None)


# --------------------------------------------------------------------------
# ProtectionPlan.shard and allreduce_compressed on 4 gloo ranks
# --------------------------------------------------------------------------

COMPRESS_SHAPE = (4, 6, 5)


def _compress_inputs():
    g = np.random.default_rng(0).standard_normal(COMPRESS_SHAPE)
    e = np.random.default_rng(1).standard_normal(COMPRESS_SHAPE) * 0.01
    return g.astype(np.float32), e.astype(np.float32)


@pytest.fixture(scope="module")
def sharded_plans(tmp_path_factory):
    """plan_shard_rank's results on the (2, 2) and (1, 4) meshes (the
    latter also reduces _compress_inputs()), once per pytest run."""
    def build():
        return {name: run_ranks(R.plan_shard_rank, 4, "gloo", JOIN_S,
                                (d, m, _compress_inputs() if d == 1
                                 else None))
                for name, (d, m) in MESHES.items()}
    return shared_reference(tmp_path_factory, "sharding_plan_shard", build)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_plan_shard_matches_local_encodes(sharded_plans, mesh_name):
    """Every rank's sliced or re-encoded checksums and locator sums equal
    those encoded from its own shard (bitwise), entries that straddle a
    shard boundary are encoded (wk/wv at model 2: 32 columns in one chunk;
    ffn gate/up at model 4: 96 columns in chunks of 48), the rest are
    sliced or kept whole, and meta records the mesh."""
    d, m = MESHES[mesh_name]
    for rank, res in enumerate(sharded_plans[mesh_name]):
        how = {row["name"]: row["how"] for row in res["rows"]}
        for row in res["rows"]:
            assert row["gap_ck"] == 0.0 and row["gap_lc"] == 0.0, row
            assert row["wlc_cb"] == row["cb"], row
        if m == 2:
            assert how["stages/b0_attn_full/attn/wk"] == "encoded"
            assert how["stages/b1_ffn/ffn/gate"] == "sliced"
        else:
            assert how["stages/b0_attn_full/attn/wk"] == "replicated"
            assert how["stages/b1_ffn/ffn/gate"] == "encoded"
        assert how["stages/b0_attn_full/attn/wo"] == "sliced"
        assert how["embed/head"] == "sliced"
        assert res["meta"]["shape"] == {"data": d, "model": m}
        assert res["meta"]["coords"] == {"data": rank // m,
                                         "model": rank % m}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_plan_shard_refuses_a_stale_shard(sharded_plans, mesh_name):
    """A shard that no longer sums, with its peers, to the leaf the plan
    fingerprinted is refused (PlanStaleError) on every rank of its model
    group; the other group's shards still match."""
    d, m = MESHES[mesh_name]
    stale = [res["stale"] for res in sharded_plans[mesh_name]]
    last_group = (len(stale) - 1) // m
    assert stale == [r // m == last_group for r in range(len(stale))]


def test_allreduce_compressed_matches_jax(sharded_plans):
    """allreduce_compressed over 4 gloo ranks equals the JAX function
    under jax.vmap(axis_name=) over the same 4 shards: the reduced
    gradient and every rank's new error-feedback residual."""
    g, e = _compress_inputs()
    red, err = jax.vmap(lambda a, b: jax_arc(a, b, "i"), axis_name="i")(
        jnp.asarray(g), jnp.asarray(e))
    for rank, res in enumerate(sharded_plans["1x4"]):
        got_red, got_err = res["compressed"]
        np.testing.assert_allclose(got_red, np.asarray(red)[rank],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got_err, np.asarray(err)[rank],
                                   rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# context-parallel caches executed on gloo ranks
# --------------------------------------------------------------------------

CP_MESHES = {"2x2": (2, 2), "2x1": (2, 1)}
CP_ARCHS = ("yi-9b-smoke", "recurrentgemma-2b-smoke", "mamba2-1.3b-smoke")


@pytest.fixture(scope="module")
def cp_caches(tmp_path_factory):
    """cp_cache_rank's results on the (2, 2) and (2, 1) meshes, once per
    pytest run."""
    def build():
        return {name: run_ranks(R.cp_cache_rank, d * m, "gloo", JOIN_S,
                                (d, m))
                for name, (d, m) in CP_MESHES.items()}
    return shared_reference(tmp_path_factory, "sharding_cp_caches", build)


def _cp_local_shape(path: str, shape, d: int, m: int):
    """A context-parallel cache leaf's shape on one rank: the KV sequence
    over 'data' and its heads over 'model' where they divide; the rec
    width and the ssm heads and conv channels over 'model'; every row on
    every rank."""
    lead = 1 if path.startswith("stages/") else 0
    out = list(shape)
    name = path.rsplit("/", 1)[-1]
    if name in ("k", "v"):
        out[lead + 1] //= d
        if out[lead + 2] % m == 0:
            out[lead + 2] //= m
    elif name == "h":
        out[lead + 1] //= m
    elif name == "conv":
        out[lead + 2] //= m
    return out


@pytest.mark.parametrize("mesh_name", sorted(CP_MESHES))
def test_context_parallel_cache_shapes(cp_caches, mesh_name):
    """init_caches in a context-parallel scope, for a session's 3 slots
    and a batch-1 prefill, and shard_tree of full batch-1 caches under
    cache_shardings: every rank holds every row and its L/D block of each
    KV cache's sequence (12 of 24), with the heads, the rec width and the
    ssm heads and channels over 'model' as the rules place them."""
    d, m = CP_MESHES[mesh_name]
    for res in cp_caches[mesh_name]:
        for arch in CP_ARCHS:
            cfg = TCF.get(arch)
            for rows in (3, 1):
                full = SH.flat_specs(TM.init_caches(cfg, rows, R.MAX_LEN,
                                                    device="meta"))
                got = res["shapes"][f"{arch}/{rows}"]
                assert sorted(got) == sorted(full)
                for path, t in full.items():
                    assert got[path] == _cp_local_shape(path, t.shape, d,
                                                        m), (arch, path)
                if rows == 1:
                    assert res["local_shapes"][arch] == got


@pytest.mark.parametrize("mesh_name", sorted(CP_MESHES))
def test_context_parallel_caches_round_trip(cp_caches, mesh_name):
    """shard_tree then unshard_tree of full batch-1 caches (cache=True)
    gives the caches back bitwise on every rank."""
    for res in cp_caches[mesh_name]:
        assert all(res["round_trip"][a] for a in CP_ARCHS)


@pytest.mark.parametrize("mesh_name", sorted(CP_MESHES))
def test_data_sharded_param_spec_still_raises(cp_caches, mesh_name):
    """The cache path executes 'data'-axis specs for caches only: a param
    tree placed with fsdp=True, and a cache tree with KV caches taken as
    params, raise NotImplementedError naming FSDP placement and ROADMAP
    item 1.12 (mamba2's caches, with no KV, shard over 'model' only); a
    context-parallel scope refuses rows that divide the data axes."""
    for res in cp_caches[mesh_name]:
        for arch in CP_ARCHS:
            ref = res["refused"]
            kv = arch != "mamba2-1.3b-smoke"
            assert (ref[f"{arch}/cache_as_params"] is None) == (not kv)
            for what in ("fsdp_params",) + (("cache_as_params",) if kv
                                            else ()):
                msg = ref[f"{arch}/{what}"]
                assert msg and msg.startswith("NotImplementedError"), msg
                assert "FSDP" in msg and "1.12" in msg, msg
            assert ref[f"{arch}/dividing_rows"].startswith("ValueError")


class _ModelRank:
    """The one thing _shard_entry asks of a mesh: this rank's index on
    'model'."""

    def __init__(self, r: int):
        self.r = r

    def index(self, axis: str) -> int:
        return self.r


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_entry_at_mamba2_full_width_shards(tp):
    """ProtectionPlan.shard's per-entry cut at Mamba2-1.3B's full widths
    in bf16: in_proj (2048 x 8512, the plan's 608-wide chunks) is sliced
    at model 2 (4256 columns, 7 chunks) and re-encoded at model 4 (2128
    columns straddle a chunk: 532-wide chunks of the shard); out_proj
    (4096 x 2048, row-sharded) keeps its 1024-wide column chunks with
    this rank's K slice and re-encodes its column locators. Every rank's checksums
    and locator sums equal those encoded from its own shard, bitwise."""
    from repro_torch.core import checksums as C
    from repro_torch.core.plan import _shard_entry, matmul_entry
    from repro_torch.core.protected import weight_checksums_matmul
    from repro_torch.core.types import ProtectConfig
    cfg = ProtectConfig()
    g = torch.Generator().manual_seed(0)
    for name, (k, m), spec in (("in_proj", (2048, 8512), (None, "model")),
                               ("out_proj", (4096, 2048), ("model", None))):
        w = (torch.randn((k, m), generator=g) * k ** -0.5).to(torch.bfloat16)
        e = matmul_entry(name, w, cfg)
        if name == "in_proj":
            assert e.wck.col_chunk == 608
        for r in range(tp):
            if spec[1]:
                local = w[:, r * m // tp:(r + 1) * m // tp]
            else:
                local = w[r * k // tp:(r + 1) * k // tp]
            got = _shard_entry(e, spec, local, _ModelRank(r))
            want_cb = (1024 if name == "out_proj" else
                       608 if tp == 2 else 532)
            want = weight_checksums_matmul(local, want_cb)
            wl = C.weight_locators_matmul(local, want_cb)
            assert got.wck.col_chunk == got.wlc.cb == want_cb
            assert torch.equal(got.wck.cw1, want.cw1), (name, tp, r)
            assert torch.equal(got.wck.cw2, want.cw2), (name, tp, r)
            for a, b in zip(got.wlc[:4], wl[:4]):
                assert np.array_equal(np.asarray(a), np.asarray(b)), \
                    (name, tp, r)
            assert tuple(got.w_shape) == tuple(local.shape)
