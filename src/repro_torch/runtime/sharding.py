"""Logical-axis sharding rules (twin of repro.runtime.sharding: MaxText-
style path patterns to partition specs) and their execution over a
launch.mesh.Mesh: local shards, the collectives seam and the Megatron
pair.

Strategy on the (pod, data, model) production mesh, as in the JAX
package:
- batch/sequence activations shard over ('pod','data') [DP]
- attention heads / d_ff / vocab shard over 'model' [TP]
- MoE experts shard over 'model' [EP]; expert d_ff over 'data' (FSDP)
- optimizer state mirrors its parameter
- long-context decode KV caches shard sequence over 'data'

A spec is a tuple with one entry per leading axis of the leaf: None
(replicated), an axis name, or a tuple of axis names (the JAX package's
PartitionSpec as a tuple). The rule functions compute specs only, for any
mesh; the port executes them with rank-local tensors: `shard_tree` cuts a
full tree into this rank's shards, `unshard_tree` rebuilds it, and every
layer that needs a collective finds it from its leaf's spec through
`parallel_scope`. A cache leaf may be sharded over the data axes too:
caches whose batch does not divide them split the sequence of each KV
cache over 'data' (context-parallel decode, `parallel_scope(...,
context_parallel=True)`), and each rank's attention partials are merged
over 'data' (`merge_softmax_partials`). Executing the FSDP (`fsdp=True`)
placement of params is ROADMAP item 1.12's later step and raises.

The collectives use `all_reduce` only, on fp32 or int64 tensors: per PyTorch's backend table those are what gloo runs on
CUDA tensors, so the same code runs a gloo mesh whose ranks share one card
and an NCCL one. Partial products are summed in fp32 and rounded once.
"""
from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from .._tree import tree_flatten_with_path, tree_unflatten

F32 = torch.float32

Spec = Tuple


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


# (path regex, spec function). First match wins. `d` = data axes.
_RULES = [
    # embeddings / heads: vocab over model
    (r"embed/table$",            lambda d: (None, "model", None)),
    (r"embed/head/w$",           lambda d: (None, "model")),
    # attention projections
    (r"attn/w[qkv]/w$",          lambda d: (None, "model")),
    (r"attn/wo/w$",              lambda d: ("model", None)),
    # dense ffn
    (r"ffn/(gate|up)/w$",        lambda d: (None, "model")),
    (r"ffn/down/w$",             lambda d: ("model", None)),
    # moe: experts over model (EP); expert d_ff over data (FSDP)
    (r"moe/router/w$",           lambda d: (None, None)),
    (r"moe/(gate|up)$",          lambda d: ("model", None, d)),
    (r"moe/down$",               lambda d: ("model", d, None)),
    (r"moe/shared/(gate|up)/w$", lambda d: (None, "model")),
    (r"moe/shared/down/w$",      lambda d: ("model", None)),
    # mamba2
    (r"ssm/in_proj/w$",          lambda d: (None, "model")),
    (r"ssm/out_proj/w$",         lambda d: ("model", None)),
    (r"ssm/conv_w$",             lambda d: (None, "model")),
    # rg-lru
    (r"rec/(in_x|in_gate)/w$",   lambda d: (None, "model")),
    (r"rec/(gate_a|gate_i)/w$",  lambda d: (None, "model")),
    (r"rec/out/w$",              lambda d: ("model", None)),
    (r"rec/conv_w$",             lambda d: (None, "model")),
    (r"rec/lam$",                lambda d: ("model",)),
    # adafactor factored second-moment for expert weights
    (r"moe/(gate|up|down)/(r|c)$", lambda d: ("model", None)),
]


def head_ok(ps: str, cfg, tp: int) -> bool:
    """Attention projections shard over 'model' only when the head count
    divides the axis (otherwise the (B,S,H,hd) reshape would regather
    every layer); cfg=None disables the check."""
    if cfg is None:
        return True
    if re.search(r"attn/(wq|wo)/w$", ps):
        return cfg.num_heads % tp == 0
    if re.search(r"attn/w[kv]/w$", ps):
        return cfg.num_kv_heads % tp == 0
    return True


def _data_spec(mesh):
    d = data_axes(mesh)
    return d if len(d) > 1 else (d[0] if d else None)


def spec_for_param(path: str, ndim: int, mesh) -> Spec:
    d = _data_spec(mesh)
    for pat, fn in _RULES:
        if re.search(pat, path):
            spec = fn(d)
            if len(spec) > ndim:           # stacked-stage leading axis
                spec = spec[:ndim]
            return spec
    return ()                               # replicate (norms, scalars, ...)


def _stacked(ps: str) -> bool:
    return "stages/" in ps or ps.startswith("stages")


def param_shardings(params, mesh, cfg=None, dp_only: bool = False,
                    fsdp: bool = False):
    """Tree of specs for a param tree (or an optimizer mirror of one).
    Stacked stage leaves keep the rule of their block with the stage axis
    replicated. Head-aware with `cfg` (head_ok). dp_only replicates every
    leaf; fsdp additionally shards each weight's first model-free axis
    over 'data' (ZeRO-3; its specs are computed, not executed)."""
    tp = mesh.shape.get("model", 1)
    out = []
    for ps, leaf in tree_flatten_with_path(params):
        stacked = _stacked(ps)
        base_ndim = leaf.dim() - (1 if stacked else 0)
        if dp_only or not head_ok(ps, cfg, tp):
            inner = (None,) * base_ndim
        else:
            inner = spec_for_param(ps, base_ndim, mesh)
        if fsdp and not dp_only and base_ndim >= 2:
            names = list(inner) + [None] * (base_ndim - len(inner))
            if "data" not in str(names):
                for i, nm in enumerate(names):
                    if nm is None:
                        names[i] = "data"
                        break
            inner = tuple(names)
        spec = (None,) + tuple(inner) if stacked else tuple(inner)
        out.append(_legalize(spec, tuple(leaf.shape), mesh))
    return tree_unflatten(params, out)


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        size = 1
        for n in name:
            size *= mesh.shape[n]
        return size
    return mesh.shape[name]


def _legalize(spec: Spec, shape, mesh) -> Spec:
    """Drop sharding on axes that do not divide evenly (e.g. 8 kv heads on
    a 16-way model axis) - replicate instead of failing."""
    out = []
    for i, name in enumerate(spec):
        if name is None or i >= len(shape):
            out.append(None)
            continue
        out.append(name if shape[i] % _axis_size(mesh, name) == 0 else None)
    return tuple(out)


def data_index(mesh) -> Tuple[int, int]:
    """(this rank's index, the number of ranks) over the data axes, laid
    out row-major as a batch sharded over them is."""
    idx, n = 0, 1
    for a in data_axes(mesh):
        idx = idx * mesh.shape[a] + mesh.index(a)
        n *= mesh.shape[a]
    return idx, n


def batch_spec(mesh) -> Spec:
    return (_data_spec(mesh),)


def cache_shardings(caches, mesh, batch: int):
    """Serving-state specs. Batch shards over the DP axes when it
    divides; otherwise attention KV shards its *sequence* axis over 'data'
    (context-parallel decode). KV heads shard over 'model' when
    divisible."""
    d = data_axes(mesh)
    dsize = 1
    for a in d:
        dsize *= mesh.shape[a]
    d_spec = _data_spec(mesh)
    batch_ok = batch % dsize == 0
    out = []
    for ps, leaf in tree_flatten_with_path(caches):
        stacked = _stacked(ps)
        base = tuple(leaf.shape[1:] if stacked else leaf.shape)
        name = ps.rsplit("/", 1)[-1]
        bspec = d_spec if batch_ok else None
        if name in ("k", "v"):            # (B, L, Hkv, hd)
            spec = (bspec, None if batch_ok else "data", "model", None)
        elif name == "h" and len(base) == 4:   # ssm state (B, H, P, N)
            spec = (bspec, "model", None, None)
        elif name == "h":                  # rg-lru state (B, W)
            spec = (bspec, "model")
        elif name == "conv":               # conv tail (B, K-1, C)
            spec = (bspec, None, "model")
        else:
            spec = (bspec,) + (None,) * (len(base) - 1)
        spec = _legalize(spec, base, mesh)
        out.append((None,) + spec if stacked else spec)
    return tree_unflatten(caches, out)


def checksum_shardings(plan, mesh, cfg=None) -> Dict[str, Tuple[Spec, Spec]]:
    """{entry name -> (cw1 spec, cw2 spec)}: each matmul entry's weight
    checksums placed by the rule of the weight they encode. A (K, M)
    weight with spec (kspec, mspec) has (M/chunk, K) checksums, so the
    checksum spec is the transposed weight spec and the protected
    contraction runs against colocated shards. Conv checksums, w_view
    entries and anything without the matmul (blocks, K) layout replicate.
    Stacked (reps, M/chunk, K) entries keep a replicated leading repeats
    axis and are sliced per repeat like their weights: unlike the JAX
    package, which replicates them to get round its partitioner (its
    sharding.py:241-250), the port's local GEMMs need local checksums."""
    repl = ()
    tp = mesh.shape.get("model", 1)
    out = {}
    for name, e in plan.entries.items():
        if e.wck is None:
            continue
        if (e.op.kind != "matmul" or e.w_view is not None
                or not hasattr(e.wck, "col_chunk")):
            out[name] = (repl, repl)
            continue
        ps = name + "/w"
        if not head_ok(ps, cfg, tp):
            out[name] = (repl, repl)
            continue
        wspec = spec_for_param(ps, 2, mesh)
        names = list(wspec) + [None] * (2 - len(wspec))
        shape = tuple(e.wck.cw1.shape)
        if e.stack:
            cspec = (None,) + _legalize((names[1], names[0]), shape[1:],
                                        mesh)
        else:
            cspec = _legalize((names[1], names[0]), shape, mesh)
        out[name] = (cspec, cspec)
    return out


# --------------------------------------------------------------------------
# executing specs: local shards
# --------------------------------------------------------------------------

def _axes_of(name) -> Tuple[str, ...]:
    if name is None:
        return ()
    return tuple(name) if isinstance(name, tuple) else (name,)


def _check_executable(spec: Spec, mesh, what: str,
                      cache: bool = False) -> None:
    """Raise for a param spec sharded over an axis other than 'model' (a
    cache leaf may be sharded over the data axes too)."""
    if cache:
        return
    for name in spec:
        for a in _axes_of(name):
            if a != "model" and mesh.shape.get(a, 1) > 1:
                raise NotImplementedError(
                    f"{what}: a param spec sharded over {a!r} ({spec}) is "
                    "not executed yet: FSDP placement is ROADMAP item "
                    "1.12's later step")


def shard_slices(spec: Spec, shape, mesh) -> Tuple[slice, ...]:
    """This rank's block of a leaf of `shape` under `spec` (ranks along a
    tuple of axes are laid out row-major, as JAX lays them out)."""
    out = []
    for i, n in enumerate(shape):
        name = spec[i] if i < len(spec) else None
        k = 1
        idx = 0
        for a in _axes_of(name):
            idx = idx * mesh.shape[a] + mesh.index(a)
            k *= mesh.shape[a]
        step = n // k
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def local_shape(spec: Spec, shape, mesh) -> Tuple[int, ...]:
    return tuple(s.stop - s.start for s in shard_slices(spec, shape, mesh))


def flat_specs(specs) -> Dict[str, Spec]:
    """{leaf path: spec} of a spec tree (param_shardings' result)."""
    return dict(_flat_spec_items(specs, ()))


def _flat_spec_items(tree, prefix):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_spec_items(tree[k], prefix + (str(k),))
    else:
        yield "/".join(prefix), tree


def shard_tree(tree, specs, mesh, cache: bool = False):
    """This rank's local tensors of a full tree (each a contiguous copy
    on the mesh's device, or the leaf itself when it is replicated and
    already there). `cache`: a tree of caches (cache_shardings' specs),
    whose KV sequence may be sharded over 'data'; a param tree's specs
    shard over 'model' only."""
    fs = flat_specs(specs)
    out = []
    for path, leaf in tree_flatten_with_path(tree):
        spec = fs[path]
        _check_executable(spec, mesh, path, cache)
        sl = shard_slices(spec, tuple(leaf.shape), mesh)
        t = leaf[sl] if any(s is not None for s in spec) else leaf
        out.append(t.to(mesh.device).contiguous())
    return tree_unflatten(tree, out)


def unshard_tree(tree, specs, mesh, cache: bool = False):
    """The full tree back from every rank's local tensors: each rank puts
    its block into zeros of the full shape and the blocks are summed over
    the axes the leaf is sharded on (exact: every element has one
    non-zero term). `cache` as in shard_tree."""
    fs = flat_specs(specs)
    out = []
    for path, leaf in tree_flatten_with_path(tree):
        spec = fs[path]
        _check_executable(spec, mesh, path, cache)
        if not any(s is not None for s in spec):
            out.append(leaf)
            continue
        shape = tuple(n * (mesh.axis_size(spec[i]) if i < len(spec) else 1)
                      for i, n in enumerate(leaf.shape))
        big = torch.zeros(shape, dtype=_wire_dtype(leaf.dtype),
                          device=mesh.device)
        big[shard_slices(spec, shape, mesh)] = leaf.to(big.dtype)
        axes = sorted({a for name in spec for a in _axes_of(name)})
        for a in axes:
            _all_reduce(big, mesh, a, dist.ReduceOp.SUM)
        out.append(big.to(leaf.dtype))
    return tree_unflatten(tree, out)


# --------------------------------------------------------------------------
# the collectives seam
# --------------------------------------------------------------------------

def _wire_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type a tensor crosses the wire in: fp32 for floating types (no
    bf16 on gloo's CUDA path; partial sums rounded once), int64 for
    integer and boolean ones."""
    if dtype.is_floating_point:
        return F32
    return torch.int64


def _all_reduce(t: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    """In place over `axis`'s group (a no-op on an axis of one rank)."""
    if mesh.axis_size(axis) > 1:
        dist.all_reduce(t, op=op, group=mesh.group(axis))
    return t


def axis_sum(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of every rank's `t` over `axis`, in fp32 (or int64), rounded
    once to t's type."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return t
    w = t.to(_wire_dtype(t.dtype)).contiguous()
    if w.data_ptr() == t.data_ptr():
        w = w.clone()
    return _all_reduce(w, mesh, axis, dist.ReduceOp.SUM).to(t.dtype)


def axis_sum_(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """axis_sum in place, for a contiguous fp32 or int64 `t`."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return t
    if t.dtype != _wire_dtype(t.dtype) or not t.is_contiguous():
        raise ValueError("axis_sum_ takes a contiguous fp32 or int64 tensor")
    return _all_reduce(t, mesh, axis, dist.ReduceOp.SUM)


def axis_max(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    if mesh is None or mesh.axis_size(axis) == 1:
        return t
    w = t.to(_wire_dtype(t.dtype)).contiguous()
    if w.data_ptr() == t.data_ptr():
        w = w.clone()
    return _all_reduce(w, mesh, axis, dist.ReduceOp.MAX).to(t.dtype)


def axis_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's `t` along `axis`, concatenated on `dim` in rank order:
    a zero-padded sum (exact), so it needs all_reduce only."""
    n = 1 if mesh is None else mesh.axis_size(axis)
    if n == 1:
        return t
    dim = dim % t.dim()
    shape = list(t.shape)
    step = shape[dim]
    shape[dim] = step * n
    big = torch.zeros(shape, dtype=_wire_dtype(t.dtype), device=t.device)
    i = mesh.index(axis) if axis != "world" else mesh.rank
    big.narrow(dim, i * step, step).copy_(t)
    return _all_reduce(big, mesh, axis, dist.ReduceOp.SUM).to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce (sum) of the gradient
    over 'model' backward - where a replicated tensor enters a
    model-parallel region."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return axis_sum(g, ctx.mesh, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce (sum) over 'model' forward, identity
    backward - where a model-parallel region's partial sums leave it."""

    @staticmethod
    def forward(ctx, x, mesh):
        return axis_sum(x, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather over 'model' along one dim forward; backward, the
    gradient summed over 'model' and this rank's slice taken (each rank's
    consumers of the gathered tensor use their own shards of the weights
    after it, so each holds a partial gradient of the whole)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.step = mesh, dim, x.shape[dim]
        return axis_gather(x, mesh, "model", dim)

    @staticmethod
    def backward(ctx, g):
        g = axis_sum(g, ctx.mesh, "model")
        i = ctx.mesh.index("model")
        return g.narrow(ctx.dim, i * ctx.step, ctx.step), None, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    if (mesh is None or mesh.axis_size("model") == 1
            or not (torch.is_grad_enabled() and x.requires_grad)):
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    if mesh is None or mesh.axis_size("model") == 1:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return axis_sum(x, mesh, "model")
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """Every model rank's `x` concatenated on `dim` in rank order; its
    gradient is summed over 'model' and sliced back (_GatherFromModel).
    A dense layer fed by it takes `gathered=True`: no second sum."""
    if mesh is None or mesh.axis_size("model") == 1:
        return x
    dim = dim % x.dim()
    if not (torch.is_grad_enabled() and x.requires_grad):
        return axis_gather(x, mesh, "model", dim)
    return _GatherFromModel.apply(x, mesh, dim)


def merge_softmax_partials(m: torch.Tensor, l: torch.Tensor,
                           o: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The softmax-weighted values over a sequence split across `axes`
    (the data axes of context-parallel decode), from each rank's partials
    on its block: the row max `m` (..., 1), the row sum of exp(s - m) `l`
    (..., 1) and the values weighted by it `o` (..., hd), all fp32. A
    rank whose block is masked whole gives l = 0 and o = 0 and a max at
    the mask's floor, so its rescale exp(m - max) is 0: no NaN. The sums
    run in fp32, one all_reduce for l and o together."""
    gm = m
    for a in axes:
        gm = axis_max(gm, mesh, a)
    scale = torch.exp(m - gm)
    lo = torch.cat([l * scale, o * scale], dim=-1)
    for a in axes:
        lo = axis_sum(lo, mesh, a)
    return lo[..., 1:] / lo[..., :1]


# --------------------------------------------------------------------------
# the ambient mesh: layers find their leaf's spec by its param-tree path
# --------------------------------------------------------------------------

class _Parallel:
    def __init__(self, mesh, specs: Dict[str, Spec],
                 context_parallel: bool = False):
        self.mesh = mesh
        self.specs = specs
        self.context_parallel = context_parallel

    def spec(self, path: str) -> Spec:
        """The spec of the leaf at `path` as the layer sees it: a stage
        leaf without its leading repeats axis."""
        spec = self.specs.get(path)
        if spec is None:
            return ()
        return tuple(spec[1:]) if _stacked(path) else tuple(spec)

    @property
    def tp(self) -> int:
        return self.mesh.axis_size("model")


_PAR: contextvars.ContextVar[Optional[_Parallel]] = \
    contextvars.ContextVar("repro_torch_parallel", default=None)


@contextlib.contextmanager
def parallel_scope(mesh, specs, context_parallel: bool = False
                   ) -> Iterator[_Parallel]:
    """Run the scope's forwards on `mesh` with params placed by `specs`
    (param_shardings' tree): each layer reads its leaf's spec by the
    param-tree path of core.plan.path_scope and adds the collective the
    spec requires. `context_parallel`: the caches' rows are replicated
    over the data axes and each KV cache's sequence is split over them
    (models.transformer.init_caches makes them so; attention writes and
    attends its own block and merges over 'data')."""
    if context_parallel and mesh.axis_size(data_axes(mesh)) == 1:
        raise ValueError("context-parallel caches need a data axis of "
                         "more than one rank")
    token = _PAR.set(_Parallel(mesh, flat_specs(specs), context_parallel))
    try:
        yield _PAR.get()
    finally:
        _PAR.reset(token)


@contextlib.contextmanager
def parallel_as(par: Optional[_Parallel]) -> Iterator[None]:
    """Re-enter a current_parallel() value (None: no mesh), as
    core.plan.replay_scope does for a recompute."""
    token = _PAR.set(par)
    try:
        yield
    finally:
        _PAR.reset(token)


def current_parallel() -> Optional[_Parallel]:
    return _PAR.get()


def current_mesh():
    par = _PAR.get()
    return par.mesh if par is not None else None


def is_sharded(spec: Spec, axis: str = "model") -> bool:
    return any(axis in _axes_of(n) for n in spec)
