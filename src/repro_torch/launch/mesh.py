"""The (data, model) mesh over torch.distributed ranks (twin of
repro.launch.mesh), and `run_ranks`, which starts a mesh's ranks as
processes of one host.

A JAX mesh is an array of devices that one program is partitioned over. A
torch mesh is an arrangement of ranks, one process each: `Mesh` keeps the
axis names and sizes, this rank's coordinate on each axis and one process
group per axis (the ranks that differ from this one only along it), made
with `dist.new_group` by every rank in the same order. Ranks are laid out
row-major over the axes, so a rank's model peers are consecutive.

The backend is always the caller's: the mesh never swaps NCCL for gloo.
Several ranks may share one card (gloo carries their collectives on CUDA
tensors; NCCL refuses two ranks on one device).

    run_ranks(fn, world=4, backend="gloo", timeout=120, args=(...))
    # in each rank: mesh = make_host_mesh(2, 2, backend="gloo",
    #                                     device="cuda")
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device

BACKENDS = ("gloo", "nccl")


class AbstractMesh:
    """A mesh's axis names and sizes only (JAX's AbstractMesh): enough for
    runtime.sharding's rule functions, which compute specs and run
    nothing."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError("one size per axis name")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, shape)))
        self.size = math.prod(self.shape.values())

    def axis_size(self, axis) -> int:
        """Ranks along `axis`: a name, a tuple of names, "world" or None
        (1)."""
        if axis is None:
            return 1
        if axis == "world":
            return self.size
        if isinstance(axis, tuple):
            return math.prod(self.shape.get(a, 1) for a in axis)
        return self.shape.get(axis, 1)


class Mesh(AbstractMesh):
    """A named grid of torch.distributed ranks: `shape` maps each axis
    name to its size (in axis order), `coords` this rank's index on each
    axis, `group(axis)` the axis's process group ("world" for all ranks),
    `device` where this rank's tensors live."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 backend: str, device: DeviceLike = None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r} (have "
                             f"{BACKENDS}); the caller names it")
        super().__init__(shape, axis_names)
        size = self.size
        if not dist.is_initialized():
            raise RuntimeError(
                f"a mesh of {size} ranks needs torch.distributed "
                "initialised with that world size (init_process_group, or "
                "launch.mesh.run_ranks)")
        if dist.get_world_size() != size:
            raise RuntimeError(
                f"mesh {dict(zip(axis_names, shape))} has {size} ranks "
                f"but the world has {dist.get_world_size()}")
        self.device = resolve_device(device)
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an NCCL mesh needs a CUDA device")
        self.backend = backend
        self.rank = dist.get_rank()
        rem, coords = self.rank, {}
        for name in reversed(self.axis_names):
            coords[name] = rem % self.shape[name]
            rem //= self.shape[name]
        self.coords: Dict[str, int] = {n: coords[n] for n in self.axis_names}
        # every rank makes every group, in the same order (new_group is
        # collective over the world), and keeps the ones it belongs to
        self._groups: Dict[str, Any] = {}
        for axis in self.axis_names:
            others = [n for n in self.axis_names if n != axis]
            for fixed in itertools.product(*(range(self.shape[n])
                                             for n in others)):
                at = dict(zip(others, fixed))
                ranks = [self._rank_of({**at, axis: i})
                         for i in range(self.shape[axis])]
                g = dist.new_group(ranks, backend=backend)
                if self.rank in ranks:
                    self._groups[axis] = g
        self._groups["world"] = dist.new_group(list(range(size)),
                                               backend=backend)

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + coords[name]
        return r

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis` (0 for an axis the mesh lacks)."""
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self._groups[axis]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.backend} on {self.device})")


def make_production_mesh(*, multi_pod: bool = False, backend: str,
                         device: DeviceLike = None) -> Mesh:
    """(data=16, model=16), or (pod=2, data=16, model=16) multi-pod: 256
    or 512 ranks, one card each."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, backend=backend, device=device)


def make_host_mesh(data: int = 1, model: int = 1, *, backend: str,
                   device: DeviceLike = None) -> Mesh:
    """A small (data, model) mesh over the ranks of one host."""
    return Mesh((data, model), ("data", "model"), backend=backend,
                device=device)


# --------------------------------------------------------------------------
# starting a mesh's ranks
# --------------------------------------------------------------------------

def _rank_main(rank: int, world: int, backend: str, store_path: str,
               timeout: float, out_dir: str, fn: Callable, args) -> None:
    torch.set_num_threads(1)
    kw = {}
    if backend == "nccl":
        # NCCL binds a rank to one card: the ranks go round the host's
        kw["device_id"] = torch.device("cuda",
                                       rank % torch.cuda.device_count())
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout), **kw)
    try:
        result: Any = ("ok", fn(rank, *args))
    except BaseException:                     # reported to the parent
        result = ("error", traceback.format_exc())
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    if result[0] == "ok":
        dist.barrier()
        dist.destroy_process_group()
    else:
        # a failed rank leaves at once; its peers' collectives time out
        os._exit(1)


def run_ranks(fn: Callable, world: int, backend: str, timeout: float,
              args: tuple = ()) -> List[Any]:
    """fn(rank, *args) in `world` processes, each a rank of one
    torch.distributed world on `backend`, joined through a FileStore in a
    temporary directory (no TCP port to choose). Returns the ranks'
    results in rank order. `timeout` bounds the collectives
    (init_process_group's timeout) and the join: a rank that raises,
    dies or is still running then fails the whole run, and every rank
    still running is killed. fn and args must pickle (fn at module
    level); the ranks are spawned, so they import what fn needs."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, backend, store, timeout, tmp,
                                   fn, args), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            codes = [p.exitcode for p in procs]
            if all(c is not None for c in codes) or any(c for c in codes):
                break            # all done, or one failed: stop the rest
            time.sleep(0.05)
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results, errors = [], []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                why = ("still running at the join limit" if r in alive
                       else f"exited with code {procs[r].exitcode}")
                errors.append(f"rank {r} left no result ({why})")
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                errors.append(f"rank {r} raised:\n{value}")
            results.append(value)
        if errors:
            raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}, "
                               f"world={world}, {backend}): "
                               + "\n".join(errors))
        return results

