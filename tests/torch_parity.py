"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py):
numpy <-> jax/torch conversion, verdict comparison, the JAX-side
references computed once per pytest run (`shared_reference`), a JAX
ProtectedSession whose decode steps cannot race the host
(`steady_jax_session`), and the fixture that hands GPU-only tests the
card or skips them.

Inputs are made with numpy from a seed and handed to both packages, so the
two sides see bit-identical operands. This module imports the standard
library, numpy and pytest only (torch if present): the card's host runs
tests/test_torch_gpu.py without JAX."""
from __future__ import annotations

import fcntl
import json
import os
from pathlib import Path
from typing import Any, Callable

import numpy as np
import pytest

try:
    import torch
except ImportError:  # the test files importorskip torch themselves
    torch = None
else:
    # the parity tests run tiny tensors; torch's default of one intra-op
    # thread per core only oversubscribes the host the other pytest
    # workers share
    torch.set_num_threads(1)


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def normal(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (rng(seed).standard_normal(shape) * scale).astype(np.float32)


def to_np(x) -> np.ndarray:
    """A jax array, torch tensor or array-like as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.array(x)


def tree_np(tree):
    """Nested dict of jax arrays -> nested dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    return to_np(tree)


def verdict(rep) -> tuple:
    """(detected, corrected_by, residual) of a FaultReport as ints."""
    return tuple(int(np.max(to_np(getattr(rep, f))))
                 for f in ("detected", "corrected_by", "residual"))


def assert_close(a, b, rtol: float, atol: float, what: str = "") -> None:
    np.testing.assert_allclose(to_np(a).astype(np.float64),
                               to_np(b).astype(np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture
def cuda_device():
    """The CUDA device for tests that need the card; skips without one.
    Decided here, when the test runs, never while modules are imported."""
    if torch is None or not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU host)")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# JAX-side references shared across pytest-xdist workers
# --------------------------------------------------------------------------

def _encode(x, arrays: dict):
    """A tree of dicts, lists, tuples, numpy-convertible arrays and JSON
    scalars as JSON, its arrays moved into `arrays` (bfloat16 as its
    uint16 bits, which np.savez cannot otherwise keep)."""
    if isinstance(x, dict):
        return {"dict": [[_encode(k, arrays), _encode(v, arrays)]
                         for k, v in x.items()]}
    if isinstance(x, (list, tuple)):
        return {"tuple" if isinstance(x, tuple) else "list":
                [_encode(v, arrays) for v in x]}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    arr = np.asarray(x)
    key = f"a{len(arrays)}"
    bf16 = arr.dtype.name == "bfloat16"
    arrays[key] = arr.view(np.uint16) if bf16 else arr
    return {"array": key, "bf16": bf16,
            "scalar": isinstance(x, np.generic)}


def _decode(x, arrays):
    if not isinstance(x, dict):
        return x
    if "dict" in x:
        return {_decode(k, arrays): _decode(v, arrays) for k, v in x["dict"]}
    if "list" in x:
        return [_decode(v, arrays) for v in x["list"]]
    if "tuple" in x:
        return tuple(_decode(v, arrays) for v in x["tuple"])
    arr = arrays[x["array"]]
    if x["bf16"]:
        import ml_dtypes  # where a bfloat16 reference was written
        arr = arr.view(ml_dtypes.bfloat16)
    return arr[()] if x["scalar"] else arr


def _shared_dir(tmp_path_factory) -> Path:
    """The directory every worker of this pytest run sees: the parent of
    the workers' own base temp directories under xdist, the run's base
    temp directory otherwise (its parent outlives the run)."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / "jax_references"
    path.mkdir(parents=True, exist_ok=True)
    return path


def shared_reference(tmp_path_factory, name: str,
                     build: Callable[[], Any]) -> Any:
    """`build()`'s value, computed once per pytest run and read by every
    other xdist worker that asks for `name`: the pattern the pytest-xdist
    documentation gives for a session fixture that runs once. The value
    is a tree of dicts (any JSON-scalar keys), lists, tuples, arrays
    (numpy, or anything np.asarray takes: they come back as numpy) and
    JSON scalars; it is written as `<name>.npz` plus `<name>.json` under
    the run's base temp directory, guarded by an flock on `<name>.lock`.
    Every caller, the worker that built it too, gets the value as read
    back from those files. Nothing outlives the run's temp directory,
    which pytest rotates away (keeping the last three); delete it to drop
    a reference."""
    root = _shared_dir(tmp_path_factory)
    meta, data = root / f"{name}.json", root / f"{name}.npz"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not meta.exists():
                arrays: dict = {}
                tree = _encode(build(), arrays)
                tmp = root / f"{name}.tmp.npz"
                np.savez(tmp, **arrays)
                os.replace(tmp, data)
                tmp = root / f"{name}.tmp.json"
                tmp.write_text(json.dumps(tree))
                os.replace(tmp, meta)
            with np.load(data) as f:
                arrays = {k: f[k] for k in f.files}
            return _decode(json.loads(meta.read_text()), arrays)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


# --------------------------------------------------------------------------
# a JAX session reference that does not race the host
# --------------------------------------------------------------------------

def steady_jax_session(*args, **kwargs):
    """A JAX package ProtectedSession (same arguments) whose decode steps
    complete before the call that launched them returns.

    The JAX session hands its decode program `jnp.asarray` of its host
    position vector, which on the CPU usually shares the numpy buffer,
    and increments that vector in place right after the asynchronous
    launch (src/repro/serving/session.py:370-372,392): a step that has
    not read its positions yet under a loaded host reads the next step's,
    and its tokens move from run to run. Waiting for the step's outputs
    before the increment closes the window without editing the JAX
    package; the session's arithmetic is unchanged."""
    import jax
    from repro.serving import ProtectedSession

    class SteadySession(ProtectedSession):
        def _dispatch_decode(self, tokens):
            out = super()._dispatch_decode(tokens)
            jax.block_until_ready(out)
            return out

    return SteadySession(*args, **kwargs)
