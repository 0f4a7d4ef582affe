"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py):
numpy <-> jax/torch conversion, verdict comparison, and the fixture that
hands GPU-only tests the card or skips them.

Inputs are made with numpy from a seed and handed to both packages, so the
two sides see bit-identical operands."""
from __future__ import annotations

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
