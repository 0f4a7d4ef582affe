"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes `build/repro_torch/lib<name>-<hash>.so` at
the repository root, at first use. The hash covers the source and the
flags, so an edited source rebuilds and an unchanged one loads as built.
`build_all()` starts one nvcc per source together and waits for all of
them. A CUDA host without nvcc is an error: nothing here falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("checksum_reduce", "abft_matmul")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# nvcc's -Xptxas -v report of each build (registers, shared memory, spills)
PTXAS_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the repro_torch kernels are "
        "built from csrc/ at first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str, nvcc: str):
    out = _lib_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return out, (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, ctypes.CDLL]:
    """Build (in parallel) and load every named source; returns the
    loaded libraries by name."""
    names = [n for n in (names or SOURCES)]
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        if todo:
            nvcc = nvcc_path()
            started = {n: _start(n, nvcc) for n in todo}
            errors = []
            for n, (out, job) in started.items():
                if job is None:
                    continue
                tmp, proc = job
                log, _ = proc.communicate()
                PTXAS_LOG[n] = log
                if proc.returncode != 0:
                    errors.append(f"nvcc failed on {n}.cu "
                                  f"(exit {proc.returncode}):\n{log}")
                    continue
                os.replace(tmp, out)
            if errors:
                raise RuntimeError("\n".join(errors))
            for n, (out, _) in started.items():
                _LIBS[n] = ctypes.CDLL(str(out))
        return {n: _LIBS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    return build_all([name])[name]


_FNS: Dict[str, object] = {}


def function(lib: str, symbol: str, argtypes):
    """The C entry point `symbol` of csrc/<lib>.cu, typed (int return,
    `argtypes`), building the library at first use."""
    fn = _FNS.get(symbol)
    if fn is None:
        fn = getattr(load(lib), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def launch(fn, device, *args) -> None:
    """Call a C entry point with PyTorch's current stream on `device`
    appended, inside that device's context; raise on the cudaError_t it
    returns (a refused launch never runs, and synchronize would not say
    so)."""
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err} at launch")
