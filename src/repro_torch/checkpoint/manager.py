"""Checkpointing: CRC-checksummed leaves, async save, restart (twin of
repro.checkpoint.manager, file for file).

Layout (per step):
    <dir>/step_<n>/manifest.json   {leaf path -> {file, crc32, shape, dtype}}
    <dir>/step_<n>/<leaf>.npy
    <dir>/step_<n>/COMMITTED       written last - torn saves are ignored

Fault-tolerance contract:
- every array file carries a crc32; restore verifies before use (a
  RowHammer-style corruption on disk is detected, matching the paper's
  'reload weights from the CNN model' repair path);
- saves go through a temp dir + atomic rename, and COMMITTED is written
  last, so a node failure mid-save never yields a half checkpoint;
- async: `save(..., blocking=False)` hands the host-side write to a
  daemon thread; `wait()` joins before the next save or shutdown.

The files are the JAX package's: leaf names are its "/"-joined dict keys,
and a bfloat16 leaf is its raw 2-byte payload under the header numpy
writes for an ml_dtypes bfloat16 array (descr '<V2'), with manifest dtype
"bfloat16" and the CRC over the same bytes. `restore` reads a leaf back by
its manifest dtype, so both packages' bf16 files load here (the JAX
package's own restore cannot turn a '<V2' file back into bf16).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .._device import DeviceLike
from .._tree import tree_flatten_with_path, tree_unflatten

_BF16_DESCR = "<V2"      # numpy's descr of an ml_dtypes bfloat16 array


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).view(np.uint8).tobytes())


def _host(leaf):
    """(numpy array whose bytes go to disk, manifest dtype) of a leaf:
    bf16 as its uint16 payload."""
    t = torch.as_tensor(leaf).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype)))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, blocking: bool = True) -> None:
        self.wait()
        # copy to the host NOW (the caller may go on to the next step);
        # write possibly async
        host_leaves = [(n, *_host(x))
                       for n, x in tree_flatten_with_path(tree)]

        def _write():
            final = os.path.join(self.dir, f"step_{step:08d}")
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest: Dict[str, Any] = {"step": step, "leaves": {}}
            for name, arr, dtype in host_leaves:
                fname = name.replace("/", "__") + ".npy"
                _save_leaf(os.path.join(tmp, fname), arr, dtype)
                manifest["leaves"][name] = {
                    "file": fname, "crc32": _crc(arr),
                    "shape": list(arr.shape), "dtype": dtype}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.write("ok")
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, d, "COMMITTED")):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree, device: DeviceLike = None):
        """Restore into the structure of `target_tree`. Each leaf goes to
        `device` when given, else to the device of the target's leaf at
        its path (the CPU where the target holds no tensor)."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves_out = []
        for name, want in tree_flatten_with_path(target_tree):
            meta = manifest["leaves"][name]
            arr = np.load(os.path.join(path, meta["file"]))
            if _crc(arr) != meta["crc32"]:
                raise IOError(f"checkpoint corruption detected in {name} "
                              f"(crc mismatch) - refusing to load")
            dev = device if device is not None else (
                want.device if isinstance(want, torch.Tensor) else "cpu")
            leaves_out.append(_from_host(arr, meta["dtype"]).to(dev))
        return tree_unflatten(target_tree, leaves_out)
