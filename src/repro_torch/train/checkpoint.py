"""ValetCheckpointer — asynchronous, replicated checkpointing with the
paper's write-path semantics.

``save()`` is the critical path: it only copies the snapshot's tensors into
host staging arrays (the "local mempool" write) and returns once the copy
has finished.  A background writer (the Remote Sender Thread analogue)
serializes staged snapshots to N replica directories (remote peers / disk
backup, Table 3).  If a newer snapshot is staged before an older one is
written, the older one is *skipped* — the Update-flag rule of §5.2 applied
to whole snapshots (the newest data wins; stale write-sets are never
persisted over newer ones).

Restore validates manifests and falls back across replicas (peer-failure
path).  The on-disk layout is the reference's: ``replica<r>/step_<8
digits>/`` holding ``arrays.npz`` (``a0``, ``a1``, ... in ``tree_flatten``
order) and ``manifest.json`` (step, array count, shapes, dtypes).  numpy
has no bfloat16: a bf16 tensor is staged as its uint16 bits under the
dtype name ``"bfloat16"``.  ``restore`` returns numpy arrays (bf16 leaves
widened to float32, which holds them exactly); ``restore_tensors`` returns
torch tensors with the saved dtypes, bf16 bit for bit, on a device.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import tree_flatten, tree_unflatten

BF16 = "bfloat16"


def _stage(leaf) -> Tuple[np.ndarray, str]:
    """A leaf's host copy and dtype name.  A tensor is copied with a
    blocking ``.cpu()``, so the copy is complete when this returns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        bf16 = t.dtype == torch.bfloat16
        a = t.view(torch.int16).numpy().view(np.uint16) if bf16 else t.numpy()
        if leaf.device.type == "cpu":
            a = a.copy()            # the staged copy owns its bytes
        return a, BF16 if bf16 else str(a.dtype)
    a = np.array(leaf, copy=True)
    return a, str(a.dtype)


@dataclass
class _Staged:
    step: int
    arrays: List[np.ndarray]
    dtypes: List[str]
    stage_time: float


class ValetCheckpointer:
    """Async replicated checkpointer for (params, opt_state, extras)."""

    def __init__(self, directory: str, replicas: int = 2,
                 keep: int = 3):
        self.dirs = [os.path.join(directory, f"replica{r}")
                     for r in range(max(replicas, 1))]
        for d in self.dirs:
            os.makedirs(d, exist_ok=True)
        self.keep = keep
        self._q: "queue.Queue[Optional[_Staged]]" = queue.Queue()
        self._latest_staged = -1
        self._latest_written = -1
        self._lock = threading.Lock()
        self._structure = None
        self.n_skipped_stale = 0
        self._writer = threading.Thread(target=self._writer_loop, daemon=True)
        self._writer.start()

    # -- critical path ---------------------------------------------------------

    def save(self, step: int, tree) -> float:
        """Stage a snapshot; returns staging latency in seconds."""
        t0 = time.monotonic()
        leaves, structure = tree_flatten(tree)
        self._structure = structure
        staged = [_stage(l) for l in leaves]          # device -> host staging
        dt = time.monotonic() - t0
        with self._lock:
            self._latest_staged = max(self._latest_staged, step)
        self._q.put(_Staged(step, [a for a, _ in staged],
                            [d for _, d in staged], time.monotonic()))
        return dt

    # -- background writer -------------------------------------------------------

    def _writer_loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            with self._lock:
                stale = item.step < self._latest_staged
            if stale:
                # Update-flag semantics: a newer snapshot supersedes this one
                self.n_skipped_stale += 1
                self._q.task_done()
                continue
            for d in self.dirs:
                self._write_one(d, item)
            with self._lock:
                self._latest_written = max(self._latest_written, item.step)
            self._q.task_done()

    def _write_one(self, d: str, item: _Staged):
        tmp = tempfile.mkdtemp(dir=d)
        try:
            path = os.path.join(tmp, "arrays.npz")
            np.savez(path, **{f"a{i}": a for i, a in enumerate(item.arrays)})
            manifest = {
                "step": item.step,
                "n_arrays": len(item.arrays),
                "shapes": [list(a.shape) for a in item.arrays],
                "dtypes": item.dtypes,
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = os.path.join(d, f"step_{item.step:08d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                      # atomic publish
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc(d)

    def _gc(self, d: str):
        steps = sorted(self._list_steps(d))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(d, f"step_{s:08d}"),
                          ignore_errors=True)

    @staticmethod
    def _list_steps(d: str) -> List[int]:
        out = []
        for name in os.listdir(d):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return out

    # -- barrier / shutdown --------------------------------------------------------

    def wait(self):
        """Drain the staging queue (checkpoint barrier)."""
        self._q.join()

    def close(self):
        self.wait()
        self._q.put(None)
        self._writer.join(timeout=10)

    # -- restore -------------------------------------------------------------------

    def _newest_valid(self):
        """(step, arrays, dtypes) of the newest snapshot that loads, or
        None.  Corrupt/partial replicas are skipped — the Table-3 'access
        replica first' read path."""
        candidates: List[Tuple[int, str]] = []
        for d in self.dirs:
            for s in self._list_steps(d):
                candidates.append((s, os.path.join(d, f"step_{s:08d}")))
        for step, path in sorted(candidates, reverse=True):
            try:
                with open(os.path.join(path, "manifest.json")) as f:
                    manifest = json.load(f)
                with np.load(os.path.join(path, "arrays.npz")) as data:
                    arrays = [data[f"a{i}"]
                              for i in range(manifest["n_arrays"])]
                dtypes = manifest["dtypes"]
                if len(dtypes) != len(arrays) or any(
                        list(a.shape) != shape
                        for a, shape in zip(arrays, manifest["shapes"])):
                    raise ValueError("manifest does not match the arrays")
            except Exception:
                continue                                  # replica failed
            return step, arrays, dtypes
        return None

    def _tree(self, leaves, tree_like):
        structure = self._structure
        if structure is None and tree_like is not None:
            structure = tree_flatten(tree_like)[1]
        if structure is None:
            return leaves
        return tree_unflatten(structure, leaves)

    def restore(self, tree_like=None) -> Optional[Tuple[int, Any]]:
        """Load the newest valid snapshot across replicas.

        Returns (step, tree) or None; the tree's structure is the last
        saved one's, else ``tree_like``'s, else a flat list.  Leaves are
        numpy arrays, bf16 ones widened to float32."""
        found = self._newest_valid()
        if found is None:
            return None
        step, arrays, dtypes = found
        leaves = [_bf16_bits(a).float().numpy() if d == BF16 else a
                  for a, d in zip(arrays, dtypes)]
        return step, self._tree(leaves, tree_like)

    def restore_tensors(self, device="cuda", tree_like=None
                        ) -> Optional[Tuple[int, Any]]:
        """``restore`` as torch tensors on ``device`` in the saved dtypes
        (bf16 bit for bit)."""
        found = self._newest_valid()
        if found is None:
            return None
        step, arrays, dtypes = found
        leaves = [(_bf16_bits(a) if d == BF16 else torch.from_numpy(a))
                  .to(device) for a, d in zip(arrays, dtypes)]
        return step, self._tree(leaves, tree_like)


def _bf16_bits(a: np.ndarray) -> torch.Tensor:
    """A bf16 CPU tensor from its staged uint16 bits."""
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
