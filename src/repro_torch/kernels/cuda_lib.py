"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, under ``build/kernels/`` at
the repository root; the file name carries a hash of the sources and flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
Every ``.cu`` file is compiled by its own ``nvcc`` process, all started
together, and then linked.  The library is bound with ``ctypes``; nothing is
built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None     # the loaded library, once per process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit on PATH or CUDA_HOME")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cus, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libvalet_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Tuple[Path, float, str]:
    """Compile the kernels if the hashed library is missing.

    Returns the library's path, the nvcc wall seconds (0 when it was already
    built) and the compiler output; ``verbose`` adds ``-Xptxas -v``
    (registers, shared memory and spills per kernel) to a fresh build."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cus, _ = _sources()
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (p.stem + ".o") for p in cus]
        procs = [subprocess.Popen([nvcc, *flags, "-c", str(p), "-o", str(o)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for p, o in zip(cus, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(c.name, log) for c, p, log in zip(cus, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {name}\n{log}" for name, log in failed))
        so = Path(tmp) / out.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                               "-o", str(so)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(so, out)      # atomic: a concurrent loader sees all or nothing
    return out, time.perf_counter() - t0, "".join(logs)


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()[0]))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.valet_paged_attention.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                          i, i, i, i, i, i, f, p]
    lib.valet_paged_attention.restype = i
    lib.valet_paged_attention_partials.argtypes = [p] * 11 + [i] * 13 + [f, p]
    lib.valet_paged_attention_partials.restype = i
    lib.valet_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i,
                                          f, p]
    lib.valet_flash_attention.restype = i
    lib.valet_ssd_scan.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                   i, p]
    lib.valet_ssd_scan.restype = i
    q = ctypes.c_longlong
    lib.valet_host_pages.argtypes = [p, p, i, p, i, q, i, p, p]
    lib.valet_host_pages.restype = i
    lib.valet_host_pages_move.argtypes = [p, p, p, i, p, i, i, q, i, p, p]
    lib.valet_host_pages_move.restype = i
    lib.valet_moe_gemm.argtypes = [p, p, p, i, p, p, p, i, i, i, i, i, p]
    lib.valet_moe_gemm.restype = i
    lib.valet_kv_append.argtypes = [p] * 7 + [i, q, i, i, i, i, p]
    lib.valet_kv_append.restype = i
    lib.valet_graph_nodes.argtypes = [p, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.valet_graph_nodes.restype = i
    _lib = lib
    return lib


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a graph captured with ``keep_graph=True`` and not
    yet reset."""
    n = ctypes.c_ulonglong()
    check(load().valet_graph_nodes(graph.raw_cuda_graph(), ctypes.byref(n)),
          "cudaGraphGetNodes")
    return n.value


def dtype_code(dtype) -> int:
    """The C interface's dtype code (0 = f32, 1 = bf16); raises otherwise."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernel takes float32 or bfloat16, not {dtype}")
    return codes[dtype]


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
