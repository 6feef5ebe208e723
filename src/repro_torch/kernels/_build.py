"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library under
``<repo>/build/repro_torch_kernels/`` (listed in ``.gitignore``), named by
a hash of its source, the shared headers ``csrc/*.cuh`` and the flags so
an edited kernel is rebuilt, and loaded with ``ctypes``.  :func:`build` starts one ``nvcc`` per source, all at
once.  Nothing here runs at import time, and nothing is built on a
machine that never launches a kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["BUILD_DIR", "SOURCES", "build", "load"]

SOURCES = ("sssj_cand", "sssj_dense", "gate_ub", "flash_attn")
CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _paths(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns ``{name: {"path",
    "seconds", "log"}}`` (``log`` holds ``-Xptxas -v``'s register and
    spill report; seconds 0 and an empty log for a library already
    built).  Raises with the compiler's output if a build fails."""
    out: Dict[str, dict] = {}
    procs = {}
    try:
        for name in names:
            src, lib = _paths(name)
            if lib.exists():
                out[name] = {"path": str(lib), "seconds": 0.0, "log": ""}
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True),
                tmp, lib, time.monotonic(),
            )
        for name, (proc, tmp, lib, t0) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
            out[name] = {"path": str(lib),
                         "seconds": time.monotonic() - t0, "log": log}
    finally:
        for proc, *_ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(build([name])[name]["path"])
