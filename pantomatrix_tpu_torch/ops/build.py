"""Build the hand-written CUDA kernels of ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` into ``build/torch_kernels/lib<name>-<hash>.so`` beside the package (the
hash is over the source and the compiler flags, so an edit to either rebuilds), then
loaded with ``ctypes``.
Nothing is compiled or loaded at import: a kernel builds when a CUDA tensor first
reaches its wrapper, or when a caller asks for :func:`build` up front. Several
sources build in parallel, one ``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels of "
        "pantomatrix_tpu_torch/csrc are built from source at first use on the GPU")


def library_path(name: str, flags: Optional[Iterable[str]] = None) -> Path:
    """Where the library of ``csrc/<name>.cu`` built with ``flags`` (default
    ``NVCC_FLAGS``) lives: named by a hash of the source and the flags together, so that
    a change to either builds anew."""
    src = CSRC_DIR / f"{name}.cu"
    flags = NVCC_FLAGS if flags is None else list(flags)
    digest = hashlib.sha256(src.read_bytes() + "\0".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str], flags: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named source whose library is missing, all at once, with ``flags``
    (default ``NVCC_FLAGS``); return the library paths. The compiler's report
    (``-Xptxas -v``: registers, shared memory, spills) is kept in ``<library>.log``.
    Raises on a failed build."""
    flags = NVCC_FLAGS if flags is None else list(flags)
    paths = {name: library_path(name, flags) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *flags, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    failures = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        lib = todo[name]
        Path(f"{lib}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib


__all__ = ["BUILD_DIR", "CSRC_DIR", "build", "library_path", "load", "nvcc_path"]
