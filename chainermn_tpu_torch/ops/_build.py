"""Build the port's CUDA sources into shared libraries at first use.

Each kernel is CUDA C++ for ``sm_90a`` with a plain C entry point,
compiled by ``nvcc`` into ``chainermn_tpu_torch/build/`` and loaded with
``ctypes`` — seconds per build, where a source that includes PyTorch's
headers takes minutes. A library's sources compile to objects by one
``nvcc`` each, all started together, and one more call links them
(``chainermn_tpu_torch/tools/build_times.py`` times this against one
``nvcc`` over all the sources). A library is rebuilt when the hash of
its sources, headers and flags changes. Nothing is built at import: the
first call of a kernel's wrapper on a CUDA tensor builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC",
)

#: name -> {"path", "seconds", "built"} for every library loaded in this
#: process (``built`` False when an up-to-date library was reused).
BUILD_LOG: dict = {}

_LOADED: dict = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``PATH``, then ``$CUDA_HOME/bin``, then
    ``/usr/local/cuda/bin``. Raises when there is none — the CUDA kernels
    cannot be built, and nothing falls back to another implementation."""
    candidates = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home:
            candidates.append(os.path.join(home, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin, /usr/local/cuda/bin):"
        " the port's CUDA kernels are built from chainermn_tpu_torch/csrc at "
        "first use and need the CUDA toolkit on the machine with the card"
    )


def _run(name: str, cmd: Sequence[str]) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )


def compile_library(name: str, paths: Sequence[Path], out: Path,
                    flags: Sequence[str] = NVCC_FLAGS) -> None:
    """Build the shared library ``out`` from ``paths``: one ``nvcc -c``
    per source, all started together, then a link. The objects live in a
    temporary directory beside ``out`` that goes whether or not nvcc
    succeeds."""
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, f"{p.stem}.o") for p in paths]
        cmds = [[nvcc, *flags, "-c", "-o", o, str(p)]
                for p, o in zip(paths, objs)]
        with ThreadPoolExecutor(len(cmds)) as pool:
            list(pool.map(lambda c: _run(name, c), cmds))
        lib = os.path.join(tmp, out.name)
        _run(name, [nvcc, *flags, "-shared", "-o", lib, *objs])
        os.replace(lib, out)


def load_library(name: str, sources: Sequence[str],
                 defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>`` from ``sources`` (file
    names under ``csrc/``), with ``-D`` for each of ``defines``. Cached
    per process."""
    if name in _LOADED:
        return _LOADED[name]
    paths = [CSRC_DIR / s for s in sources]
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    digest = hashlib.sha256(" ".join(flags).encode())
    for p in paths + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    built = False
    if not out.exists():
        compile_library(name, paths, out, flags)
        built = True
    lib = ctypes.CDLL(str(out))
    BUILD_LOG[name] = {"path": str(out),
                       "seconds": time.perf_counter() - t0, "built": built}
    _LOADED[name] = lib
    return lib
