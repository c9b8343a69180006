"""Native (C++) host components of the port (counterpart of
:mod:`chainermn_tpu.native`).

The C++ sources are framework-neutral, so the port keeps its own copies
under ``src/`` and builds them the same on-demand way: ``g++`` compiles a
component into ``chainermn_tpu_torch/build/`` at its first use (never at
import), and a build failure raises — nothing falls back to a Python
implementation. Ported so far: the async checkpoint writer
(:mod:`chainermn_tpu_torch.native.ckpt_writer`).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

#: component name -> (source file, extra compile flags)
COMPONENTS = {
    "ckpt_writer": ("ckpt_writer.cpp", ["-pthread"]),
}


class NativeBuildError(RuntimeError):
    pass


def lib_path(name: str) -> Path:
    """Path of the compiled component ``name``, built on demand. The
    library's name carries a hash of its source and flags, so an edited
    source is rebuilt; the build writes a temporary file and renames it,
    so processes that build at once never load a half-written one."""
    src_name, flags = COMPONENTS[name]
    src = SRC_DIR / src_name
    cxx = os.environ.get("CXX", "g++")
    cmd = [cxx, "-O2", "-shared", "-fPIC", "-Wall", *flags]
    digest = hashlib.sha256(" ".join(cmd).encode() + src.read_bytes())
    lib = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([*cmd, "-o", tmp, str(src)],
                                  capture_output=True, text=True,
                                  timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"building {lib.name} failed: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(
                f"building {lib.name} failed:\n{proc.stderr[-2000:]}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


__all__ = ["NativeBuildError", "lib_path"]
