#!/usr/bin/env python3
"""Time the two ways of building the flash-attention library from clean.

    python3 chainermn_tpu_torch/tools/build_times.py

The library has three sources (``ops/flash_attention.py::SOURCES``). Two
builds are timed, each from clean into a scratch directory under
``chainermn_tpu_torch/build/``:

- ``one_nvcc``: one ``nvcc -shared`` over all the sources;
- ``per_source``: what ``_build.load_library`` does — one ``nvcc -c``
  per source, started together, then a link.

They run in the order one, per-source, per-source, one, and the script
prints one JSON line of the seconds of each run. Needs ``nvcc``; no card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from chainermn_tpu_torch.ops import _build  # noqa: E402
from chainermn_tpu_torch.ops.flash_attention import SOURCES  # noqa: E402


def main() -> int:
    paths = [_build.CSRC_DIR / s for s in SOURCES]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {"one_nvcc": [], "per_source": []}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for i, way in enumerate(("one_nvcc", "per_source", "per_source",
                                 "one_nvcc")):
            out = Path(tmp) / f"libflash_attention_{i}.so"
            t0 = time.perf_counter()
            if way == "one_nvcc":
                subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                                "-shared", "-o", str(out), *map(str, paths)],
                               check=True)
            else:
                _build.compile_library("flash_attention", paths, out)
            seconds[way].append(time.perf_counter() - t0)
    print(json.dumps({"library": "flash_attention", "sources": SOURCES,
                      "seconds": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
