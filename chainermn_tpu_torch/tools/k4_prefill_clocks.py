#!/usr/bin/env python3
"""Where the time of K4's prefill kernel goes, phase by phase, on one card.

    python3 chainermn_tpu_torch/tools/k4_prefill_clocks.py [--cases A,B]

Builds the ``paged_decode`` sources with ``-DK4_PREFILL_CLOCKS``, which
turns on the clock64 probes of ``csrc/paged_prefill_sm90.cu``, into a
library of their own in ``chainermn_tpu_torch/build/`` (the library that
the port loads has no probes), makes it the one that the wrapper
``paged_flash_decode`` launches, and calls the wrapper once on each named
row of ``chip_smoke.py``'s phase 2 (``_k4_cases``; by default the
prefills at T 32, 512 and 2048 and the decode tick of 32 rows per kv
head), after three warm-up calls and a 96 MB rewrite of L2. One JSON
line per row: the launch's time by CUDA events, its error against the
plain version, and for the CTAs that walk the most key tiles the mean
clock64 cycles of thread 0 in the whole CTA and in its prologue (q copy,
positions, the first plans and copy), and per key tile in the wait for
the tile's copy, S, the issue of the next tile's copy, the softmax and P
V (with the plan of a later tile made under it); beside them the card's
name, power limit and SM clock. Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
PHASES = ("wait", "S", "issue", "softmax", "PV")
DEFAULT_CASES = "prefill_T32,prefill_T512,prefill_T2048,decode_group32_R32"
CLOCK_CTAS = 4096  # kClockCtas of the kernel source


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", default=DEFAULT_CASES)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k4_prefill_clocks: no CUDA device is visible",
              file=sys.stderr)
        return 2
    from chainermn_tpu_torch.ops import paged_decode as pd
    from chainermn_tpu_torch.ops._build import load_library

    print(cs._nvidia_smi(), flush=True)
    lib = pd._bind(load_library("paged_decode_clocks", pd.SOURCES,
                                defines=("K4_PREFILL_CLOCKS",)))
    lib.paged_prefill_clocks.argtypes = [ctypes.c_void_p]
    pd._lib = lib  # the wrapper launches the probed build
    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(24 * 2**20, dtype=torch.float32, device="cuda")
    clocks = (ctypes.c_longlong * (CLOCK_CTAS * 8))()
    cases = {name: (kw, window) for name, kw, window, _ in cs._k4_cases(np)}
    for name in args.cases.split(","):
        kw, window = cases[name]
        q, kp, vp, tables, pos = cs._k4_case(torch, gen,
                                             dtype=torch.bfloat16, **kw)
        for r in kw.get("scratch_rows", ()):
            pos[r] = 0
        B, T, Hq, D = q.shape
        Hkv = kp.shape[2]
        if pd._route(q.dtype, T, Hq, Hkv) != "mma":
            raise ValueError(f"{name} does not take the mma route")

        def launch():
            return pd.paged_flash_decode(q, kp, vp, tables, pos,
                                         window=window)

        for _ in range(3):
            launch()
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch()
        end.record()
        end.synchronize()
        want = pd.paged_flash_decode_reference(q, kp, vp, tables, pos,
                                               window=window)
        err = (out.float() - want.float()).abs().max().item()
        if lib.paged_prefill_clocks(clocks):
            raise RuntimeError("reading the clocks failed")
        ctas = -(-T * (Hq // Hkv) // pd.PREFILL_TILE) * Hkv * B
        c = np.frombuffer(clocks, dtype=np.int64).reshape(CLOCK_CTAS, 8)
        c = c[:min(ctas, CLOCK_CTAS)]
        top = c[c[:, 7] == c[:, 7].max()]
        tiles = float(top[:, 7].mean())
        sm_mhz = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout.split()[0]
        print("K4 prefill clocks", json.dumps({
            "case": name, "ms": start.elapsed_time(end), "max_abs_err": err,
            "ctas": ctas, "tiles_of_the_longest": tiles,
            "cycles": {"cta": float(top[:, 0].mean()),
                       "prologue": float(top[:, 1].mean())},
            "cycles_per_tile": {ph: float(top[:, 2 + k].mean()) / max(1.0,
                                                                     tiles)
                                for k, ph in enumerate(PHASES)},
            "sm_clock_mhz": float(sm_mhz)}), flush=True)
        if err > cs.TOLERANCE["torch.bfloat16"]:
            raise AssertionError(f"{name}: max abs err {err}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
