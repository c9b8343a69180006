#!/usr/bin/env python3
"""Time K4's bf16 rows on one card by split plan, or another checkout's
K4 by the same clock.

    python3 chainermn_tpu_torch/tools/k4_sweep.py \\
        [--root DIR] [--plans 1024:128,2048:64] [--cases A,B] [--profile]

For each bf16 row of ``chip_smoke.py``'s phase 2 (``_k4_cases``: the
16-slot decode tick, GQA, a 256 window, head dims 32 and 128, MQA, a
4-token span at group 4, the serving path's short contexts, the
prefills), or only those that ``--cases`` names,
the wrapper ``paged_flash_decode`` is timed with ``chip_smoke._time_ms``
(median of 20 launches after a 96 MB rewrite of L2, CUDA events, a spin
kernel ahead), beside the row's ``bound_ms``:

- ``--root`` names the checkout whose ``chainermn_tpu_torch`` is timed
  (default: this one), so a parent tree's K4 is timed by this script's
  clock; its library builds in that checkout;
- ``--plans`` sets ``SPLIT_TARGET_CTAS:SPLIT_MIN_KEYS`` of the split
  route's ``_split_plan`` in turn (a tree without the split route
  ignores it);
- ``--profile`` adds each K4 kernel's mean device time per call from
  ``torch.profiler`` over ten calls, each after a read of the 96 MB
  buffer.

One JSON line per (row, plan), after the card's name and power limit
and the clock's floor: the same timing of a one-element ``add_``, the
launch and event overhead that every time here includes. Needs one
card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def _per_kernel_us(torch, cs, call, flush, n=10):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.sum()
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        kernel = next((k for k in cs.K4_KERNELS if k in ev.key), None)
        if kernel:
            dev = getattr(ev, "self_device_time_total", None)
            if dev is None:
                dev = ev.self_cuda_time_total
            out[kernel] = dev / n
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--plans", default="")
    ap.add_argument("--cases", default="",
                    help="comma-separated case names (default: every "
                    "bf16 row)")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k4_sweep: no CUDA device is visible", file=sys.stderr)
        return 2
    from chainermn_tpu_torch.ops import paged_decode as pd

    if root not in Path(pd.__file__).resolve().parents:
        raise RuntimeError(f"imported {pd.__file__}, not from {root}")
    print(cs._nvidia_smi(), flush=True)
    pd.load_kernel()
    has_split = hasattr(pd, "_split_plan")
    plans = [tuple(int(x) for x in p.split(":"))
             for p in args.plans.split(",") if p] if has_split else []
    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(24 * 2**20, dtype=torch.float32, device="cuda")
    tiny = torch.zeros(1, device="cuda")
    print("K4 sweep floor", json.dumps({"root": str(root), "ms": cs._time_ms(
        torch, lambda: tiny.add_(1), flush)}), flush=True)
    wanted = {c for c in args.cases.split(",") if c}
    for name, kw, window, dtypes in cs._k4_cases(np):
        if "bfloat16" not in dtypes or (wanted and name not in wanted):
            continue
        inputs = cs._k4_case(torch, gen, dtype=torch.bfloat16, **kw)
        for r in kw.get("scratch_rows", ()):
            inputs[4][r] = 0
        nbytes, ops = cs._k4_work(np, inputs[0], inputs[1], inputs[3],
                                  inputs[4], window)
        bound_ms, bound_by = cs._bound(nbytes, ops, torch.bfloat16)
        for plan in plans or [None]:
            if plan is not None:
                pd.SPLIT_TARGET_CTAS, pd.SPLIT_MIN_KEYS = plan
            row = {"root": str(root), "case": name, "plan": plan,
                   "bound_ms": bound_ms, "bound_by": bound_by}

            def call():
                return pd.paged_flash_decode(*inputs, window=window)

            if has_split:  # the route whose count a call moves
                before = dict(pd.ROUTE_LAUNCHES)
                call()
                row["route"] = next(r for r, n in pd.ROUTE_LAUNCHES.items()
                                    if n != before[r])
                row["split_plan"] = pd._split_plan(
                    kw["B"], kw["Hkv"], inputs[3].shape[1],
                    inputs[1].shape[1])
            row["ms"] = cs._time_ms(torch, call, flush)
            if args.profile:
                row["kernel_us"] = _per_kernel_us(torch, cs, call, flush)
            print("K4 sweep", json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
