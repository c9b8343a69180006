#!/usr/bin/env python3
"""Time the ZeRO, FSDP and plain AdamW steps of ``chip_smoke.py``'s
phase 15 (d) on one card, or another checkout's, by the same clock.

    python3 chainermn_tpu_torch/tools/zero_fsdp_steps.py \\
        [--root DIR] [--steps 12] [--modes plain,zero,fsdp]

Phase 7's LM (Transformer-base, ``flash_attention``, B 8 x T 2048 packed
documents) takes ``--steps`` steps under each mode at world size 1 over
a one-rank NCCL communicator: plain AdamW behind the packed all-reduce
(``create_multi_node_optimizer``), ``zero_shard_optimizer`` over AdamW,
and FSDP (``create_fsdp_train_state``). ``--root`` names the checkout
whose ``chainermn_tpu_torch`` runs (default: this one; its flash library
builds there), so a parent tree's ZeRO is timed by this script's clock.

One JSON line per mode, after the card's name and power limit: the host
ms of each step (each ending in a host read of its loss; the first is a
warm-up and left out of the median), the ``torch.distributed`` calls of
the last step, the peak memory and the losses. Needs one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--modes", default="plain,zero,fsdp")
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
        print("zero_fsdp_steps: no CUDA device is visible", file=sys.stderr)
        return 2
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.examples.transformer.train_transformer_lm \
        import pack_documents
    from chainermn_tpu_torch.ops import flash_attention as fa

    if root not in Path(fa.__file__).resolve().parents:
        raise RuntimeError(f"imported {fa.__file__}, not from {root}")
    print(cs._nvidia_smi(), flush=True)
    fa.load_kernel()
    comm = create_communicator("pure_nccl")
    rng = np.random.default_rng(0)
    batches = [tuple(torch.from_numpy(x).cuda()
                     for x in pack_documents(rng, 8, 2048))
               for _ in range(args.steps)]
    for mode in args.modes.split(","):
        if mode == "plain":
            losses, _, calls, peak, ms, _ = cs._tp_train(
                torch, np, comm, batches, tp=False)
        else:
            losses, peak, calls, state, _, ms = cs._zero_fsdp_run(
                torch, comm, batches, mode)
            del state
        print("zero/fsdp steps", json.dumps({
            "root": str(root), "mode": mode,
            "step_ms_p50": statistics.median(ms[1:]), "step_ms": ms,
            "dist_calls_last_step": calls, "peak_memory_bytes": peak,
            "losses": losses}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
