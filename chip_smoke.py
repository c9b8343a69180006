#!/usr/bin/env python3
"""Drive the PyTorch port (``chainermn_tpu_torch``) once on one NVIDIA card.

    python3 chip_smoke.py   # the whole check, one card

Phases, each printed before the next starts; any failure raises and the
script exits non-zero without its final ``ok`` line:

1. Environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions, and the build of every CUDA kernel of the path from
   ``chainermn_tpu_torch/csrc`` (timed).
2. Kernel vs plain version on the card: the paged flash-decoding kernel
   (K4) against ``paged_flash_decode_reference`` at the serving path's
   shapes — decode (16 slots, positions over [0, 2047], two all-scratch
   rows, a poisoned scratch block), prefill (T = 128 and 512), GQA and a
   sliding window — in fp32 and bf16, with the kernel, the plain version
   and one library call (``scaled_dot_product_attention`` over the
   gathered dense view, a yardstick the port never calls) timed with CUDA
   events, and each shape's least possible time (``bound_ms``).
3. Serving at full width: the Transformer-base LM (6 layers, d_model 512,
   8 heads, vocab 32000, bf16, seeded random weights) behind
   ``ServingEngine(num_slots=16, max_len=2048, kv_block_size=64,
   decode_attend_impl='fused')`` under ``Scheduler('prefill_priority')``
   serves 24 requests. The kernel's launch count over this run must equal
   ``num_layers * (prefills + decode steps)``.
4. Stream equivalence: 8 requests through two fp32 engines, ``'fused'``
   and ``'xla'``; greedy streams must be identical, except at a true
   near-tie (top-2 logit gap < 1e-4).
5. Where the time goes: a ``torch.profiler`` window over 16 more
   requests on the bf16 engine — wall vs device-busy time and the device
   time of the busiest kernels.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM data-sheet peaks (dense): HBM bytes/s and ops/s by input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
#: kernel vs plain version: fp32 accumulation on both sides, sums in
#: another order (fp32); bf16 output and P rounded to bf16 at different
#: points of the online vs one-pass softmax (a few bf16 ulps of O(1)).
TOLERANCE = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
#: a greedy divergence between the fp32 engines is accepted only at a
#: true near-tie of the top-2 logits.
NEAR_TIE = 1e-4
TIMING_REPS = 20


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 2

def _k4_case(torch, gen, *, B, T, Hq, Hkv, D=64, bs=64, M=32, dtype,
             positions, scratch_rows=(), poison=1e9):
    """Pools, tables and q for one K4 shape: each row owns the blocks
    covering ``[0, positions[b] + T)`` (interleaved in the pool), the rest
    of its table is scratch; scratch block 0 is poisoned."""
    nb = B * M + 1
    kp = torch.randn(nb, bs, Hkv, D, generator=gen)
    vp = torch.randn(nb, bs, Hkv, D, generator=gen)
    kp[0] = poison
    vp[0] = poison
    tables = torch.zeros(B, M, dtype=torch.int32)
    perm = torch.randperm(nb - 1, generator=gen) + 1
    nxt = 0
    for b in range(B):
        if b in scratch_rows:
            continue
        n = min(M, (int(positions[b]) + T - 1) // bs + 1)
        tables[b, :n] = perm[nxt:nxt + n].int()
        nxt += n
    q = torch.randn(B, T, Hq, D, generator=gen)
    pos = torch.tensor(positions, dtype=torch.int32)
    return [t.cuda() for t in (q.to(dtype), kp.to(dtype), vp.to(dtype),
                               tables, pos)]


def _k4_work(np, q, k_pool, tables, positions, window, scratch=0):
    """Bytes K4 must move and operations it must do on THESE inputs: the
    K/V of every key some row can see, in a block that is not scratch,
    read once; q read and the output written once; tables and positions;
    4 * D operations per (row, visible key)."""
    B, T, Hq, D = q.shape
    bs, Hkv = k_pool.shape[1], k_pool.shape[2]
    M = tables.shape[1]
    group = Hq // Hkv
    tabs = tables.cpu().numpy()
    pos = positions.cpu().numpy().astype(np.int64)
    kv_tokens = ops = 0
    for b in range(B):
        kmax = min(int(pos[b]) + T - 1, M * bs - 1)
        kmin = max(0, int(pos[b]) - window + 1) if window else 0
        keys = np.arange(kmin, kmax + 1)
        live = tabs[b, keys // bs] != scratch
        kv_tokens += int(live.sum())
        qpos = pos[b] + np.arange(T)[:, None]
        vis = live[None] & (keys[None] <= qpos)
        if window:
            vis &= keys[None] > qpos - window
        ops += 4 * D * group * int(vis.sum())
    esz = q.element_size()
    nbytes = (2 * kv_tokens * Hkv * D * esz + 2 * q.numel() * esz
              + tables.numel() * 4 + positions.numel() * 4)
    return nbytes, ops


def _bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(torch, fn, flush):
    """Median device time of ``fn`` over TIMING_REPS runs, each with a
    cold L2 (a 96 MB buffer is rewritten first) and a spin kernel ahead
    of it so the host's enqueue time stays outside the event pair."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        flush.zero_()
        torch.cuda._sleep(5_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _sdpa_yardstick(torch, F, q, k_pool, v_pool, tables, positions, window):
    """One library call computing the same attention: SDPA over the
    pre-gathered dense ``[B, M * bs]`` view with a boolean mask (the
    gather is set-up, not timed)."""
    B, T, Hq, D = q.shape
    bs, Hkv = k_pool.shape[1], k_pool.shape[2]
    L = tables.shape[1] * bs
    t = tables.long()
    k = k_pool[t].reshape(B, L, Hkv, D).transpose(1, 2).contiguous()
    v = v_pool[t].reshape(B, L, Hkv, D).transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    kpos = torch.arange(L, device=q.device)
    qpos = positions.long()[:, None] + torch.arange(T, device=q.device)
    live = (t != 0)[:, :, None].expand(B, t.shape[1], bs).reshape(B, L)
    mask = live[:, None, :] & (kpos[None, None] <= qpos[:, :, None])
    if window:
        mask &= kpos[None, None] > qpos[:, :, None] - window
    mask = mask[:, None]  # [B, 1, T, L]
    return lambda: F.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask, enable_gqa=Hq != Hkv)


def phase_kernels(torch, np, F):
    from chainermn_tpu_torch.ops import paged_decode as pd

    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(24 * 2**20, dtype=torch.float32, device="cuda")
    spread = [int(x) for x in np.linspace(0, 2047, 16)]
    cases = [
        ("decode", dict(B=16, T=1, Hq=8, Hkv=8, positions=spread,
                        scratch_rows=(3, 11)), None),
        ("prefill_T128", dict(B=1, T=128, Hq=8, Hkv=8, positions=[0]), None),
        ("prefill_T512", dict(B=1, T=512, Hq=8, Hkv=8, positions=[0]), None),
        ("decode_gqa", dict(B=16, T=1, Hq=8, Hkv=2, positions=spread,
                            scratch_rows=(5,)), None),
        ("decode_window256", dict(B=16, T=1, Hq=8, Hkv=8, positions=spread,
                                  scratch_rows=(7,)), 256),
    ]
    rows = []
    for name, kw, window in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = _k4_case(torch, gen, dtype=dtype, **kw)
            for r in kw.get("scratch_rows", ()):
                args[4][r] = 0  # a released slot: all-scratch row at 0
            got = pd.paged_flash_decode(*args, window=window)
            torch.cuda.synchronize()
            want = pd.paged_flash_decode_reference(*args, window=window)
            err = (got.float() - want.float()).abs().max().item()
            tol = TOLERANCE[str(dtype)]
            zero_rows = all(bool((got[r] == 0).all())
                            for r in kw.get("scratch_rows", ()))
            ok = (err <= tol and bool(torch.isfinite(got).all())
                  and zero_rows)
            row = {"case": name, "dtype": str(dtype).split(".")[-1],
                   "shape": {k: kw[k] for k in ("B", "T", "Hq", "Hkv")},
                   "window": window, "max_abs_err": err, "tolerance": tol}
            if dtype == torch.bfloat16:  # the serving dtype: time it
                nbytes, ops = _k4_work(np, args[0], args[1], args[3],
                                       args[4], window)
                bound_ms, bound_by = _bound(nbytes, ops, dtype)
                row.update(
                    ms=_time_ms(torch, lambda: pd.paged_flash_decode(
                        *args, window=window), flush),
                    plain_ms=_time_ms(
                        torch, lambda: pd.paged_flash_decode_reference(
                            *args, window=window), flush),
                    library_ms=_time_ms(torch, _sdpa_yardstick(
                        torch, F, *args, window), flush),
                    bound_ms=bound_ms, bound_by=bound_by,
                    bytes=nbytes, ops=ops)
            print("K4", json.dumps(row), flush=True)
            if not ok:
                raise AssertionError(
                    f"K4 {name} {dtype}: max abs err {err} vs tolerance "
                    f"{tol}, finite={bool(torch.isfinite(got).all())}, "
                    f"all-scratch rows zero={zero_rows}")
            rows.append(row)
    return rows


# ---------------------------------------------------------------- phase 3

def _requests(np, n, seed, vocab):
    rs = np.random.RandomState(seed)
    lens = rs.randint(16, 401, size=n)
    news = rs.randint(32, 65, size=n)
    return [(rs.randint(1, vocab, size=int(p)).tolist(), int(g))
            for p, g in zip(lens, news)]


def _serve(engine, reqs, policy="prefill_priority"):
    from chainermn_tpu_torch.serving import Request, Scheduler

    sched = Scheduler(engine, policy=policy)
    ids = [sched.submit(Request(prompt=p, max_new_tokens=g))
           for p, g in reqs]
    results = sched.run()
    return [results[i]["generated"] for i in ids], sched


def phase_serving(torch, np):
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.ops import paged_decode as pd
    from chainermn_tpu_torch.serving import ServingEngine

    model = TransformerLM(seed=0)  # Transformer-base, bf16, on the card
    engine = ServingEngine(model, num_slots=16, max_len=2048,
                           kv_block_size=64, decode_attend_impl="fused")
    reqs = _requests(np, 24, 0, model.vocab_size)
    _serve(engine, _requests(np, 2, 1, model.vocab_size))  # warm-up
    torch.cuda.synchronize()
    pd.LAUNCHES = 0
    t0 = time.perf_counter()
    streams, sched = _serve(engine, reqs)
    wall = time.perf_counter() - t0
    launches = pd.LAUNCHES
    summary = sched.summary()
    expected = model.num_layers * (summary["prefills"]
                                   + summary["decode_steps"])
    print("serving summary", json.dumps(summary), flush=True)
    print(f"serving: {len(reqs)} requests in {wall:.3f} s wall, decode step "
          f"p50 {summary['token_ms_p50']} ms p99 {summary['token_ms_p99']} "
          f"ms, peak pool blocks in use {engine.peak_blocks_in_use}/"
          f"{engine.num_blocks - 1}, K4 launches {launches} (expected "
          f"{expected})", flush=True)
    if launches == 0 or launches != expected:
        raise AssertionError(f"K4 launches {launches} != num_layers x "
                             f"(prefills + decode steps) = {expected}")
    for (prompt, n_new), gen in zip(reqs, streams):
        if len(gen) != n_new or not all(0 <= t < model.vocab_size
                                        for t in gen):
            raise AssertionError(f"malformed stream: {len(gen)} tokens for "
                                 f"max_new_tokens={n_new}")
    if engine.blocks_in_use != 0 or engine.free_slot_count != 16:
        raise AssertionError("slots or pool blocks leaked after the run")
    with torch.no_grad():
        prompt, _ = reqs[0]
        logits = model(torch.tensor([prompt + streams[0]], device="cuda"))
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("non-finite logits at full width")
    return launches, summary, engine


# ---------------------------------------------------------------- phase 4

def phase_equivalence(torch, np):
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import ServingEngine

    # fp32 products must be full fp32 for the two attend impls to agree
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = TransformerLM(compute_dtype=torch.float32, seed=0)
    reqs = _requests(np, 8, 2, model.vocab_size)
    out = {}
    for impl in ("fused", "xla"):
        engine = ServingEngine(model, num_slots=8, max_len=2048,
                               kv_block_size=64, decode_attend_impl=impl)
        out[impl], _ = _serve(engine, reqs)
        del engine
    n_tokens = sum(len(s) for s in out["fused"])
    for (prompt, _), a, b in zip(reqs, out["fused"], out["xla"]):
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        with torch.no_grad():
            logits = model(torch.tensor([prompt + a[:i]], device="cuda"))
        top2 = torch.topk(logits[0, -1].float(), 2).values
        gap = float(top2[0] - top2[1])
        print(f"stream divergence at generated token {i}: top-2 logit gap "
              f"{gap:.3e}", flush=True)
        if gap >= NEAR_TIE:
            raise AssertionError(f"fused and xla streams diverge at token {i}"
                                 f" with a top-2 gap {gap} >= {NEAR_TIE}")
    print(f"equivalence: fp32 fused == xla over {len(reqs)} requests, "
          f"{n_tokens} generated tokens (TF32 off)", flush=True)


def phase_profile(torch, np, engine):
    """Where the serving time goes: a torch.profiler window over 16 more
    requests on the bf16 engine — wall vs device-busy time (the sum of
    the kernels' device time; one stream, so they do not overlap) and the
    device time of the busiest kernels, K4 among them."""
    from torch.profiler import ProfilerActivity, profile

    reqs = [(p, 16) for p, _ in _requests(np, 16, 3, 32000)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, sched = _serve(engine, reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []  # device-side events only: CPU ops would count twice
    for ev in prof.key_averages():
        if "CUDA" in str(ev.device_type):
            dev = getattr(ev, "self_device_time_total", None)
            if dev is None:
                dev = ev.self_cuda_time_total
            kernels.append((dev / 1e3, ev.count, ev.key))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    k4 = sum(k[0] for k in kernels if "paged_decode_kernel" in k[2])
    s = sched.summary()
    forwards = s["prefills"] + s["decode_steps"]
    launched = sum(k[1] for k in kernels)
    print(f"profile: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
          f"({busy / wall_ms:.4f} of wall), K4 {k4:.3f} ms "
          f"({k4 / busy:.4f} of busy), {s['prefills']} prefills + "
          f"{s['decode_steps']} decode steps, {launched} device ops "
          f"({launched / forwards:.1f} per forward)", flush=True)
    for ms, count, name in kernels[:12]:
        print(f"profile: {ms:10.3f} ms {count:6d}x {name[:100]}", flush=True)
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")


# ---------------------------------------------------------------- main

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this check runs on the "
              "card only", file=sys.stderr)
        return 2
    if not (ROOT / "chainermn_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: chainermn_tpu_torch/ not found next to "
              f"{Path(__file__).name}; run it from a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch.nn.functional as F

    from chainermn_tpu_torch.ops import paged_decode as pd
    from chainermn_tpu_torch.ops._build import BUILD_LOG

    smi = _nvidia_smi()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)
    pd.load_kernel()
    log = BUILD_LOG["paged_decode"]
    print(f"build: paged_decode {'built' if log['built'] else 'reused'} in "
          f"{log['seconds']:.3f} s -> {log['path']}", flush=True)

    rows = phase_kernels(torch, np, F)
    launches, summary, engine = phase_serving(torch, np)
    phase_equivalence(torch, np)
    phase_profile(torch, np, engine)

    main_row = next(r for r in rows
                    if r["case"] == "decode" and r["dtype"] == "bfloat16")
    kernels = {"kernels": [{
        "name": "paged_flash_decode",
        "route": "cuda",
        "source": "chainermn_tpu_torch/csrc/paged_decode.cu",
        "replaces": "chainermn_tpu/ops/paged_decode.py:167",
        "launches": launches,
        "max_abs_err": main_row["max_abs_err"],
        "tolerance": main_row["tolerance"],
        "ms": main_row["ms"],
        "kernel_ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "cases": rows,
    }]}
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
