#!/usr/bin/env python3
"""Drive the PyTorch port (``chainermn_tpu_torch``) once on one NVIDIA card.

    python3 chip_smoke.py   # the whole check, one card

Phases, each printed before the next starts; any failure raises and the
script exits non-zero without its final ``ok`` line:

1. Environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions, and the build of every CUDA library from
   ``chainermn_tpu_torch/csrc`` — ``paged_decode`` and ``flash_attention``,
   one ``nvcc`` per source, started together (timed); then a count of
   the tensor-core instructions (``HMMA``/``HGMMA``) in the bf16 K1, K2
   and K3 kernels and K4's prefill kernel from ``cuobjdump -sass`` of
   the built libraries, and their registers and stack bytes from
   ``cuobjdump -res-usage``, and those of K4's four kernels.
2. Kernel vs plain version on the card: the paged flash-decoding kernels
   (K4) against ``paged_flash_decode_reference`` at the serving path's
   shapes — decode (16 slots, positions over [0, 2047], all-scratch
   rows, a poisoned scratch block), prefill (T = 128 and 512), GQA and a
   sliding window in fp32 and bf16; then bf16 at head dims 32 and 128,
   MQA (16 q heads over 1 kv head: 16 rows), a 4-token span at group 4
   (16 rows), the serving path's short contexts (positions U[16, 464])
   and block sizes 16, 8 and 48; then bf16 prefill rows at the serving
   buckets' lengths (T 32 and 2048 beside 128 and 512), GQA, MQA, a
   decode tick of 32 rows per kv head, a 256 window, a prefill tail at
   positions [1000, 37], ragged T 200, head dims 32 and 128, block sizes
   16 and 48 and a released all-scratch row. Each row prints the route
   that served it (``split``: bf16 with at most 16 rows per kv head;
   ``mma``: bf16 with more; ``rows``: fp32), which must be the rule's; a
   split or mma row must give the same bits on a second launch, and an
   mma row's key tiles, counted on the card, must equal
   ``_prefill_live_tiles``'s, and its output is held per entry as K1's O
   is (``ELEMENT_TOL``). Each bf16 row times the kernel, the plain
   version and one library call (``scaled_dot_product_attention`` over the
   gathered dense view, a yardstick the port never calls) with CUDA
   events, beside the shape's least possible time (``bound_ms``).
3. Serving at full width: the Transformer-base LM (6 layers, d_model 512,
   8 heads, vocab 32000, bf16, seeded random weights) behind
   ``ServingEngine(num_slots=16, max_len=2048, kv_block_size=64,
   decode_attend_impl='fused')`` under ``Scheduler('prefill_priority')``
   serves 24 requests. K4's launch count over this run must equal
   ``num_layers * (prefills + decode steps)``, the split route's
   ``num_layers * decode steps``, the mma route's ``num_layers *
   prefills`` and the rows route's 0.
4. Stream equivalence: 8 requests through two fp32 engines, ``'fused'``
   and ``'xla'``; greedy streams must be identical, except at a true
   near-tie (top-2 logit gap < 1e-4).
5. Where the time goes: a ``torch.profiler`` window over 16 more
   requests on the bf16 engine — wall vs device-busy time, the device
   time of the busiest kernels, and K4's kernels' share and time per
   launch.
13. (run after phase 5) The dense KV layout: (a) K4's dense entry
    (``dense_flash_decode``) against its plain version in fp32 and bf16:
    the decode tick over a [16, 2048, 8, 64] ring (bs 128, positions over
    [0, 2047], slot 0 reading 101 keys of its first block), prefills of
    T 512 through ``slots=[5]`` and of T 2048 at slot 0, GQA (2 kv
    heads), a 256 window, head dim 128, a ring of 400 keys (bs 16) and
    rings of 2047 keys (one block a row, a decode tick and a T 256
    prefill). Each row prints its route (the rule's), must count one
    dense call, give the same bits on a second launch (every route),
    stay within ``TOLERANCE`` x max(1, max |plain|), and an mma row is
    held per entry and its card-counted tiles to ``_prefill_live_tiles``;
    bf16 rows are timed beside ``bound_ms``, the plain version and SDPA
    over the slots' dense rows. (b) Phase 3's engine and requests with
    ``decode_impl='dense'``: K4's launches and the dense entry's must
    equal ``num_layers * (prefills + decode steps)`` (split: decode
    steps, mma: prefills, rows 0); TTFT, step p50/p99 and wall printed
    beside phase 3's. (c) fp32 (TF32 off): 8 requests through the dense
    fused, dense xla and paged fused engines and ``generate``, greedy and
    at temperature 0.8, top-k 50, top-p 0.95 with the scheduler's seeds;
    the streams must agree, or part at a true near-tie (top-2 gap <
    ``NEAR_TIE`` of the logits, or of the tempered, filtered logits plus
    that token's Gumbel noise). (d) bf16 at full width: ``generate`` (B
    4, prompts of 16-64 tokens, 256 steps, greedy and sampled) and
    ``beam_search`` (B 2, beam 4, 128 steps, eos, length penalty 0.6):
    well-formed outputs, beam 1 equal to greedy, the best raw beam
    scoring at least greedy's; ms per step.
6. K1–K3 (flash attention forward, dq, dk/dv) against their plain
   versions on the card, fp32 and bf16: the training path's shape
   (B 8, T 2048, 8 heads, head dim 64, causal), packed segments as the
   example twin's ``pack_documents`` makes them, GQA (2 kv heads), a
   256-wide window, a bias with its gradient (B 2, T 256), odd T = 1000,
   the block entries with ``q_offset = 1536``, query rows that see no key
   (their O and dq must be exactly 0), head dims 32 and 128 (packed), and
   no mask at all (``causal=False``, the encoder's attention: B 8, T 2048,
   8 heads, 8 or 2 kv heads; every tile visited, none skipped, and the
   library call is SDPA's unmasked one). Every output is held to
   ``TOLERANCE`` x max(1, max |plain|),
   and K1's O and LSE per entry to ``ELEMENT_TOL`` at the scale of the
   entry. bf16 runs K1-K3 on the tensor-core kernels, fp32 on the
   CUDA-core ones. The tensor-core kernels count on the card the tiles
   they visit and skip by segment ranges; each case prints K1's, K2's and
   K3's counts on a ``tiles:`` line beside what ``_live_tiles``'s rule
   predicts, and they must agree (zero in fp32; some skipped in the
   packed case). bf16 operands off the kernels' 16-byte grid must give
   the outputs and gradients of their contiguous copies bit for bit. In
   bf16 each kernel,
   the plain versions and one library call (``scaled_dot_product_attention``
   forward, and its backward as forward+backward minus forward — a
   yardstick the port never calls) are timed, with each shape's least
   possible time (``bound_ms``).
7. Training at full width: the Transformer-base LM (the module defaults,
   bf16, seeded weights) with ``attention_fn=flash_attention`` trains 30
   steps on packed synthetic documents (B 8 x T 2048 = 16,384 tokens per
   step) through ``create_communicator('pure_nccl')`` ->
   ``create_multi_node_optimizer(AdamW(3e-4, weight_decay=1e-4))`` ->
   ``create_train_state`` -> ``make_train_step``. The loss must be finite
   and fall to within ``LOSS_30_DRIFT`` of ``LOSS_30``; K1, K2 and K3
   must each launch ``num_layers x 30`` times, and K1's, K2's and K3's
   counted tiles visited and skipped must equal the rule's prediction
   over the 30 batches (some skipped); then a ``torch.profiler`` window
   over one more step.
8. Gradient equivalence: at fp32 (TF32 off), 2 layers at full width,
   B 2 x T 512 with segments, the loss and every parameter gradient with
   ``attention_fn=flash_attention`` against ``attention(impl='xla')``.
9. ResNet-50 data-parallel training at full width through the ImageNet
   twin's ``setup``: ``pure_nccl``, the bf16 wire, sync-BN over the
   one-rank NCCL group, per-rank batch 64 at 224x224, 1000 classes, bf16
   compute, channels_last, SGD(0.1, momentum 0.9); once without and once
   with double buffering. Step 1's loss must be within
   ``RESNET_LOSS_REL_TOL`` of the same weights' fp32 loss on the CPU; 30
   steps on 4 fixed batches must bring the loss below
   ``RESNET_LOSS_FRACTION`` of step 1's (without double buffering); then
   30 timed steps on fresh synthetic batches copied through the
   prefetcher: img/s, step p50/p99, peak memory, the H2D copy, the host
   draw of a batch, and a ``torch.profiler`` window over one step (busy
   share, busiest kernels). No TPU-kernel port may launch on this path.
10. The MNIST twin at full width: 200 iterations of batch 256 over
    ``pure_nccl`` with ``--prefetch 2``; final validation accuracy at
    least 0.9, and its time per iteration.
11. The bidirectional encoder and the LM losses at full width: (a) the
    Transformer-base encoder (``causal=False``, flash attention, bf16)
    trains 30 steps of the MLM recipe (mask id 31999, rate 0.15, B 8 x T
    2048) through AdamW in ``create_multi_node_optimizer`` over
    ``pure_nccl``; the loss must fall and K1, K2 and K3 must each launch
    ``num_layers`` times a step; step p50/p99, tokens/s, peak memory and
    the busy share of one profiled step. (b) ``lm_loss_fused`` (8 chunks)
    against ``lm_loss`` on the same hidden states of the causal LM: the
    loss within ``FUSED_LOSS_REL_TOL`` and both gradients within
    ``FUSED_GRAD_TOL`` of their max; forward+backward time and peak
    memory of each, and a profile of the fused one. (c) 5 encoder steps
    with ``remat=True`` ('dots') against 5 without: peak memory, step
    p50, the step-5 loss within ``REMAT_LOSS_REL_TOL`` (and whether the
    losses are bit-identical); one step with ``dropout_rate=0.1`` must be
    finite and differ from the step without it.
12. Resume and preemption: (a) phase 7's training with double buffering,
    20 steps without a stop against 10 steps, a snapshot (blocking, then
    async through the native writer, timed), a freshly built model and
    optimizer, ``maybe_load`` and 10 more steps, through the npz
    checkpointer and the dcp adapter: the losses of steps 11-20 must be
    bit-identical to the run without a stop. (b) A child process trains
    the MNIST MLP under the preemption guard and gets SIGTERM after step
    7; it must save at iteration 10, exit 0 and leave one snapshot; a
    second child resumes and finishes with the parameters of a run
    without a stop, bit for bit. (c) The MNIST twin with ``--checkpoint``
    to 100 iterations, then to 200: the second run resumes from 100.

14. (run after phase 12) Cross-rank autograd and tensor parallelism on
    one card: (a) K4's 5-D tensor-parallel entry on phase 3's pool split
    into ``STACK_SHARDS`` shards of 4 heads (bf16): the decode tick and
    a T 512 prefill, counted as this phase's main path (2 stacked calls,
    ``STACK_SHARDS`` launches on the split and on the mma route), each
    equal bit for bit to its per-shard 4-D calls and within
    ``TOLERANCE`` and ``ELEMENT_TOL`` of the plain version, timed beside
    SDPA on the same heads and its bound; (b) every function of
    ``functions/``, ``parallel/collectives.py`` and the tensor-parallel
    f/g pairs over the one-rank NCCL group, fp32 and bf16: forward and
    ``autograd.grad`` equal bit for bit to their one-rank meaning (max
    and min refuse a gradient); (c) the column and row dense, ``tp_mlp``
    and ``tp_attention`` at TP 1 at Transformer-base widths (d 512, d_ff
    2048, 8 heads, B 8 x T 2048, bf16) against the dense layers, outputs
    and gradients within ``TOLERANCE`` (bit-identity printed), and the
    ms of each; (d) ``create_mnbn_model`` over a net with
    ``nn.BatchNorm2d``: 5 SGD steps with deterministic cuDNN equal bit
    for bit to the net built with ``MultiNodeBatchNormalization``, and
    its ``state_dict`` loads into the unconverted net. Phase 2 also
    times the rows route's fp32 decode tick and T 512 prefill.
15. (run after phase 14) Tensor-parallel LM, ZeRO and FSDP on one card:
    (a) phase 3's engine and traffic with ``mesh=`` the one-rank NCCL
    group (TP 1): streams bit-identical to phase 3's, every decode tick
    ``2 x num_layers`` all-reduces and no other ``torch.distributed``
    call, ``num_layers`` K4 launches (4-D entry, the rank's heads);
    (b) TP 2 on the one card: two processes (``python3 chip_smoke.py
    --tp-child DIR RANK``) share ``cuda:0`` in a gloo group over CUDA
    tensors (NCCL refuses two ranks on one device, and an engine handed
    such an NCCL group must refuse it), each rank on 4 heads and d_ff
    1024, phase 3's requests cut to ``TP_CARD_REQUESTS`` of
    ``TP_CARD_NEW_TOKENS`` new tokens: fp32 greedy streams equal to the
    mesh-less fp32 engine's (or parted at a true near-tie), every rank's
    streams equal, each rank's K4 launches ``num_layers x (prefills +
    decode steps)``; bf16: the share of equal tokens and the first
    prefill's max logit difference (a rank that fails in either dtype
    fails the phase); (c) phase 7's shape for ``TP_TRAIN_STEPS`` steps as
    the TP 1 shard: losses bit-identical to the model without TP, K1-K3
    ``num_layers`` launches a step each; the example twin's default run
    (world size 1, dp 1 x tp 1); (d) ZeRO and FSDP at world size 1 over
    NCCL, phase 7's LM: losses within ``ZERO_FSDP_LOSS_TOL`` of plain
    AdamW's, peak memory of each; the FSDP state (DTensor leaves, saved
    as ``key@@index`` shards) saved at step ``ZERO_FSDP_RESUME_AT``,
    loaded into a fresh one and resumed: losses bit-identical to the run
    without a stop.
16. (run after phase 15) The pipeline engines on phase 7's LM (6
    blocks, bf16, B 8 x T 2048 plain causal, ``PIPE_MICRO``
    microbatches), the blocks' parameters through ``functional_call`` as
    the stage function, flash attention (K1-K3) in every stage, the
    embedding and tied head outside the conveyor: (a) world size 1 over
    the one-rank NCCL group, one step each of GPipe, interleaved (v 2)
    and 1F1B (head as ``head_params``, the embedding through the input
    gradients) against the model without the pipeline on the full batch:
    loss within ``PIPE_LOSS_TOL``, every gradient entry within
    ``PIPE_GRAD_TOL``, K1/K2/K3 launches a step ``num_layers x
    microbatches`` (K1 twice that under 1F1B's recompute), step ms and
    peak memory; (b) two stages on the one card: two processes
    (``python3 chip_smoke.py --pipe-child DIR RANK``) on ``cuda:0`` in a
    gloo group (each transfer staged through the host), GPipe and 1F1B,
    each rank held to the unpipelined model's gradients and compared
    with (a)'s (max difference printed), the embedding and head
    gradients equal on both ranks, per-rank launches, bytes sent a step
    and step ms; then the hetero twin over the same two ranks (accuracy
    at least ``PIPE_TWIN_ACC``); a failing rank fails the phase; (c) the
    pipeline twin at world size 1, GPipe and 1F1B, ``PIPE_TWIN_ITERATIONS``
    iterations, accuracy at least ``PIPE_TWIN_ACC``.
17. (run after phase 16) The ParallelPlan and sequence parallelism on
    phase 7's LM (B ``SEQ_B`` x T ``SEQ_T``, plain causal): (a) world size
    1 over the one-rank NCCL group: (1) ``make_train_step(plan=
    ParallelPlan({'data': 1, 'zero': 1}))``, ``SEQ_PLAN_STEPS`` AdamW
    steps against phase 7's communicator-path step on the same batches
    (losses within 1e-5 relative, forecast bit-identical; K1/K2/K3 6/6/6
    a step; the step keeps its state tensors); (2) ``ParallelPlan({'seq':
    1})`` through ``seq_attention('ring')`` and ``('ulysses')``, one SGD
    step, loss and gradients against the plain model within
    ``SEQ1_GRAD_TOL``; (b) ``SEQ_RANKS`` processes on the one card
    (``python3 chip_smoke.py --seq-child DIR RANK``, gloo): gloo's
    all-to-all over CUDA tensors checked; (1) ``ParallelPlan({'seq':
    2})`` through the ring and Ulysses, each rank's loss and gradients
    against (a)'s plain values (``SEQ_LOSS_TOL``, ``SEQ_GRAD_TOL``),
    K1/K2/K3 launches per rank by the rule (ring rank r: 6 (r + 1);
    Ulysses: 6), bytes sent a step equal to the count from the shapes;
    (2) the sliding window (W ``SEQ_WINDOW``) and (3) the zigzag ring,
    forward and backward, against the plain call within
    ``SEQ_KERNEL_TOL``, their launches, bytes and host copies of off-grid
    views; (c) the twin's ``--sequence-parallel`` at 2 ranks, ring and
    ``--window``, ``SEQ_TWIN_ITERATIONS`` iterations: finite losses that
    fall. A failing rank fails the phase.
18. (run after phase 17) Mixture of experts: phase 7's LM with
    ``MOE_EXPERTS`` experts in every block (d_ff 2048 an expert, bf16,
    seeded). (a) world size 1 over the one-rank NCCL group: step 1's loss
    and every gradient (the dense MoE form, flash attention) against the
    fp32 model with the plain attention on the same weights
    (``MOE_GRAD_TOL``, ``MOE_LOSS_TOL``), then ``MOE_TRAIN_STEPS`` AdamW
    steps on phase 7's packed batches: finite, falling losses, K1/K2/K3
    6/6/6 a step, step p50 and peak memory; (b) ``ParallelPlan({'expert':
    1})`` with ``moe_layer(experts_per_shard=8)``, ``'sort'`` and
    ``'einsum'``, a residual MoE MLP over 4096 tokens x d 512 in bf16
    (no-drop, TF32 off): the impls' step-1 losses bit-identical, 2
    all-to-alls forward and 2 backward a step, the stats (no drop, the
    loads summing to the tokens); (d) phase 3's traffic on the MoE model:
    K4's launches by phase 3's rule, tokens/s, TTFT and token ms; fp32
    streams against ``generate`` and the TP 1 engine (``mesh=``, the
    ownership-split form) against the plain engine on 8 requests of 16
    tokens (fp32 equal or parted at a true near-tie, bf16 tokens equal
    reported; every TP 1 tick 12 all-reduces, 12 all-to-alls and 6 K4
    launches); (c) ``MOE_RANKS`` processes on the one card (``python3
    chip_smoke.py --moe-child DIR RANK``, gloo): gloo's all-to-all of CUDA
    queues; ``ParallelPlan({'expert': 2})`` at 4 experts a rank held to
    (b) (``MOE_RANK_LOSS_TOL``, ``MOE_RANK_GRAD_TOL``), its all-to-alls and
    bytes sent a step to the count from the shapes; MoE serving at TP 2
    against TP 1 (fp32 equal or a near-tie, bf16 tokens equal reported,
    the tick's calls, each rank's K4 launches); (e) the MoE twin at 2
    ranks there and at world size 1 here, ``MOE_TWIN_ITERATIONS``
    iterations: finite losses, accuracy rising.
19. (run after phase 18) The topology communicators, the wires, the
    reduction schedules and local SGD under phase 7's LM: (a) world size
    1 over NCCL, ``TOPO_STEPS`` AdamW steps each under ``pure_nccl``
    (fp32 and bf16 wires), ``hierarchical``, ``two_dimensional``,
    ``single_node`` and ``non_cuda_aware`` (bf16), ``two_dimensional``
    with the int8 wire and shard-level error feedback,
    ``reduction_schedule`` ``'flat'``, ``'two_level'`` and ``'zero'``
    (bf16) and ``create_local_sgd(sync_every=2)``: every run's losses bit
    for bit ``pure_nccl``'s on its wire (the int8 wire is exact at one
    rank, its residual all zero), K1/K2/K3 6/6/6 a step, step ms p50/p99
    beside ``pure_nccl``'s, ``torch.distributed`` calls a step; local
    SGD's largest |parameter| difference from the fp32 run printed, its
    last loss within ``TOPO_LOSS_TOL`` relative; (b) ``TOPO_RANKS``
    processes on the one card (``python3 chip_smoke.py --comm-child DIR
    RANK``, CUDA tensors over gloo, ``mesh=`` 2 x 2), the LM at full
    width cut to ``TOPO_LAYERS`` layers and B ``TOPO_B`` x T ``TOPO_T`` a
    rank, ``TOPO_RANK_STEPS`` steps each under ``two_dimensional`` bf16,
    the int8 wire with flat and with shard-level error feedback, the
    fp32 ``'two_level'`` schedule and local SGD: parameters equal on
    every rank bit for bit after every step (local SGD: after each
    sync), step 1's reduced gradient against the fp32 mean of the ranks'
    local gradients as a share of the wire's bound (at most 1), calls
    and bytes sent a step per rank equal to the shapes' count, the
    residual's shapes, stage 1's codes on the card against the CPU (none
    more than one code apart); (c) the Transformer twin with
    ``two_dimensional``, the int8 wire and error feedback, and with
    ``--local-sgd 4``, the MNIST twin with ``--reduction-schedule
    two_level``, the ImageNet twin (ResNet-50, batch 64) with
    ``--optimizer lars`` and ``lamb``: finite losses, first -> last.

20. (run after phase 19) The composition DSL and its executor, the
    composed schedules, ``MeasuredComposedReducer``,
    ``AsyncHostGradReducer`` and ``calibrate`` under phase 7's LM: (a)
    world size 1 over NCCL, ``COMP_STEPS`` AdamW steps on the bf16 wire
    under ``two_dimensional`` (its 1 x 1 ``('inter', 'intra')`` mesh)
    with each derived composition as ``reduction_schedule``, a sliced
    (``[s0..3]``) and a zigzag (``[z0..3]``) spelling and ``'zero'``:
    losses bit for bit ``pure_nccl`` bf16's, K1/K2/K3 6/6/6 a step, the
    ``torch.distributed`` calls of a step equal to
    ``predicted_collectives`` over the gradient buckets plus the
    metrics all-reduce; ``ParallelPlan({'data': 1})`` with and without
    ``grad_reduction='rs(a0)>ag(a0)'``, ``COMP_PLAN_STEPS`` steps, bit
    for bit, one reduce-scatter and one all-gather a leaf;
    ``MeasuredComposedReducer``'s ms a stage on the LM's fp32 gradients
    (two_level and ``[s0..3]``), its means equal to the gradients; the
    async reducer's staleness-1 loop over ``COMP_ASYNC_STEPS`` steps,
    its parameters bit for bit the same loop's through ``reduce_sync``;
    (b) ``COMP_RANKS`` processes on the one card (``python3
    chip_smoke.py --comp-child DIR RANK``, gloo, ``mesh=`` 2 x 2), the
    LM cut as in 19 (b), ``COMP_RANK_STEPS`` fp32 steps under every
    derived composition, ``[s0..3]`` and ``[z0..3]``: parameters equal
    on every rank after every step, step 1's reduced gradient within the
    fp32 summation bound of the ``ar(inter+intra)`` run's, calls and
    bytes sent a step per rank equal to the composition's frame
    (``stage_wire_layout``'s rows at their ring shares); then
    ``calibrate``'s α/β printed as gloo figures.

The ``kernels`` JSON and the card's name and power limit come on the two
lines before the last; the last line is ``{"ok": true, "device": {...}}``.
``dense_flash_decode``'s ``launches`` are phase 13 (b)'s,
``paged_flash_decode_stacked``'s phase 14 (a)'s.
K1-K3's ``launches`` are phase 7's (the LM training path); their
``launches_by_path`` add phase 11's encoder run, phase 15 (c)'s TP 1
training, phase 16's pipelined steps ((a) by engine, (b) by rank),
phase 17's plan and sequence-parallel steps ((a), and (b) by rank),
phase 18 (a)'s MoE LM step and phases 19's and 20's steps ((a) by run,
(b) by rank); K4's add phase 15 (a)'s TP 1 serving, each
rank's of (b), phase 18 (d)'s MoE serving and each rank's of 18 (c).

``python3 chip_smoke.py --drill-child DIR MODE`` is phase 12's child
process, ``--tp-child DIR RANK`` phase 15 (b)'s, ``--pipe-child DIR
RANK`` phase 16 (b)'s, ``--seq-child DIR RANK`` phase 17 (b)'s,
``--moe-child DIR RANK`` phase 18 (c)'s, ``--comm-child DIR RANK``
phase 19 (b)'s and ``--comp-child DIR RANK`` phase 20 (b)'s, not checks
of their own.
"""

from __future__ import annotations

import json
import math
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM data-sheet peaks (dense): HBM bytes/s and ops/s by input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
#: kernel vs plain version: fp32 accumulation on both sides, sums in
#: another order (fp32); bf16 output and P rounded to bf16 at different
#: points of the online vs one-pass softmax (a few bf16 ulps of O(1)).
#: K4 holds the max abs error to it (its mma rows also per entry, as
#: below); K1-K3 to it times max(1, max |plain|) per output (O, LSE, dq,
#: dk, dv, dbias), since their gradients grow with T (their backward gets
#: the same LSE and delta on both sides).
TOLERANCE = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
#: K1's O and LSE, and the output of K4's mma rows, are held per element
#: as well, each entry at the scale of its own value: |O - O_plain| <=
#: tol * (|O_plain| + mean |O_plain|) (the mean covers entries that
#: cancel to near 0) and |LSE - LSE_plain| <= tol * max(1, |LSE_plain|).
#: A row deep in a long document averages hundreds of keys to an O far
#: below the tensor's max, so only a limit of its own size catches a
#: kernel that weighs its key tiles wrongly. On an H100 the bf16
#: tensor-core K1 reads up to 2.1e-2 of that scale on O and 3.3e-7 on
#: LSE over the ten cases. K4's mma kernel borrows K1's design; its rows
#: average up to ~2000 keys (T 2048, the 32-row decode tick), and read up
#: to 2.1e-2 of that scale on O over the fifteen mma rows (T 2048).
ELEMENT_TOL = {"O": {"torch.float32": 2e-5, "torch.bfloat16": 5e-2},
               "lse": {"torch.float32": 2e-5, "torch.bfloat16": 2e-5}}
#: a greedy divergence between the fp32 engines is accepted only at a
#: true near-tie of the top-2 logits.
NEAR_TIE = 1e-4
TIMING_REPS = 20
#: flash vs xla attention through 2 fp32 layers: every gradient's max
#: error over its max |value|, and the loss's relative error.
GRAD_EQ_TOL = 1e-4
LOSS_EQ_TOL = 1e-5
TRAIN_STEPS = 30
TRAIN_WARMUP = 5
#: the loss at step 30 of phase 7 (these seeds, batches and weights) on
#: an NVIDIA H100 when K1 rounds P against each row's final max, as the
#: one-pass softmax does. The tensor-core K1 rounds P against the running
#: max, which moves it by ~1e-4; a move past LOSS_30_DRIFT is a fault.
LOSS_30 = 7.036672
LOSS_30_DRIFT = 1e-3


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
    4 * D operations per (query row of a q head, visible key)."""
    B, T, Hq, D = q.shape
    bs, Hkv = k_pool.shape[1], k_pool.shape[2]
    M = tables.shape[1]
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
        ops += 4 * D * Hq * int(vis.sum())  # every q head of each row
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


def _k4_cases(np):
    """(name, shape, window, dtypes) of each K4 row: the ten rows of
    decode, prefill, GQA and a window in fp32 and bf16, then bf16 rows at
    the split route's edges, the serving path's short contexts and other
    block sizes, then the mma route's bf16 rows."""
    f32_bf16 = ("float32", "bfloat16")
    spread = [int(x) for x in np.linspace(0, 2047, 16)]
    short = [int(x) for x in np.random.RandomState(7).randint(16, 465, 16)]
    decode = dict(B=16, T=1, Hq=8, Hkv=8, positions=spread)
    prefill = dict(B=1, Hq=8, Hkv=8, positions=[0])
    return [
        ("decode", dict(decode, scratch_rows=(3, 11)), None, f32_bf16),
        ("prefill_T128", dict(prefill, T=128), None, f32_bf16),
        ("prefill_T512", dict(prefill, T=512), None, f32_bf16),
        ("decode_gqa", dict(decode, Hkv=2, scratch_rows=(5,)), None,
         f32_bf16),
        ("decode_window256", dict(decode, scratch_rows=(7,)), 256, f32_bf16),
        ("decode_d32", dict(decode, D=32, scratch_rows=(3,)), None,
         ("bfloat16",)),
        ("decode_d128", dict(decode, D=128, scratch_rows=(3,)), None,
         ("bfloat16",)),
        ("decode_mqa_R16", dict(decode, Hq=16, Hkv=1, scratch_rows=(9,)),
         None, ("bfloat16",)),
        ("span_T4_group4_R16", dict(decode, T=4, Hkv=2, positions=[
            min(p, 2044) for p in spread], scratch_rows=(2,)), None,
         ("bfloat16",)),
        ("serving_short_contexts", dict(decode, positions=short), None,
         ("bfloat16",)),
        # block sizes other than the serving pool's 64: tiles over several
        # blocks (16), chunks over two blocks (8, a ragged last split of a
        # 37-block table, a window), blocks of 48 keys
        ("decode_bs16", dict(decode, Hkv=2, bs=16, M=128, scratch_rows=(1,)),
         None, ("bfloat16",)),
        ("span_T2_bs8_window100", dict(B=8, T=2, Hq=8, Hkv=2, bs=8, M=37,
                                       positions=[0, 7, 40, 99, 150, 201,
                                                  260, 294],
                                       scratch_rows=(2,)), 100,
         ("bfloat16",)),
        ("decode_bs48", dict(B=4, T=1, Hq=4, Hkv=4, bs=48, M=10,
                             positions=[0, 47, 300, 479]), None,
         ("bfloat16",)),
        # the mma route (bf16, more than 16 rows per kv head): prompts at
        # the serving buckets' lengths (bucketing.py: 16-512, then
        # max_len 2048), GQA, MQA, a decode tick whose group alone is 32
        # rows, a window, a prefill tail past position 0, a ragged T, the
        # other head dims and block sizes, a released all-scratch row
        ("prefill_T32", dict(prefill, T=32), None, ("bfloat16",)),
        ("prefill_T2048", dict(prefill, T=2048), None, ("bfloat16",)),
        ("prefill_gqa_T512", dict(prefill, T=512, Hkv=2), None,
         ("bfloat16",)),
        ("prefill_mqa_T128", dict(prefill, T=128, Hkv=1), None,
         ("bfloat16",)),
        ("decode_group32_R32", dict(decode, Hq=32, Hkv=1,
                                    scratch_rows=(4,)), None,
         ("bfloat16",)),
        ("prefill_window256_T512", dict(prefill, T=512), 256,
         ("bfloat16",)),
        ("prefill_tail_T64", dict(prefill, B=2, T=64,
                                  positions=[1000, 37]), None,
         ("bfloat16",)),
        ("prefill_ragged_T200", dict(prefill, T=200), None, ("bfloat16",)),
        ("prefill_d32_T512", dict(prefill, T=512, D=32), None,
         ("bfloat16",)),
        ("prefill_d128_T512", dict(prefill, T=512, D=128), None,
         ("bfloat16",)),
        ("prefill_bs16_T512", dict(prefill, T=512, bs=16, M=128), None,
         ("bfloat16",)),
        ("prefill_bs48_T512", dict(prefill, T=512, bs=48, M=43), None,
         ("bfloat16",)),
        ("prefill_released_row", dict(B=3, T=128, Hq=8, Hkv=2,
                                      positions=[0, 0, 300],
                                      scratch_rows=(1,)), None,
         ("bfloat16",)),
    ]


def phase_kernels(torch, np, F):
    from chainermn_tpu_torch.ops import paged_decode as pd

    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(24 * 2**20, dtype=torch.float32, device="cuda")
    tiny = torch.zeros(1, device="cuda")
    print(f"K4 clock floor: a one-element add_ times "
          f"{_time_ms(torch, lambda: tiny.add_(1), flush):.6f} ms by the "
          "same clock (launch and event overhead, in every time below)",
          flush=True)
    rows = []
    for name, kw, window, dtypes in _k4_cases(np):
        for dtype in (getattr(torch, d) for d in dtypes):
            args = _k4_case(torch, gen, dtype=dtype, **kw)
            for r in kw.get("scratch_rows", ()):
                args[4][r] = 0  # a released slot: all-scratch row at 0
            before = dict(pd.ROUTE_LAUNCHES)
            pd.paged_prefill_tile_counts()  # zero the mma route's counts
            got = pd.paged_flash_decode(*args, window=window)
            torch.cuda.synchronize()
            route = next(r for r, n in pd.ROUTE_LAUNCHES.items()
                         if n != before[r])
            tiles = pd.paged_prefill_tile_counts()
            B, T, Hq, D = args[0].shape
            _, bs, Hkv, _ = args[1].shape
            predicted = pd._prefill_live_tiles(
                T, Hq, Hkv, bs, args[3].shape[1], args[4].tolist(), window)
            if route != "mma":
                predicted = (0, 0)
            # the split route merges its splits in a fixed order and the
            # mma route writes each row once, with no atomics: a second
            # launch gives the same bits
            again = pd.paged_flash_decode(*args, window=window)
            same_bits = bool(torch.equal(got, again))
            want = pd.paged_flash_decode_reference(*args, window=window)
            err = (got.float() - want.float()).abs().max().item()
            tol = TOLERANCE[str(dtype)]
            # an mma row is also held per entry, as K1's O: a row deep in
            # a long prompt averages ~1000 keys to an O far below the
            # tensor's max, where only a limit of its own size catches a
            # key tile weighed wrongly
            over = (_per_entry_over_limit(got, want) if route == "mma"
                    else 0.0)
            zero_rows = all(bool((got[r] == 0).all())
                            for r in kw.get("scratch_rows", ()))
            expected_route = pd._route(dtype, kw["T"], kw["Hq"], kw["Hkv"])
            ok = (err <= tol and over <= 1.0
                  and bool(torch.isfinite(got).all())
                  and zero_rows and route == expected_route
                  and (same_bits or route == "rows")
                  and tuple(tiles) == tuple(predicted))
            row = {"case": name, "dtype": str(dtype).split(".")[-1],
                   "route": route,
                   "shape": {"D": 64, "bs": 64, "M": 32, **{
                       k: v for k, v in kw.items() if k in (
                           "B", "T", "Hq", "Hkv", "D", "bs", "M")}},
                   "window": window, "max_abs_err": err, "tolerance": tol,
                   "two_launches_equal": same_bits}
            if route == "mma":  # counted on the card, and the rule's
                row.update(per_entry_over_limit=over,
                           tiles_visited=tiles[0], tiles_skipped=tiles[1],
                           predicted_tiles=list(predicted))
            if route == "split":
                row["split_plan"] = pd._split_plan(
                    kw["B"], kw["Hkv"], args[3].shape[1], args[1].shape[1])
            # the serving dtype, and the rows route (fp32) at the decode
            # tick and the T 512 prefill: time it
            if dtype == torch.bfloat16 or name in ("decode", "prefill_T512"):
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
                    f"{tol}, per entry {over} of its limit (mma rows), finite={bool(torch.isfinite(got).all())}, "
                    f"all-scratch rows zero={zero_rows}, route {route} "
                    f"(expected {expected_route}), two launches equal bit "
                    f"for bit={same_bits}, tiles visited/skipped {tiles} "
                    f"(predicted {predicted})")
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
    pd.reset_launches()
    t0 = time.perf_counter()
    streams, sched = _serve(engine, reqs)
    wall = time.perf_counter() - t0
    launches, routes = pd.LAUNCHES, dict(pd.ROUTE_LAUNCHES)
    summary = sched.summary()
    expected = model.num_layers * (summary["prefills"]
                                   + summary["decode_steps"])
    # every decode tick (T 1) takes the split route and every prefill the
    # mma route: no prompt here is as short as 16 tokens, the one bucket
    # whose prefill would have few enough rows for the split route; the
    # rows route serves fp32 alone
    expected_routes = {"split": model.num_layers * summary["decode_steps"],
                       "mma": model.num_layers * summary["prefills"],
                       "rows": 0}
    print("serving summary", json.dumps(summary), flush=True)
    print(f"serving: {len(reqs)} requests in {wall:.3f} s wall, decode step "
          f"p50 {summary['token_ms_p50']} ms p99 {summary['token_ms_p99']} "
          f"ms, peak pool blocks in use {engine.peak_blocks_in_use}/"
          f"{engine.num_blocks - 1}, K4 launches {launches} (expected "
          f"{expected}), by route {json.dumps(routes)} (expected "
          f"{json.dumps(expected_routes)})", flush=True)
    if launches == 0 or launches != expected:
        raise AssertionError(f"K4 launches {launches} != num_layers x "
                             f"(prefills + decode steps) = {expected}")
    if routes != expected_routes:
        raise AssertionError(f"K4 launches by route {routes} != "
                             f"{expected_routes} (split: num_layers x decode "
                             "steps; mma: num_layers x prefills; rows: 0)")
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
    return launches, routes, summary, engine, streams


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


#: K4's kernels: the rows route, the split route's two launches, the
#: mma route
K4_KERNELS = ("paged_decode_kernel", "paged_decode_split_kernel",
              "paged_decode_merge_kernel", "paged_prefill_mma_kernel")


def phase_profile(torch, np, engine):
    """Where the serving time goes: a torch.profiler window over 16 more
    requests on the bf16 engine — wall vs device-busy time and the device
    time of the busiest kernels, K4 among them."""
    reqs = [(p, 16) for p, _ in _requests(np, 16, 3, 32000)]
    out = {}

    def serve():
        out["sched"] = _serve(engine, reqs)[1]

    _, busy, kernels = _profile_window(torch, serve, "profile", K4_KERNELS)
    s = out["sched"].summary()
    forwards = s["prefills"] + s["decode_steps"]
    launched = sum(k[1] for k in kernels)
    k4 = [(ms, n, m) for ms, n, name in kernels for m in K4_KERNELS
          if m in name]
    k4_ms = sum(k[0] for k in k4)
    share = k4_ms / busy
    print(f"profile: {s['prefills']} prefills + {s['decode_steps']} decode "
          f"steps, {launched} device ops ({launched / forwards:.1f} per "
          f"forward); K4 (its kernels) {k4_ms:.3f} ms ({share:.4f} of "
          f"busy) over {sum(k[1] for k in k4)} launches: " + ", ".join(
              f"{name} {ms:.3f} ms {n}x "
              f"({1e3 * ms / n:.2f} us each)" for ms, n, name in k4),
          flush=True)


# ---------------------------------------------------------------- phase 13

def _dense_case(torch, gen, *, Bc, L, T, Hq, Hkv, D=64, dtype, positions,
                slots=None):
    """The dense slot cache ``[Bc, L, Hkv, D]`` (random keys and values in
    every row: no scratch block, all of it slot-owned), q for the rows
    that ``slots`` picks (all when None) and their positions."""
    ck = torch.randn(Bc, L, Hkv, D, generator=gen)
    cv = torch.randn(Bc, L, Hkv, D, generator=gen)
    rows = Bc if slots is None else len(slots)
    q = torch.randn(rows, T, Hq, D, generator=gen)
    out = [t.to(dtype).cuda() for t in (q, ck, cv)]
    out.append(torch.tensor(positions, dtype=torch.int32).cuda())
    out.append(None if slots is None
               else torch.tensor(slots, dtype=torch.int32).cuda())
    return out


def _dense_view(torch, pd, ck, slots):
    """The paged view that ``dense_flash_decode`` hands the kernel: the
    pool ``[Bc * M, bs, Hkv, D]`` and the identity table."""
    Bc, L, Hkv, D = ck.shape
    bs = pd._pick_block(128, L)
    M = L // bs
    rows = (torch.arange(Bc, device=ck.device) if slots is None
            else slots.long())
    tables = (rows[:, None] * M
              + torch.arange(M, device=ck.device)[None]).int()
    return ck.view(Bc * M, bs, Hkv, D), tables


def _dense_sdpa(torch, F, q, ck, cv, positions, slots, window):
    """One library call computing the same attention: SDPA over the
    slots' dense rows (picked before timing) with a boolean mask."""
    B, T, Hq, D = q.shape
    L, Hkv = ck.shape[1], ck.shape[2]
    k = (ck if slots is None else ck[slots.long()]).transpose(1, 2)
    v = (cv if slots is None else cv[slots.long()]).transpose(1, 2)
    k, v = k.contiguous(), v.contiguous()
    qt = q.transpose(1, 2).contiguous()
    kpos = torch.arange(L, device=q.device)
    qpos = positions.long()[:, None] + torch.arange(T, device=q.device)
    mask = kpos[None, None] <= qpos[:, :, None]
    if window:
        mask &= kpos[None, None] > qpos[:, :, None] - window
    return lambda: F.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask[:, None], enable_gqa=Hq != Hkv)


def _dense_cases(np):
    """(name, shape, window) of each dense row: the serving decode tick
    over a [16, 2048, 8, 64] ring (bs 128) with slot 0 reading its first
    block, prefills of one slot through ``slots``, GQA, a window, head dim
    128, and rings of 400 (bs 16) and 2047 keys (one block a row)."""
    spread = [int(x) for x in np.linspace(0, 2047, 16)]
    spread[0] = 100  # slot 0: 101 live keys in block 0 of the view
    decode = dict(Bc=16, L=2048, T=1, Hq=8, Hkv=8, positions=spread)
    prefill = dict(Bc=16, L=2048, Hq=8, Hkv=8, positions=[0])
    rs = np.random.RandomState(13)
    return [
        ("dense_decode", decode, None),
        ("dense_prefill_T512_slot5", dict(prefill, T=512, slots=[5]), None),
        ("dense_prefill_T2048_slot0", dict(prefill, T=2048, slots=[0]),
         None),
        ("dense_decode_gqa", dict(decode, Hkv=2), None),
        ("dense_decode_window256", decode, 256),
        ("dense_decode_d128", dict(decode, D=128), None),
        ("dense_decode_L400_bs16", dict(decode, L=400, positions=[
            int(x) for x in rs.randint(0, 400, 16)]), None),
        ("dense_decode_L2047_one_block", dict(decode, L=2047, positions=[
            min(p, 2046) for p in spread]), None),
        ("dense_prefill_T256_L2047_slot3", dict(prefill, L=2047, T=256,
                                                 slots=[3],
                                                 positions=[1500]), None),
    ]


def phase_dense_kernels(torch, np, F):
    """Phase 13 (a): K4's dense entry against its plain version."""
    from chainermn_tpu_torch.ops import paged_decode as pd

    gen = torch.Generator().manual_seed(13)
    flush = torch.empty(24 * 2**20, dtype=torch.float32, device="cuda")
    rows = []
    for name, kw, window in _dense_cases(np):
        for dtype in (torch.float32, torch.bfloat16):
            q, ck, cv, pos, slots = _dense_case(torch, gen, dtype=dtype,
                                                **kw)
            pool, tables = _dense_view(torch, pd, ck, slots)
            bs, M = pool.shape[1], tables.shape[1]

            def run():
                return pd.dense_flash_decode(q, ck, cv, pos, slots,
                                             window=window)

            def plain():
                return pd.paged_flash_decode_reference(
                    q, pool, cv.view(pool.shape), tables, pos,
                    window=window, scratch_block=None)

            before = dict(pd.ROUTE_LAUNCHES)
            dense_before = pd.DENSE_LAUNCHES
            pd.paged_prefill_tile_counts()  # zero the mma route's counts
            got = run()
            torch.cuda.synchronize()
            route = next(r for r, n in pd.ROUTE_LAUNCHES.items()
                         if n != before[r])
            counted = pd.DENSE_LAUNCHES - dense_before
            tiles = pd.paged_prefill_tile_counts()
            predicted = (pd._prefill_live_tiles(
                kw["T"], kw["Hq"], kw["Hkv"], bs, M, pos.tolist(), window)
                if route == "mma" else (0, 0))
            same_bits = bool(torch.equal(got, run()))
            want = plain()
            err = (got.float() - want.float()).abs().max().item()
            scale = max(1.0, want.float().abs().max().item())
            tol = TOLERANCE[str(dtype)]
            over = (_per_entry_over_limit(got, want) if route == "mma"
                    else 0.0)
            expected_route = pd._route(dtype, kw["T"], kw["Hq"], kw["Hkv"])
            ok = (err <= tol * scale and over <= 1.0 and counted == 1
                  and bool(torch.isfinite(got).all())
                  and route == expected_route and same_bits
                  and tuple(tiles) == tuple(predicted))
            row = {"case": name, "dtype": str(dtype).split(".")[-1],
                   "route": route,
                   "shape": {"Bc": kw["Bc"], "L": kw["L"], "bs": bs, "M": M,
                             "T": kw["T"], "Hq": kw["Hq"], "Hkv": kw["Hkv"],
                             "D": kw.get("D", 64),
                             "slots": kw.get("slots")},
                   "window": window, "max_abs_err": err,
                   "tolerance": tol * scale, "two_launches_equal": same_bits}
            if route == "mma":
                row.update(per_entry_over_limit=over,
                           tiles_visited=tiles[0], tiles_skipped=tiles[1],
                           predicted_tiles=list(predicted))
            if route == "split":
                row["split_plan"] = pd._split_plan(q.shape[0], kw["Hkv"], M,
                                                   bs)
            if dtype == torch.bfloat16:
                nbytes, ops = _k4_work(np, q, pool, tables, pos, window,
                                       scratch=-1)
                bound_ms, bound_by = _bound(nbytes, ops, dtype)
                row.update(
                    ms=_time_ms(torch, run, flush),
                    # the kernels alone on the prebuilt view and table:
                    # what the dense entry adds is ms - paged_ms
                    paged_ms=_time_ms(torch, lambda: pd.paged_flash_decode(
                        q, pool, cv.view(pool.shape), tables, pos,
                        window=window, scratch_block=None), flush),
                    plain_ms=_time_ms(torch, plain, flush),
                    library_ms=_time_ms(torch, _dense_sdpa(
                        torch, F, q, ck, cv, pos, slots, window), flush),
                    bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                    ops=ops)
            print("K4 dense", json.dumps(row), flush=True)
            if not ok:
                raise AssertionError(
                    f"K4 dense {name} {dtype}: max abs err {err} vs "
                    f"{tol * scale}, per entry {over} of its limit, route "
                    f"{route} (expected {expected_route}), dense count "
                    f"{counted}, two launches equal={same_bits}, tiles "
                    f"{tiles} (predicted {predicted})")
            rows.append(row)
    return rows


def phase_dense_serving(torch, np, paged_summary):
    """Phase 13 (b): phase 3's configuration on the dense layout."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.ops import paged_decode as pd
    from chainermn_tpu_torch.serving import ServingEngine

    model = TransformerLM(seed=0)
    engine = ServingEngine(model, num_slots=16, max_len=2048,
                           decode_impl="dense", decode_attend_impl="fused")
    reqs = _requests(np, 24, 0, model.vocab_size)
    _serve(engine, _requests(np, 2, 1, model.vocab_size))  # warm-up
    torch.cuda.synchronize()
    pd.reset_launches()
    streams, sched = _serve(engine, reqs)
    launches, routes, dense = (pd.LAUNCHES, dict(pd.ROUTE_LAUNCHES),
                               pd.DENSE_LAUNCHES)
    s = sched.summary()
    n = model.num_layers
    expected = n * (s["prefills"] + s["decode_steps"])
    expected_routes = {"split": n * s["decode_steps"],
                       "mma": n * s["prefills"], "rows": 0}
    print("dense serving summary", json.dumps(s), flush=True)
    keys = ("wall_s", "ttft_ms_p50", "ttft_ms_p99", "token_ms_p50",
            "token_ms_p99", "tokens_per_sec")
    print("dense vs paged serving (phase 3, same call): " + ", ".join(
        f"{k} {s.get(k)} vs {paged_summary.get(k)}" for k in keys)
        + f"; K4 launches {launches} (expected {expected}), dense entry "
        f"{dense}, by route {json.dumps(routes)} (expected "
        f"{json.dumps(expected_routes)})", flush=True)
    if launches == 0 or launches != expected or dense != expected:
        raise AssertionError(f"dense engine: K4 launches {launches}, dense "
                             f"entry {dense}, expected {expected}")
    if routes != expected_routes:
        raise AssertionError(f"dense engine: K4 routes {routes} != "
                             f"{expected_routes}")
    for (_, n_new), gen in zip(reqs, streams):
        if len(gen) != n_new or not all(0 <= t < model.vocab_size
                                        for t in gen):
            raise AssertionError("malformed dense stream")
    if (engine.free_slot_count != 16 or engine.kv_blocks_free() is not None
            or engine.blocks_in_use is not None):
        raise AssertionError("dense engine: slots leaked or a pool appeared")
    return dense, routes, s


def _first_divergence(a, b):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _check_streams(torch, model, reqs, seeds, streams, sampling, label):
    """Every engine's streams against ``generate``'s: identical, or parted
    at a true near-tie of the top-2 of the logits (greedy) or of the
    tempered, filtered logits plus the Gumbel noise of that token's key
    (sampled), first divergence of each request."""
    from chainermn_tpu_torch.models.transformer import (
        _tempered_filtered,
        stream_sample_keys,
    )
    from chainermn_tpu_torch.utils import prng

    ref = streams["generate"]
    n_div, n_tokens = 0, sum(len(s) for s in ref)
    for name, got in streams.items():
        for r, ((prompt, _), a, b) in enumerate(zip(reqs, ref, got)):
            if len(a) != len(b):
                raise AssertionError(f"{label}: {name} gave {len(b)} tokens "
                                     f"for request {r}, generate {len(a)}")
            i = _first_divergence(a, b)
            if i is None:
                continue
            n_div += 1
            with torch.no_grad():
                logits = model(torch.tensor([prompt + a[:i]],
                                            device="cuda"))[0, -1].float()
            if sampling:
                key = stream_sample_keys(
                    prng.PRNGKey(0, device="cuda"),
                    torch.tensor([seeds[r]], device="cuda"),
                    torch.tensor([len(prompt) + i], device="cuda"))
                logits = _tempered_filtered(
                    logits[None], sampling["temperature"],
                    sampling["top_k"], sampling["top_p"])[0]
                logits = logits + prng.gumbel(key, logits.shape)[0]
            top2 = torch.topk(logits, 2).values
            gap = float(top2[0] - top2[1])
            print(f"streams {label}: {name} parts from generate at "
                  f"request {r} token {i}, top-2 gap {gap:.3e}", flush=True)
            if not gap < NEAR_TIE:
                raise AssertionError(
                    f"{label} streams of {name} and generate part at "
                    f"request {r} token {i} with a top-2 gap {gap}")
    print(f"streams {label}: dense fused, dense xla, paged fused and "
          f"generate over {len(reqs)} requests, {n_tokens} tokens, "
          f"{n_div} divergences (fp32, TF32 off)", flush=True)


def phase_dense_streams(torch, np):
    """Phase 13 (c): fp32 streams of the dense and paged engines against
    ``generate``, greedy and sampled."""
    import zlib

    from chainermn_tpu_torch.models import TransformerLM, generate
    from chainermn_tpu_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = TransformerLM(compute_dtype=torch.float32, seed=0)
    reqs = _requests(np, 8, 2, model.vocab_size)
    for sampling in ({}, dict(temperature=0.8, top_k=50, top_p=0.95)):
        label = "sampled" if sampling else "greedy"
        streams = {}
        for name, kw in (("dense fused", dict(decode_impl="dense")),
                         ("dense xla", dict(decode_impl="dense",
                                            decode_attend_impl="xla")),
                         ("paged fused", dict(kv_block_size=64))):
            engine = ServingEngine(model, num_slots=8, max_len=2048,
                                   **kw, **sampling)
            streams[name], _ = _serve(engine, reqs)
            del engine
        # the scheduler's seeds: crc32 of the ids it gave, r0 ... r7
        seeds = [zlib.crc32(f"r{i}".encode()) & 0x7FFFFFFF
                 for i in range(len(reqs))]
        P = max(len(p) for p, _ in reqs)
        prompt = torch.zeros(len(reqs), P, dtype=torch.long, device="cuda")
        for r, (p, _) in enumerate(reqs):
            prompt[r, :len(p)] = torch.tensor(p)
        n_steps = max(len(p) + g for p, g in reqs)
        kw = (dict(sampling, rng=np.zeros(2, np.uint32), seeds=seeds)
              if sampling else {})
        out = generate(model, prompt, n_steps, **kw).cpu().tolist()
        streams["generate"] = [out[r][len(p):len(p) + g]
                               for r, (p, g) in enumerate(reqs)]
        _check_streams(torch, model, reqs, seeds, streams, sampling, label)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def phase_decoders(torch, np):
    """Phase 13 (d): ``generate`` and ``beam_search`` at full width."""
    from chainermn_tpu_torch.models import (
        TransformerLM,
        beam_search,
        generate,
    )

    model = TransformerLM(seed=0)  # Transformer-base, bf16
    V = model.vocab_size
    rs = np.random.RandomState(14)
    lens = [16, 64, 33, 48]
    prompt = torch.zeros(4, max(lens), dtype=torch.long)
    for r, n in enumerate(lens):
        prompt[r, :n] = torch.from_numpy(rs.randint(1, V, size=n))
    prompt = prompt.cuda()
    out = {}
    for label, kw in (("greedy", {}), ("sampled", dict(
            temperature=0.8, top_k=50, top_p=0.95,
            rng=np.zeros(2, np.uint32), seeds=[11, 12, 13, 14]))):
        generate(model, prompt[:, :8], 16, **kw)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(model, prompt, 256, **kw)
        toks = toks.cpu()
        dt = time.perf_counter() - t0
        ok = (tuple(toks.shape) == (4, 256)
              and bool(((toks >= 0) & (toks < V)).all())
              and all(torch.equal(toks[r, :n], prompt[r, :n].cpu())
                      for r, n in enumerate(lens)))
        print(f"generate {label}: B 4, prompts {lens}, n_steps 256 in "
              f"{dt:.3f} s, {1e3 * dt / 256:.3f} ms per step, "
              f"{1e3 * dt / (4 * 256 - sum(lens)):.3f} ms per generated "
              f"token", flush=True)
        if not ok:
            raise AssertionError(f"generate {label}: malformed output")
        out[label] = toks
    bprompt = prompt[:2, :40].clone()  # ragged: 16 and 40 tokens
    beam_search(model, bprompt[:, :8], 16, 4, eos_id=2)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    beams, scores = beam_search(model, bprompt, 128, 4, eos_id=2,
                                length_penalty=0.6)
    scores = scores.cpu()
    dt = time.perf_counter() - t0
    greedy = generate(model, bprompt, 128).cpu()
    one, one_scores = beam_search(model, bprompt, 128, 1)
    raw, raw_scores = beam_search(model, bprompt, 128, 4)
    ok = (tuple(beams.shape) == (2, 4, 128)
          and bool(torch.isfinite(scores[:, 0]).all())
          and torch.equal(one[:, 0].cpu(), greedy)
          and bool((raw_scores[:, 0] >= one_scores[:, 0] - 1e-3).all()))
    print(f"beam_search: B 2, beam 4, n_steps 128, eos 2, length penalty "
          f"0.6 in {dt:.3f} s ({1e3 * dt / 128:.3f} ms per step); top "
          f"scores {scores[:, 0].tolist()}; beam 1 == greedy "
          f"{torch.equal(one[:, 0].cpu(), greedy)}; best raw score "
          f"{raw_scores[:, 0].tolist()} vs greedy "
          f"{one_scores[:, 0].tolist()}", flush=True)
    if not ok:
        raise AssertionError("beam_search: malformed output, beam 1 != "
                             "greedy, or the top beam scored below greedy")


# ---------------------------------------------------------------- phase 6

def _flash_cases():
    """(name, shape and options) of each K1-K3 case; (b) is the main
    path's inputs (packed training rows). ``block`` cases go through the
    ring's block entries."""
    full = dict(B=8, T=2048, H=8, Hkv=8)
    return [
        ("causal", full),
        ("packed", dict(full, seg=True)),
        ("gqa", dict(full, Hkv=2)),
        ("window256", dict(full, window=256)),
        ("bias_grad", dict(B=2, T=256, H=8, Hkv=8, bias=True)),
        ("odd_T1000", dict(full, T=1000)),
        ("block_q_offset", dict(full, T=512, Tk=2048, q_offset=1536,
                                block=True)),
        ("no_key_rows", dict(B=2, T=64, Tk=192, H=8, Hkv=2, q_offset=128,
                             seg="no_key", block=True)),
        ("d32", dict(B=2, T=1024, H=8, Hkv=8, D=32, seg=True)),
        ("d128", dict(B=2, T=1024, H=8, Hkv=8, D=128, seg=True)),
        # no mask at all: the bidirectional encoder's attention (phase 11)
        ("full", dict(full, causal=False)),
        ("full_gqa", dict(full, Hkv=2, causal=False)),
    ]


#: the query rows of ``no_key_rows`` whose segment id no key carries
NO_KEY_ROWS = 16


def _flash_inputs(torch, np, dtype, seed, *, B, T, H, Hkv, Tk=None, D=64,
                  seg=False, bias=False, window=None, q_offset=0,
                  block=False, causal=True):
    from chainermn_tpu_torch.examples.transformer.train_transformer_lm \
        import pack_documents

    del block
    Tk = Tk or T
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v, do = randn(B, T, H, D), randn(B, Tk, Hkv, D), \
        randn(B, Tk, Hkv, D), randn(B, T, H, D)
    seg_q = seg_k = None
    if seg == "no_key":  # two key documents; the first rows ask for a third
        seg_k = (torch.arange(Tk, device="cuda") >= Tk // 2).int()
        seg_k = seg_k.expand(B, Tk).contiguous()
        seg_q = torch.ones(B, T, dtype=torch.int32, device="cuda")
        seg_q[:, :NO_KEY_ROWS] = 7
    elif seg:
        _, s = pack_documents(np.random.default_rng(seed), B, T)
        seg_q = seg_k = torch.from_numpy(s).cuda()
    kw = dict(causal=causal, scale=D ** -0.5, seg_q=seg_q, seg_k=seg_k,
              bias=(torch.randn(1, H, T, Tk, generator=gen, device="cuda")
                    * 0.5 if bias else None),
              window=window, q_offset=q_offset)
    return q, k, v, do, kw


def _flash_work(fa, q, k, kw):
    """Bytes and operations K1, K2 and K3 must move and do on THESE
    inputs: every input read once and every output written once; 4, 6
    and 8 * D operations per (query row, visible key) pair, counted over
    the causal/window/segment mask of this run's data."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    mask = fa._mask(q, k, kw["seg_q"], kw["seg_k"], kw["causal"],
                    kw["window"], kw["q_offset"])
    pairs = H * (B * Tq * Tk if mask is None
                 else int(mask.expand(B, 1, Tq, Tk).sum()))
    esz = q.element_size()
    qo = B * Tq * H * D * esz        # q, O or dO
    kv = 2 * B * Tk * Hkv * D * esz  # k and v
    rows = B * H * Tq * 4            # LSE or delta
    bias = kw["bias"]
    b_in = 0 if bias is None else bias.numel() * 4
    b_out = 0 if bias is None else B * H * Tq * Tk * 4  # fp32 dbias
    return {"fwd": (2 * qo + kv + rows + b_in, 4 * D * pairs),
            "dq": (2 * qo + kv + 2 * rows + b_in + B * Tq * H * D * 4,
                   6 * D * pairs),
            "dkv": (2 * qo + kv + 2 * rows + b_in + b_out
                    + 2 * B * Tk * Hkv * D * 4, 8 * D * pairs)}, pairs


def _tiles(torch, F, fa, q, k, kw):
    """The (visited, skipped) (q tile, k tile, q head) triples that the
    bf16 K2 and K3 should count on these inputs: the tiles of the
    causal/window band that ``_live_tiles``'s segment rule keeps and
    drops (a prediction from the inputs; the kernels count their own)."""
    B, Tq, H, _ = q.shape
    Tk, t = k.shape[1], fa.TILE
    nq, nk = -(-Tq // t), -(-Tk // t)
    band = fa._mask(q, k, None, None, kw["causal"], kw["window"],
                    kw["q_offset"])
    if band is None:
        band = torch.ones(1, 1, Tq, Tk, dtype=torch.bool, device=q.device)
    band = F.pad(band[0, 0].to(torch.int8), (0, nk * t - Tk, 0, nq * t - Tq))
    band = band.reshape(nq, t, nk, t).amax((1, 3)).bool().expand(B, nq, nk)
    live = band
    if kw["seg_q"] is not None:
        live = band & fa._live_tiles(kw["seg_q"], kw["seg_k"], t)
    return H * int(live.sum()), H * int((band & ~live).sum())


def _sdpa_attention(torch, F, fa, q, k, v, do, kw):
    """One library call computing the same attention (forward; and
    forward+backward), over BHTD views: no mask where nothing is masked,
    ``is_causal`` where that is the whole mask, else the explicit mask
    (+ the bias)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    plain = (kw["seg_q"] is None and kw["bias"] is None
             and kw["window"] is None and kw["q_offset"] == 0
             and q.shape[1] == k.shape[1])
    if plain and not kw["causal"]:
        mkw = {}
    elif plain:
        mkw = {"is_causal": True}
    else:
        mask = fa._mask(q, k, kw["seg_q"], kw["seg_k"], kw["causal"],
                        kw["window"], kw["q_offset"])
        if kw["bias"] is None:
            mkw = {"attn_mask": mask}
        else:
            mkw = {"attn_mask": kw["bias"].to(q.dtype).masked_fill(
                ~mask, float("-inf"))}
    qr, kr, vr = (x.detach().requires_grad_() for x in (qt, kt, vt))
    dot = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=gqa,
                                              **mkw)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qr, kr, vr, enable_gqa=gqa,
                                             **mkw)
        torch.autograd.grad(out, (qr, kr, vr), dot)

    return fwd, fwd_bwd


def _per_entry_over_limit(out, ro):
    """The largest error per entry of an attention output over its limit,
    ``ELEMENT_TOL["O"]`` at the entry's scale (K1's O, K4's mma rows);
    <= 1 passes."""
    ao = ro.float().abs()
    return ((out.float() - ro.float()).abs() / (
        ELEMENT_TOL["O"][str(out.dtype)] * (ao + ao.mean()))).max().item()


def _per_element_over_limit(out, lse, ro, rl):
    """K1's largest error per entry of O and of LSE over its limit
    (``ELEMENT_TOL`` at the entry's scale); <= 1 passes."""
    return {"O_per_element": _per_entry_over_limit(out, ro),
            "lse_per_element": ((lse - rl).abs() / (
                ELEMENT_TOL["lse"][str(out.dtype)]
                * rl.abs().clamp(min=1.0))).max().item()}


def phase_flash_kernels(torch, np, F):
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.ops.attention import NEG_INF

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(24 * 2**20, dtype=torch.float32, device="cuda")
    rows = []
    for ci, (name, shape) in enumerate(_flash_cases()):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, kw = _flash_inputs(torch, np, dtype, ci, **shape)
            bias_grad = kw["bias"] is not None
            fa.tile_counts()  # zero the kernels' counts
            if shape.get("block"):  # the ring's block entries
                bkw = dict(causal=kw["causal"], scale=kw["scale"],
                           q_offset=kw["q_offset"], seg_q=kw["seg_q"],
                           seg_kv=kw["seg_k"])
                out, lse = fa.flash_block_fwd(q, k, v, **bkw)
            else:
                out, lse = fa.flash_fwd(q, k, v, **kw)
            delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
            if shape.get("block"):
                got = fa.flash_block_bwd(q, k, v, do, lse, delta, **bkw)
            else:
                got = fa.flash_bwd(q, k, v, do, lse, delta,
                                   bias_grad=bias_grad, **kw)
            torch.cuda.synchronize()
            counted = fa.tile_counts()
            ro, rl = fa.flash_attention_fwd_reference(q, k, v, **kw)
            want = fa.flash_attention_bwd_reference(
                q, k, v, do, lse, delta, bias_grad=bias_grad, **kw)
            names = ["O", "lse", "dq", "dk", "dv", "dbias"][:2 + len(want)]
            tol = TOLERANCE[str(dtype)]
            err, over, ok = {}, {}, True
            for n, a, b in zip(names, (out, lse, *got), (ro, rl, *want)):
                err[n] = (a.float() - b.float()).abs().max().item()
                over[n] = err[n] / (tol * max(1.0, b.abs().max().item()))
                ok &= bool(torch.isfinite(a).all())
            over.update(_per_element_over_limit(out, lse, ro, rl))
            ok &= all(x <= 1.0 for x in over.values())
            row = {"case": name, "dtype": str(dtype).split(".")[-1],
                   "shape": shape, "max_abs_err": err, "tolerance": tol,
                   "err_over_limit": over}
            if shape.get("seg") == "no_key":
                # rows that see no key: O = 0, LSE = NEG_INF, dq exactly 0
                dead = got[0][:, :NO_KEY_ROWS]
                row["no_key_dq_max_abs"] = dead.abs().max().item()
                ok &= (row["no_key_dq_max_abs"] == 0.0
                       and bool((out[:, :NO_KEY_ROWS] == 0).all())
                       and bool((lse[..., :NO_KEY_ROWS] == NEG_INF).all()))
            # fp32 runs the CUDA-core K1-K3, which count nothing; bf16 the
            # tensor-core ones, whose counts must match the rule
            predicted = (_tiles(torch, F, fa, q, k, kw)
                         if dtype == torch.bfloat16 else (0, 0))
            print("tiles:", json.dumps({
                "case": name, "dtype": row["dtype"],
                "counted_by_kernels": counted,
                "predicted_by_live_tiles": predicted}), flush=True)
            unmasked = not kw["causal"] and kw["seg_q"] is None
            if dtype == torch.bfloat16 and unmasked:
                # every (q tile, k tile, head) triple visited, none skipped
                B_, Tq_, H_ = q.shape[:3]
                every = B_ * H_ * -(-Tq_ // fa.TILE) * -(-k.shape[1]
                                                          // fa.TILE)
                if predicted != (every, 0):
                    raise AssertionError(f"K1-K3 {name}: the rule predicts "
                                         f"{predicted}, not all {every} "
                                         "tiles visited and none skipped")
            if any(c != predicted for c in counted.values()) or (
                    name == "packed" and dtype == torch.bfloat16
                    and predicted[1] == 0):
                raise AssertionError(
                    f"K1-K3 {name} {dtype}: tiles counted (visited, "
                    f"skipped) {counted} != the rule's {predicted}, or the "
                    "packed case skipped none")
            if dtype == torch.bfloat16:  # the training dtype: time it
                row["tiles"] = counted
                work, pairs = _flash_work(fa, q, k, kw)
                lib_fwd, lib_fwd_bwd = _sdpa_attention(torch, F, fa, q, k,
                                                       v, do, kw)
                ms = {"fwd": _time_ms(torch, lambda: fa.flash_fwd(
                          q, k, v, **kw), flush),
                      "dq": _time_ms(torch, lambda: fa.flash_bwd_dq(
                          q, k, v, do, lse, delta, **kw), flush),
                      "dkv": _time_ms(torch, lambda: fa.flash_bwd_dkv(
                          q, k, v, do, lse, delta, bias_grad=bias_grad,
                          **kw), flush)}
                plain_fwd = _time_ms(torch, lambda: fa.
                                     flash_attention_fwd_reference(
                                         q, k, v, **kw), flush)
                plain_bwd = _time_ms(torch, lambda: fa.
                                     flash_attention_bwd_reference(
                                         q, k, v, do, lse, delta,
                                         bias_grad=bias_grad, **kw), flush)
                lib_f = _time_ms(torch, lib_fwd, flush)
                lib_fb = _time_ms(torch, lib_fwd_bwd, flush)
                row.update(
                    ms=ms, pairs=pairs,
                    # the plain backward computes dq, dk and dv in one
                    # pass, and SDPA's backward all of them: K2 and K3
                    # share those two numbers
                    plain_ms={"fwd": plain_fwd, "dq": plain_bwd,
                              "dkv": plain_bwd},
                    library_ms={"fwd": lib_f, "dq": lib_fb - lib_f,
                                "dkv": lib_fb - lib_f},
                    bound={kn: dict(zip(("bound_ms", "bound_by"),
                                        _bound(nb, ops, dtype)),
                                    bytes=nb, ops=ops)
                           for kn, (nb, ops) in work.items()})
            print("K1-K3", json.dumps(row), flush=True)
            if not ok:
                raise AssertionError(
                    f"K1-K3 {name} {dtype}: max abs errors {err}; each "
                    f"error over its limit {over} (tolerance {tol} x max(1, "
                    "max |plain|) per output, ELEMENT_TOL per entry of O "
                    "and LSE; all must be <= 1), dq on rows that see no key "
                    f"{row.get('no_key_dq_max_abs')} (their O must be 0 and "
                    "their LSE NEG_INF)")
            rows.append(row)
            del q, k, v, do, out, lse, got, ro, rl, want
    _odd_views(torch, np, fa)
    return rows


def _odd_views(torch, np, fa):
    """bf16 q, k, v and dO whose base and strides are off the 16-byte grid
    (views of a wider tensor, one element in) get the output, LSE and
    gradients of their contiguous copies, bit for bit: the wrappers hand
    the tensor-core K1-K3 an aligned copy."""
    q, k, v, do, kw = _flash_inputs(torch, np, torch.bfloat16, 99, B=2,
                                    T=256, H=8, Hkv=8, D=65, seg=True)
    odd = [x[..., 1:] for x in (q, k, v, do)]
    same = [x.contiguous() for x in odd]
    got = {}
    for label, (oq, ok_, ov, odo) in (("odd", odd), ("contiguous", same)):
        out, lse = fa.flash_fwd(oq, ok_, ov, **kw)
        delta = (odo.float() * out.float()).sum(-1).transpose(1, 2)
        got[label] = (out, lse, *fa.flash_bwd(oq, ok_, ov, odo, lse, delta,
                                              **kw))
    equal = [torch.equal(a, b) for a, b in zip(got["odd"],
                                                 got["contiguous"])]
    print(f"odd views: bf16 O/LSE/dq/dk/dv of operands off the 16-byte grid "
          f"(base {odd[0].data_ptr() % 16} bytes past it, token stride "
          f"{odd[0].stride(1)} elements) equal those of their contiguous "
          f"copies: {equal}", flush=True)
    if not all(equal):
        raise AssertionError(f"odd views changed the outputs or the "
                             f"gradients: {equal}")


# ---------------------------------------------------------------- phase 7

def _packed_loss(model, batch):
    """The example twin's packed loss: next-token cross-entropy, targets
    that cross a document boundary masked."""
    import torch

    from chainermn_tpu_torch.models import lm_loss

    tokens, seg = batch
    valid = torch.cat([torch.ones_like(seg[:, :1]),
                       (seg[:, 1:] == seg[:, :-1]).to(seg.dtype)], dim=1)
    return lm_loss(model(tokens, segment_ids=seg), tokens, mask=valid)


def _profile_window(torch, fn, label, markers, host_ops=None):
    """Wall vs device-busy time of ``fn()`` under torch.profiler (the sum
    of the kernels' device time; one stream, so they do not overlap) and
    the busiest kernels; ``markers`` name kernels whose share to print.
    ``host_ops``, a dict, receives each host-side event's self time
    (ms) and count: the ops and the CUDA runtime calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []  # device-side events only: CPU ops would count twice
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type):
            if host_ops is not None:
                host_ops[ev.key] = (ev.self_cpu_time_total / 1e3, ev.count)
            continue
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = ev.self_cuda_time_total
        kernels.append((dev / 1e3, ev.count, ev.key))
    kernels.sort(reverse=True)
    busy = sum(kc[0] for kc in kernels)
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    shares = {m: sum(kc[0] for kc in kernels if m in kc[2]) for m in markers}
    print(f"{label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
          f"({busy / wall_ms:.4f} of wall, "
          f"{sum(kc[1] for kc in kernels)} device ops), " + ", ".join(
              f"{m} {t:.3f} ms ({t / busy:.4f} of busy)"
              for m, t in shares.items()), flush=True)
    for ms, count, name in kernels[:12]:
        print(f"{label}: {ms:10.3f} ms {count:6d}x {name[:100]}", flush=True)
    return wall_ms, busy, kernels


def phase_training(torch, np):
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.examples.transformer.train_transformer_lm \
        import pack_documents
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.training import (
        create_train_state,
        make_train_step,
    )

    model = TransformerLM(seed=0, attention_fn=fa.flash_attention)
    comm = create_communicator("pure_nccl")
    opt = create_multi_node_optimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4), comm)
    state = create_train_state(model, opt, comm)
    step = make_train_step(_packed_loss, opt, comm)
    rng = np.random.default_rng(0)
    batches = [tuple(torch.from_numpy(x).cuda()
                     for x in pack_documents(rng, 8, 2048))
               for _ in range(TRAIN_STEPS + 1)]  # set-up, not timed
    tokens_per_step = batches[0][0].numel()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    fa.tile_counts()  # zero the kernels' counts
    losses, step_ms = [], []
    for batch in batches[:TRAIN_STEPS]:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(fa.LAUNCHES)
    counted = fa.tile_counts()
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(step_ms[TRAIN_WARMUP:])
    p50 = statistics.median(steady)
    p99 = steady[min(len(steady) - 1, -(-99 * len(steady) // 100) - 1)]
    expected = model.num_layers * TRAIN_STEPS
    shape = torch.empty(8, 2048, model.num_heads, 0, device="cuda")
    per_batch = [_tiles(torch, torch.nn.functional, fa, shape, shape,
                        dict(causal=True, window=None, q_offset=0,
                             seg_q=seg, seg_k=seg))
                 for _, seg in batches[:TRAIN_STEPS]]
    # each layer's K1, K2 and K3 see the batch's segments once a step
    predicted = tuple(model.num_layers * sum(n) for n in zip(*per_batch))
    tiles = {"counted_by_kernels": counted,
             "predicted_by_live_tiles": predicted}
    summary = {
        "steps": TRAIN_STEPS, "tokens_per_step": tokens_per_step,
        "loss": {str(i): losses[i - 1] for i in (1, 10, 20, 30)},
        "step_ms_p50": p50, "step_ms_p99": p99,
        "step_ms_first": step_ms[0], "tokens_per_s": tokens_per_step
        / (p50 / 1e3), "peak_memory_bytes": peak, "launches": launches,
        "expected_launches": expected, "tiles": tiles}
    print("training summary", json.dumps(summary), flush=True)
    print(f"training: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{TRAIN_STEPS} steps, step p50 {p50:.3f} ms p99 {p99:.3f} ms "
          f"(after {TRAIN_WARMUP} warm-up steps), "
          f"{tokens_per_step / (p50 / 1e3):,.0f} tokens/s, peak memory "
          f"{peak / 2**30:.3f} GiB, launches {launches} (expected "
          f"{expected} each)", flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    if abs(losses[-1] - LOSS_30) > LOSS_30_DRIFT:
        raise AssertionError(f"the loss at step {TRAIN_STEPS} is "
                             f"{losses[-1]}, more than {LOSS_30_DRIFT} from "
                             f"{LOSS_30}")
    if any(n != expected for n in launches.values()):
        raise AssertionError(f"K1/K2/K3 launches {launches} != num_layers "
                             f"x steps = {expected}")
    if any(c != predicted for c in counted.values()) or not predicted[1]:
        raise AssertionError(f"K1-K3 tiles (visited, skipped) over the run "
                             f"{tiles} disagree with the rule, or none was "
                             "skipped")

    def one_step():
        nonlocal state
        state, metrics = step(state, batches[TRAIN_STEPS])
        float(metrics["loss"])

    _profile_window(torch, one_step, "training profile",
                    ("flash_fwd_mma_kernel", "flash_dq_mma_kernel",
                     "flash_dkv_mma_kernel"))
    return launches, summary


# ---------------------------------------------------------------- phase 8

def phase_grad_equivalence(torch, np):
    import functools

    from chainermn_tpu_torch.examples.transformer.train_transformer_lm \
        import pack_documents
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.ops.attention import attention
    from chainermn_tpu_torch.ops.flash_attention import flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = tuple(torch.from_numpy(x).cuda() for x in
                  pack_documents(np.random.default_rng(1), 2, 512))
    out = {}
    for name, fn in (("flash", flash_attention),
                     ("xla", functools.partial(attention, impl="xla"))):
        model = TransformerLM(num_layers=2, compute_dtype=torch.float32,
                              seed=1, attention_fn=fn)
        loss = _packed_loss(model, batch)
        loss.backward()
        out[name] = (loss.item(), {n: p.grad for n, p in
                                   model.named_parameters()})
    (lf, gf), (lx, gx) = out["flash"], out["xla"]
    loss_err = abs(lf - lx) / abs(lx)
    errs = {n: ((gf[n] - gx[n]).abs().max() / gx[n].abs().max()).item()
            for n in gx}
    worst = max(errs, key=errs.get)
    print(f"grad equivalence: fp32 flash vs xla attention, 2 layers, B2 "
          f"T512 packed: loss {lf:.6f} vs {lx:.6f} (rel err {loss_err:.3e}),"
          f" max grad err / max |grad| {errs[worst]:.3e} ({worst}) over "
          f"{len(errs)} tensors (tolerance {GRAD_EQ_TOL})", flush=True)
    if loss_err > LOSS_EQ_TOL or errs[worst] > GRAD_EQ_TOL:
        raise AssertionError(f"flash and xla attention disagree: loss rel "
                             f"err {loss_err}, {worst} grad err "
                             f"{errs[worst]}")


# ---------------------------------------------------------------- phase 9

#: phase 9's gate on 4 fixed batches repeated over RESNET_FIXED_STEPS
#: steps: the mean loss of the last pass over them (4 steps) must fall
#: below this fraction of step 1's loss. Chosen from CPU runs of the twin
#: before the first card run (fp32, full width, 30 steps on 4 fixed
#: batches; last loss over step 1's): 64x64 images at batch 32 0.001, at
#: batch 16 0.0003, 128x128 at batch 16 0.0003; 96x96 at batch 8 swung
#: between 0.001 and 5.4 (of 6.96) and ended at 0.15. Double buffering
#: applies each step's gradients one step late and oscillates at this
#: learning rate (CPU: 0.449 and 1.109 at the end), so that run is held
#: to finite losses only.
RESNET_LOSS_FRACTION = 0.5
RESNET_FIXED_STEPS = 30
RESNET_TIMED_STEPS = 30
#: card bf16 vs CPU fp32, step 1's loss on the same weights and batch
RESNET_LOSS_REL_TOL = 2e-2


def _h2d_ms(torch, host, pinned):
    """Device time of copying ``host`` to the card (CUDA events, median
    of 5)."""
    src = host.pin_memory() if pinned else host
    times = []
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        src.to("cuda", non_blocking=pinned)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def _cpu_step1_loss(torch, run, batch):
    """Step 1's loss of the same weights and batch in fp32 on the CPU
    (local BN, batch statistics)."""
    import torch.nn.functional as F

    from chainermn_tpu_torch.examples.imagenet import train_imagenet as ti
    from chainermn_tpu_torch.models import ResNet50

    cpu = ResNet50(compute_dtype=torch.float32, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in
                         run.model.state_dict().items()})
    with torch.no_grad():
        x, y = ti.to_model_input(batch, "cpu")
        return float(F.cross_entropy(cpu(x), y.long()))


def phase_resnet(torch, np, smi):
    """ResNet-50 data-parallel training through the example twin's path:
    ``train_imagenet.setup`` (pure_nccl, the bf16 wire, sync-BN over the
    one-rank NCCL group, per-rank batch 64 at 224x224, 1000 classes,
    bf16 compute, channels_last, SGD(0.1, momentum 0.9)), once without
    and once with ``--double-buffering``."""
    from chainermn_tpu_torch.examples.imagenet import train_imagenet as ti
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.ops import paged_decode as pd
    from chainermn_tpu_torch.training.prefetch import prefetch_to_device

    summaries = {}
    for db in (False, True):
        tag = "double-buffering" if db else "plain"
        run = ti.setup(["--batchsize", "64", "--image-size", "224"]
                       + (["--double-buffering"] if db else []))
        assert run.comm.backend == "nccl" and run.comm.size == 1
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        pd.LAUNCHES = 0
        fixed = [run.next_batch() for _ in range(4)]  # as the example draws
        cpu_loss = _cpu_step1_loss(torch, run, fixed[0])
        dev_fixed = [ti.to_model_input(b, run.device) for b in fixed]
        state, losses = run.state, []
        for i in range(RESNET_FIXED_STEPS):
            state, metrics = run.step(state, dev_fixed[i % 4])
            losses.append(float(metrics["loss"]))
        rel = abs(losses[0] - cpu_loss) / abs(cpu_loss)
        tail = statistics.fmean(losses[-4:])
        print(f"resnet50 {tag}: step 1 loss {losses[0]:.6f} on the card "
              f"(bf16) vs {cpu_loss:.6f} on the CPU (fp32, same weights "
              f"and batch of 64): rel err {rel:.3e} (limit "
              f"{RESNET_LOSS_REL_TOL}); {RESNET_FIXED_STEPS} steps on 4 "
              f"fixed batches: losses {[round(x, 4) for x in losses]}; "
              f"mean of the last 4 {tail:.4f} = {tail / losses[0]:.4f} of "
              f"step 1's", flush=True)
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite ResNet-50 loss: {losses}")
        if rel > RESNET_LOSS_REL_TOL:
            raise AssertionError(f"step 1's loss on the card {losses[0]} is "
                                 f"{rel} from the CPU's {cpu_loss}")
        if not db and not tail < RESNET_LOSS_FRACTION * losses[0]:
            raise AssertionError(
                f"the fixed-batch loss fell to {tail} of step 1's "
                f"{losses[0]}, not below {RESNET_LOSS_FRACTION} of it")

        # fresh synthetic batches as the example draws them; drawn before
        # the clock starts (the host RNG is timed on its own), copied to
        # the card through the prefetcher inside each timed step
        t0 = time.perf_counter()
        fresh = [run.next_batch()
                 for _ in range(RESNET_TIMED_STEPS + TRAIN_WARMUP)]
        draw_ms = (time.perf_counter() - t0) * 1e3 / len(fresh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        batches = prefetch_to_device(iter(fresh), 2)
        step_ms, t_run = [], time.perf_counter()
        for i in range(len(fresh)):
            if i == TRAIN_WARMUP:
                t_run = time.perf_counter()
            t0 = time.perf_counter()
            x, y = next(batches)
            state, metrics = run.step(state, (x.permute(0, 3, 1, 2), y))
            losses.append(float(metrics["loss"]))  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
        wall = time.perf_counter() - t_run
        peak = torch.cuda.max_memory_allocated()
        steady = sorted(step_ms[TRAIN_WARMUP:])
        p50 = statistics.median(steady)
        p99 = steady[min(len(steady) - 1, -(-99 * len(steady) // 100) - 1)]
        ours = {**fa.LAUNCHES, "paged_flash_decode": pd.LAUNCHES}
        x_host = torch.from_numpy(fresh[0][0])
        h2d = {"pageable": _h2d_ms(torch, x_host, False),
               "pinned": _h2d_ms(torch, x_host, True)}
        batch = (x.permute(0, 3, 1, 2), y)

        def one_step():
            nonlocal state
            state, m = run.step(state, batch)
            float(m["loss"])

        prof_wall, busy, kernels = _profile_window(
            torch, one_step, f"resnet50 {tag} profile",
            ("xmma", "gemm", "elementwise", "reduce", "copy", "nccl",
             "pool"))
        images = 64 * RESNET_TIMED_STEPS
        summaries[tag] = {
            "img_per_s": images / wall, "img_per_s_at_p50": 64 / (p50 / 1e3),
            "step_ms_p50": p50, "step_ms_p99": p99,
            "step_ms_first_fresh": step_ms[0], "peak_memory_bytes": peak,
            "busy_share": busy / prof_wall, "profiled_wall_ms": prof_wall,
            "device_busy_ms": busy,
            "device_ops_per_step": sum(kc[1] for kc in kernels),
            "h2d_ms": h2d,
            "host_batch_draw_ms": draw_ms,
            "fixed_batch_losses": losses[:RESNET_FIXED_STEPS],
            "cpu_step1_loss": cpu_loss, "tpu_kernel_port_launches": ours}
        print(f"resnet50 {tag} summary", json.dumps(summaries[tag]),
              flush=True)
        print(f"resnet50 {tag}: {images / wall:.1f} img/s over "
              f"{RESNET_TIMED_STEPS} steps on fresh batches (after "
              f"{TRAIN_WARMUP} warm-up), step p50 {p50:.3f} ms p99 "
              f"{p99:.3f} ms, peak memory {peak / 2**30:.3f} GiB, device "
              f"busy {busy / prof_wall:.4f} of one profiled step's wall; "
              f"H2D of one batch (38.5 MB fp32) {h2d['pageable']:.3f} ms "
              f"pageable, {h2d['pinned']:.3f} ms pinned; host draw of one "
              f"batch {draw_ms:.1f} ms; launches of the TPU-kernel ports "
              f"{ours}; card {smi}", flush=True)
        if any(ours.values()):
            raise AssertionError(f"the ResNet path launched a TPU-kernel "
                                 f"port: {ours}")
        torch.cuda.empty_cache()
    return summaries


# ---------------------------------------------------------------- phase 10

MNIST_ITERATIONS = 200
MNIST_MIN_ACC = 0.9


def phase_mnist(torch, smi):
    """The MNIST twin at full width over pure_nccl: 200 iterations of
    batch 256 with ``--prefetch 2``, evaluated every 100."""
    from chainermn_tpu_torch.examples.mnist import train_mnist

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final = train_mnist.main(["--iterations", str(MNIST_ITERATIONS),
                              "--batchsize", "256", "--prefetch", "2"])
    wall = time.perf_counter() - t0
    print(f"mnist: {MNIST_ITERATIONS} iterations of batch 256 in "
          f"{wall:.3f} s, {wall / MNIST_ITERATIONS * 1e3:.3f} ms per "
          f"iteration (set-up and 3 evaluations included); final "
          f"{final}; card {smi}", flush=True)
    if not final["val_acc"] >= MNIST_MIN_ACC:
        raise AssertionError(f"MNIST val accuracy {final['val_acc']} < "
                             f"{MNIST_MIN_ACC}")
    return final


# ---------------------------------------------------------------- phase 11

ENCODER_STEPS = 30
MLM_MASK_ID = 31999
MLM_RATE = 0.15
#: lm_loss_fused against lm_loss on the same bf16 hidden states and
#: table: the losses' relative difference, and each gradient's max error
#: over its max |value|. Both heads multiply bf16 operands; the unfused
#: one rounds its logits (and their gradient) to bf16, the fused one
#: keeps them in fp32, so they part by bf16 rounding — TOLERANCE's bf16
#: 2e-2 for the gradients, and for the mean loss over 16,376 targets,
#: where the roundings average out, 1e-3.
FUSED_LOSS_REL_TOL = 1e-3
FUSED_GRAD_TOL = 2e-2
FUSED_CHUNKS = 8
REMAT_STEPS = 5
#: the step-5 loss with and without remat: the recomputed block runs the
#: same kernels on the same inputs
REMAT_LOSS_REL_TOL = 1e-6
FLASH_KERNELS = ("flash_fwd_mma_kernel", "flash_dq_mma_kernel",
                 "flash_dkv_mma_kernel")


def _p50_p99(ms):
    steady = sorted(ms)
    return (statistics.median(steady),
            steady[min(len(steady) - 1, -(-99 * len(steady) // 100) - 1)])


def _run_steps(step, state, batches):
    """Run ``step`` over ``batches``: (state, losses, host ms of each
    step, each ending in a host read of its loss)."""
    losses, ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, losses, ms


def _mlm_batches(torch, np, n):
    """``n`` MLM batches of B 8 x T 2048: the example twin's synthetic
    tokens as targets (all below the mask id), corrupted by
    ``mlm_corrupt`` from a card generator seeded with the step's index,
    as the twin does."""
    from chainermn_tpu_torch.examples.transformer.train_transformer_lm \
        import synthetic_tokens
    from chainermn_tpu_torch.models import mlm_corrupt

    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        targets = torch.from_numpy(
            synthetic_tokens(rng, 8, 2048) % MLM_MASK_ID).cuda()
        gen = torch.Generator(device="cuda").manual_seed(i)
        x, sel = mlm_corrupt(gen, targets, mask_id=MLM_MASK_ID,
                             vocab_size=32000, rate=MLM_RATE)
        out.append((x, targets, sel))
    return out


def _mlm_loss(model, batch):
    from chainermn_tpu_torch.models import mlm_loss

    x, targets, sel = batch
    return mlm_loss(model(x), targets, sel)


def _trainer(torch, loss_fn, *, double_buffering=False, **model_kw):
    """Transformer-base (bf16, seeded weights, flash attention) behind
    AdamW(3e-4, weight decay 1e-4) in ``create_multi_node_optimizer``
    over ``pure_nccl`` at world size 1: (comm, model, state, step)."""
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.training import (
        create_train_state,
        make_train_step,
    )

    model = TransformerLM(seed=0, attention_fn=fa.flash_attention,
                          **model_kw)
    comm = create_communicator("pure_nccl")
    opt = create_multi_node_optimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4), comm,
        double_buffering=double_buffering)
    return (comm, model, create_train_state(model, opt, comm),
            make_train_step(loss_fn, opt, comm))


def _reset_launches(fa):
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0


def phase_encoder(torch, np, smi):
    """(a) The bidirectional encoder at full width on the MLM recipe:
    30 steps, K1-K3 without the mask, their launches per step."""
    from chainermn_tpu_torch.ops import flash_attention as fa

    batches = _mlm_batches(torch, np, ENCODER_STEPS + 1)  # set-up
    _, model, state, step = _trainer(torch, _mlm_loss, causal=False)
    tokens_per_step = batches[0][0].numel()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(fa)
    state, losses, ms = _run_steps(step, state, batches[:ENCODER_STEPS])
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    p50, p99 = _p50_p99(ms[TRAIN_WARMUP:])
    expected = model.num_layers * ENCODER_STEPS

    def one_step():
        nonlocal state
        state, metrics = step(state, batches[ENCODER_STEPS])
        float(metrics["loss"])

    wall, busy, _ = _profile_window(torch, one_step, "encoder profile",
                                    FLASH_KERNELS)
    summary = {
        "steps": ENCODER_STEPS, "tokens_per_step": tokens_per_step,
        "loss": {str(i): losses[i - 1] for i in (1, 10, 20, 30)},
        "step_ms_p50": p50, "step_ms_p99": p99,
        "tokens_per_s": tokens_per_step / (p50 / 1e3),
        "peak_memory_bytes": peak, "busy_share": busy / wall,
        "launches": launches,
        "launches_per_step": {k: v / ENCODER_STEPS
                              for k, v in launches.items()},
        "expected_launches": expected}
    print("encoder summary", json.dumps(summary), flush=True)
    print(f"encoder (causal=False, MLM, mask id {MLM_MASK_ID}, rate "
          f"{MLM_RATE}): loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{ENCODER_STEPS} steps, step p50 {p50:.3f} ms p99 {p99:.3f} ms, "
          f"{tokens_per_step / (p50 / 1e3):,.0f} tokens/s, peak memory "
          f"{peak / 2**30:.3f} GiB, device busy {busy / wall:.4f} of one "
          f"profiled step, K1/K2/K3 launches {launches} (expected "
          f"{expected} each); card {smi}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite encoder loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the encoder loss did not fall: {losses[0]} "
                             f"-> {losses[-1]}")
    if any(n != expected for n in launches.values()):
        raise AssertionError(f"K1/K2/K3 launches {launches} != num_layers x "
                             f"steps = {expected}")
    del model, state, step
    return batches, summary


def _fwd_bwd_measure(torch, fn, flush):
    """(result, peak bytes above the live memory before, device ms of
    forward+backward)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return out, peak, _time_ms(torch, fn, flush)


def phase_fused_loss(torch, np, smi):
    """(b) ``lm_loss_fused`` (8 chunks) against ``lm_loss`` over the tied
    head on the same hidden states of the causal LM, B 8 x T 2048."""
    import torch.nn.functional as F

    from chainermn_tpu_torch.models import (
        TransformerLM,
        lm_loss,
        lm_loss_fused,
    )
    from chainermn_tpu_torch.ops import flash_attention as fa

    model = TransformerLM(seed=0, attention_fn=fa.flash_attention,
                          return_hidden=True)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, model.vocab_size, (8, 2048))).cuda()
    with torch.no_grad():
        hidden = model(tokens)
    table = model.tok_emb.weight
    dt = model.compute_dtype

    def unfused():
        h = hidden.detach().requires_grad_()
        loss = lm_loss(F.linear(h.to(dt), table.to(dt)), tokens)
        return (loss, *torch.autograd.grad(loss, (h, table)))

    def fused():
        h = hidden.detach().requires_grad_()
        loss = lm_loss_fused(h, table, tokens, n_chunks=FUSED_CHUNKS,
                             compute_dtype=dt)
        return (loss, *torch.autograd.grad(loss, (h, table)))

    flush = torch.empty(24 * 2**20, dtype=torch.float32, device="cuda")
    (lu, hu, tu), peak_u, ms_u = _fwd_bwd_measure(torch, unfused, flush)
    (lf, hf, tf), peak_f, ms_f = _fwd_bwd_measure(torch, fused, flush)
    lf, lu = float(lf.detach()), float(lu.detach())
    loss_rel = abs(lf - lu) / abs(lu)
    errs = {name: ((a.float() - b.float()).abs().max()
                   / b.float().abs().max()).item()
            for name, a, b in (("hidden", hf, hu), ("table", tf, tu))}
    row = {"loss_fused": lf, "loss_unfused": lu,
           "loss_rel_diff": loss_rel, "grad_err_over_max": errs,
           "ms": {"fused": ms_f, "unfused": ms_u},
           "peak_bytes": {"fused": peak_f, "unfused": peak_u},
           "chunks": FUSED_CHUNKS,
           "limits": {"loss_rel": FUSED_LOSS_REL_TOL,
                      "grad": FUSED_GRAD_TOL}}
    _profile_window(torch, fused, "fused loss profile",
                    ("gemm", "logsumexp", "elementwise", "reduce", "copy"))
    print("fused loss", json.dumps(row), flush=True)
    print(f"lm_loss_fused ({FUSED_CHUNKS} chunks) vs lm_loss on the same "
          f"hidden states, B 8 x T 2048, vocab {model.vocab_size}: loss "
          f"{lf:.6f} vs {lu:.6f} (rel {loss_rel:.3e}, limit "
          f"{FUSED_LOSS_REL_TOL}), max grad err / max |grad| {errs} (limit "
          f"{FUSED_GRAD_TOL}); forward+backward {ms_f:.3f} ms vs "
          f"{ms_u:.3f} ms, peak above live memory {peak_f / 2**30:.3f} GiB "
          f"vs {peak_u / 2**30:.3f} GiB; card {smi}", flush=True)
    if not (math.isfinite(lf) and loss_rel <= FUSED_LOSS_REL_TOL
            and all(e <= FUSED_GRAD_TOL for e in errs.values())):
        raise AssertionError(f"lm_loss_fused disagrees with lm_loss: {row}")
    return row


def phase_remat_dropout(torch, np, smi, batches):
    """(c) 5 encoder steps with ``remat=True`` ('dots') against 5
    without, and one step with ``dropout_rate=0.1``."""
    from chainermn_tpu_torch.models import mlm_loss
    from chainermn_tpu_torch.ops import flash_attention as fa

    runs = {}
    for tag, kw in (("plain", {}),
                    ("remat_dots", {"remat": True, "remat_policy": "dots"})):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, model, state, step = _trainer(torch, _mlm_loss, causal=False,
                                         **kw)
        _reset_launches(fa)
        state, losses, ms = _run_steps(step, state, batches[:REMAT_STEPS])
        runs[tag] = {"losses": losses, "step_ms_p50": _p50_p99(ms[1:])[0],
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                     "launches": dict(fa.LAUNCHES)}
        del model, state, step
    a, b = runs["plain"]["losses"], runs["remat_dots"]["losses"]
    rel = abs(a[-1] - b[-1]) / abs(a[-1])
    gen = torch.Generator(device="cuda").manual_seed(123)

    def dropout_loss(model, batch):
        x, targets, sel = batch
        return mlm_loss(model(x, dropout_generator=gen), targets, sel)

    _, model, state, step = _trainer(torch, dropout_loss, causal=False,
                                     dropout_rate=0.1)
    _, drop, _ = _run_steps(step, state, batches[:1])
    del model, state, step
    summary = {**runs, "step5_rel_diff": rel, "bit_identical": a == b,
               "dropout_step1_loss": drop[0], "plain_step1_loss": a[0]}
    print("remat summary", json.dumps(summary), flush=True)
    print(f"remat 'dots' vs plain, {REMAT_STEPS} encoder steps: peak memory "
          f"{runs['remat_dots']['peak_memory_bytes'] / 2**30:.3f} vs "
          f"{runs['plain']['peak_memory_bytes'] / 2**30:.3f} GiB, step p50 "
          f"{runs['remat_dots']['step_ms_p50']:.3f} vs "
          f"{runs['plain']['step_ms_p50']:.3f} ms, step-5 loss {b[-1]!r} vs "
          f"{a[-1]!r} (rel {rel:.3e}, limit {REMAT_LOSS_REL_TOL}; bit-"
          f"identical over the 5 steps: {a == b}), launches "
          f"{runs['remat_dots']['launches']} vs {runs['plain']['launches']}"
          f"; dropout 0.1, step 1 loss {drop[0]:.6f} vs {a[0]:.6f} without;"
          f" card {smi}", flush=True)
    if rel > REMAT_LOSS_REL_TOL:
        raise AssertionError(f"remat moved the step-5 loss by {rel}")
    if not math.isfinite(drop[0]) or drop[0] == a[0]:
        raise AssertionError(f"the dropout step's loss {drop[0]} is not "
                             f"finite or equals the plain step's {a[0]}")
    return summary


# ---------------------------------------------------------------- phase 12

RESUME_STEPS = 20
RESUME_AT = 10
DRILL_STEPS = 20
DRILL_SIGNAL_AT = 7
DRILL_EVERY = 5
DRILL_TIMEOUT_S = 180


def _resume_batches(torch, np, n):
    """Phase 7's packed documents, batch i seeded by its step index."""
    from chainermn_tpu_torch.examples.transformer.train_transformer_lm \
        import pack_documents

    return [tuple(torch.from_numpy(x).cuda() for x in
                  pack_documents(np.random.default_rng(1000 + i), 8, 2048))
            for i in range(n)]


def _dir_bytes(path):
    path = Path(path)
    if path.is_file():
        return path.stat().st_size
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def phase_resume(torch, np, smi, tmp):
    """(a) Phase 7's training with double buffering: 20 steps without a
    stop, against 10 steps, a snapshot, a freshly built model and
    optimizer, ``maybe_load`` and 10 more steps — through the npz
    checkpointer (async native writer) and the dcp adapter. Steps 11-20
    must give the same losses bit for bit."""
    from chainermn_tpu_torch.extensions import (
        create_dcp_checkpointer,
        create_multi_node_checkpointer,
    )

    batches = _resume_batches(torch, np, RESUME_STEPS)
    _, _, state, step = _trainer(torch, _packed_loss, double_buffering=True)
    _, ref, _ = _run_steps(step, state, batches)
    del state, step
    rows = {}
    for backend, make in (("npz", create_multi_node_checkpointer),
                          ("dcp", create_dcp_checkpointer)):
        torch.cuda.empty_cache()
        comm, _, state, step = _trainer(torch, _packed_loss,
                                        double_buffering=True)
        state, first, _ = _run_steps(step, state, batches[:RESUME_AT])
        ckpt = make(f"resume_{backend}", comm, path=str(tmp))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        where = ckpt.save(state, RESUME_AT, block=True)
        block_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ckpt.save(state, RESUME_AT, block=False)
        submit_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ckpt.wait_async()
        drain_ms = (time.perf_counter() - t0) * 1e3
        size = _dir_bytes(where)
        del state, step
        torch.cuda.empty_cache()
        _, _, fresh, step = _trainer(torch, _packed_loss,
                                     double_buffering=True)
        t0 = time.perf_counter()
        fresh, it = ckpt.maybe_load(fresh)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        _, rest, _ = _run_steps(step, fresh, batches[RESUME_AT:])
        ckpt.close()
        del fresh, step
        same = first + rest == ref
        rows[backend] = {"snapshot_mb": size / 1e6, "block_save_ms": block_ms,
                         "async_submit_ms": submit_ms,
                         "async_drain_ms": drain_ms, "load_ms": load_ms,
                         "resumed_at": it, "bit_identical": same,
                         "losses_11_20": rest, "uninterrupted_11_20":
                         ref[RESUME_AT:]}
        print(f"resume {backend}: snapshot {size / 1e6:.1f} MB, blocking "
              f"save {block_ms:.1f} ms, async submit {submit_ms:.1f} ms + "
              f"drain {drain_ms:.1f} ms, maybe_load {load_ms:.1f} ms "
              f"(iteration {it}); steps 11-20 bit-identical to the run "
              f"without a stop: {same}; card {smi}", flush=True)
        if it != RESUME_AT or not same:
            raise AssertionError(
                f"resume through {backend} at iteration {it}: losses of "
                f"steps 1-20 {first + rest} != {ref} without a stop")
    print("resume summary", json.dumps(rows), flush=True)
    return rows


def _drill_batch(torch, np, it, device):
    rng = np.random.default_rng(it)
    x = torch.from_numpy(rng.standard_normal((256, 784), np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 256))
    return x.to(device), y.to(device)


def _drill(ckpt_dir, mode):
    """The MNIST MLP trained DRILL_STEPS steps on seeded batches (SGD,
    momentum 0.9). ``'preempt'``: under the preemption guard, waiting at
    step DRILL_SIGNAL_AT for a SIGTERM, checkpointing when the guard
    says so (every DRILL_EVERY steps) and exiting 0 there; ``'resume'``:
    from the snapshot to the end; ``'straight'``: no stop. Returns the
    final parameters."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.models import MLP
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.training import (
        create_train_state,
        make_train_step,
    )
    from chainermn_tpu_torch.utils.preemption import install_preemption_guard

    comm = create_communicator("pure_nccl")
    model = MLP(seed=0)
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9), comm)
    state = create_train_state(model, opt, comm)
    step = make_train_step(
        lambda m, b: F.cross_entropy(m(b[0]).float(), b[1]), opt, comm)
    start = 0
    guard = ckpt = None
    if mode != "straight":
        ckpt = create_multi_node_checkpointer("drill", comm, path=ckpt_dir,
                                              keep=2)
    if mode == "resume":
        state, start = ckpt.maybe_load(state)
        print(f"drill: resumed from iteration {start}", flush=True)
    if mode == "preempt":
        guard = install_preemption_guard()
    for it in range(start + 1, DRILL_STEPS + 1):
        state, _ = step(state, _drill_batch(torch, np, it, comm.device))
        if guard is None:
            continue
        if it == DRILL_SIGNAL_AT:
            print(f"drill: step {it} done, waiting for SIGTERM", flush=True)
            deadline = time.monotonic() + 60
            while not guard.triggered and time.monotonic() < deadline:
                time.sleep(0.01)
        if guard.should_checkpoint(comm, every=DRILL_EVERY, iteration=it):
            ckpt.save(state, it)
            print(f"drill: preempted, saved iteration {it}", flush=True)
            guard.exit_if_preempted(comm)
    if mode == "preempt":
        raise AssertionError("the preemption guard never triggered")
    return {k: v.detach().cpu().numpy()
            for k, v in state.model.state_dict().items()}


def _drill_child(ckpt_dir, mode):
    import numpy as np

    params = _drill(ckpt_dir, mode)
    np.savez(Path(ckpt_dir) / f"final_{mode}.npz", **params)
    print("drill: finished", flush=True)


def phase_preemption(torch, np, smi, tmp):
    """(b) The preemption drill in child processes on the card: SIGTERM
    at a known step, a snapshot at the next multiple of DRILL_EVERY, exit
    0, one snapshot; a second child resumes and finishes; its parameters
    must equal those of a run without a stop."""
    ckpt_dir = tmp / "drill"
    ckpt_dir.mkdir()
    cmd = [sys.executable, str(Path(__file__).resolve()), "--drill-child",
           str(ckpt_dir)]
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd + ["preempt"], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    lines = []
    try:
        for line in child.stdout:
            lines.append(line.rstrip())
            if "waiting for SIGTERM" in line:
                child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=DRILL_TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    preempt_s = time.perf_counter() - t0
    saved = sorted(f.name for f in ckpt_dir.iterdir()
                   if f.name.startswith("snapshot_"))
    expected_it = -(-DRILL_SIGNAL_AT // DRILL_EVERY) * DRILL_EVERY
    print(f"preemption drill: SIGTERM after step {DRILL_SIGNAL_AT}; child "
          f"exit {rc} in {preempt_s:.1f} s; snapshots {saved}; its last "
          f"lines {lines[-3:]}", flush=True)
    if rc != 0 or saved != [f"snapshot_drill_0_{expected_it}.npz"]:
        raise AssertionError(f"the preempted child exited {rc} leaving "
                             f"{saved} (expected exit 0 and one snapshot at "
                             f"iteration {expected_it}):\n" + "\n".join(lines))
    done = subprocess.run(cmd + ["resume"], capture_output=True, text=True,
                          cwd=ROOT, timeout=DRILL_TIMEOUT_S)
    if done.returncode != 0:
        raise AssertionError(f"the resuming child failed:\n{done.stdout}\n"
                             f"{done.stderr}")
    resumed = dict(np.load(ckpt_dir / "final_resume.npz"))
    straight = _drill(None, "straight")
    same = (set(resumed) == set(straight)
            and all(np.array_equal(resumed[k], straight[k])
                    for k in straight))
    print(f"preemption drill: the resumed child ("
          f"{done.stdout.strip().splitlines()[0]}) ends with parameters "
          f"equal bit for bit to a run without a stop: {same}; card {smi}",
          flush=True)
    if not same:
        raise AssertionError("the resumed run's parameters differ from the "
                             "run without a stop")
    return {"exit": rc, "snapshots": saved, "bit_identical": same}


def phase_mnist_resume(torch, smi, tmp):
    """(c) The MNIST twin with --checkpoint: 100 iterations, then again to
    200, which must resume from iteration 100."""
    import contextlib
    import io

    from chainermn_tpu_torch.examples.mnist import train_mnist

    ckpt_dir = tmp / "mnist"
    flags = ["--checkpoint", str(ckpt_dir), "--checkpoint-interval", "50"]
    outs, finals = [], []
    for n in (100, 200):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            finals.append(train_mnist.main(flags + ["--iterations", str(n)]))
        outs.append(buf.getvalue())
    saved = sorted(f.name for f in ckpt_dir.iterdir())
    resumed = "resumed from iteration 100" in outs[1]
    print(f"mnist --checkpoint: 100 iterations (final {finals[0]}), then "
          f"--iterations 200: 'resumed from iteration 100' printed: "
          f"{resumed}; final val accuracy {finals[1]['val_acc']}; "
          f"snapshots {saved}; card {smi}", flush=True)
    if not resumed or not finals[1]["val_acc"] >= MNIST_MIN_ACC:
        raise AssertionError(f"the MNIST twin did not resume from 100 or "
                             f"did not learn:\n{outs[1]}")
    return finals[1]


# ---------------------------------------------------------------- phase 14

#: phase 14 (a): phase 3's serving pool (Hq = Hkv = 8) split into this
#: many tensor-parallel shards of 4 heads each
STACK_SHARDS = 2
#: phase 14 (c): the Transformer-base block at tensor-parallel size 1
TP_D, TP_FF, TP_HEADS, TP_B, TP_T = 512, 2048, 8, 8, 2048
#: phase 14 (d): SGD steps of the converted model and its twin
MNBN_STEPS = 5


def _stack_heads(torch, t, shards):
    """``[..., H, D]`` as ``[shards, ..., H / shards, D]``: the heads
    split into ``shards`` tensor-parallel groups."""
    return torch.stack(t.chunk(shards, dim=-2)).contiguous()


def phase_stacked_kernels(torch, np, F):
    """Phase 14 (a): K4's 5-D tensor-parallel stacked entry at phase 3's
    pool split into STACK_SHARDS shards: the decode tick and a T 512
    prefill, counted as this phase's main path, then each held to its
    per-shard 4-D calls (bit for bit) and to the plain version, and
    timed beside SDPA on the same heads and its bound."""
    from chainermn_tpu_torch.ops import paged_decode as pd

    gen = torch.Generator().manual_seed(14)
    flush = torch.empty(24 * 2**20, dtype=torch.float32, device="cuda")
    spread = [int(x) for x in np.linspace(0, 2047, 16)]
    cases = [("stacked_decode", dict(B=16, T=1, Hq=8, Hkv=8,
                                     positions=spread, scratch_rows=(3,))),
             ("stacked_prefill_T512", dict(B=1, T=512, Hq=8, Hkv=8,
                                           positions=[0]))]
    made = []
    for name, kw in cases:
        q, kp, vp, tables, pos = _k4_case(torch, gen, dtype=torch.bfloat16,
                                          **kw)
        for r in kw.get("scratch_rows", ()):
            pos[r] = 0
        stacked = [_stack_heads(torch, t, STACK_SHARDS) for t in (q, kp, vp)]
        made.append((name, kw, (q, kp, vp, tables, pos), stacked))
    # the main path: both calls, counted
    torch.cuda.synchronize()
    pd.reset_launches()
    outs = [pd.paged_flash_decode(*stacked, tables, pos)
            for _, _, (_, _, _, tables, pos), stacked in made]
    torch.cuda.synchronize()
    counted = {"stacked": pd.STACKED_LAUNCHES, "launches": pd.LAUNCHES,
               "routes": dict(pd.ROUTE_LAUNCHES)}
    want_routes = {"split": STACK_SHARDS, "mma": STACK_SHARDS, "rows": 0}
    print(f"K4 stacked main path: {json.dumps(counted)} (expected 2 "
          f"stacked calls, routes {json.dumps(want_routes)})", flush=True)
    if (counted["stacked"] != 2 or counted["routes"] != want_routes
            or counted["launches"] != 2 * STACK_SHARDS):
        raise AssertionError(f"K4's 5-D entry launches {counted} != 2 "
                             f"calls of {STACK_SHARDS} shards on the split "
                             "and mma routes")
    rows = []
    for (name, kw, full, stacked), got in zip(made, outs):
        tables, pos = full[3], full[4]
        shards_equal = all(bool(torch.equal(got[s], pd.paged_flash_decode(
            stacked[0][s], stacked[1][s], stacked[2][s], tables, pos)))
            for s in range(STACK_SHARDS))
        want = pd.paged_flash_decode_reference(*stacked, tables, pos)
        err = (got.float() - want.float()).abs().max().item()
        over = _per_entry_over_limit(got, want)
        nbytes, ops = _k4_work(np, full[0], full[1], tables, pos, None)
        bound_ms, bound_by = _bound(nbytes, ops, torch.bfloat16)
        row = {"case": name, "dtype": "bfloat16", "shards": STACK_SHARDS,
               "shape": {k: v for k, v in kw.items()
                         if k in ("B", "T", "Hq", "Hkv")},
               "route": pd._route(torch.bfloat16, kw["T"],
                                  kw["Hq"] // STACK_SHARDS,
                                  kw["Hkv"] // STACK_SHARDS),
               "max_abs_err": err, "tolerance": TOLERANCE["torch.bfloat16"],
               "per_entry_over_limit": over,
               "equal_to_per_shard_calls": shards_equal,
               "ms": _time_ms(torch, lambda: pd.paged_flash_decode(
                   *stacked, tables, pos), flush),
               "plain_ms": _time_ms(
                   torch, lambda: pd.paged_flash_decode_reference(
                       *stacked, tables, pos), flush),
               "library_ms": _time_ms(torch, _sdpa_yardstick(
                   torch, F, *full, None), flush),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bytes": nbytes, "ops": ops}
        print("K4 stacked", json.dumps(row), flush=True)
        if not (shards_equal and err <= TOLERANCE["torch.bfloat16"]
                and over <= 1.0 and bool(torch.isfinite(got).all())):
            raise AssertionError(f"K4 stacked {name}: equal to the "
                                 f"per-shard calls={shards_equal}, max abs "
                                 f"err {err}, per entry {over} of its limit")
        rows.append(row)
    return rows, counted


def _one_rank_cases(torch, Fn, C, T):
    """``(name, f, expected(x))`` of every function of ``functions/``,
    ``parallel/collectives.py`` and the f/g pairs of ``parallel/
    tensor.py`` at world size 1: what each means on one rank."""
    return [
        ("send_recv(x, 0, 0)", lambda x: Fn.send_recv(x, 0, 0), lambda x: x),
        ("send+recv", lambda x: _sent_and_received(Fn, x), lambda x: x),
        ("pseudo_connect", lambda x: Fn.pseudo_connect(x.sum() * 0, x),
         lambda x: x),
        ("stream_blocks", lambda x: Fn.stream_blocks({"k": x}, 0, 0)["k"],
         lambda x: x),
        ("allgather", lambda x: Fn.allgather(x), lambda x: x[None]),
        ("allgather tiled", lambda x: Fn.allgather(x, axis=1, tiled=True),
         lambda x: x),
        ("alltoall", lambda x: Fn.alltoall(x), lambda x: x),
        ("bcast", lambda x: Fn.bcast(x), lambda x: x),
        ("gather", lambda x: Fn.gather(x), lambda x: x[None]),
        ("scatter", lambda x: Fn.scatter(x), lambda x: x),
        ("allreduce", lambda x: Fn.allreduce(x), lambda x: x),
        ("allreduce mean", lambda x: C.allreduce(x, op="mean"),
         lambda x: x),
        ("reduce_scatter", lambda x: C.reduce_scatter(x), lambda x: x),
        ("ppermute", lambda x: C.ppermute(x, None, [(0, 0)]), lambda x: x),
        ("shift", lambda x: C.shift(x), lambda x: x),
        ("copy_to_tp", lambda x: T.copy_to_tp(x), lambda x: x),
        ("reduce_from_tp", lambda x: T.reduce_from_tp(x), lambda x: x),
        ("gather_from_tp", lambda x: T.gather_from_tp(x), lambda x: x),
    ]


def _sent_and_received(Fn, x):
    received, delegate = Fn.send(x, 0, None, src=0)
    return Fn.recv(received, delegate=delegate)


def phase_cross_rank_functions(torch):
    """Phase 14 (b): every function of ``functions/`` and
    ``parallel/collectives.py`` (and the f/g pairs) over NCCL at world
    size 1 on CUDA tensors: forward and ``autograd.grad`` equal, bit for
    bit, to their one-rank meaning."""
    from chainermn_tpu_torch import functions as Fn
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.parallel import collectives as C
    from chainermn_tpu_torch.parallel import tensor as T

    comm = create_communicator("pure_nccl")
    if not (C.axis_index() == 0 and C.axis_size_of(comm) == 1
            and C.axes_bound(comm.group)):
        raise AssertionError("the one-rank NCCL group's index, size or "
                             "bound probe is wrong")
    gen = torch.Generator(device="cuda").manual_seed(14)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, f, meaning in _one_rank_cases(torch, Fn, C, T):
            x = torch.randn(4, 6, 8, device="cuda", generator=gen,
                            dtype=dtype).requires_grad_()
            y = f(x)
            ct = torch.randn(y.shape, device="cuda", generator=gen,
                             dtype=dtype)
            (g,) = torch.autograd.grad(y, x, ct)
            want_y = meaning(x.detach())
            ok = (torch.equal(y.detach(), want_y)
                  and torch.equal(g, ct.reshape(x.shape)))
            results[f"{name} {str(dtype)[6:]}"] = ok
            if not ok:
                raise AssertionError(f"{name} ({dtype}) at world size 1: "
                                     "forward or gradient differs from its "
                                     "one-rank meaning")
        for op in ("max", "min"):
            x = torch.randn(5, device="cuda", dtype=dtype,
                            generator=gen).requires_grad_()
            y = C.allreduce(x, comm, op=op)
            try:
                torch.autograd.grad(y.sum(), x)
                raised = False
            except NotImplementedError:
                raised = True
            if not (torch.equal(y.detach(), x.detach()) and raised):
                raise AssertionError(f"allreduce {op}: value or its "
                                     "refused gradient")
            results[f"allreduce {op} {str(dtype)[6:]}"] = True
    print(f"cross-rank functions over NCCL at world size 1: "
          f"{sum(results.values())} of {len(results)} equal to their "
          f"one-rank meaning, forward and backward: "
          f"{json.dumps(results)}", flush=True)
    return comm


def phase_tensor_parallel(torch, np, comm):
    """Phase 14 (c): ``tp_mlp``, ``tp_attention`` and the column and row
    layers at tensor-parallel size 1, Transformer-base widths (d 512,
    d_ff 2048, 8 heads, B 8 x T 2048, bf16), against the dense layers:
    outputs and gradients, and ms of each."""
    import torch.nn.functional as F

    from chainermn_tpu_torch.ops.attention import dot_product_attention
    from chainermn_tpu_torch.parallel import tensor as T

    g = comm.group
    gen = torch.Generator(device="cuda").manual_seed(14)
    flush = torch.empty(24 * 2**20, dtype=torch.float32, device="cuda")
    bf = torch.bfloat16

    def rnd(*shape, scale=0.02):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(bf)

    x = rnd(TP_B, TP_T, TP_D, scale=1.0)
    w1, b1, w2, b2 = rnd(TP_D, TP_FF), rnd(TP_FF), rnd(TP_FF, TP_D), rnd(TP_D)
    wq, wk, wv, wo = (rnd(TP_D, TP_D) for _ in range(4))
    hd = TP_D // TP_HEADS

    def dense_attn(x, wq, wk, wv, wo):
        q, k, v = ((x @ w).reshape(TP_B, TP_T, TP_HEADS, hd)
                   for w in (wq, wk, wv))
        ctx = dot_product_attention(q, k, v, causal=True)
        return ctx.reshape(TP_B, TP_T, TP_D) @ wo

    layers = {
        "column_parallel_dense": (
            lambda x, w, b: T.column_parallel_dense(x, w, b, group=g),
            lambda x, w, b: x @ w + b, (x, w1, b1)),
        "row_parallel_dense": (
            lambda x, w, b: T.row_parallel_dense(x, w, b, group=g),
            lambda x, w, b: x @ w + b, (rnd(TP_B, TP_T, TP_FF, scale=1.0),
                                        w2, b2)),
        "tp_mlp": (
            lambda x, w1, b1, w2, b2: T.tp_mlp(x, w1, b1, w2, b2, group=g),
            lambda x, w1, b1, w2, b2: F.gelu(x @ w1 + b1,
                                             approximate="tanh") @ w2 + b2,
            (x, w1, b1, w2, b2)),
        "tp_attention": (
            lambda x, *w: T.tp_attention(x, *w, group=g, n_heads=TP_HEADS,
                                         causal=True),
            dense_attn, (x, wq, wk, wv, wo)),
    }
    rows = {}
    for name, (tp, dense, args) in layers.items():
        args = [a.detach().requires_grad_() for a in args]
        y = tp(*args)
        ct = torch.randn(y.shape, device="cuda", generator=gen).to(bf)
        grads = torch.autograd.grad(y, args, ct)
        y_ref = dense(*args)
        grads_ref = torch.autograd.grad(y_ref, args, ct)
        errs = [((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1.0)).item()
                for a, b in zip([y, *grads], [y_ref, *grads_ref])]
        bitwise = all(bool(torch.equal(a, b)) for a, b in
                      zip([y, *grads], [y_ref, *grads_ref]))
        row = {"err_over_max": max(errs), "bit_identical": bitwise,
               "ms": _time_ms(torch, lambda: tp(*args), flush),
               "dense_ms": _time_ms(torch, lambda: dense(*args), flush),
               "fwd_bwd_ms": _time_ms(torch, lambda: torch.autograd.grad(
                   tp(*args), args, ct), flush),
               "dense_fwd_bwd_ms": _time_ms(
                   torch, lambda: torch.autograd.grad(dense(*args), args,
                                                      ct), flush)}
        rows[name] = row
        print(f"tensor parallel at TP 1 {name} {json.dumps(row)}",
              flush=True)
        if max(errs) > TOLERANCE["torch.bfloat16"]:
            raise AssertionError(f"{name} at TP 1 differs from the dense "
                                 f"layer: {errs}")
    return rows


def _bn_net(torch, norm):
    from torch import nn

    class Net(nn.Sequential):
        def forward(self, x):
            for layer in self[:-1]:
                x = layer(x)
            return self[-1](x.mean((2, 3)))

    return Net(
        nn.Conv2d(3, 16, 3, padding=1), norm(16), nn.ReLU(),
        nn.Conv2d(16, 32, 3, stride=2, padding=1), norm(32), nn.ReLU(),
        nn.Linear(32, 10))


def phase_mnbn(torch, comm):
    """Phase 14 (d): ``create_mnbn_model`` over a net with plain
    ``nn.BatchNorm2d`` against the same net built with
    ``MultiNodeBatchNormalization``: MNBN_STEPS SGD steps on the card
    with deterministic cuDNN algorithms (a convolution's backward may
    otherwise sum in another order from run to run), equal losses bit for
    bit; the converted state loads into the unconverted net."""
    from chainermn_tpu_torch.links import (
        MultiNodeBatchNormalization,
        create_mnbn_model,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _mnbn_steps(torch, comm, MultiNodeBatchNormalization,
                           create_mnbn_model)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _mnbn_steps(torch, comm, MultiNodeBatchNormalization, create_mnbn_model):
    torch.manual_seed(14)
    plain = _bn_net(torch, torch.nn.BatchNorm2d).cuda()
    converted = create_mnbn_model(plain, comm)
    built = _bn_net(torch, lambda c: MultiNodeBatchNormalization(
        c, comm, momentum=0.9, epsilon=1e-5, device="cuda")).cuda()
    state = {k: v for k, v in plain.state_dict().items()
             if "num_batches_tracked" not in k}
    built.load_state_dict(state)
    gen = torch.Generator(device="cuda").manual_seed(14)
    batch = (torch.randn(32, 3, 32, 32, device="cuda", generator=gen),
             torch.randint(0, 10, (32,), device="cuda", generator=gen))
    batches = [batch] * MNBN_STEPS  # one batch: the loss must fall
    losses = {}
    for name, net in (("converted", converted), ("built", built)):
        opt = torch.optim.SGD(net.parameters(), lr=0.1, momentum=0.9)
        losses[name] = []
        for x, y in batches:
            loss = torch.nn.functional.cross_entropy(net(x), y)
            opt.zero_grad()
            loss.backward()
            comm.allreduce_grad(net)
            opt.step()
            losses[name].append(loss.item())
    fresh = _bn_net(torch, torch.nn.BatchNorm2d).cuda()
    fresh.load_state_dict(converted.state_dict())  # strict: every name
    x = batches[0][0]
    with torch.no_grad():
        same_eval = bool(torch.allclose(fresh.eval()(x), converted.eval()(x),
                                        rtol=1e-5, atol=1e-5))
    n_synced = sum(isinstance(m, MultiNodeBatchNormalization)
                   for m in converted.modules())
    print(f"create_mnbn_model: {n_synced} BatchNorm2d converted; "
          f"{MNBN_STEPS} SGD steps on the card, losses converted "
          f"{losses['converted']} vs built with "
          f"MultiNodeBatchNormalization {losses['built']} (equal: "
          f"{losses['converted'] == losses['built']}); state_dict loads "
          f"into the unconverted net, eval outputs equal: {same_eval}",
          flush=True)
    if (n_synced != 2 or not same_eval
            or losses["converted"] != losses["built"]
            or not losses["converted"][-1] < losses["converted"][0]):
        raise AssertionError("create_mnbn_model: the converted net's "
                             "losses or state differ")
    return losses


# ---------------------------------------------------------------- phase 15

TP_CARD_SHARDS = 2
TP_CARD_REQUESTS = 8
TP_CARD_NEW_TOKENS = 16
TP_CHILD_TIMEOUT_S = 420
TP_TRAIN_STEPS = 10
#: phase 7's gate: ZeRO and FSDP against plain AdamW, step by step
ZERO_FSDP_LOSS_TOL = 1e-3
ZERO_FSDP_RESUME_AT = 5
#: the ``torch.distributed`` calls phase 15 counts
DIST_CALLS = ("all_reduce", "all_gather", "all_gather_into_tensor",
              "reduce_scatter_tensor", "broadcast", "reduce", "gather",
              "scatter", "send", "recv", "batch_isend_irecv",
              "all_to_all_single")


class _CountedDist:
    """Count the ``torch.distributed`` calls made while it is entered
    (the port looks them up on the module, where they are wrapped)."""

    def __init__(self):
        import torch.distributed as dist

        self.dist = dist
        self.counts = dict.fromkeys(DIST_CALLS, 0)

    def __enter__(self):
        self.saved = {n: getattr(self.dist, n) for n in DIST_CALLS}

        def wrap(name):
            def call(*a, **k):
                self.counts[name] += 1
                return self.saved[name](*a, **k)
            return call

        for n in DIST_CALLS:
            setattr(self.dist, n, wrap(n))
        return self.counts

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.dist, n, f)


def _ticks_counted(engine, pd):
    """Wrap ``engine.decode_step`` to record, per tick, its
    ``torch.distributed`` calls (nonzero ones) and K4's launches; returns
    the list the ticks append to."""
    ticks = []
    step = engine.decode_step

    def counted():
        k4 = pd.LAUNCHES
        with _CountedDist() as calls:
            out = step()
        ticks.append(({k: v for k, v in calls.items() if v},
                      pd.LAUNCHES - k4))
        return out

    engine.decode_step = counted
    return ticks


def phase_tp_serving(torch, np, comm, phase3_streams):
    """Phase 15 (a): phase 3's engine and traffic with ``mesh=`` the
    one-rank NCCL group (TP 1): streams bit-identical to phase 3's, and
    every decode tick 2 x num_layers all-reduces, nothing else, and
    num_layers K4 launches."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.ops import paged_decode as pd
    from chainermn_tpu_torch.serving import ServingEngine

    model = TransformerLM(seed=0)
    engine = ServingEngine(model, num_slots=16, max_len=2048,
                           kv_block_size=64, decode_attend_impl="fused",
                           mesh=comm)
    reqs = _requests(np, 24, 0, model.vocab_size)
    _serve(engine, _requests(np, 2, 1, model.vocab_size))  # warm-up
    torch.cuda.synchronize()
    pd.reset_launches()
    ticks = _ticks_counted(engine, pd)
    t0 = time.perf_counter()
    streams, sched = _serve(engine, reqs)
    wall = time.perf_counter() - t0
    summary = sched.summary()
    launches, routes = pd.LAUNCHES, dict(pd.ROUTE_LAUNCHES)
    want_calls = {"all_reduce": 2 * model.num_layers}
    bad = [t for t in ticks if t != (want_calls, model.num_layers)]
    same = streams == phase3_streams
    del engine
    cost = _one_rank_all_reduce_us(torch, comm)
    profiled, host = _tp1_profiles(torch, np, model, comm)
    row = {"tp": 1, "group": "nccl", "requests": len(reqs),
           "decode_ticks": len(ticks), "dist_calls_per_tick": ticks[0][0],
           "k4_launches_per_tick": ticks[0][1], "k4_launches": launches,
           "route_launches": routes, "wall_s": wall,
           "token_ms_p50": summary["token_ms_p50"],
           "token_ms_p99": summary["token_ms_p99"],
           "bit_identical_to_phase3": same,
           "one_rank_all_reduce_host_us": cost,
           "profiled_8_ticks": profiled, "host_extra_ms_by_op": host}
    print("tp serving (a) summary", json.dumps(row), flush=True)
    print(f"tp serving (a): TP 1 over NCCL, {len(reqs)} requests, "
          f"{len(ticks)} decode ticks, each {ticks[0][0]} torch.distributed "
          f"calls and {ticks[0][1]} K4 launches (expected {want_calls} and "
          f"{model.num_layers}); K4 launches {launches} by route "
          f"{json.dumps(routes)}; decode step p50 "
          f"{summary['token_ms_p50']} ms (phase 3 without a mesh: see its "
          f"summary); host us of one reduce_from_tp at the tick's shape "
          f"{cost}; 8 profiled ticks {profiled}; streams bit-identical to "
          f"phase 3: {same}", flush=True)
    if bad:
        raise AssertionError(f"{len(bad)} decode ticks made other "
                             f"collectives or launches: {bad[:3]}")
    if not same:
        raise AssertionError("TP 1 streams differ from phase 3's")
    return row


def _tp1_profiles(torch, np, model, comm, top=12):
    """8 decode ticks of 16 slots under torch.profiler, with the mesh (TP
    1) and without, in the order TP 1, none, none, TP 1 (two engines in
    one process, so the host's drift between windows shows): each
    window's wall, device busy and summed host self time, and the host
    self time that TP 1 adds, by op and runtime call (the mean of its
    two windows less the mean of the other two), largest first."""
    from chainermn_tpu_torch.serving import ServingEngine

    engines = {}
    for name, mesh in (("tp1", comm), ("no_mesh", None)):
        e = ServingEngine(model, num_slots=16, max_len=2048,
                          kv_block_size=64, decode_attend_impl="fused",
                          mesh=mesh)
        for p, _ in _requests(np, 16, 3, model.vocab_size):
            e.prefill_join(p)
        e.decode_step()  # warm
        engines[name] = e
    profiled, ops = {}, {}
    for name in ("tp1", "no_mesh", "no_mesh", "tp1"):
        e, got = engines[name], {}

        def ticks8(e=e):
            for _ in range(8):
                e.decode_step()

        wall_ms, busy, _ = _profile_window(
            torch, ticks8, f"tp serving (a) {name} 8 ticks",
            ("paged_decode",), host_ops=got)
        profiled.setdefault(name, []).append(
            {"wall_ms": wall_ms, "busy_ms": busy,
             "host_self_ms": sum(t for t, _ in got.values())})
        ops.setdefault(name, []).append(got)
    del engines

    def mean(name, key):
        return sum(w.get(key, (0.0, 0))[0] for w in ops[name]) / 2

    keys = set().union(*ops["tp1"], *ops["no_mesh"])
    extra = sorted(((mean("tp1", k) - mean("no_mesh", k), k) for k in keys),
                   reverse=True)
    host = [{"op": k, "extra_ms": d,
             "tp1_calls": ops["tp1"][0].get(k, (0, 0))[1],
             "no_mesh_calls": ops["no_mesh"][0].get(k, (0, 0))[1]}
            for d, k in extra[:top]]
    total = sum(d for d, _ in extra)
    print(f"tp serving (a) host: TP 1 adds {total:.3f} ms of host self time "
          f"over 8 ticks (mean of two windows each); by op: "
          + "; ".join(f"{h['op'][:60]} +{h['extra_ms']:.3f} ms "
                      f"({h['tp1_calls']} vs {h['no_mesh_calls']} calls)"
                      for h in host), flush=True)
    return profiled, {"total_extra_ms": total, "top": host}


def _one_rank_all_reduce_us(torch, comm, reps=200):
    """Host µs of one ``reduce_from_tp`` at the decode tick's shape ([16,
    1, 512] bf16) over ``comm``'s one-rank NCCL group, and of the clone
    it makes first, each ``reps`` calls ending in a synchronize."""
    from chainermn_tpu_torch.parallel import collectives as C

    x = torch.randn(16, 1, 512, device="cuda", dtype=torch.bfloat16)
    out = {}
    for name, fn in (("clone", lambda: x.clone()),
                     ("clone_and_all_reduce",
                      lambda: C._all_reduce(x, comm.group))):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
    return out


def _tp_requests(np, vocab):
    """Phase 3's first requests, cut to ``TP_CARD_REQUESTS`` of
    ``TP_CARD_NEW_TOKENS`` new tokens."""
    return [(p, TP_CARD_NEW_TOKENS)
            for p, _ in _requests(np, 24, 0, vocab)[:TP_CARD_REQUESTS]]


class _FirstOutput:
    """Stands in for an engine's decode model and keeps the first output
    (the first prefill's logits)."""

    def __init__(self, model):
        self.model, self.first = model, None

    def __call__(self, *a, **k):
        out = self.model(*a, **k)
        if self.first is None:
            self.first = out.detach().float().cpu()
        return out


def _tp_serve(torch, np, dtype, mesh, device):
    """A fresh engine over phase 3's model at ``dtype`` serving the cut
    traffic: (streams, first prefill's logits, summary, K4 launches, ms)."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.ops import paged_decode as pd
    from chainermn_tpu_torch.serving import ServingEngine

    model = TransformerLM(seed=0, compute_dtype=dtype, device=device)
    engine = ServingEngine(model, num_slots=16, max_len=2048,
                           kv_block_size=64, decode_attend_impl="fused",
                           mesh=mesh, device=device)
    first = _FirstOutput(engine._decode_model)
    engine._decode_model = first
    reqs = _tp_requests(np, model.vocab_size)
    pd.reset_launches()
    t0 = time.perf_counter()
    streams, sched = _serve(engine, reqs)
    summary = sched.summary()
    summary["k4_expected"] = model.num_layers * (summary["prefills"]
                                                 + summary["decode_steps"])
    return (streams, first.first, summary, pd.LAUNCHES,
            dict(pd.ROUTE_LAUNCHES), time.perf_counter() - t0)


def _tp_child(tmp, rank):
    """One rank of phase 15 (b): a gloo group of ``TP_CARD_SHARDS`` ranks
    on the one card, fp32 then bf16 TP serving, and an NCCL group on the
    same card handed to the engine, which must refuse it."""
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=TP_CARD_SHARDS)
    out = {"rank": rank}
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype)[6:]
        streams, logits, summ, k4, routes, wall = _tp_serve(
            torch, np, dtype, dist.group.WORLD, "cuda:0")
        np.save(f"{tmp}/logits_{key}_{rank}.npy", logits.numpy())
        out[key] = {"streams": streams, "k4_launches": k4,
                    "k4_expected": summ["k4_expected"],
                    "route_launches": routes, "wall_s": wall,
                    "token_ms_p50": summ["token_ms_p50"],
                    "token_ms_p99": summ["token_ms_p99"],
                    "decode_steps": summ["decode_steps"],
                    "prefills": summ["prefills"]}
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import ServingEngine

    nccl = dist.new_group(backend="nccl")
    model = TransformerLM(vocab_size=64, num_layers=1, num_heads=4,
                          d_model=32, d_ff=64, max_len=64, device="cuda:0")
    try:
        ServingEngine(model, num_slots=2, mesh=nccl, device="cuda:0")
        out["nccl_refusal"] = None
    except ValueError as e:
        out["nccl_refusal"] = str(e)
    with open(f"{tmp}/out{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _near_tie_parts(torch, model, reqs, ref, got):
    """Each request's first token where ``got`` parts from ``ref``, with
    the top-2 gap of ``model``'s logits there: [(request, token, gap)]."""
    parts = []
    for r, ((prompt, _), a, b) in enumerate(zip(reqs, ref, got)):
        i = _first_divergence(a, b)
        if i is None and len(a) == len(b):
            continue
        i = min(len(a), len(b)) if i is None else i
        with torch.no_grad():
            logits = model(torch.tensor([prompt + a[:i]],
                                        device="cuda"))[0, -1].float()
        top2 = torch.topk(logits, 2).values
        parts.append((r, i, float(top2[0] - top2[1])))
    return parts


def phase_tp_two_ranks(torch, np, smi):
    """Phase 15 (b): TP 2 on the one card: two processes on ``cuda:0``
    in a gloo group over CUDA tensors (NCCL refuses two ranks on one
    device), each rank on 4 heads and d_ff 1024, phase 3's requests cut
    to 8 of 16 new tokens. fp32 greedy streams equal the mesh-less fp32
    engine's (or part at a true near-tie); bf16: the share of equal
    tokens and the first prefill's max logit difference; per rank K4's
    launches and ms per tick; an NCCL group on the one card is
    refused."""
    from chainermn_tpu_torch.models import TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    ref = {}
    for dtype in (torch.float32, torch.bfloat16):
        streams, logits, summ, k4, _, _ = _tp_serve(torch, np, dtype, None,
                                                    "cuda")
        ref[str(dtype)[6:]] = (streams, logits, summ)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp2_") as tmp:
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--tp-child",
             tmp, str(r)]) for r in range(TP_CARD_SHARDS)]
        deadline = time.monotonic() + TP_CHILD_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            raise AssertionError(f"TP 2 ranks exited with {codes}")
        outs = [json.loads(Path(tmp, f"out{r}.json").read_text())
                for r in range(TP_CARD_SHARDS)]
        logits = {k: [np.load(Path(tmp, f"logits_{k}_{r}.npy"))
                      for r in range(TP_CARD_SHARDS)]
                  for k in ("float32", "bfloat16")}
    torch.backends.cuda.matmul.allow_tf32 = True
    reqs = _tp_requests(np, 32000)
    rows = {}
    for key in ("float32", "bfloat16"):
        want, want_logits, want_summ = ref[key]
        got = [o[key]["streams"] for o in outs]
        if any(g != got[0] for g in got[1:]):
            raise AssertionError(f"TP 2 {key}: the ranks' streams differ")
        same_tok = sum(x == y for a, b in zip(want, got[0])
                       for x, y in zip(a, b))
        n_tok = sum(len(a) for a in want)
        diff = float(np.abs(logits[key][0] - want_logits.numpy()).max())
        rows[key] = {
            "equal_tokens": same_tok, "tokens": n_tok,
            "equal_share": same_tok / n_tok,
            "streams_identical": got[0] == want,
            "first_prefill_max_logit_diff": diff,
            "ranks_logits_identical": all(
                np.array_equal(x, logits[key][0]) for x in logits[key][1:]),
            "per_rank": [{k: o[key][k] for k in (
                "k4_launches", "k4_expected", "route_launches", "token_ms_p50",
                "token_ms_p99", "decode_steps", "prefills", "wall_s")}
                for o in outs],
            "meshless_token_ms_p50": want_summ["token_ms_p50"]}
        if any(p["k4_launches"] != p["k4_expected"] or not p["k4_launches"]
               for p in rows[key]["per_rank"]):
            raise AssertionError(f"TP 2 {key}: a rank's K4 launches are not "
                                 f"num_layers x (prefills + decode steps): "
                                 f"{rows[key]['per_rank']}")
        if key == "float32":
            model = TransformerLM(seed=0, compute_dtype=torch.float32)
            torch.backends.cuda.matmul.allow_tf32 = False
            parts = _near_tie_parts(torch, model, reqs, want, got[0])
            torch.backends.cuda.matmul.allow_tf32 = True
            del model
            rows[key]["divergences"] = parts
            far = [p for p in parts if not p[2] < NEAR_TIE]
            if far:
                raise AssertionError(f"TP 2 fp32 streams part from the "
                                     f"mesh-less engine's away from a "
                                     f"near-tie: {far}")
    refusals = [o["nccl_refusal"] for o in outs]
    rows["nccl_refusal"] = refusals
    print("tp serving (b) summary", json.dumps(rows), flush=True)
    for key in ("float32", "bfloat16"):
        r = rows[key]
        print(f"tp serving (b) {key}: TP {TP_CARD_SHARDS} on one card over "
              f"gloo, {TP_CARD_REQUESTS} requests x {TP_CARD_NEW_TOKENS} "
              f"tokens: {r['equal_tokens']}/{r['tokens']} tokens equal to "
              f"the mesh-less engine's ({r['equal_share']:.4f}), first "
              f"prefill max logit diff {r['first_prefill_max_logit_diff']:.3e}"
              f"; per rank K4 launches "
              f"{[p['k4_launches'] for p in r['per_rank']]}, ms per tick "
              f"p50 {[p['token_ms_p50'] for p in r['per_rank']]} (mesh-less "
              f"{r['meshless_token_ms_p50']}); card {smi}", flush=True)
    if not all(m and "NCCL" in m for m in refusals):
        raise AssertionError(f"an NCCL group of {TP_CARD_SHARDS} ranks on "
                             f"one card was not refused: {refusals}")
    return rows


def _tp_train(torch, np, comm, batches, *, tp: bool):
    """Phase 7's model and AdamW for ``len(batches)`` steps, plain or as
    the TP 1 shard over ``comm``: (losses, K1-K3 launches, the
    ``torch.distributed`` calls of the last step, peak bytes)."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.serving import tp_local_model
    from chainermn_tpu_torch.training import (
        create_train_state,
        make_train_step,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = TransformerLM(seed=0, attention_fn=fa.flash_attention)
    if tp:
        model = tp_local_model(model, comm)
    opt = create_multi_node_optimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4), comm)
    state = create_train_state(model, opt, comm)
    step = make_train_step(_packed_loss, opt, comm)
    _reset_launches(fa)
    state, losses, ms = _run_steps(step, state, batches[:-1])
    launches = dict(fa.LAUNCHES)
    with _CountedDist() as calls:
        state, last, ms_last = _run_steps(step, state, batches[-1:])
    return (losses + last, launches,
            {k: v for k, v in calls.items() if v},
            torch.cuda.max_memory_allocated(), ms + ms_last,
            model.num_layers)


def phase_tp_training(torch, np, comm, smi):
    """Phase 15 (c): phase 7's shape (B 8 x T 2048, packed, flash
    attention, AdamW) for 10 steps as the TP 1 shard over the one-rank
    NCCL group against the model without TP: losses bit-identical; K1-K3
    launches per step; then the example twin's default run (world size
    1, dp 1 x tp 1, on the card)."""
    from chainermn_tpu_torch.examples.tensor_parallel import (
        train_tp_transformer as twin,
    )
    from chainermn_tpu_torch.examples.transformer.train_transformer_lm \
        import pack_documents

    rng = np.random.default_rng(0)
    batches = [tuple(torch.from_numpy(x).cuda()
                     for x in pack_documents(rng, 8, 2048))
               for _ in range(TP_TRAIN_STEPS)]
    plain, _, plain_calls, plain_peak, plain_ms, _ = _tp_train(
        torch, np, comm, batches, tp=False)
    tp, tp_launch, tp_calls, tp_peak, tp_ms, layers = _tp_train(
        torch, np, comm, batches, tp=True)
    t0 = time.perf_counter()
    res = twin.main([])
    twin_s = time.perf_counter() - t0
    row = {"steps": TP_TRAIN_STEPS, "plain_losses": plain,
           "tp_losses": tp, "bit_identical": plain == tp,
           "k1_k3_launches_tp_first_steps": tp_launch,
           "dist_calls_last_step": {"plain": plain_calls, "tp": tp_calls},
           "peak_memory_bytes": {"plain": plain_peak, "tp": tp_peak},
           "step_ms_p50": {"plain": statistics.median(plain_ms[1:]),
                           "tp": statistics.median(tp_ms[1:])},
           "twin": {"final_loss": res["final"],
                    "first_loss": res["losses"][0],
                    "iterations": len(res["losses"]), "seconds": twin_s}}
    print("tp training (c) summary", json.dumps(row), flush=True)
    print(f"tp training (c): TP 1 over NCCL, {TP_TRAIN_STEPS} steps of B 8 x "
          f"T 2048: losses bit-identical to the model without TP: "
          f"{plain == tp}; K1-K3 launches over the first "
          f"{TP_TRAIN_STEPS - 1} steps {tp_launch}; torch.distributed "
          f"calls of a step {tp_calls} (without TP {plain_calls}); twin "
          f"default run: loss {res['losses'][0]:.4f} -> {res['final']:.4f} "
          f"in {len(res['losses'])} iterations, {twin_s:.1f} s; card {smi}",
          flush=True)
    if plain != tp:
        raise AssertionError(f"TP 1 losses {tp} != {plain}")
    want = layers * (TP_TRAIN_STEPS - 1)
    if any(v != want for v in tp_launch.values()):
        raise AssertionError(f"K1-K3 launches {tp_launch} on the TP path "
                             f"!= num_layers x steps = {want}")
    if not res["final"] < res["losses"][0]:
        raise AssertionError("the TP example twin did not learn")
    return row


def _zero_fsdp_run(torch, comm, batches, mode, *, ckpt=None, save_at=None,
                   resume=False):
    """Phase 7's model for ``len(batches)`` steps under ``mode`` ('zero'
    or 'fsdp'): (losses, peak bytes, the ``torch.distributed`` calls of
    the last step, state)."""
    import functools

    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.parallel.fsdp import (
        create_fsdp_train_state,
        make_fsdp_train_step,
    )
    from chainermn_tpu_torch.parallel.zero import zero_shard_optimizer
    from chainermn_tpu_torch.training import (
        create_train_state,
        make_train_step,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    make = functools.partial(torch.optim.AdamW, lr=3e-4, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)
    model = TransformerLM(seed=0, attention_fn=fa.flash_attention)
    if mode == "zero":
        opt = zero_shard_optimizer(make, model.parameters(), comm)
        state = create_train_state(model, opt, comm)
        step = make_train_step(_packed_loss, opt, comm)
    else:
        state, pl = create_fsdp_train_state(model, make, comm)
        step = make_fsdp_train_step(_packed_loss, state.optimizer, comm, pl)
    start = 0
    if resume:
        state, start = ckpt.maybe_load(state)
    losses, ms = [], []
    calls = {}
    for i in range(start, len(batches)):
        t0 = time.perf_counter()
        with _CountedDist() as c:
            state, metrics = step(state, batches[i])
        losses.append(float(metrics["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        calls = {k: v for k, v in c.items() if v}
        if ckpt is not None and save_at == i + 1:
            ckpt.save(state, i + 1)
    return (losses, torch.cuda.max_memory_allocated(), calls, state, start,
            ms)


def phase_zero_fsdp(torch, np, comm, smi, plain, tmp):
    """Phase 15 (d): ZeRO and FSDP at world size 1 over NCCL, phase 7's LM
    for 10 steps: losses within ``ZERO_FSDP_LOSS_TOL`` of plain AdamW's
    (phase 15 (c)'s run without TP), peak memory of each; the FSDP state
    (DTensor leaves) saved at step 5, loaded into a fresh one, and 5 more
    steps bit-identical to the run without a stop."""
    from chainermn_tpu_torch.examples.transformer.train_transformer_lm \
        import pack_documents
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer

    rng = np.random.default_rng(0)
    batches = [tuple(torch.from_numpy(x).cuda()
                     for x in pack_documents(rng, 8, 2048))
               for _ in range(TP_TRAIN_STEPS)]
    rows = {"plain_adamw": {"losses": plain["plain_losses"],
                            "peak_memory_bytes":
                            plain["peak_memory_bytes"]["plain"],
                            "step_ms_p50": plain["step_ms_p50"]["plain"]}}
    for mode in ("zero", "fsdp"):
        losses, peak, calls, state, _, ms = _zero_fsdp_run(
            torch, comm, batches, mode)
        drift = max(abs(a - b) for a, b in zip(losses, plain["plain_losses"]))
        rows[mode] = {"losses": losses, "peak_memory_bytes": peak,
                      "max_loss_diff_vs_adamw": drift,
                      "dist_calls_per_step": calls,
                      "step_ms_p50": statistics.median(ms[1:])}
        del state
        if drift > ZERO_FSDP_LOSS_TOL:
            raise AssertionError(f"{mode} losses {losses} part from AdamW's "
                                 f"{plain['plain_losses']} by {drift}")
    ckpt = create_multi_node_checkpointer("fsdp15", comm, path=str(tmp))
    first, *_ = _zero_fsdp_run(torch, comm, batches[:ZERO_FSDP_RESUME_AT],
                               "fsdp", ckpt=ckpt,
                               save_at=ZERO_FSDP_RESUME_AT)
    rest, _, _, state, start, _ = _zero_fsdp_run(
        torch, comm, batches, "fsdp", ckpt=ckpt, resume=True)
    ckpt.close()
    shard_keys = sum("@@" in k for k in np.load(
        ckpt._fname(ZERO_FSDP_RESUME_AT)).files)
    same = first + rest == rows["fsdp"]["losses"]
    rows["fsdp_resume"] = {"resumed_at": start, "bit_identical": same,
                           "shard_entries": shard_keys}
    del state
    print("zero/fsdp (d) summary", json.dumps(rows), flush=True)
    diffs = {m: rows[m]["max_loss_diff_vs_adamw"] for m in ("zero", "fsdp")}
    gib = {m: rows[m]["peak_memory_bytes"] / 2**30
           for m in ("plain_adamw", "zero", "fsdp")}
    step_ms = {m: rows[m]["step_ms_p50"]
               for m in ("plain_adamw", "zero", "fsdp")}
    print(f"zero/fsdp (d): world size 1 over NCCL, {TP_TRAIN_STEPS} steps: "
          f"max loss diff vs AdamW {diffs}; peak memory GiB {gib}; step "
          f"ms p50 {step_ms}; FSDP "
          f"resume at {start} ({shard_keys} shard entries) bit-identical: "
          f"{same}; card {smi}", flush=True)
    if start != ZERO_FSDP_RESUME_AT or not same or not shard_keys:
        raise AssertionError(f"FSDP resume at {start}: {first + rest} != "
                             f"{rows['fsdp']['losses']}")
    return rows


# ---------------------------------------------------------------- phase 16

#: phase 16: phase 7's LM over B 8 x T 2048 (plain causal) in 4
#: microbatches of 2; on the one card (b) 2 stages of 3 blocks each
PIPE_B, PIPE_T, PIPE_MICRO = 8, 2048, 4
PIPE_CARD_STAGES = 2
PIPE_CHILD_TIMEOUT_S = 300
#: steps of each engine: the first warms up, the step ms is the median
#: of the rest
PIPE_STEPS = 4
#: (c) the twin's runs: iterations, and the accuracy each must reach
#: (10 classes, chance 0.1; the JAX test asks 0.9 of its 120 iterations)
PIPE_TWIN_ITERATIONS = 60
PIPE_TWIN_ACC = 0.9
#: pipelined against the same model without the pipeline on the full
#: batch, each gradient entry: |g - g_ref| <= rtol * |g_ref| + atol *
#: max |g_ref| of its leaf. Written before the first run. bf16 rounds
#: every activation and every weight gradient to 8 mantissa bits (2^-9
#: relative); the pipeline's GEMMs run on 2 of the 8 rows at a time, so
#: cuBLAS tiles and rounds other partial products, and a weight gradient
#: is 4 microbatch products, each rounded to bf16, summed in fp32 where
#: the full batch rounds one. Through 6 blocks that compounds to a few
#: ulps of a leaf's largest entries (0.009 of it in the same comparison
#: on the CPU's bf16 at d 128 and 6 blocks); 0.03 leaves that 3x room.
PIPE_GRAD_TOL = (0.03, 0.03)
#: the loss (about 10.4 at these weights) from bf16 logits
PIPE_LOSS_TOL = 2e-3


def _pipe_tokens(torch, np, device):
    rng = np.random.default_rng(16)
    return torch.from_numpy(rng.integers(0, 32000, size=(PIPE_B, PIPE_T))
                            ).to(device)


def _pipe_pieces(torch, model):
    """The pipelined LM's pieces over ``model``: the embedding (tokens and
    learned positions, in the compute dtype), a stage (a run of blocks,
    an ``nn.Sequential``, through ``functional_call`` on the stage's
    parameters) and the head (the final norm and the tied embedding, by
    default the model's own, or ``(norm weight, norm bias, embedding)``),
    computing what ``model(tokens)`` computes."""
    import torch.nn.functional as F
    from torch.func import functional_call

    dt = model.compute_dtype

    def embed(tokens):
        x = model.tok_emb.weight[tokens.long()].to(dt)
        return x + model.pos_emb[:tokens.shape[1]].to(dt)

    def stage(blocks):
        return lambda p, x: functional_call(blocks, p, (x,))

    def head(x, hp=None):
        w, b, emb = hp or (model.ln_f.weight, model.ln_f.bias,
                           model.tok_emb.weight)
        h = functional_call(model.ln_f, {"weight": w, "bias": b}, (x,))
        return F.linear(h.to(dt), emb.to(dt))

    return embed, stage, head


#: the leaves outside the conveyor, on every rank
PIPE_OUTER = ("tok_emb.weight", "pos_emb", "ln_f.weight", "ln_f.bias")


def _pipe_steps(torch, model, group, tokens, engines, first, count,
                profile=None):
    """``PIPE_STEPS`` steps of each engine over blocks ``[first, first +
    count)`` on this rank (stage ``first // count`` of ``group``): per
    engine the loss, the gradients of this rank's blocks (by the model's
    names) and of the leaves outside the conveyor, step ms (the median
    after the first step, and each), the K1-K3 launches of the last step
    and peak memory; ``profile``, a label, adds a profiled step of each
    engine (its busy share)."""
    from torch import nn

    from chainermn_tpu_torch.models import lm_loss
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.parallel import pipeline as pl

    embed, stage, head = _pipe_pieces(torch, model)
    params = dict(model.named_parameters())
    blocks = nn.Sequential(*model.blocks[first:first + count])
    own = {n: params[f"blocks.{first + int(n.split('.')[0])}."
                     + n.split(".", 1)[1]]
           for n, _ in blocks.named_parameters()}
    hp_names = ("ln_f.weight", "ln_f.bias", "tok_emb.weight")

    def head_loss_grad(hp, y, tok):
        with torch.enable_grad():
            hp = [t.detach().requires_grad_() for t in hp]
            y = y.detach().requires_grad_()
            loss = lm_loss(head(y, hp), tok)
            *dh, dy = torch.autograd.grad(loss, [*hp, y])
        return loss.detach(), (tuple(dh), dy)

    def grads_of():
        names = [f"blocks.{i}." for i in range(first, first + count)]
        return {k: p.grad.detach().clone() for k, p in params.items()
                if k in PIPE_OUTER or k.startswith(tuple(names))}

    runs = {}
    for name in engines:
        if name == "gpipe":
            pipe = pl.make_pipeline(stage(blocks), group,
                                    n_microbatches=PIPE_MICRO)

            def step():
                loss = lm_loss(head(pipe(own, embed(tokens))), tokens)
                loss.backward()
                return loss
        elif name == "interleaved":
            # one stage, two chunks of half the blocks each
            half = count // 2
            template = nn.Sequential(*model.blocks[first:first + half])
            pipe = pl.make_pipeline(stage(template), group,
                                    n_microbatches=PIPE_MICRO,
                                    virtual_stages=2)

            def step():
                chunks = [{n: params[f"blocks.{first + j * half + int(n.split('.')[0])}."
                                     + n.split(".", 1)[1]]
                           for n, _ in template.named_parameters()}
                          for j in range(2)]
                loss = lm_loss(head(pipe(pl.stack_stage_params(chunks),
                                         embed(tokens))), tokens)
                loss.backward()
                return loss
        else:  # 1f1b: the head as head_params, the embedding through dx
            engine = pl.make_pipeline_1f1b(stage(blocks), head_loss_grad,
                                           group, n_microbatches=PIPE_MICRO)

            def step():
                x = embed(tokens)
                loss, g_stage, g_head, dx = engine(
                    own, x.detach(), tokens,
                    tuple(params[k].detach() for k in hp_names),
                    collect_input_grads=True)
                g_emb, g_pos = torch.autograd.grad(
                    x, [params["tok_emb.weight"], params["pos_emb"]], dx)
                for k, g in g_stage.items():
                    own[k].grad = g
                params["ln_f.weight"].grad = g_head[0]
                params["ln_f.bias"].grad = g_head[1]
                params["tok_emb.weight"].grad = g_head[2] + g_emb
                params["pos_emb"].grad = g_pos
                return loss
        all_ms = []
        for _ in range(PIPE_STEPS):  # the first step warms up
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches(fa)
            t0 = time.perf_counter()
            loss = step()
            torch.cuda.synchronize()
            all_ms.append((time.perf_counter() - t0) * 1e3)
        runs[name] = {"loss": float(loss.detach()), "grads": grads_of(),
                      "ms": statistics.median(all_ms[1:]), "all_ms": all_ms,
                      "launches": dict(fa.LAUNCHES),
                      "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        if profile:
            model.zero_grad(set_to_none=True)
            wall, busy, _ = _profile_window(torch, step,
                                            f"{profile} {name} profile",
                                            MMA_KERNELS)
            runs[name]["profile"] = {"wall_ms": wall, "busy_ms": busy}
        model.zero_grad(set_to_none=True)
    return runs


def _over_limit(grads, ref, tol):
    """The largest ``|g - g_ref| / (rtol |g_ref| + atol max |g_ref|)`` over
    the leaves (``tol = (rtol, atol)``, the limit per entry, atol scaled by
    each leaf's largest entry), its leaf, and the max |g - g_ref|."""
    rtol, atol = tol
    worst, leaf, diff = 0.0, None, 0.0
    for k, g in grads.items():
        r = ref[k].to(g.device).float()
        d = (g.float() - r).abs()
        ratio = float((d / (rtol * r.abs() + atol * r.abs().max())).max())
        diff = max(diff, float(d.max()))
        if ratio > worst:
            worst, leaf = ratio, k
    return worst, leaf, diff


def _pipe_expected(count):
    """K1/K2/K3 launches a step of ``count`` blocks a stage: each block
    runs K1 once a microbatch forward (1F1B again in its recompute) and
    K2 and K3 once a microbatch backward."""
    one = count * PIPE_MICRO
    return {"gpipe": {"fwd": one, "dq": one, "dkv": one},
            "interleaved": {"fwd": one, "dq": one, "dkv": one},
            "1f1b": {"fwd": 2 * one, "dq": one, "dkv": one}}


def phase_pipeline(torch, np, comm, smi, tmp):
    """Phase 16 (a) and (b): phase 7's LM with its blocks pipelined, the
    embedding and tied head outside the conveyor. (a) World size 1 over
    the one-rank NCCL group: one step each of GPipe, interleaved v 2 and
    1F1B (trainable head, input grads) against the model without the
    pipeline on the full batch: loss within ``PIPE_LOSS_TOL``, every
    gradient entry within ``PIPE_GRAD_TOL``, K1-K3 launches a step the
    rule's, step ms. (b) Two stages on the one card (two processes over
    gloo, ``--pipe-child``): GPipe and 1F1B, each rank held to the
    unpipelined model and compared with (a), the embedding and head
    gradients equal on both ranks; each child also trains the hetero
    twin."""
    from chainermn_tpu_torch.models import TransformerLM, lm_loss
    from chainermn_tpu_torch.ops import flash_attention as fa

    model = TransformerLM(seed=0, attention_fn=fa.flash_attention)
    tokens = _pipe_tokens(torch, np, "cuda")
    L = model.num_layers

    def unpipelined():
        loss = lm_loss(model(tokens), tokens)
        loss.backward()
        return loss

    all_ms = []
    for _ in range(PIPE_STEPS):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(fa)
        t0 = time.perf_counter()
        ref_loss = unpipelined()
        torch.cuda.synchronize()
        all_ms.append((time.perf_counter() - t0) * 1e3)
    ref_ms = statistics.median(all_ms[1:])
    ref_peak = torch.cuda.max_memory_allocated()
    ref_launches = dict(fa.LAUNCHES)
    ref = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    ref_loss = float(ref_loss.detach())
    model.zero_grad(set_to_none=True)
    wall, busy, _ = _profile_window(torch, unpipelined,
                                    "pipeline (a) unpipelined profile",
                                    MMA_KERNELS)
    runs = _pipe_steps(torch, model, comm.group, tokens,
                       ("gpipe", "interleaved", "1f1b"), 0, L,
                       profile="pipeline (a)")
    expected = _pipe_expected(L)
    rows = {"reference": {"loss": ref_loss, "ms": ref_ms, "all_ms": all_ms,
                          "launches": ref_launches,
                          "peak_memory_bytes": ref_peak,
                          "profile": {"wall_ms": wall, "busy_ms": busy}}}
    for name, run in runs.items():
        worst, leaf, diff = _over_limit(run["grads"], ref, PIPE_GRAD_TOL)
        rows[name] = {"loss": run["loss"],
                      "loss_diff": abs(run["loss"] - ref_loss),
                      "grad_over_limit": worst, "worst_leaf": leaf,
                      "grad_max_abs_diff": diff, "ms": run["ms"],
                      "all_ms": run["all_ms"], "profile": run["profile"],
                      "launches": run["launches"],
                      "expected_launches": expected[name],
                      "peak_memory_bytes": run["peak_memory_bytes"]}
    print("pipeline (a) summary", json.dumps(rows), flush=True)
    for name in runs:
        r = rows[name]
        print(f"pipeline (a) {name}: world size 1, {L} blocks, B {PIPE_B} x "
              f"T {PIPE_T} in {PIPE_MICRO} microbatches: loss "
              f"{r['loss']:.6f} (unpipelined {ref_loss:.6f}), grads "
              f"{r['grad_over_limit']:.3f} of their limit (worst "
              f"{r['worst_leaf']}, max |diff| {r['grad_max_abs_diff']:.3e})"
              f", step p50 {r['ms']:.2f} ms (unpipelined {ref_ms:.2f}), "
              f"profiled step busy {r['profile']['busy_ms']:.2f} of "
              f"{r['profile']['wall_ms']:.2f} ms (unpipelined {busy:.2f} of "
              f"{wall:.2f}), K1/K2/K3 launches {r['launches']}, peak "
              f"{r['peak_memory_bytes'] / 2**30:.3f} GiB (unpipelined "
              f"{ref_peak / 2**30:.3f}); card {smi}", flush=True)
    for name, r in rows.items():
        if name == "reference":
            continue
        if r["loss_diff"] > PIPE_LOSS_TOL or not r["grad_over_limit"] <= 1:
            raise AssertionError(f"pipeline (a) {name}: loss diff "
                                 f"{r['loss_diff']}, grads "
                                 f"{r['grad_over_limit']} of their limit at "
                                 f"{r['worst_leaf']}")
        if r["launches"] != r["expected_launches"]:
            raise AssertionError(f"pipeline (a) {name}: K1-K3 launches "
                                 f"{r['launches']} != "
                                 f"{r['expected_launches']}")
    # (b): the children hold themselves to the unpipelined model and to
    # (a); they read both from here
    torch.save({k: v.cpu() for k, v in ref.items()}, tmp / "ref.pt")
    for name in ("gpipe", "1f1b"):
        torch.save({k: v.cpu() for k, v in runs[name]["grads"].items()},
                   tmp / f"a_{name}.pt")
    (tmp / "a.json").write_text(json.dumps(
        {"ref_loss": ref_loss,
         **{n: runs[n]["loss"] for n in ("gpipe", "1f1b")}}))
    del runs, ref, model
    torch.cuda.empty_cache()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--pipe-child",
         str(tmp), str(r)]) for r in range(PIPE_CARD_STAGES)]
    deadline = time.monotonic() + PIPE_CHILD_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"pipeline (b) ranks exited with {codes}")
    outs = [json.loads((tmp / f"pipe_out{r}.json").read_text())
            for r in range(PIPE_CARD_STAGES)]
    same = {}
    for name in ("gpipe", "1f1b"):
        eh = [torch.load(tmp / f"outer_{name}_{r}.pt")
              for r in range(PIPE_CARD_STAGES)]
        same[name] = all(torch.equal(eh[0][k], e[k]) for e in eh[1:]
                         for k in PIPE_OUTER)
    b = {"ranks": outs, "outer_grads_equal_on_every_rank": same}
    print("pipeline (b) summary", json.dumps(b), flush=True)
    for name in ("gpipe", "1f1b"):
        print(f"pipeline (b) {name}: {PIPE_CARD_STAGES} stages on one card "
              f"over gloo: per rank loss diff vs (a) "
              f"{[o[name]['loss_diff_vs_a'] for o in outs]}, grads max "
              f"|diff| vs (a) {[o[name]['grad_max_abs_diff_vs_a'] for o in outs]}"
              f", {[o[name]['grad_over_limit'] for o in outs]} of their limit "
              f"vs the unpipelined model, embedding/head grads equal on both "
              f"ranks: {same[name]}; K1/K2/K3 launches "
              f"{[o[name]['launches'] for o in outs]}, bytes sent a step "
              f"{[o[name]['bytes_sent'] for o in outs]}, step ms "
              f"{[round(o[name]['ms'], 2) for o in outs]}; card {smi}",
              flush=True)
    print(f"pipeline (c) hetero twin: {PIPE_CARD_STAGES} ranks on one card, "
          f"{PIPE_TWIN_ITERATIONS} iterations: accuracy "
          f"{[o['hetero_twin']['acc'] for o in outs]}, final loss "
          f"{[o['hetero_twin']['loss'] for o in outs]}, "
          f"{[round(o['hetero_twin']['seconds'], 2) for o in outs]} s",
          flush=True)
    if not all(same.values()):
        raise AssertionError(f"pipeline (b): the embedding/head gradients "
                             f"differ between the ranks: {same}")
    return rows, [{n: o[n]["launches"] for n in ("gpipe", "1f1b")}
                  for o in outs]


def _pipe_child(tmp, rank):
    """One rank of phase 16 (b): stage ``rank`` of a gloo group of
    ``PIPE_CARD_STAGES`` ranks on the one card, GPipe then 1F1B over its
    half of phase 7's blocks, held to the unpipelined model's gradients
    and compared with (a)'s; then the hetero twin over the same group.
    Exits non-zero when a check fails."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from chainermn_tpu_torch.examples.pipeline import train_pipeline_mlp
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.ops import flash_attention as fa

    tmp = Path(tmp)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=PIPE_CARD_STAGES)
    model = TransformerLM(seed=0, attention_fn=fa.flash_attention,
                          device="cuda:0")
    per = model.num_layers // PIPE_CARD_STAGES
    tokens = _pipe_tokens(torch, np, "cuda:0")
    sent = {"transfer": 0, "broadcast": 0}
    keep = dist.batch_isend_irecv, dist.broadcast

    def transfer(ops):
        sent["transfer"] += sum(o.tensor.numel() * o.tensor.element_size()
                                for o in ops if o.op is dist.isend)
        return keep[0](ops)

    def broadcast(t, src, group=None, **kw):
        if src == dist.get_rank():
            sent["broadcast"] += t.numel() * t.element_size()
        return keep[1](t, src, group=group, **kw)

    dist.batch_isend_irecv, dist.broadcast = transfer, broadcast
    try:
        runs = {}
        for name in ("gpipe", "1f1b"):
            for k in sent:
                sent[k] = 0
            runs[name] = _pipe_steps(torch, model, dist.group.WORLD, tokens,
                                     (name,), rank * per, per)[name]
            runs[name]["bytes_sent"] = sent["transfer"] // PIPE_STEPS
            runs[name]["broadcast_bytes"] = sent["broadcast"] // PIPE_STEPS
    finally:
        dist.batch_isend_irecv, dist.broadcast = keep
    ref = torch.load(tmp / "ref.pt")
    a = json.loads((tmp / "a.json").read_text())
    expected = _pipe_expected(per)
    out = {"rank": rank}
    failed = []
    for name, run in runs.items():
        mine = torch.load(tmp / f"a_{name}.pt")
        worst, leaf, _ = _over_limit(run["grads"], ref, PIPE_GRAD_TOL)
        diff_a = max(float((g.float().cpu() - mine[k].float()).abs().max())
                     for k, g in run["grads"].items())
        out[name] = {"loss": run["loss"],
                     "loss_diff_vs_a": abs(run["loss"] - a[name]),
                     "loss_diff_vs_unpipelined": abs(run["loss"]
                                                     - a["ref_loss"]),
                     "grad_over_limit": worst, "worst_leaf": leaf,
                     "grad_max_abs_diff_vs_a": diff_a,
                     "bit_identical_to_a": diff_a == 0.0
                     and run["loss"] == a[name],
                     "launches": run["launches"],
                     "expected_launches": expected[name],
                     "bytes_sent": run["bytes_sent"],
                     "broadcast_bytes": run["broadcast_bytes"],
                     "ms": run["ms"], "all_ms": run["all_ms"],
                     "peak_memory_bytes": run["peak_memory_bytes"]}
        torch.save({k: run["grads"][k].cpu() for k in PIPE_OUTER},
                   tmp / f"outer_{name}_{rank}.pt")
        o = out[name]
        if (o["loss_diff_vs_unpipelined"] > PIPE_LOSS_TOL
                or not worst <= 1
                or o["launches"] != o["expected_launches"]):
            failed.append(name)
    del runs, ref, model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    twin = train_pipeline_mlp.run(
        ["--schedule", "hetero", "--iterations", str(PIPE_TWIN_ITERATIONS)],
        group=dist.group.WORLD)
    out["hetero_twin"] = {"acc": twin["accs"][-1], "loss": twin["losses"][-1],
                          "seconds": time.perf_counter() - t0}
    if not twin["accs"][-1] >= PIPE_TWIN_ACC:
        failed.append("hetero_twin")
    out["failed"] = failed
    (tmp / f"pipe_out{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    if failed:
        print(f"pipeline (b) rank {rank} failed: {failed}: "
              f"{json.dumps(out)}", file=sys.stderr, flush=True)
        sys.exit(1)


def phase_pipeline_twin(torch, smi):
    """Phase 16 (c): the pipeline twin at world size 1 on the card (over
    the one-rank NCCL group), GPipe and 1F1B, at its defaults but
    ``PIPE_TWIN_ITERATIONS`` iterations; the hetero schedule, which needs
    two stages, ran in (b)'s ranks."""
    from chainermn_tpu_torch.examples.pipeline import train_pipeline_mlp

    rows = {}
    for schedule in ("gpipe", "1f1b"):
        t0 = time.perf_counter()
        res = train_pipeline_mlp.run(
            ["--schedule", schedule, "--iterations",
             str(PIPE_TWIN_ITERATIONS)])
        rows[schedule] = {"acc": res["accs"][-1], "loss": res["losses"][-1],
                          "first_loss": res["losses"][0],
                          "seconds": time.perf_counter() - t0}
    print("pipeline (c) summary", json.dumps(rows), flush=True)
    print(f"pipeline (c): the twin at world size 1, "
          f"{PIPE_TWIN_ITERATIONS} iterations: " + ", ".join(
              f"{k} loss {r['first_loss']:.4f} -> {r['loss']:.4f} acc "
              f"{r['acc']:.4f} in {r['seconds']:.2f} s"
              for k, r in rows.items()) + f"; card {smi}", flush=True)
    bad = {k: r for k, r in rows.items() if not r["acc"] >= PIPE_TWIN_ACC}
    if bad:
        raise AssertionError(f"the pipeline twin did not learn: {bad}")
    return rows


# ---------------------------------------------------------------- phase 17

#: phase 17: phase 7's LM (6 layers, d 512, 8 heads, vocab 32000, bf16,
#: seeded) over B 8 x T 2048 plain causal; (a) at world size 1 over the
#: one-rank NCCL group, (b) over SEQ_RANKS ranks on the one card (gloo)
SEQ_B, SEQ_T = 8, 2048
SEQ_PLAN_STEPS = 3
SEQ_RANKS = 2
SEQ_CHILD_TIMEOUT_S = 300
SEQ_WINDOW = 256
#: (c) the twin's iterations at 2 ranks (batch 2 x SEQ_T tokens)
SEQ_TWIN_ITERATIONS = 10
#: (a) 2: the plan's seq step at size 1 against the plain model, each
#: gradient entry |g - g_ref| <= rtol |g_ref| + atol max |g_ref| of its
#: leaf. Written before the first run. At one rank the ring runs K1-K3
#: once a layer on the diagonal block, the merge of one partial with the
#: empty one is exact (its weights are exp(0) = 1 and 0), and the all-to-
#: alls of Ulysses move nothing, so the gradient is the plain model's
#: bit for bit; the step reads it back as p0 - p1 of SGD at lr 1, whose
#: fp32 subtraction rounds at 2^-24 of |p0| (<= 0.2): far under 1e-3 of
#: a leaf's largest gradient.
SEQ1_GRAD_TOL = (1e-3, 1e-3)
#: (b) 1: two seq ranks against (a)'s world-size-1 plain values. Written
#: before the first run. The ring's rank 1 merges two bf16 partial
#: outputs in fp32 where the plain kernel sums one pass, so each
#: attention output moves by a bf16 ulp or two; through 6 layers that is
#: the pipeline's case (PIPE_GRAD_TOL's reasoning), so the same limits.
SEQ_LOSS_TOL = 2e-3
SEQ_GRAD_TOL = (0.03, 0.03)
#: (b) 2-3: the window and zigzag rings' outputs and gradients against a
#: plain fp32 attention (einsum, masked softmax, autograd; no kernel) of
#: the whole sequence on the same card tensors, row by row: the largest
#: |diff| of a (b, t, h) row over the norm of its plain row, or over the
#: RMS of the plain rows' norms where the row is smaller (dq's first rows
#: are near zero). Written before the first run of this form: through
#: the kernels' plain version on the CPU (B 1, T 2048, 8 heads, W 256 and
#: full causal, bf16 inputs) the kernels' rounding rules give O 0.0030,
#: dq 0.048, dk 0.0064, dv 0.0034 of this scale, and a window off by one
#: (W 255 or 257) O 0.65 and 1.18, dq 0.56 and 2.06; so a limit of 0.1.
SEQ_KERNEL_TOL = 0.1


def _seq_batch(torch, np, device):
    """Phase 17's batch: tokens [SEQ_B, SEQ_T] and their next tokens (the
    last position's target is the row's first token), so the mean loss
    over the positions is the same whatever the sequence sharding."""
    rng = np.random.default_rng(17)
    tokens = torch.from_numpy(rng.integers(0, 32000, size=(SEQ_B, SEQ_T))
                              ).to(device)
    return tokens, torch.roll(tokens, -1, dims=1)


def _seq_loss(torch, model, pos=None):
    """``loss_fn(params, (tokens, targets))`` over ``model`` through
    ``functional_call``: the mean next-token cross-entropy of the shard,
    at the shard's global positions ``pos``."""
    import torch.nn.functional as F
    from torch.func import functional_call

    def loss_fn(p, batch):
        tokens, targets = batch
        kw = {} if pos is None else {"positions": pos}
        logits = functional_call(model, p, (tokens,), kw)
        return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                               targets.reshape(-1))

    return loss_fn


def _params_of(model):
    return {k: v.detach() for k, v in model.named_parameters()}


def _sgd_grads(torch, plan, model, loss_fn, batch):
    """One plan step of SGD at lr 1 from ``model``'s weights: (the
    metrics' loss, the gradients as p0 - p1, K1-K3 launches, step ms)."""
    import functools

    from chainermn_tpu_torch.ops import flash_attention as fa

    params = _params_of(model)
    make = functools.partial(torch.optim.SGD, lr=1.0)
    state = plan.create_train_state(params, make)
    step = plan.compile_train_step(loss_fn, make, params)
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    torch.cuda.synchronize()
    _reset_launches(fa)
    t0 = time.perf_counter()
    state, m = step(state, plan.local_batch(batch))
    loss = float(m["loss"])
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fa.LAUNCHES)
    grads = {k: p0[k] - state.params[k].detach() for k in p0}
    return loss, grads, launches, ms


def phase_seq_plan(torch, np, comm, smi, tmp):
    """Phase 17 (a) at world size 1 over the one-rank NCCL group: (1)
    ``make_train_step(plan=ParallelPlan({'data': 1, 'zero': 1}))``, 3
    AdamW steps against phase 7's communicator-path step on the same
    batches, K1-K3 launches a step; (2) ``ParallelPlan({'seq': 1})``
    through the ring and Ulysses against the plain model: the loss and
    every gradient entry within ``SEQ1_GRAD_TOL``. Leaves the plain
    model's loss and gradients (and (2)'s) in ``tmp`` for (b)."""
    import functools

    from chainermn_tpu_torch.models import TransformerLM, lm_loss
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.parallel.plan import ParallelPlan
    from chainermn_tpu_torch.training import (
        create_train_state,
        make_train_step,
    )

    adamw = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    rng = np.random.default_rng(7)
    batches = [torch.from_numpy(rng.integers(0, 32000, size=(SEQ_B, SEQ_T))
                                ).cuda() for _ in range(SEQ_PLAN_STEPS)]
    runs = {}
    for path in ("communicator", "plan"):
        model = TransformerLM(seed=0, attention_fn=fa.flash_attention)
        if path == "communicator":
            opt = create_multi_node_optimizer(
                torch.optim.AdamW(model.parameters(), **adamw), comm)
            state = create_train_state(model, opt, comm)
            step = make_train_step(lambda m_, t: lm_loss(m_(t), t), opt,
                                   comm)
        else:
            plan = ParallelPlan({"data": 1, "zero": 1})
            make = functools.partial(torch.optim.AdamW, **adamw)
            params = _params_of(model)
            state = plan.create_train_state(params, make)
            step = make_train_step(
                lambda p, t: lm_loss(
                    torch.func.functional_call(model, p, (t,)), t),
                make, plan=plan)
            held = [id(t) for t in state.params.values()]
        losses, launches, ms = [], [], []
        for batch in batches:
            torch.cuda.synchronize()
            _reset_launches(fa)
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(dict(fa.LAUNCHES))
        weights = (dict(model.named_parameters()) if path == "communicator"
                   else state.params)
        runs[path] = {"losses": losses, "launches": launches, "ms": ms,
                      "weights": {k: v.detach().clone()
                                  for k, v in weights.items()}}
        # where the step's time goes: two profiled steps more (after the
        # weights are kept), each window's wall, busy and host self time
        runs[path]["profiles"], runs[path]["host_ops"] = [], []
        for _ in range(2):
            got = {}

            def one(state=state, batch=batches[0]):
                step(state, batch)

            wall, busy, kernels = _profile_window(
                torch, one, f"seq plan (a) 1 {path} profile",
                ("flash_",), host_ops=got)
            runs[path]["profiles"].append(
                {"wall_ms": wall, "busy_ms": busy,
                 "device_ops": sum(kc[1] for kc in kernels),
                 "host_self_ms": sum(t for t, _ in got.values())})
            runs[path]["host_ops"].append(got)
        if path == "plan":
            runs[path]["same_tensors"] = held == [
                id(t) for t in state.params.values()]
            runs[path]["describe"] = plan.describe()
        del model, state, step
    c, p = runs["communicator"], runs["plan"]
    diff = max(float((p["weights"][k] - c["weights"][k]).abs().max())
               for k in c["weights"])
    expected = {"fwd": 6, "dq": 6, "dkv": 6}

    def mean_op(run, key):
        return sum(w.get(key, (0.0, 0))[0] for w in run["host_ops"]) / 2

    keys = set().union(*p["host_ops"], *c["host_ops"])
    extra = sorted(((mean_op(p, k) - mean_op(c, k), k) for k in keys),
                   reverse=True)
    a1 = {"losses_communicator": c["losses"], "losses_plan": p["losses"],
          "bit_identical": c["losses"] == p["losses"] and diff == 0.0,
          "weights_max_abs_diff": diff, "launches_plan": p["launches"],
          "launches_communicator": c["launches"],
          "expected_launches": expected, "ms_plan": p["ms"],
          "ms_communicator": c["ms"], "same_tensors": p["same_tensors"],
          "describe": p["describe"], "profiles_plan": p["profiles"],
          "profiles_communicator": c["profiles"],
          "plan_extra_host_ms": sum(d for d, _ in extra),
          "plan_extra_host_top": [
              {"op": k, "extra_ms": d,
               "plan_calls": p["host_ops"][0].get(k, (0, 0))[1],
               "communicator_calls": c["host_ops"][0].get(k, (0, 0))[1]}
              for d, k in extra[:12]]}
    print("seq plan (a) 1 summary", json.dumps(a1), flush=True)
    print(f"seq plan (a) 1: make_train_step(plan=ParallelPlan({{'data': 1, "
          f"'zero': 1}})) {SEQ_PLAN_STEPS} AdamW steps, B {SEQ_B} x T "
          f"{SEQ_T}: losses {p['losses']} (communicator path "
          f"{c['losses']}), bit-identical {a1['bit_identical']}, weights "
          f"max |diff| {diff:.3e}; K1/K2/K3 launches a step "
          f"{p['launches'][-1]}; step ms {[round(x, 2) for x in p['ms']]} "
          f"(communicator path {[round(x, 2) for x in c['ms']]}); card "
          f"{smi}", flush=True)
    print(f"seq plan (a) 1 profile: wall / device busy / host self ms / "
          f"device ops of a profiled step, plan "
          f"{[(round(w['wall_ms'], 3), round(w['busy_ms'], 3), round(w['host_self_ms'], 3), w['device_ops']) for w in p['profiles']]}"
          f", communicator path "
          f"{[(round(w['wall_ms'], 3), round(w['busy_ms'], 3), round(w['host_self_ms'], 3), w['device_ops']) for w in c['profiles']]}"
          f"; the plan adds {a1['plan_extra_host_ms']:.3f} ms of host self "
          f"time a step (mean of two windows each), by op: " + "; ".join(
              f"{h['op'][:60]} +{h['extra_ms']:.3f} ms ({h['plan_calls']} "
              f"vs {h['communicator_calls']} calls)"
              for h in a1["plan_extra_host_top"]), flush=True)
    # forecast and measured: the same gradients and the same element-wise
    # AdamW, so the losses and every weight agree bit for bit
    if p["losses"] != c["losses"] or diff != 0.0:
        raise AssertionError(f"seq plan (a) 1: the plan's losses "
                             f"{p['losses']} and weights (max |diff| "
                             f"{diff}) are not the communicator path's "
                             f"{c['losses']} bit for bit")
    if any(ln != expected for ln in p["launches"]) \
            or not p["same_tensors"]:
        raise AssertionError(f"seq plan (a) 1: launches {p['launches']} "
                             f"(expected {expected} a step) or a step made "
                             "new state tensors")
    del runs, c, p

    # (2): the plain model's loss and gradients at world size 1, then the
    # seq plan at size 1 through each impl
    batch = _seq_batch(torch, np, "cuda")
    model = TransformerLM(seed=0, attention_fn=fa.flash_attention)
    params = {k: v.requires_grad_() for k, v in _params_of(model).items()}
    _reset_launches(fa)
    loss = _seq_loss(torch, model)(params, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    ref = {k: g.detach() for k, g in zip(params, grads)}
    ref_loss = float(loss.detach())
    ref_launches = dict(fa.LAUNCHES)
    del model, params, grads, loss
    rows = {"plain": {"loss": ref_loss, "launches": ref_launches}}
    saved = {"plain": {k: v.cpu() for k, v in ref.items()}}
    for impl in ("ring", "ulysses"):
        plan = ParallelPlan({"seq": 1})
        attn_fn, rec = plan.seq_attention(heads=8, t_local=SEQ_T, impl=impl)
        model = TransformerLM(seed=0, attention_fn=attn_fn)
        loss, g, launches, ms = _sgd_grads(torch, plan, model,
                                           _seq_loss(torch, model), batch)
        worst, leaf, d = _over_limit(g, ref, SEQ1_GRAD_TOL)
        rows[impl] = {"loss": loss, "loss_diff": abs(loss - ref_loss),
                      "grad_over_limit": worst, "worst_leaf": leaf,
                      "grad_max_abs_diff": d, "launches": launches,
                      "ms": ms, "record": rec,
                      "collectives": plan.describe()["collectives"]}
        saved[impl] = {k: v.cpu() for k, v in g.items()}
        del model, g
    torch.save(saved, tmp / "seq_a.pt")
    (tmp / "seq_a.json").write_text(json.dumps(
        {k: r["loss"] for k, r in rows.items()}))
    print("seq plan (a) 2 summary", json.dumps(rows), flush=True)
    for impl in ("ring", "ulysses"):
        r = rows[impl]
        print(f"seq plan (a) 2 {impl}: ParallelPlan({{'seq': 1}}), "
              f"B {SEQ_B} x T {SEQ_T}: loss {r['loss']:.6f} (plain "
              f"{ref_loss:.6f}), grads {r['grad_over_limit']:.3e} of their "
              f"limit (worst {r['worst_leaf']}, max |diff| "
              f"{r['grad_max_abs_diff']:.3e}), K1/K2/K3 launches "
              f"{r['launches']} (plain {ref_launches}), step "
              f"{r['ms']:.2f} ms; card {smi}", flush=True)
        if r["loss_diff"] > 1e-5 * abs(ref_loss) \
                or not r["grad_over_limit"] <= 1 \
                or r["launches"] != ref_launches:
            raise AssertionError(f"seq plan (a) 2 {impl}: {r}")
    return a1, rows


def _seq_expected_bytes(impl, b, t_local, hq, hkv, d, layers, n):
    """Bytes a rank sends a step by the shapes (bf16 activations, fp32 K/V
    gradient accumulators): the ring's K/V pair n - 1 hops forward and
    n - 1 backward, the accumulators n hops; Ulysses' all-to-alls (q, k,
    v in and the output out, forward; their cotangents backward), each
    sending (n - 1)/n of its buffer."""
    kv = 2 * b * t_local * hkv * d
    if impl == "ring":
        return layers * ((n - 1) * kv * 2 * 2 + n * kv * 4)
    per = (2 * b * t_local * hq * d + 2 * b * t_local * hkv * d) * 2
    return layers * 2 * per * (n - 1) // n


def _seq_child(tmp, rank):
    """One rank of phase 17 (b) and (c): rank ``rank`` of a gloo group of
    ``SEQ_RANKS`` on the one card. (b) 1: ``ParallelPlan({'seq': 2})``
    through the ring and Ulysses, one SGD step (lr 1) of phase 7's LM
    over this rank's half of the sequence, held to (a)'s world-size-1
    plain model; (b) 2: the sliding window (W ``SEQ_WINDOW``) and (b) 3:
    the zigzag ring, forward and backward at the kernel level, against the
    plain call at world size 1; (c): the twin's ``--sequence-parallel``,
    ring and window. Exits non-zero when a check fails."""
    import functools

    import numpy as np
    import torch
    import torch.distributed as dist

    from chainermn_tpu_torch.examples.transformer import (
        train_transformer_lm,
    )
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.parallel import ring_attention as ra
    from chainermn_tpu_torch.parallel.local_attention import (
        sliding_window_attention_local,
    )
    from chainermn_tpu_torch.parallel.plan import ParallelPlan

    tmp = Path(tmp)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/seq_store",
                            rank=rank, world_size=SEQ_RANKS)
    n = SEQ_RANKS
    out = {"rank": rank}
    failed = []
    # gloo's all-to-all over CUDA tensors (Ulysses' reshard), checked
    # before Ulysses leans on it
    probe = torch.arange(4 * n, device="cuda:0", dtype=torch.float32
                         ) + 100 * rank
    got = torch.empty_like(probe)
    dist.all_to_all_single(got, probe)
    want = torch.cat([torch.arange(4 * rank, 4 * rank + 4,
                                   dtype=torch.float32) + 100 * s
                      for s in range(n)]).cuda()
    out["gloo_all_to_all_cuda"] = bool(torch.equal(got, want))
    if not out["gloo_all_to_all_cuda"]:
        failed.append("gloo_all_to_all_cuda")

    a_grads = torch.load(tmp / "seq_a.pt")
    a_loss = json.loads((tmp / "seq_a.json").read_text())
    batch = _seq_batch(torch, np, "cuda:0")
    # the attention's bytes (ring hops, Ulysses' all-to-alls) and, apart,
    # the buffers the step all-reduces (the seq mean of the gradients and
    # the metrics; how many bytes that puts on the wire is gloo's choice)
    sent = {"bytes": 0, "all_reduce": 0}
    keep = dist.batch_isend_irecv, dist.all_to_all_single, dist.all_reduce

    def transfer(ops):
        sent["bytes"] += sum(o.tensor.numel() * o.tensor.element_size()
                             for o in ops if o.op is dist.isend)
        return keep[0](ops)

    def all_to_all(output, input, *args, **kw):
        sent["bytes"] += input.numel() * input.element_size() * (n - 1) // n
        return keep[1](output, input, *args, **kw)

    def all_reduce(tensor, *args, **kw):
        sent["all_reduce"] += tensor.numel() * tensor.element_size()
        return keep[2](tensor, *args, **kw)

    t_local = SEQ_T // n
    for impl in ("ring", "ulysses"):
        plan = ParallelPlan({"seq": n}, device="cuda:0")
        attn_fn, _ = plan.seq_attention(heads=8, t_local=t_local, impl=impl)
        model = TransformerLM(seed=0, attention_fn=attn_fn, device="cuda:0")
        loss_fn = _seq_loss(torch, model, plan.seq_local_positions(t_local))
        sent["bytes"] = sent["all_reduce"] = 0
        (dist.batch_isend_irecv, dist.all_to_all_single,
         dist.all_reduce) = transfer, all_to_all, all_reduce
        try:
            loss, g, launches, ms = _sgd_grads(torch, plan, model, loss_fn,
                                               batch)
        finally:
            (dist.batch_isend_irecv, dist.all_to_all_single,
             dist.all_reduce) = keep
        L = model.num_layers
        each = L * (rank + 1) if impl == "ring" else L
        expected = {"fwd": each, "dq": each, "dkv": each}
        want_bytes = _seq_expected_bytes(impl, SEQ_B, t_local, 8, 8, 64, L,
                                         n)
        # one buffer of every gradient, and the loss (4 bytes)
        want_ar = sum(v.numel() * v.element_size()
                      for v in model.parameters()) + 4
        worst, leaf, d = _over_limit(g, a_grads["plain"], SEQ_GRAD_TOL)
        diff_a = max(float((g[k].float().cpu() - a_grads[impl][k].float()
                            ).abs().max()) for k in g)
        out[impl] = {"loss": loss, "loss_diff": abs(loss - a_loss["plain"]),
                     "loss_diff_vs_a": abs(loss - a_loss[impl]),
                     "grad_over_limit": worst, "worst_leaf": leaf,
                     "grad_max_abs_diff": d,
                     "grad_max_abs_diff_vs_a": diff_a,
                     "launches": launches, "expected_launches": expected,
                     "attention_bytes": sent["bytes"],
                     "expected_attention_bytes": want_bytes,
                     "all_reduce_bytes": sent["all_reduce"],
                     "expected_all_reduce_bytes": want_ar, "ms": ms}
        if (out[impl]["loss_diff"] > SEQ_LOSS_TOL or not worst <= 1
                or launches != expected or sent["bytes"] != want_bytes
                or sent["all_reduce"] != want_ar):
            failed.append(impl)
        del model, g
        torch.cuda.empty_cache()

    # (b) 2 and 3: the kernels' level, one generator for every rank
    gen = torch.Generator(device="cuda:0").manual_seed(17)
    q, k, v = (torch.randn(SEQ_B, SEQ_T, 8, 64, device="cuda:0",
                           generator=gen).bfloat16() for _ in range(3))

    def grads_of(fn, *xs):
        xs = [x.detach().clone().requires_grad_() for x in xs]
        o = fn(*xs)
        g = torch.autograd.grad((o.float() ** 2).sum(), xs)
        return o.detach(), g

    def plain(a, b_, c, window=None):
        """fp32 causal attention over the whole sequence, no kernel."""
        s_ = torch.einsum("bqhd,bkhd->bhqk", a.float(), b_.float()) * 64 ** -0.5
        i = torch.arange(a.shape[1], device=a.device)
        vis = i[:, None] >= i[None, :]
        if window is not None:
            vis &= i[:, None] - i[None, :] < window
        s_ = s_.masked_fill(~vis, float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", s_.softmax(-1), c.float())

    def held(got, want):
        """SEQ_KERNEL_TOL's measure: the largest row |diff| over its row's
        norm, or over the RMS of the rows' norms where that is larger."""
        d = (got.float() - want.float()).norm(dim=-1)
        r = want.float().norm(dim=-1)
        return float((d / r.clamp_min(float(r.square().mean().sqrt()))
                      ).max())

    lo, hi = rank * t_local, (rank + 1) * t_local
    for case in ("window", "zigzag"):
        if case == "window":
            ref_o, ref_g = grads_of(functools.partial(
                plain, window=SEQ_WINDOW), q, k, v)
            shard = (lambda x: x[:, lo:hi])

            def dist_fn(a, b_, c):
                return sliding_window_attention_local(a, b_, c,
                                                      window=SEQ_WINDOW)
        else:
            ref_o, ref_g = grads_of(plain, q, k, v)

            def shard(x):
                return ra.to_zigzag(x, n)[:, lo:hi]

            def dist_fn(a, b_, c):
                return ra.ring_attention_local(a, b_, c, causal=True,
                                               layout="zigzag")
        _reset_launches(fa)
        copies = fa.OFF_GRID_COPIES["copies"]
        sent["bytes"] = 0
        dist.batch_isend_irecv = transfer
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o, g = grads_of(dist_fn, *(shard(x) for x in (q, k, v)))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            dist.batch_isend_irecv = keep[0]
        errs = {"O": held(o, shard(ref_o)),
                **{name: held(gi, shard(ri)) for name, gi, ri in
                   zip(("dq", "dk", "dv"), g, ref_g)}}
        out[case] = {"row_err": errs, "launches": dict(fa.LAUNCHES),
                     "off_grid_copies": fa.OFF_GRID_COPIES["copies"] - copies,
                     "bytes_sent": sent["bytes"], "ms": ms}
        if max(errs.values()) > SEQ_KERNEL_TOL:
            failed.append(case)
    # zigzag: each rank runs 1 + 3 + (n - 1 - 1) ... = n + 2 block calls of
    # K1 forward and of K2/K3 backward (past: 1, diag: 3, future: 1)
    if out["zigzag"]["launches"] != {"fwd": n + 2, "dq": n + 2,
                                     "dkv": n + 2}:
        failed.append("zigzag_launches")
    if out["window"]["launches"] != {"fwd": 1, "dq": 1, "dkv": 1}:
        failed.append("window_launches")
    del q, k, v, ref_o, ref_g
    torch.cuda.empty_cache()

    # (c) the twin's sequence-parallel mode, ring and window
    out["twin"] = {}
    for name, extra in (("ring", []), ("window", ["--window",
                                                  str(SEQ_WINDOW)])):
        t0 = time.perf_counter()
        m = train_transformer_lm.main(
            ["--device", "cuda:0", "--sequence-parallel", "--seq-len",
             str(SEQ_T), "--iterations", str(SEQ_TWIN_ITERATIONS)] + extra,
            group=dist.group.WORLD)
        losses = [float(x) for x in m["losses"]]
        out["twin"][name] = {"losses": losses,
                             "seconds": time.perf_counter() - t0}
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]):
            failed.append(f"twin_{name}")
    out["failed"] = failed
    (tmp / f"seq_out{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    if failed:
        print(f"seq plan (b) rank {rank} failed: {failed}: "
              f"{json.dumps(out)}", file=sys.stderr, flush=True)
        sys.exit(1)


def phase_seq_ranks(torch, smi, tmp):
    """Phase 17 (b) and (c): ``SEQ_RANKS`` processes on the one card
    (``python3 chip_smoke.py --seq-child DIR RANK``), reading (a)'s
    values from ``tmp``; a failing rank fails the phase."""
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--seq-child",
         str(tmp), str(r)]) for r in range(SEQ_RANKS)]
    deadline = time.monotonic() + SEQ_CHILD_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    outs = [json.loads((tmp / f"seq_out{r}.json").read_text())
            for r in range(SEQ_RANKS) if (tmp / f"seq_out{r}.json").exists()]
    print("seq plan (b) summary", json.dumps(outs), flush=True)
    if any(codes) or len(outs) != SEQ_RANKS:
        raise AssertionError(f"seq plan (b) ranks exited with {codes}")
    for impl in ("ring", "ulysses"):
        print(f"seq plan (b) 1 {impl}: ParallelPlan({{'seq': {SEQ_RANKS}}}) "
              f"on one card over gloo, B {SEQ_B} x T {SEQ_T}: per rank loss "
              f"{[round(o[impl]['loss'], 6) for o in outs]} (diff vs the "
              f"plain model {[o[impl]['loss_diff'] for o in outs]}), grads "
              f"{[round(o[impl]['grad_over_limit'], 4) for o in outs]} of "
              f"their limit, max |diff| vs (a) {impl} "
              f"{[o[impl]['grad_max_abs_diff_vs_a'] for o in outs]}; "
              f"K1/K2/K3 launches {[o[impl]['launches'] for o in outs]}; "
              f"attention bytes sent a step "
              f"{[o[impl]['attention_bytes'] for o in outs]} (by the shapes "
              f"{outs[0][impl]['expected_attention_bytes']}), all-reduced "
              f"buffer bytes {[o[impl]['all_reduce_bytes'] for o in outs]} "
              f"(the gradients and the loss "
              f"{outs[0][impl]['expected_all_reduce_bytes']}); step ms "
              f"over gloo {[round(o[impl]['ms'], 1) for o in outs]}; card "
              f"{smi}", flush=True)
    for case in ("window", "zigzag"):
        print(f"seq plan (b) {case}: [{SEQ_B}, {SEQ_T}, 8, 64] bf16 over "
              f"{SEQ_RANKS} ranks against plain fp32 attention: row |diff| "
              f"over the row's scale {[o[case]['row_err'] for o in outs]} "
              f"(limit {SEQ_KERNEL_TOL}), launches "
              f"{[o[case]['launches'] for o in outs]}, host copies of "
              f"off-grid views {[o[case]['off_grid_copies'] for o in outs]}"
              f", bytes sent {[o[case]['bytes_sent'] for o in outs]}; card "
              f"{smi}", flush=True)
    for name in ("ring", "window"):
        t = outs[0]["twin"][name]
        print(f"seq plan (c) twin --sequence-parallel {name}: losses "
              f"{[round(x, 4) for x in t['losses']]} in "
              f"{t['seconds']:.1f} s", flush=True)
    return outs


# ---------------------------------------------------------------- phase 18

#: phase 18: phase 7's LM with a top-1 mixture of MOE_EXPERTS experts in
#: every block (d_ff 2048 an expert), bf16, seeded
MOE_EXPERTS = 8
MOE_TRAIN_STEPS = 10
MOE_TRAIN_WARMUP = 2
#: (b)/(c): the residual MoE MLP step (tokens x d, d_ff an expert) and
#: its SGD steps
MOE_MLP_TOKENS, MOE_MLP_D, MOE_MLP_FF = 4096, 512, 2048
MOE_MLP_STEPS = 3
MOE_MLP_LR = 0.1
MOE_RANKS = 2
MOE_CHILD_TIMEOUT_S = 300
MOE_TWIN_ITERATIONS = 50
#: (a) step 1 of the bf16 model (flash kernels) against the fp32 model
#: with the plain attention on the same weights and batch. Written before
#: the first run. bf16 rounds every activation and weight to 8 mantissa
#: bits (2^-9 relative) where fp32 keeps 24; through 6 blocks, the tied
#: head over 32000 classes and the router's choice (a token whose top-2
#: router logits sit within the bf16 rounding of h goes to another
#: expert: a few of 16,384 a layer, each moving its expert's gradient by
#: about 1/16,384 of its sum), a gradient entry moves by a few percent of
#: its leaf's largest; each entry is held to |g - g_ref| <= 0.1 |g_ref| +
#: 0.1 max |g_ref| of its leaf, and the loss to 1e-2 relative. On the
#: card the fp32 model's own router sent 81-274 of a block's 16,384
#: tokens to another expert than the bf16 run's did, and each moved its
#: whole contribution to the gradients of that block's router and ln2
#: (1.34 and 1.30 of this limit): so the fp32 runs route every token as
#: the bf16 run did, and the tokens routed elsewhere are counted. fp32
#: through K1-K3's fp32 kernels, routed alike, is held to the plain
#: attention at phase 8's limits (GRAD_EQ_TOL, LOSS_EQ_TOL).
MOE_GRAD_TOL = (0.1, 0.1)
MOE_LOSS_TOL = 1e-2
#: (c) 1: two expert ranks against (b)'s world-size-1 step (no-drop
#: capacity, so both layouts route every token to the same expert).
#: Written before the first run. The ranks' GEMMs run on half the rows
#: and their experts' queues on other shapes, so cuBLAS may round other
#: partial products: the pipeline's case (PIPE_GRAD_TOL's reasoning),
#: the same limits.
MOE_RANK_LOSS_TOL = 2e-3
MOE_RANK_GRAD_TOL = (0.03, 0.03)


def _moe_mlp_params(torch):
    """(b)'s seeded fp32 weights in the plan's global view at world size
    1: ``w_in`` [d, d], the router [d, E], and the experts' ``w1`` [1, E,
    d, ff] and ``w2`` [1, E, ff, d] (one expert rank of E experts)."""
    g = torch.Generator().manual_seed(18)
    d, ff, e = MOE_MLP_D, MOE_MLP_FF, MOE_EXPERTS

    def draw(*shape, scale):
        return torch.randn(shape, generator=g) * scale

    return {"w_in": draw(d, d, scale=d ** -0.5),
            "router": draw(d, e, scale=0.02),
            "experts": {"w1": draw(1, e, d, ff, scale=d ** -0.5),
                        "w2": draw(1, e, ff, d, scale=ff ** -0.5)}}


def _moe_mlp_batch(torch, device):
    g = torch.Generator().manual_seed(19)
    x = torch.randn(MOE_MLP_TOKENS, MOE_MLP_D, generator=g)
    y = torch.randn(MOE_MLP_TOKENS, MOE_MLP_D, generator=g)
    return x.to(device, torch.bfloat16), y.to(device)


def _bf16_expert(p, x):
    """One expert's MLP in bf16 (its queue rows arrive in the router's
    fp32, as the dispatch promotes them)."""
    import torch
    import torch.nn.functional as F

    bf = torch.bfloat16
    return F.gelu(x.to(bf) @ p["w1"].to(bf), approximate="tanh") \
        @ p["w2"].to(bf)


def _moe_mlp_loss(torch, moe_fn):
    """The residual MoE MLP's loss: ``h = x @ w_in`` (bf16), ``h + moe(h)``
    against ``y``, plus 0.01 of the aux loss; the stats as metrics."""
    def loss_fn(p, batch):
        x, y = batch
        h = x @ p["w_in"].to(torch.bfloat16)
        out, aux = moe_fn(h, p["router"], _bf16_expert, p["experts"])
        loss = ((h.float() + out - y) ** 2).mean() \
            + 0.01 * aux["load_balance"]
        return loss, ({"dropped": aux["dropped"],
                       "expert_load": aux["expert_load"]}, ())

    return loss_fn


def _moe_mlp_steps(torch, plan, impl, params, batch, steps):
    """``steps`` SGD steps of the MoE MLP through ``plan``'s expert axis
    at ``impl``: (losses, the first step's gradients as (p0 - p1) / lr on
    the CPU, its torch.distributed calls, the last step's metrics, step
    ms)."""
    import functools

    from chainermn_tpu_torch.parallel.plan_specs import P

    specs = {"w_in": P(), "router": P(), "experts": P("expert")}
    e_local = MOE_EXPERTS // plan.axis_size("expert")
    moe_fn, record = plan.moe_layer(
        tokens_local=MOE_MLP_TOKENS // plan.axis_size("expert"),
        d_model=MOE_MLP_D, experts_per_shard=e_local, capacity_factor=None,
        impl=impl, dtype=torch.bfloat16)
    sgd = functools.partial(torch.optim.SGD, lr=MOE_MLP_LR)
    state = plan.create_train_state(params, sgd, param_specs=specs)
    step = plan.compile_train_step(_moe_mlp_loss(torch, moe_fn), sgd, params,
                                   param_specs=specs)
    flat = lambda tree: dict(_leaves_of(tree))  # noqa: E731
    p0 = {k: v.detach().clone() for k, v in flat(state.params).items()}
    losses, ms, calls, grads = [], [], None, None
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _CountedDist() as c:
            state, m = step(state, plan.local_batch(batch))
            losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            calls = {k: v for k, v in c.items() if v}
            grads = {k: ((p0[k] - v.detach()) / MOE_MLP_LR).float().cpu()
                     for k, v in flat(state.params).items()}
    metrics = {"dropped": float(m["dropped"]),
               "expert_load": [float(v) for v in m["expert_load"]]}
    return losses, grads, calls, metrics, ms, record


def _leaves_of(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves_of(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _moe_a2a_bytes(tokens_local, n):
    """Bytes a rank sends a step through the four all-to-alls of (c)'s
    MoE MLP (no-drop queues [E, tokens_local, d]): the dispatch's fp32
    queues (the router's dtype; its backward sends their fp32
    cotangents) and the bf16 expert outputs (and their cotangents), each
    call sending (n - 1)/n of its buffer."""
    per = MOE_EXPERTS * tokens_local * MOE_MLP_D
    return 2 * (per * 4 + per * 2) * (n - 1) // n


def _moe_model(torch, dtype, **kw):
    from chainermn_tpu_torch.models import TransformerLM

    return TransformerLM(seed=0, compute_dtype=dtype, n_experts=MOE_EXPERTS,
                         **kw)


def _routed_as(torch, blk, idx):
    """``blk``'s dense MoE form with every token sent to the expert
    ``idx`` names (``[tokens]``), the gate its softmax probability: the
    block's ``_moe_ffn`` with the choice given instead of taken."""
    import torch.nn.functional as F

    def ffn(h):
        cd = blk.compute_dtype
        e = blk.moe_w_up.shape[0]
        probs = torch.softmax(h.float() @ blk.moe_router, dim=-1)
        pick = idx.reshape(h.shape[:-1])
        gate = probs.gather(-1, pick[..., None])[..., 0]
        up = (torch.einsum("...d,edf->...ef", h, blk.moe_w_up.to(cd))
              + blk.moe_b_up.to(cd))
        down = (torch.einsum("...ef,efd->...ed", F.gelu(
            up, approximate="tanh"), blk.moe_w_down.to(cd))
            + blk.moe_b_down.to(cd))
        combine = (F.one_hot(pick, e).to(down.dtype)
                   * gate.to(down.dtype)[..., None])
        return torch.einsum("...ed,...e->...d", down, combine)

    return ffn


def _moe_step1(torch, model, batch, route=None):
    """Step 1 of ``model`` on ``batch``: the loss, every parameter's fp32
    gradient and, per block, the expert each token's own router picks
    (its logits in fp32 from the block's normed rows, as ``_moe_ffn``
    takes them). ``route``, per block the experts of another run, makes
    every block send each token there instead (:func:`_routed_as`). The
    model is dropped."""
    picks = {}
    if route is not None:
        for blk, idx in zip(model.blocks, route):
            blk._moe_ffn = _routed_as(torch, blk, idx)

    def hook(blk):
        def record(_, __, h):
            # the first call: a recomputed block (remat) routes again
            if blk not in picks:
                logits = h.detach().float() @ blk.moe_router.detach()
                picks[blk] = logits.argmax(-1).reshape(-1)
        return record

    handles = [b.ln2.register_forward_hook(hook(b)) for b in model.blocks]
    params = dict(model.named_parameters())
    loss = _packed_loss(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    for h in handles:
        h.remove()
    return (float(loss.detach()), {k: g.float() for k, g in
                                   zip(params, grads)},
            [picks[b] for b in model.blocks])


def phase_moe(torch, np, comm, smi, tmp):
    """Phase 18 (a), (b) and (d) at world size 1 over the one-rank NCCL
    group; leaves (b)'s gradients and (d)'s TP 1 streams in ``tmp`` for
    (c)'s ranks."""
    import functools

    from chainermn_tpu_torch.examples.transformer.train_transformer_lm \
        import pack_documents
    from chainermn_tpu_torch.models import generate
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.ops import paged_decode as pd
    from chainermn_tpu_torch.ops.attention import attention
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.parallel.plan import ParallelPlan
    from chainermn_tpu_torch.serving import ServingEngine
    from chainermn_tpu_torch.training import (
        create_train_state,
        make_train_step,
    )

    tf32 = torch.backends.cuda.matmul.allow_tf32
    rows = {}
    # (a) training: step 1's loss and gradients against fp32 first
    rng = np.random.default_rng(0)  # phase 7's batches
    batches = [tuple(torch.from_numpy(x).cuda()
                     for x in pack_documents(rng, 8, 2048))
               for _ in range(MOE_TRAIN_STEPS)]
    model = _moe_model(torch, torch.bfloat16,
                       attention_fn=fa.flash_attention)
    loss_bf16, got, routes = _moe_step1(torch, model, batches[0])
    tokens = batches[0][0].numel()
    torch.backends.cuda.matmul.allow_tf32 = False
    # the plain version recomputes each block in its backward (remat):
    # the same gradients, without fp32 [B, H, T, T] scores of 6 blocks
    # alive at once. Both fp32 runs route every token to the expert the
    # bf16 run chose (their own choices are counted apart)
    ref_loss, ref, ref_routes = _moe_step1(torch, _moe_model(
        torch, torch.float32, attention_fn=functools.partial(
            attention, impl="xla"), remat=True, remat_policy="nothing"),
        batches[0], routes)
    f32_loss, f32, _ = _moe_step1(torch, _moe_model(
        torch, torch.float32, attention_fn=fa.flash_attention), batches[0],
        routes)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    worst, leaf, diff = _over_limit(got, ref, MOE_GRAD_TOL)
    f32_errs = {k: float((f32[k] - ref[k]).abs().max()
                         / ref[k].abs().max()) for k in ref}
    f32_worst = max(f32_errs, key=f32_errs.get)
    rerouted = [int((x != y).sum()) for x, y in zip(routes, ref_routes)]
    del got, ref, f32
    torch.cuda.empty_cache()
    opt = create_multi_node_optimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4), comm)
    state = create_train_state(model, opt, comm)
    step = make_train_step(_packed_loss, opt, comm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, launches = [], [], []
    for batch in batches:
        _reset_launches(fa)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(dict(fa.LAUNCHES))
    peak = torch.cuda.max_memory_allocated()
    want = {k: model.num_layers for k in ("fwd", "dq", "dkv")}

    def one_step():
        nonlocal state
        state, m = step(state, batches[-1])
        float(m["loss"])

    # where the MoE step's time goes: one more step, profiled
    wall, busy, kernels = _profile_window(
        torch, one_step, "moe (a) profile",
        ("flash_fwd_mma_kernel", "flash_dq_mma_kernel",
         "flash_dkv_mma_kernel", "gemm"))
    rows["a"] = {
        "losses": losses, "step_ms": step_ms,
        "step_ms_p50": statistics.median(step_ms[MOE_TRAIN_WARMUP:]),
        "tokens_per_s": batches[0][0].numel()
        / (statistics.median(step_ms[MOE_TRAIN_WARMUP:]) / 1e3),
        "peak_memory_bytes": peak, "launches_per_step": launches,
        "step1_loss_bf16": loss_bf16, "step1_loss_fp32_plain": ref_loss,
        "loss_rel_diff": abs(loss_bf16 - ref_loss) / abs(ref_loss),
        "grad_over_limit": worst, "worst_leaf": leaf,
        "grad_max_abs_diff": diff,
        "tokens_fp32_routes_elsewhere_by_layer": rerouted,
        "step1_loss_fp32_flash": f32_loss,
        "fp32_flash_loss_rel_diff": abs(f32_loss - ref_loss) / abs(ref_loss),
        "fp32_flash_grad_err": f32_errs[f32_worst],
        "fp32_flash_worst_leaf": f32_worst, "expected_launches": want,
        "profiled_step": {"wall_ms": wall, "busy_ms": busy,
                          "device_ops": sum(kc[1] for kc in kernels)}}
    del state, step, opt, model, batches
    torch.cuda.empty_cache()
    a = rows["a"]
    print("moe (a) summary", json.dumps(a), flush=True)
    print(f"moe (a): the LM with {MOE_EXPERTS} experts a block, bf16, B 8 x "
          f"T 2048 packed, {MOE_TRAIN_STEPS} AdamW steps: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, step p50 "
          f"{a['step_ms_p50']:.3f} ms ({a['tokens_per_s']:,.0f} tokens/s), "
          f"peak memory {peak / 2**30:.3f} GiB, K1/K2/K3 launches a step "
          f"{launches[-1]} (expected {want}); step 1 against the fp32 model "
          f"with plain attention, routed as the bf16 run routed: loss "
          f"{loss_bf16:.6f} vs {ref_loss:.6f} (rel "
          f"{a['loss_rel_diff']:.3e}, limit {MOE_LOSS_TOL}), grads "
          f"{worst:.3e} of their limit (worst {leaf}, max |diff| "
          f"{diff:.3e}); tokens the fp32 model's own router sends to "
          f"another expert, by block, {rerouted} of {tokens}; fp32 through "
          f"K1-K3's fp32 kernels, routed alike: loss rel "
          f"{a['fp32_flash_loss_rel_diff']:.3e} (limit {LOSS_EQ_TOL}), max "
          f"grad err / max |grad| {a['fp32_flash_grad_err']:.3e} "
          f"({f32_worst}, limit {GRAD_EQ_TOL}); card {smi}", flush=True)
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"moe (a): losses not finite and falling: "
                             f"{losses}")
    if any(ln != want for ln in launches):
        raise AssertionError(f"moe (a): K1/K2/K3 launches {launches}, "
                             f"expected {want} a step")
    if a["loss_rel_diff"] > MOE_LOSS_TOL or not worst <= 1:
        raise AssertionError(f"moe (a): step 1 against fp32: loss rel diff "
                             f"{a['loss_rel_diff']}, grads {worst} of their "
                             f"limit ({leaf})")
    if (a["fp32_flash_loss_rel_diff"] > LOSS_EQ_TOL
            or a["fp32_flash_grad_err"] > GRAD_EQ_TOL):
        raise AssertionError(f"moe (a): fp32 through the kernels against the "
                             f"plain attention: loss rel "
                             f"{a['fp32_flash_loss_rel_diff']}, grad err "
                             f"{a['fp32_flash_grad_err']} ({f32_worst})")

    # (b) the plan's expert axis at world size 1, both impls
    torch.backends.cuda.matmul.allow_tf32 = False
    params = _moe_mlp_params(torch)
    batch = _moe_mlp_batch(torch, "cuda")
    b = {}
    for impl in ("sort", "einsum"):
        plan = ParallelPlan({"expert": 1})
        losses, grads, calls, metrics, ms, record = _moe_mlp_steps(
            torch, plan, impl, params, batch, MOE_MLP_STEPS)
        b[impl] = {"losses": losses, "calls_step1": calls,
                   "metrics": metrics, "step_ms": ms, "record": record,
                   "describe": plan.describe()}
        if impl == "sort":
            torch.save(grads, tmp / "moe_b_grads.pt")
            (tmp / "moe_b.json").write_text(json.dumps(
                {"loss": losses[0]}))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    b["step1_bit_identical"] = b["sort"]["losses"][0] \
        == b["einsum"]["losses"][0]
    b["max_rel_loss_diff"] = max(abs(s - e) / abs(e) for s, e in zip(
        b["sort"]["losses"], b["einsum"]["losses"]))
    rows["b"] = b
    print("moe (b) summary", json.dumps(b), flush=True)
    for impl in ("sort", "einsum"):
        r = b[impl]
        print(f"moe (b) {impl}: ParallelPlan({{'expert': 1}}), "
              f"{MOE_EXPERTS} experts, {MOE_MLP_TOKENS} tokens x d "
              f"{MOE_MLP_D} bf16, no-drop: losses {r['losses']}, step 1's "
              f"torch.distributed calls {r['calls_step1']}, dropped "
              f"{r['metrics']['dropped']}, expert load "
              f"{r['metrics']['expert_load']} (sum "
              f"{sum(r['metrics']['expert_load'])}), step ms "
              f"{[round(x, 2) for x in r['step_ms']]}; card {smi}",
              flush=True)
    print(f"moe (b): sort vs einsum step 1 bit-identical "
          f"{b['step1_bit_identical']}, max relative loss diff "
          f"{b['max_rel_loss_diff']:.3e}", flush=True)
    for impl in ("sort", "einsum"):
        r = b[impl]
        if r["calls_step1"].get("all_to_all_single") != 4:
            raise AssertionError(f"moe (b) {impl}: {r['calls_step1']}: not "
                                 "2 all-to-alls forward and 2 backward")
        if r["metrics"]["dropped"] != 0 or sum(
                r["metrics"]["expert_load"]) != MOE_MLP_TOKENS:
            raise AssertionError(f"moe (b) {impl}: stats {r['metrics']}")
    if not b["step1_bit_identical"] or b["max_rel_loss_diff"] > 1e-5:
        raise AssertionError(f"moe (b): the impls' losses differ: "
                             f"{b['sort']['losses']} vs "
                             f"{b['einsum']['losses']}")

    # (d) serving at world size 1: phase 3's traffic
    model = _moe_model(torch, torch.bfloat16)
    engine = ServingEngine(model, num_slots=16, max_len=2048,
                           kv_block_size=64, decode_attend_impl="fused")
    reqs = _requests(np, 24, 0, model.vocab_size)
    _serve(engine, _requests(np, 2, 1, model.vocab_size))  # warm-up
    torch.cuda.synchronize()
    pd.reset_launches()
    t0 = time.perf_counter()
    streams, sched = _serve(engine, reqs)
    wall = time.perf_counter() - t0
    summary = sched.summary()
    launches, routes = pd.LAUNCHES, dict(pd.ROUTE_LAUNCHES)
    want_routes = {"split": model.num_layers * summary["decode_steps"],
                   "mma": model.num_layers * summary["prefills"], "rows": 0}
    del engine, model
    d = {"requests": len(reqs), "wall_s": wall, "k4_launches": launches,
         "route_launches": routes, "expected_routes": want_routes,
         **{k: summary[k] for k in (
             "tokens_per_sec", "ttft_ms_p50", "ttft_ms_p99", "token_ms_p50",
             "token_ms_p99", "prefills", "decode_steps")}}
    # fp32 streams against generate, and the TP 1 engine (the ownership-
    # split form) against the plain engine, on the cut traffic
    cut = _tp_requests(np, 32000)
    torch.backends.cuda.matmul.allow_tf32 = False
    m32 = _moe_model(torch, torch.float32)
    plain32, _ = _serve(ServingEngine(
        m32, num_slots=16, max_len=2048, kv_block_size=64,
        decode_attend_impl="fused"), cut)
    width = max(len(p) for p, _ in cut) + TP_CARD_NEW_TOKENS
    prompt = torch.zeros(len(cut), width, dtype=torch.long, device="cuda")
    for i, (p, _) in enumerate(cut):
        prompt[i, :len(p)] = torch.tensor(p)
    out = generate(m32, prompt[:, :max(len(p) for p, _ in cut)], width)
    gen = [out[i, len(p):len(p) + TP_CARD_NEW_TOKENS].tolist()
           for i, (p, _) in enumerate(cut)]
    d["fp32_generate_parts"] = _near_tie_parts(torch, m32, cut, gen,
                                               plain32)
    tp1 = {}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype)[6:]
        m = _moe_model(torch, dtype, moe_dispatch_impl="sort")
        plain = plain32 if key == "float32" else _serve(ServingEngine(
            m, num_slots=16, max_len=2048, kv_block_size=64,
            decode_attend_impl="fused"), cut)[0]
        engine = ServingEngine(m, num_slots=16, max_len=2048,
                               kv_block_size=64, decode_attend_impl="fused",
                               mesh=comm)
        pd.reset_launches()
        ticks = _ticks_counted(engine, pd)
        got, sched1 = _serve(engine, cut)
        same = sum(x == y for a, b_ in zip(plain, got) for x, y in zip(a, b_))
        tp1[key] = {"streams": got, "equal_tokens": same,
                    "tokens": sum(len(a) for a in plain),
                    "ticks": len(ticks), "tick": ticks[0],
                    "bad_ticks": [t for t in ticks if t != (
                        {"all_reduce": 2 * m.num_layers,
                         "all_to_all_single": 2 * m.num_layers},
                        m.num_layers)],
                    "token_ms_p50": sched1.summary()["token_ms_p50"]}
        if key == "float32":
            tp1[key]["parts"] = _near_tie_parts(torch, m, cut, plain, got)
        del engine, m
    torch.backends.cuda.matmul.allow_tf32 = tf32
    (tmp / "moe_tp1.json").write_text(json.dumps(
        {k: v["streams"] for k, v in tp1.items()}))
    d["tp1"] = {k: {kk: vv for kk, vv in v.items() if kk != "streams"}
                for k, v in tp1.items()}
    rows["d"] = d
    print("moe (d) summary", json.dumps(d), flush=True)
    print(f"moe (d): {len(reqs)} requests of phase 3's traffic, 16 slots: "
          f"{d['tokens_per_sec']} tokens/s, TTFT p50 {d['ttft_ms_p50']} p99 "
          f"{d['ttft_ms_p99']} ms, token ms p50 {d['token_ms_p50']} p99 "
          f"{d['token_ms_p99']}, wall {wall:.3f} s; K4 launches {launches} "
          f"by route {routes} (expected {want_routes}); fp32 engine vs "
          f"generate: parts {d['fp32_generate_parts']}; TP 1 (mesh, "
          f"ownership-split) vs the plain engine: fp32 "
          f"{tp1['float32']['equal_tokens']}/{tp1['float32']['tokens']} "
          f"tokens equal (parts {tp1['float32']['parts']}), bf16 "
          f"{tp1['bfloat16']['equal_tokens']}/{tp1['bfloat16']['tokens']}; "
          f"a TP 1 tick {tp1['float32']['tick']}; card {smi}", flush=True)
    if routes != want_routes or not launches:
        raise AssertionError(f"moe (d): K4 launches by route {routes} != "
                             f"{want_routes}")
    for (prompt_, n_new), g in zip(reqs, streams):
        if len(g) != n_new or not all(0 <= t < 32000 for t in g):
            raise AssertionError("moe (d): a malformed stream")
    far = [p for p in d["fp32_generate_parts"] + tp1["float32"]["parts"]
           if not p[2] < NEAR_TIE]
    if far:
        raise AssertionError(f"moe (d): fp32 streams part away from a "
                             f"near-tie: {far}")
    if tp1["float32"]["bad_ticks"] or tp1["bfloat16"]["bad_ticks"]:
        raise AssertionError(f"moe (d): TP 1 ticks made other calls or "
                             f"launches: {tp1['float32']['bad_ticks'][:2]}")
    return rows


def _moe_child(tmp, rank):
    """One rank of phase 18 (c) and (e): rank ``rank`` of a gloo group of
    ``MOE_RANKS`` on the one card. (c) 1: ``ParallelPlan({'expert': 2})``
    at 4 experts a rank, one SGD step of (b)'s MoE MLP held to (b)'s
    world-size-1 step, its all-to-alls and bytes counted; (c) 2: MoE
    serving at TP 2 (fp32, bf16) against (d)'s TP 1 streams, every decode
    tick's calls and K4 launches; (e): the twin at 2 ranks. Exits non-zero
    when a check fails."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from chainermn_tpu_torch.examples.moe import train_moe_mlp
    from chainermn_tpu_torch.ops import paged_decode as pd
    from chainermn_tpu_torch.parallel.plan import ParallelPlan
    from chainermn_tpu_torch.serving import ServingEngine

    tmp = Path(tmp)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/moe_store",
                            rank=rank, world_size=MOE_RANKS)
    n = MOE_RANKS
    out = {"rank": rank}
    failed = []
    # gloo's all-to-all over CUDA [E, C, d] queues, checked first
    e, c, dd = MOE_EXPERTS, 4, 16
    probe = (torch.arange(e * c * dd, device="cuda:0", dtype=torch.float32)
             .reshape(e, c, dd) + 1e4 * rank)
    got = torch.empty_like(probe)
    dist.all_to_all_single(got, probe)
    want = torch.cat([probe[rank * e // n:(rank + 1) * e // n] - 1e4 * rank
                      + 1e4 * s for s in range(n)])
    out["gloo_all_to_all_cuda"] = bool(torch.equal(got, want))
    if not out["gloo_all_to_all_cuda"]:
        failed.append("gloo_all_to_all_cuda")

    # (c) 1: the plan's expert axis over the two ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    full = _moe_mlp_params(torch)
    params = {"w_in": full["w_in"], "router": full["router"],
              "experts": {k: v.reshape(n, MOE_EXPERTS // n, *v.shape[2:])
                          for k, v in full["experts"].items()}}
    batch = _moe_mlp_batch(torch, "cuda:0")
    sent = {"bytes": 0}
    keep = dist.all_to_all_single

    def all_to_all(output, input, *args, **kw):
        sent["bytes"] += input.numel() * input.element_size() * (n - 1) // n
        return keep(output, input, *args, **kw)

    dist.all_to_all_single = all_to_all
    try:
        plan = ParallelPlan({"expert": n}, device="cuda:0")
        losses, grads, calls, metrics, ms, _ = _moe_mlp_steps(
            torch, plan, "sort", params, batch, 1)
    finally:
        dist.all_to_all_single = keep
    b_grads = torch.load(tmp / "moe_b_grads.pt")
    b_loss = json.loads((tmp / "moe_b.json").read_text())["loss"]
    el = MOE_EXPERTS // n
    ref = {k: (v[rank * el:(rank + 1) * el]
               if k.startswith("experts/") else v)
           for k, v in b_grads.items()}
    worst, leaf, diff = _over_limit(grads, ref, MOE_RANK_GRAD_TOL)
    want_bytes = _moe_a2a_bytes(MOE_MLP_TOKENS // n, n)
    out["plan"] = {"loss": losses[0], "loss_b": b_loss,
                   "loss_rel_diff": abs(losses[0] - b_loss) / abs(b_loss),
                   "grad_over_limit": worst, "worst_leaf": leaf,
                   "grad_max_abs_diff": diff, "calls": calls,
                   "a2a_bytes": sent["bytes"], "expected_a2a_bytes":
                   want_bytes, "metrics": metrics, "ms": ms[0]}
    if (out["plan"]["loss_rel_diff"] > MOE_RANK_LOSS_TOL or not worst <= 1
            or calls.get("all_to_all_single") != 4
            or sent["bytes"] != want_bytes
            or metrics["dropped"] != 0):
        failed.append("plan")
    del grads, b_grads, ref, full, params, batch
    torch.cuda.empty_cache()

    # (c) 2: MoE serving at TP n
    tp1 = json.loads((tmp / "moe_tp1.json").read_text())
    cut = _tp_requests(np, 32000)
    out["tp"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype)[6:]
        m = _moe_model(torch, dtype, moe_dispatch_impl="sort",
                       device="cuda:0")
        engine = ServingEngine(m, num_slots=16, max_len=2048,
                               kv_block_size=64, decode_attend_impl="fused",
                               mesh=dist.group.WORLD, device="cuda:0")
        pd.reset_launches()
        ticks = _ticks_counted(engine, pd)
        t0 = time.perf_counter()
        streams, sched = _serve(engine, cut)
        summ = sched.summary()
        want_tick = ({"all_reduce": 2 * m.num_layers,
                      "all_to_all_single": 2 * m.num_layers},
                     m.num_layers)
        same = sum(x == y for a, b_ in zip(tp1[key], streams)
                   for x, y in zip(a, b_))
        out["tp"][key] = {
            "streams": streams, "equal_tokens_vs_tp1": same,
            "tokens": sum(len(a) for a in tp1[key]),
            "tick": ticks[0], "bad_ticks": len([t for t in ticks
                                                if t != want_tick]),
            "k4_launches": pd.LAUNCHES,
            "k4_expected": m.num_layers * (summ["prefills"]
                                           + summ["decode_steps"]),
            "token_ms_p50": summ["token_ms_p50"],
            "wall_s": time.perf_counter() - t0}
        r = out["tp"][key]
        if r["bad_ticks"] or r["k4_launches"] != r["k4_expected"]:
            failed.append(f"tp_{key}")
        del engine, m
    torch.backends.cuda.matmul.allow_tf32 = True

    # (e) the twin at n ranks
    t0 = time.perf_counter()
    res = train_moe_mlp.run(["--device", "cuda:0", "--iterations",
                             str(MOE_TWIN_ITERATIONS)],
                            group=dist.group.WORLD)
    out["twin"] = {"losses": res["losses"], "accs": res["accs"],
                   "seconds": time.perf_counter() - t0}
    if not (all(math.isfinite(x) for x in res["losses"])
            and res["accs"][-1] > res["accs"][0]):
        failed.append("twin")
    out["failed"] = failed
    (tmp / f"moe_out{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    if failed:
        print(f"moe (c) rank {rank} failed: {failed}: {json.dumps(out)}",
              file=sys.stderr, flush=True)
        sys.exit(1)


def phase_moe_ranks(torch, np, smi, tmp):
    """Phase 18 (c) and (e)'s two-rank run: ``MOE_RANKS`` processes on
    the one card (``python3 chip_smoke.py --moe-child DIR RANK``), reading
    (b)'s and (d)'s values from ``tmp``; a failing rank fails the phase.
    The fp32 TP 2 streams must equal TP 1's, or part at a true near-tie;
    the bf16 tokens equal are reported."""
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--moe-child",
         str(tmp), str(r)]) for r in range(MOE_RANKS)]
    deadline = time.monotonic() + MOE_CHILD_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    outs = [json.loads((tmp / f"moe_out{r}.json").read_text())
            for r in range(MOE_RANKS) if (tmp / f"moe_out{r}.json").exists()]
    print("moe (c) summary", json.dumps(outs), flush=True)
    if any(codes) or len(outs) != MOE_RANKS:
        raise AssertionError(f"moe (c) ranks exited with {codes}")
    p = [o["plan"] for o in outs]
    print(f"moe (c) 1: ParallelPlan({{'expert': {MOE_RANKS}}}) at "
          f"{MOE_EXPERTS // MOE_RANKS} experts a rank over gloo on one card: "
          f"gloo all-to-all of CUDA queues {[o['gloo_all_to_all_cuda'] for o in outs]}"
          f"; per rank loss {[x['loss'] for x in p]} (world size 1: "
          f"{p[0]['loss_b']}), grads {[round(x['grad_over_limit'], 4) for x in p]}"
          f" of their limit (worst {[x['worst_leaf'] for x in p]}), calls "
          f"{[x['calls'] for x in p]}, all-to-all bytes sent "
          f"{[x['a2a_bytes'] for x in p]} (by the shapes "
          f"{p[0]['expected_a2a_bytes']}), step ms over gloo "
          f"{[round(x['ms'], 1) for x in p]}; card {smi}", flush=True)
    tp1 = json.loads((tmp / "moe_tp1.json").read_text())
    for key in ("float32", "bfloat16"):
        r = [o["tp"][key] for o in outs]
        if any(x["streams"] != r[0]["streams"] for x in r[1:]):
            raise AssertionError(f"moe (c) 2 {key}: the ranks' streams "
                                 "differ")
        print(f"moe (c) 2 {key}: TP {MOE_RANKS} MoE serving, "
              f"{TP_CARD_REQUESTS} requests x {TP_CARD_NEW_TOKENS} tokens: "
              f"{r[0]['equal_tokens_vs_tp1']}/{r[0]['tokens']} tokens equal "
              f"to TP 1's; a tick {r[0]['tick']}; per rank K4 launches "
              f"{[x['k4_launches'] for x in r]} (expected "
              f"{[x['k4_expected'] for x in r]}), ms per tick p50 "
              f"{[x['token_ms_p50'] for x in r]}; card {smi}", flush=True)
    # fp32: TP 2 equals TP 1, or parts at a true near-tie of the logits
    torch.backends.cuda.matmul.allow_tf32 = False
    m32 = _moe_model(torch, torch.float32)
    parts = _near_tie_parts(torch, m32, _tp_requests(np, 32000),
                            tp1["float32"], outs[0]["tp"]["float32"]
                            ["streams"])
    del m32
    torch.backends.cuda.matmul.allow_tf32 = True
    print(f"moe (c) 2 float32: parts from TP 1 (request, token, top-2 gap) "
          f"{parts}", flush=True)
    far = [x for x in parts if not x[2] < NEAR_TIE]
    if far:
        raise AssertionError(f"moe (c) 2: fp32 TP {MOE_RANKS} streams part "
                             f"from TP 1's away from a near-tie: {far}")
    t = outs[0]["twin"]
    print(f"moe (e) twin at {MOE_RANKS} ranks over gloo: loss "
          f"{t['losses'][0]:.4f} -> {t['losses'][-1]:.4f}, acc "
          f"{t['accs'][0]:.4f} -> {t['accs'][-1]:.4f} in {t['seconds']:.1f} s",
          flush=True)
    return outs


def phase_moe_twin(torch, smi):
    """Phase 18 (e) at world size 1 on the card (over the one-rank NCCL
    group): the twin's defaults but ``MOE_TWIN_ITERATIONS`` iterations."""
    from chainermn_tpu_torch.examples.moe import train_moe_mlp

    t0 = time.perf_counter()
    res = train_moe_mlp.run(["--iterations", str(MOE_TWIN_ITERATIONS)])
    row = {"losses": res["losses"], "accs": res["accs"],
           "seconds": time.perf_counter() - t0}
    print(f"moe (e) twin at world size 1: loss {res['losses'][0]:.4f} -> "
          f"{res['losses'][-1]:.4f}, acc {res['accs'][0]:.4f} -> "
          f"{res['accs'][-1]:.4f} in {row['seconds']:.1f} s; card {smi}",
          flush=True)
    if not (all(math.isfinite(x) for x in res["losses"])
            and res["accs"][-1] > res["accs"][0]):
        raise AssertionError(f"moe (e): the twin did not learn: {row}")
    return row


# ---------------------------------------------------------------- phase 19

TOPO_STEPS = 10
TOPO_WARMUP = 2
TOPO_RANKS = 4
TOPO_CHILD_TIMEOUT_S = 300
#: (b): the LM at full width cut to 2 layers, B 2 x T 512 a rank
TOPO_LAYERS = 2
TOPO_B, TOPO_T = 2, 512
TOPO_RANK_STEPS = 3
#: a reduced gradient may sit this far past the wire's stated bound
#: before (b) fails: none (the bound is the wire's own)
TOPO_BOUND_SHARE = 1.0
#: (a) local SGD: its outer step a - (a - c) rounds once a sync, and
#: AdamW turns a rounding into a step of up to 2 lr where a gradient is
#: near zero, so its largest |parameter| difference from the fp32 run is
#: printed; the last loss must stay within this relative distance
TOPO_LOSS_TOL = 1e-3
TOPO_TWIN_ITERATIONS = 10
TOPO_IMAGENET_ITERATIONS = 5
TOPO_MNIST_ITERATIONS = 60


def _adamw(torch, params):
    """Phase 7's optimizer: AdamW with optax.adamw's defaults."""
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _topo_train(torch, fa, comm, make_opt, batches, **model_kw):
    """Phase 7's LM behind ``make_opt(model, comm)`` for ``len(batches)``
    steps: losses, host ms a step, K1-K3 launches a step, the
    ``torch.distributed`` calls of the last step, and the model."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.training import (
        create_train_state,
        make_train_step,
    )

    torch.cuda.empty_cache()
    model = TransformerLM(seed=0, attention_fn=fa.flash_attention,
                          **model_kw)
    opt = make_opt(model, comm)
    state = create_train_state(model, opt, comm)
    step = make_train_step(_packed_loss, opt, comm)
    _reset_launches(fa)
    state, losses, ms = _run_steps(step, state, batches[:-1])
    launches = {k: v / (len(batches) - 1) for k, v in fa.LAUNCHES.items()}
    with _CountedDist() as calls:
        state, last, ms_last = _run_steps(step, state, batches[-1:])
    return {"losses": losses + last, "ms": ms + ms_last,
            "launches_per_step": launches,
            "calls_per_step": {k: v for k, v in calls.items() if v},
            "model": model, "optimizer": opt}


def phase_topology(torch, np, smi):
    """Phase 19 (a): phase 7's LM (B 8 x T 2048 packed, bf16, flash
    attention, AdamW) at world size 1 over NCCL, ``TOPO_STEPS`` steps
    under each topology communicator (bf16 wire), two_dimensional with
    the int8 wire and shard-level error feedback, the three reduction
    schedules (bf16 wire) and local SGD (sync every 2): every run's losses
    bit for bit those of ``pure_nccl`` on the same wire (fp32 for int8:
    at one rank every wire is exact and the residual stays zero), K1/K2/
    K3 6/6/6 a step; local SGD's largest |parameter| difference from the
    fp32 run."""
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.examples.transformer.train_transformer_lm \
        import pack_documents
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.optimizers import (
        create_local_sgd,
        create_multi_node_optimizer,
    )

    rng = np.random.default_rng(0)
    batches = [tuple(torch.from_numpy(x).cuda()
                     for x in pack_documents(rng, 8, 2048))
               for _ in range(TOPO_STEPS)]

    def mno(**kw):
        return lambda model, comm: create_multi_node_optimizer(
            _adamw(torch, model.parameters()), comm, **kw)

    def sgd_local(model, comm):
        return create_local_sgd(_adamw(torch, model.parameters()), comm,
                                sync_every=2)

    bf16 = {"allreduce_grad_dtype": "bfloat16"}
    runs = [  # (label, communicator name, its kwargs, optimizer, wire)
        ("pure_nccl fp32", "pure_nccl", {}, mno(), "float32"),
        ("pure_nccl bf16", "pure_nccl", bf16, mno(), "bfloat16")]
    runs += [(name, name, bf16, mno(), "bfloat16") for name in (
        "hierarchical", "two_dimensional", "single_node", "non_cuda_aware")]
    runs += [("two_dimensional int8 + EF", "two_dimensional",
              {"allreduce_grad_dtype": "int8"}, mno(error_feedback=True),
              "float32")]
    runs += [(f"schedule {s}", "pure_nccl", bf16, mno(reduction_schedule=s),
              "bfloat16") for s in ("flat", "two_level", "zero")]
    runs += [("local SGD (sync every 2)", "pure_nccl", {}, sgd_local, None)]
    rows, ref = {}, {}
    for label, name, kw, make_opt, wire in runs:
        comm = create_communicator(name, **kw)
        r = _topo_train(torch, fa, comm, make_opt, batches)
        p50, p99 = _p50_p99(r["ms"][TOPO_WARMUP:])
        row = {"losses": r["losses"], "step_ms_p50": p50,
               "step_ms_p99": p99, "calls_per_step": r["calls_per_step"],
               "launches_per_step": r["launches_per_step"],
               "communicator": repr(comm)}
        if label.startswith("pure_nccl"):
            ref[wire] = r
        elif wire is not None:
            row["bit_identical_to_pure_nccl"] = (
                r["losses"] == ref[wire]["losses"])
        if label.endswith("EF"):
            row["residual_all_zero"] = all(
                not bool(t.any()) for t in
                r["optimizer"].state_dict()["residual"])
            row["residual_shapes"] = [list(t.shape) for t in
                                      r["optimizer"].state_dict()["residual"]]
        if wire is None:
            mine = dict(r["model"].named_parameters())
            row["max_abs_param_diff_vs_fp32"] = max(
                float((mine[k].detach() - p.detach()).abs().max())
                for k, p in ref["float32"]["model"].named_parameters())
        rows[label] = row
        base = ref.get(wire or "float32")
        bp50 = _p50_p99(base["ms"][TOPO_WARMUP:])
        print(f"topology (a) {label}: losses {r['losses'][0]:.6f} -> "
              f"{r['losses'][-1]:.6f}"
              + (f", bit-identical to pure_nccl {wire}: "
                 f"{row['bit_identical_to_pure_nccl']}"
                 if "bit_identical_to_pure_nccl" in row else "")
              + (f", max |dparam| vs pure_nccl fp32 "
                 f"{row['max_abs_param_diff_vs_fp32']:.3e}"
                 if wire is None else "")
              + (f", residual all zero {row['residual_all_zero']} "
                 f"shapes {row['residual_shapes']}"
                 if "residual_all_zero" in row else "")
              + f"; step ms p50 {p50:.3f} p99 {p99:.3f} (pure_nccl "
              f"{wire or 'float32'}: {bp50[0]:.3f} / {bp50[1]:.3f}); calls "
              f"a step {row['calls_per_step']}; K1/K2/K3 a step "
              f"{row['launches_per_step']}; card {smi}", flush=True)
        r.pop("optimizer")
        if not label.startswith("pure_nccl") and wire is not None:
            del r["model"]
    del ref
    torch.cuda.empty_cache()
    print("topology (a) summary", json.dumps(rows), flush=True)
    bad = [k for k, v in rows.items()
           if v.get("bit_identical_to_pure_nccl") is False
           or v.get("residual_all_zero") is False
           or any(n != 6 for n in v["launches_per_step"].values())
           or not all(math.isfinite(x) for x in v["losses"])]
    local = rows["local SGD (sync every 2)"]["losses"][-1]
    fp32 = rows["pure_nccl fp32"]["losses"][-1]
    if not abs(local - fp32) <= TOPO_LOSS_TOL * abs(fp32):
        bad.append("local SGD (sync every 2)")
    if bad:
        raise AssertionError(f"topology (a): {bad} failed: "
                             f"{json.dumps({k: rows[k] for k in bad})}")
    return rows


class _BytesDist(_CountedDist):
    """:class:`_CountedDist` that also adds up the bytes each call sends
    from this rank, by the ring algorithms' counts: an all-reduce
    ``2(n-1)/n`` of its buffer, a reduce-scatter ``(n-1)/n`` of its input,
    an all-gather ``(n-1)/n`` of its output, an all-to-all ``(n-1)/n`` of
    its input, a point-to-point transfer its tensors."""

    def __enter__(self):
        counts = super().__enter__()
        self.sent = 0
        dist = self.dist

        def size(kw, args, at):
            g = kw.get("group", args[at] if len(args) > at else None)
            return dist.get_world_size(g)

        def patch(name, nbytes):
            inner = getattr(dist, name)

            def call(*a, **k):
                self.sent += nbytes(a, k)
                return inner(*a, **k)
            setattr(dist, name, call)

        def nb(t):
            return t.numel() * t.element_size()

        patch("all_reduce", lambda a, k: 2 * (size(k, a, 2) - 1)
              * nb(a[0]) // size(k, a, 2))
        patch("reduce_scatter_tensor", lambda a, k: (size(k, a, 3) - 1)
              * nb(a[1]) // size(k, a, 3))
        patch("all_gather_into_tensor", lambda a, k: (size(k, a, 2) - 1)
              * nb(a[0]) // size(k, a, 2))
        patch("all_gather", lambda a, k: (size(k, a, 2) - 1) * nb(a[1]))
        patch("all_to_all_single", lambda a, k: (size(k, a, 4) - 1)
              * nb(a[1]) // size(k, a, 4))
        patch("batch_isend_irecv", lambda a, k: sum(
            nb(op.tensor) for op in a[0] if op.op is dist.isend))
        return counts


def _topo_expected_bytes(config, bucket_elems, n_params, step, n=4,
                         n_intra=2):
    """Bytes a step per rank of each (b) configuration's reduction by the
    shapes (``bucket_elems``: each gradient bucket's elements), by the
    ring counts of :class:`_BytesDist`."""
    if config == "local SGD":
        # a sync every 2 steps: one fp32 all-reduce of the parameters
        return 2 * (n - 1) * 4 * n_params // n if step % 2 == 1 else 0
    n_inter = n // n_intra
    total = 0
    for m in bucket_elems:
        c1 = -(-m // n_intra)  # the intra shard, ceil-padded
        if config == "two_dimensional bf16":
            # rs(intra), ar(inter) of the shard, ag(intra): 2-byte elements
            total += (2 * (n_intra - 1) * c1
                      + 2 * 2 * (n_inter - 1) * c1 // n_inter
                      + 2 * (n_intra - 1) * c1)
        elif config == "two_level fp32":
            total += (4 * (n_intra - 1) * c1
                      + 2 * 4 * (n_inter - 1) * c1 // n_inter
                      + 4 * (n_intra - 1) * c1)
        elif config == "int8 flat EF":
            # all-to-all of the int8 rows, all-gathers of the n scales,
            # of the int8 shards and of the n stage-2 scales
            c = -(-m // n)
            total += 2 * (n - 1) * c + 2 * (n - 1) * 4
        elif config == "int8 shard EF":
            # fp32 rs(intra), the int8 wire on the shard over inter, fp32
            # ag(intra)
            c2 = -(-c1 // n_inter)
            total += (2 * 4 * (n_intra - 1) * c1
                      + 2 * (n_inter - 1) * c2 + 2 * (n_inter - 1) * 4)
        else:
            raise KeyError(config)
    return total


def _comm_child(tmp, rank):
    """One rank of phase 19 (b): rank ``rank`` of ``TOPO_RANKS`` gloo
    processes on the one card, the 2 x 2 layout (``mesh=``), phase 7's LM
    at full width cut to ``TOPO_LAYERS`` layers, ``TOPO_RANK_STEPS`` AdamW
    steps of this rank's own batch a configuration; each step's
    parameters hashed and compared across the ranks; step 1's reduced
    gradient against the fp32 mean of the ranks' local gradients over
    the wire's bound; the reduction's calls and bytes a step; the
    residual's shapes; stage 1's codes on the card against the CPU.
    Exits non-zero when a check fails."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.examples.transformer.train_transformer_lm \
        import pack_documents
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.optimizers import (
        create_local_sgd,
        create_multi_node_optimizer,
    )
    from chainermn_tpu_torch.parallel import collectives as C
    from chainermn_tpu_torch.parallel.mesh import make_mesh
    from chainermn_tpu_torch.parallel.reduction_schedule import (
        bucket_partition,
    )

    tmp = Path(tmp)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/topo_store",
                            rank=rank, world_size=TOPO_RANKS)
    fa.load_kernel()
    mesh = make_mesh(("inter", "intra"), (2, 2), device="cuda:0")
    rng = np.random.default_rng(100 + rank)  # this rank's own data
    batches = [tuple(torch.from_numpy(x).cuda()
                     for x in pack_documents(rng, TOPO_B, TOPO_T))
               for _ in range(TOPO_RANK_STEPS)]
    out = {"rank": rank}
    failed = []
    configs = [
        ("two_dimensional bf16", "two_dimensional",
         {"allreduce_grad_dtype": "bfloat16"}, {}),
        ("int8 flat EF", "hierarchical", {"allreduce_grad_dtype": "int8"},
         {"error_feedback": True}),
        ("int8 shard EF", "two_dimensional",
         {"allreduce_grad_dtype": "int8"}, {"error_feedback": True}),
        ("two_level fp32", "hierarchical", {},
         {"reduction_schedule": "two_level"}),
        ("local SGD", "hierarchical", {}, None)]
    for label, name, ckw, okw in configs:
        comm = create_communicator(name, backend="gloo", device="cuda:0",
                                   mesh=mesh, **ckw)
        from chainermn_tpu_torch.models import TransformerLM
        from chainermn_tpu_torch.training import (
            create_train_state,
            make_train_step,
        )

        model = TransformerLM(seed=0, attention_fn=fa.flash_attention,
                              num_layers=TOPO_LAYERS)
        inner = _adamw(torch, model.parameters())
        opt = (create_local_sgd(inner, comm, sync_every=2) if okw is None
               else create_multi_node_optimizer(inner, comm, **okw))
        params = [p for g in inner.param_groups for p in g["params"]]
        n_params = sum(p.numel() for p in params)
        seen = {}
        stepper = opt.step
        counter = _BytesDist()
        inner_step = inner.step

        def wrapped_step():
            if "local" not in seen:  # step 1: the local gradients
                seen["local"] = [p.grad.detach().float().clone()
                                 for p in params]
            with counter as calls:
                stepper()
            seen.setdefault("calls", []).append(
                {k: v for k, v in calls.items() if v})
            seen.setdefault("bytes", []).append(counter.sent)

        def inner_wrapped(*a, **k):
            if "reduced" not in seen:
                seen["reduced"] = [p.grad.detach().float().clone()
                                   for p in params]
            return inner_step(*a, **k)

        opt.step = wrapped_step
        inner.step = inner_wrapped
        state = create_train_state(model, opt, comm)
        step = make_train_step(_packed_loss, opt, comm)
        _reset_launches(fa)
        hashes, losses, ms = [], [], []
        for batch in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            h = hashlib.sha256()
            for p in params:
                h.update(p.detach().cpu().contiguous().view(-1)
                         .view(torch.uint8).numpy().tobytes())
            hashes.append(h.hexdigest())
        everyone = comm.allgather_obj(hashes)
        # local SGD: equal after each sync (every 2nd step), apart between
        synced = [s for s in range(TOPO_RANK_STEPS)
                  if okw is not None or s % 2 == 1]
        row = {"losses": losses, "ms": ms,
               "params_equal_every_step": all(
                   x[s] == everyone[0][s] for x in everyone for s in synced),
               "params_equal_by_step": [
                   all(x[s] == everyone[0][s] for x in everyone)
                   for s in range(TOPO_RANK_STEPS)],
               "calls_per_step": seen["calls"][-1],
               "bytes_per_step": seen["bytes"],
               "n_params": n_params,
               "launches_per_step": {k: v / TOPO_RANK_STEPS
                                     for k, v in fa.LAUNCHES.items()}}
        if okw is not None:
            flat_local = torch.cat([g.reshape(-1) for g in seen["local"]])
            flat_red = torch.cat([g.reshape(-1) for g in seen["reduced"]])
            total = comm.allreduce(flat_local, "sum")  # fp32, exact enough
            mean = total / TOPO_RANKS
            maxes = comm.allgather(flat_local.abs().max().reshape(1))
            sum_abs = comm.allreduce(flat_local.abs(), "sum")
            err = (flat_red - mean).abs()
            if label.startswith("int8"):
                # two roundings, each within half a code of its scale (the
                # second's scale is the rounded sum's: 1% over the exact)
                bound = ((maxes.sum() + total.abs().max()) / 254.0
                         / TOPO_RANKS) * 1.01
            elif "bf16" in label:
                # the bf16 cast and the three sums' roundings, each within
                # half a bf16 ulp (2^-8 of the magnitude)
                bound = 2.0 ** -6 * sum_abs / TOPO_RANKS + 1e-30
            else:  # fp32: sums in another order
                bound = 2.0 ** -20 * sum_abs / TOPO_RANKS + 1e-30
            row["step1_share_of_bound"] = float((err / bound).max())
            row["step1_max_abs_err"] = float(err.max())
            if row["step1_share_of_bound"] > TOPO_BOUND_SHARE:
                failed.append(f"{label}: bound")
        sizes = [p.numel() for p in params]
        item = 2 if "bf16" in label else 4
        buckets = [sum(sizes[i] for i in b) for b in bucket_partition(
            list(range(len(params))), sizes, item)]
        row["bucket_elements"] = buckets
        row["expected_bytes_per_step"] = [
            _topo_expected_bytes(label, buckets, n_params, s)
            for s in range(TOPO_RANK_STEPS)]
        row["wire_bytes_per_element"] = max(row["bytes_per_step"]) / n_params
        if row["bytes_per_step"] != row["expected_bytes_per_step"]:
            failed.append(f"{label}: bytes")
        if okw and okw.get("error_feedback"):
            res = opt.state_dict()["residual"]
            row["residual_shapes"] = [list(t.shape) for t in res]
            row["residual_elements_over_params"] = (
                sum(t.numel() for t in res) / n_params)
            if label == "int8 shard EF":
                m = torch.cat([g.reshape(-1) for g in seen["local"]])
                rows = C._rows(m, 4)
                q_card, s_card = C.quantize_int8(rows)
                q_cpu, s_cpu = C.quantize_int8(rows.cpu())
                d = (q_card.cpu().int() - q_cpu.int()).abs()
                row["stage1_codes_differing"] = int((d > 0).sum())
                row["stage1_codes_max_diff"] = int(d.max())
                row["stage1_codes"] = int(d.numel())
                if row["stage1_codes_max_diff"] > 1:
                    failed.append("stage-1 codes")
        if not row["params_equal_every_step"]:
            failed.append(f"{label}: params differ across ranks")
        if any(v != TOPO_LAYERS for v in row["launches_per_step"].values()):
            failed.append(f"{label}: launches")
        out[label] = row
        del model, inner, opt, state, seen
        torch.cuda.empty_cache()
    out["failed"] = failed
    (tmp / f"topo_out{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    if failed:
        print(f"topology (b) rank {rank} failed: {failed}: "
              f"{json.dumps(out)}", file=sys.stderr, flush=True)
        sys.exit(1)


def phase_topology_ranks(torch, smi, tmp):
    """Phase 19 (b): ``TOPO_RANKS`` processes on the one card (``python3
    chip_smoke.py --comm-child DIR RANK``), CUDA tensors over gloo on the
    2 x 2 layout; a failing rank fails the phase."""
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--comm-child",
         str(tmp), str(r)]) for r in range(TOPO_RANKS)]
    deadline = time.monotonic() + TOPO_CHILD_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    outs = [json.loads((tmp / f"topo_out{r}.json").read_text())
            for r in range(TOPO_RANKS)
            if (tmp / f"topo_out{r}.json").exists()]
    print("topology (b) summary", json.dumps(outs), flush=True)
    if len(outs) != TOPO_RANKS:
        raise AssertionError(f"topology (b) ranks exited with {codes}")
    for label in [k for k in outs[0] if k not in ("rank", "failed")]:
        rows = [o[label] for o in outs]
        r0 = rows[0]
        print(f"topology (b) {label}, {TOPO_RANKS} ranks (2 x 2) over gloo "
              f"on one card, {TOPO_LAYERS} layers, B {TOPO_B} x T {TOPO_T} "
              f"a rank: params equal across ranks by step "
              f"{r0['params_equal_by_step']}; losses per "
              f"rank {[[round(x, 4) for x in r['losses']] for r in rows]}"
              + (f"; step 1 reduced gradient vs the fp32 mean: "
                 f"{[round(r['step1_share_of_bound'], 4) for r in rows]} of "
                 f"the wire's bound (max |err| "
                 f"{[r['step1_max_abs_err'] for r in rows]})"
                 if "step1_share_of_bound" in r0 else "")
              + f"; calls a step {r0['calls_per_step']}; bytes sent a step "
              f"per rank {[r['bytes_per_step'] for r in rows]}"
              + (f" (by the shapes {r0['expected_bytes_per_step']}, "
                 f"{r0['wire_bytes_per_element']:.4f} bytes an element of "
                 f"{r0['n_params']})" if "expected_bytes_per_step" in r0
                 else "")
              + (f"; residual shapes {r0['residual_shapes']} "
                 f"({r0['residual_elements_over_params']:.4f} of the "
                 f"parameters)" if "residual_shapes" in r0 else "")
              + (f"; stage-1 codes card vs CPU: "
                 f"{[r['stage1_codes_differing'] for r in rows]} of "
                 f"{r0['stage1_codes']} differ, max "
                 f"{[r['stage1_codes_max_diff'] for r in rows]} code"
                 if "stage1_codes" in r0 else "")
              + f"; K1/K2/K3 a step {r0['launches_per_step']}; step ms "
              f"over gloo {[round(x, 1) for x in r0['ms']]}; card {smi}",
              flush=True)
    if any(codes):
        raise AssertionError(f"topology (b) ranks exited with {codes}: "
                             f"{[o['failed'] for o in outs]}")
    return outs


def _recorded_losses(mod):
    """Wrap ``mod.make_train_step`` so every step's loss is recorded;
    returns (losses, undo)."""
    losses = []
    orig = mod.make_train_step

    def make(*a, **k):
        step = orig(*a, **k)

        def recorded(state, batch):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            return state, metrics

        return recorded

    mod.make_train_step = make
    return losses, lambda: setattr(mod, "make_train_step", orig)


def phase_topology_twins(torch, smi):
    """Phase 19 (c): the twins' new flags on the card, one rank each: the
    Transformer twin under two_dimensional with the int8 wire and error
    feedback, and with ``--local-sgd 4``; the MNIST twin with
    ``--reduction-schedule two_level``; the ImageNet twin (ResNet-50,
    batch 64) with ``--optimizer lars`` and ``lamb``. Losses first ->
    last, finite."""
    from chainermn_tpu_torch.examples.imagenet import train_imagenet
    from chainermn_tpu_torch.examples.mnist import train_mnist
    from chainermn_tpu_torch.examples.transformer import train_transformer_lm

    rows = {}
    for label, mod, argv in (
            ("transformer two_dimensional int8 EF", train_transformer_lm,
             ["--communicator", "two_dimensional", "--allreduce-grad-dtype",
              "int8", "--error-feedback", "--iterations",
              str(TOPO_TWIN_ITERATIONS)]),
            ("transformer local SGD 4", train_transformer_lm,
             ["--local-sgd", "4", "--iterations",
              str(TOPO_TWIN_ITERATIONS)]),
            ("mnist two_level", train_mnist,
             ["--reduction-schedule", "two_level", "--iterations",
              str(TOPO_MNIST_ITERATIONS)]),
            ("imagenet resnet50 lars", train_imagenet,
             ["--optimizer", "lars", "--iterations",
              str(TOPO_IMAGENET_ITERATIONS)]),
            ("imagenet resnet50 lamb", train_imagenet,
             ["--optimizer", "lamb", "--iterations",
              str(TOPO_IMAGENET_ITERATIONS)])):
        losses, undo = _recorded_losses(mod)
        t0 = time.perf_counter()
        try:
            mod.main(argv)
        finally:
            undo()
        rows[label] = {"losses": losses,
                       "seconds": time.perf_counter() - t0}
        print(f"topology (c) {label}: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} over {len(losses)} iterations in "
              f"{rows[label]['seconds']:.1f} s; card {smi}", flush=True)
        if not (losses and all(math.isfinite(x) for x in losses)):
            raise AssertionError(f"topology (c) {label}: {losses}")
    return rows


# ---------------------------------------------------------------- phase 20

COMP_STEPS = 10
COMP_WARMUP = 2
COMP_SLICES = 4
#: (a) the plan's runs and the async reducer's loop
COMP_PLAN_STEPS = 3
COMP_ASYNC_STEPS = 5
#: (b): 4 ranks on the 2 x 2 layout, the LM cut as phase 19 (b) cuts it
COMP_RANKS = 4
COMP_RANK_STEPS = 2
COMP_CHILD_TIMEOUT_S = 300
#: (b) calibrate's probe: 1 MB fp32 a pipeline, the median of 3 runs
COMP_CAL_MB = 1.0


def _comp_expected_calls(K, comp, buckets, extra_all_reduce=1):
    """The calls a step makes by ``predicted_collectives``: each bucket's
    (``buckets``: their element counts), plus the step's metrics
    all-reduce."""
    out = {}
    for m in buckets:
        for k, v in K.predicted_collectives(comp, m).items():
            out[k] = out.get(k, 0) + v
    out["all_reduce"] = out.get("all_reduce", 0) + extra_all_reduce
    return {k: v for k, v in out.items() if v}


def _comp_buckets(model, itemsize):
    """The element counts of the gradient buckets of ``model`` at a wire
    of ``itemsize`` bytes (the schedules' one layout)."""
    from chainermn_tpu_torch.parallel.reduction_schedule import (
        bucket_partition,
    )

    sizes = [p.numel() for p in model.parameters()]
    return [sum(sizes[i] for i in b) for b in bucket_partition(
        list(range(len(sizes))), sizes, itemsize)]


def _functional_packed_loss(torch, model):
    """:func:`_packed_loss` of ``model`` on a parameter tree (the plan's
    loss form, ``loss(params, batch)``)."""
    from chainermn_tpu_torch.models import lm_loss

    def loss(p, batch):
        tokens, seg = batch
        valid = torch.cat([torch.ones_like(seg[:, :1]),
                           (seg[:, 1:] == seg[:, :-1]).to(seg.dtype)], dim=1)
        logits = torch.func.functional_call(model, p, (tokens,),
                                            {"segment_ids": seg})
        return lm_loss(logits, tokens, mask=valid)

    return loss


def _comp_plan_runs(torch, np, fa, batches, smi):
    """Phase 20 (a)'s plan: ``ParallelPlan({'data': 1})`` with and
    without ``grad_reduction='rs(a0)>ag(a0)'`` (the one-axis ladder, per
    leaf), ``COMP_PLAN_STEPS`` fp32 AdamW steps each on phase 7's LM."""
    import functools

    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.parallel import composition as K
    from chainermn_tpu_torch.parallel.plan import ParallelPlan
    from chainermn_tpu_torch.training import make_train_step

    adamw = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    runs = {}
    for label, gr in (("plan", None), ("plan rs(a0)>ag(a0)",
                                       "rs(a0)>ag(a0)")):
        torch.cuda.empty_cache()
        model = TransformerLM(seed=0, attention_fn=fa.flash_attention)
        plan = ParallelPlan({"data": 1}, grad_reduction=gr)
        make = functools.partial(torch.optim.AdamW, **adamw)
        params = _params_of(model)

        state = plan.create_train_state(params, make)
        step = make_train_step(_functional_packed_loss(torch, model), make,
                               plan=plan)
        _reset_launches(fa)
        state, losses, ms = _run_steps(step, state,
                                       batches[:COMP_PLAN_STEPS - 1])
        with _CountedDist() as calls:
            state, last, ms_last = _run_steps(
                step, state, batches[COMP_PLAN_STEPS - 1:COMP_PLAN_STEPS])
        n_leaves = len(params)
        expected = ({"all_reduce": 2} if gr is None else
                    {k: v * n_leaves for k, v in K.predicted_collectives(
                        K.compile_schedule(gr, ("data",))).items() if v})
        if gr is not None:
            expected["all_reduce"] = expected.get("all_reduce", 0) + 1
        runs[label] = {
            "losses": losses + last, "ms": ms + ms_last,
            "calls_per_step": {k: v for k, v in calls.items() if v},
            "expected_calls_per_step": expected, "leaves": n_leaves,
            "launches_per_step": {k: v / COMP_PLAN_STEPS
                                  for k, v in fa.LAUNCHES.items()},
            "describe": repr(plan.describe())}
        del model, state, step, params
    return runs


def _comp_async_runs(torch, np, fa, comm, batches):
    """Phase 20 (a)'s async reducer: ``COMP_ASYNC_STEPS`` steps of phase
    7's LM, staleness 1 (step t applies step t-1's mean; the first
    applies none), through ``exchange`` and through ``reduce_sync`` with
    the same bank by hand: the parameters after the loop, and ms a
    step."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.parallel.async_host import AsyncHostGradReducer

    out = {}
    for mode in ("exchange", "reduce_sync"):
        torch.cuda.empty_cache()
        model = TransformerLM(seed=0, attention_fn=fa.flash_attention)
        params = list(model.parameters())
        opt = _adamw(torch, params)
        red = AsyncHostGradReducer(comm)
        bank, losses, ms, in_flight = None, [], [], []
        _reset_launches(fa)

        def apply(means):
            for p, g in zip(params, means):
                p.grad = g.to(p.device)
            opt.step()

        for batch in batches[:COMP_ASYNC_STEPS]:
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = _packed_loss(model, batch)
            loss.backward()
            grads = [p.grad for p in params]
            if mode == "exchange":
                stale = red.exchange(grads)
                in_flight.append(red.in_flight)
            else:
                stale, bank = bank, red.reduce_sync(grads)
            if stale is not None:
                apply(stale)
            losses.append(float(loss))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        last = red.flush() if mode == "exchange" else bank
        apply(last)
        out[mode] = {"losses": losses, "ms": ms, "in_flight": in_flight,
                     "launches_per_step": {
                         k: v / COMP_ASYNC_STEPS
                         for k, v in fa.LAUNCHES.items()},
                     "params": [p.detach().clone() for p in params]}
        del model, opt, params
    a, s = out["exchange"], out["reduce_sync"]
    equal = all(torch.equal(x, y) for x, y in zip(a.pop("params"),
                                                   s.pop("params")))
    return {"params_equal": equal, **out}


def phase_composition(torch, np, smi):
    """Phase 20 (a): phase 7's LM (B 8 x T 2048 packed, bf16, flash
    attention, AdamW) at world size 1 over NCCL. ``COMP_STEPS`` steps
    under ``two_dimensional`` (its 1 x 1 ``('inter', 'intra')`` mesh, the
    bf16 wire) with each derived composition as ``reduction_schedule``,
    a sliced (``[s0..3]``) and a zigzag (``[z0..3]``) spelling, and
    ``'zero'`` (``zero_composition``'s groups): losses bit for bit
    ``pure_nccl``'s on the bf16 wire, K1/K2/K3 6/6/6 a step, the calls of
    a step equal to ``predicted_collectives`` over the gradient buckets
    plus the metrics all-reduce. Then the plan with and without a
    ``grad_reduction=`` ladder (bit for bit, the predicted calls a leaf),
    ``MeasuredComposedReducer``'s ms a stage on the LM's gradients, and
    ``AsyncHostGradReducer``'s staleness-1 loop equal to the same loop
    through ``reduce_sync``."""
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.examples.transformer.train_transformer_lm \
        import pack_documents
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.parallel import composition as K
    from chainermn_tpu_torch.parallel.reduction_schedule import (
        MeasuredComposedReducer,
    )

    rng = np.random.default_rng(0)
    batches = [tuple(torch.from_numpy(x).cuda()
                     for x in pack_documents(rng, 8, 2048))
               for _ in range(COMP_STEPS)]

    def mno(**kw):
        return lambda model, comm: create_multi_node_optimizer(
            _adamw(torch, model.parameters()), comm, **kw)

    bf16 = {"allreduce_grad_dtype": "bfloat16"}
    comm = create_communicator("two_dimensional", **bf16)
    names = comm.axis_names
    two = K.two_level_composition(names)
    sigs = [c.signature() for c in K.derive_compositions(names)]
    sigs += [K.sliced_composition(two, COMP_SLICES).signature(),
             K.sliced_composition(two, COMP_SLICES,
                                  layout="zigzag").signature()]
    ref = _topo_train(torch, fa, create_communicator("pure_nccl", **bf16),
                      mno(), batches)
    buckets = None
    rows = {}
    for sched in sigs + ["zero"]:
        r = _topo_train(torch, fa, comm, mno(reduction_schedule=sched),
                        batches)
        if buckets is None:
            buckets = _comp_buckets(r["model"], 2)
        if sched == "zero":  # rs(intra) > ar(inter) > su > ag(intra)
            expected = {"reduce_scatter_tensor": 1, "all_reduce": 2,
                        "all_gather_into_tensor": 1}
        else:
            expected = _comp_expected_calls(
                K, K.compile_schedule(sched, names), buckets)
        p50, p99 = _p50_p99(r["ms"][COMP_WARMUP:])
        row = {"losses": r["losses"], "step_ms_p50": p50,
               "step_ms_p99": p99, "calls_per_step": r["calls_per_step"],
               "expected_calls_per_step": expected,
               "launches_per_step": r["launches_per_step"],
               "bit_identical_to_pure_nccl": r["losses"] == ref["losses"]}
        rows[sched] = row
        bp50 = _p50_p99(ref["ms"][COMP_WARMUP:])
        print(f"composition (a) {sched}: losses {r['losses'][0]:.6f} -> "
              f"{r['losses'][-1]:.6f}, bit-identical to pure_nccl bf16: "
              f"{row['bit_identical_to_pure_nccl']}; step ms p50 "
              f"{p50:.3f} p99 {p99:.3f} (pure_nccl bf16 {bp50[0]:.3f} / "
              f"{bp50[1]:.3f}); calls a step {row['calls_per_step']} "
              f"(predicted over the {len(buckets)} buckets {buckets} + "
              f"the metrics all-reduce: {expected}); K1/K2/K3 a step "
              f"{row['launches_per_step']}; card {smi}", flush=True)
        del r
    ref_model = ref.pop("model")
    ref.pop("optimizer")
    plan = _comp_plan_runs(torch, np, fa, batches, smi)
    for label, run in plan.items():
        print(f"composition (a) {label}: losses "
              f"{[round(x, 6) for x in run['losses']]}; calls a step "
              f"{run['calls_per_step']} (expected "
              f"{run['expected_calls_per_step']}, {run['leaves']} leaves); "
              f"step ms {[round(x, 3) for x in run['ms']]}; K1/K2/K3 a "
              f"step {run['launches_per_step']}; {run['describe']}; "
              f"card {smi}", flush=True)

    # MeasuredComposedReducer on the LM's fp32 gradients (one backward)
    _packed_loss(ref_model, batches[0]).backward()
    grads = [p.grad for p in ref_model.parameters()]
    measured = {}
    for sched in ("two_level", K.sliced_composition(
            two, COMP_SLICES).signature()):
        red = MeasuredComposedReducer(comm, schedule=sched)
        red.reduce(grads)  # warm
        means = red.reduce(grads)
        exact = all(torch.equal(m, g.float()) for m, g in zip(means, grads))
        measured[sched] = {"stages": [
            {k: (round(v * 1e3, 4) if k == "dur_s" else v)
             for k, v in s.items()} for s in red.stages],
            "means_equal_grads": exact}
        print(f"composition (a) MeasuredComposedReducer {sched} on "
              f"{sum(g.numel() for g in grads)} fp32 gradient elements: "
              + "; ".join(f"{s['stage']} {s['op']} {s['nbytes']} B "
                          f"{s['dur_s'] * 1e3:.4f} ms"
                          for s in red.stages)
              + f"; means == gradients (one rank): {exact}; card {smi}",
              flush=True)
    del ref_model, grads, ref
    torch.cuda.empty_cache()

    async_rows = _comp_async_runs(torch, np, fa, comm, batches)
    ea, rs = async_rows["exchange"], async_rows["reduce_sync"]
    print(f"composition (a) AsyncHostGradReducer staleness 1 over "
          f"{COMP_ASYNC_STEPS} steps: parameters equal to the reduce_sync "
          f"loop's: {async_rows['params_equal']}; losses "
          f"{[round(x, 6) for x in ea['losses']]} vs "
          f"{[round(x, 6) for x in rs['losses']]}; in flight after each "
          f"exchange {ea['in_flight']}; step ms exchange "
          f"{[round(x, 1) for x in ea['ms']]} reduce_sync "
          f"{[round(x, 1) for x in rs['ms']]}; K1/K2/K3 a step "
          f"{ea['launches_per_step']}; card {smi}", flush=True)
    summary = {"runs": rows, "plan": plan, "measured": measured,
               "async": async_rows}
    print("composition (a) summary", json.dumps(summary), flush=True)
    six = {"fwd": 6, "dq": 6, "dkv": 6}
    bad = [k for k, v in rows.items()
           if not v["bit_identical_to_pure_nccl"]
           or v["calls_per_step"] != v["expected_calls_per_step"]
           or v["launches_per_step"] != six
           or not all(math.isfinite(x) for x in v["losses"])]
    if plan["plan"]["losses"] != plan["plan rs(a0)>ag(a0)"]["losses"]:
        bad.append("plan grad_reduction not bit for bit")
    bad += [f"{k} calls" for k, v in plan.items()
            if v["calls_per_step"] != v["expected_calls_per_step"]
            or v["launches_per_step"] != six]
    bad += [f"measured {k}" for k, v in measured.items()
            if not v["means_equal_grads"]]
    if not (async_rows["params_equal"] and all(ea["in_flight"])
            and ea["launches_per_step"] == six):
        bad.append("async")
    if bad:
        raise AssertionError(f"composition (a): {bad} failed: "
                             f"{json.dumps(summary)}")
    return summary


def _comp_expected_bytes(K, comp, axis_sizes, itemsize, buckets):
    """Bytes a step per rank of ``comp`` on buckets of ``buckets``
    elements: each row of its scatter frame (the rows
    ``stage_wire_layout`` is made of, at their padded shard sizes) at its
    ring algorithm's share, as :class:`_BytesDist` counts a call."""
    total = 0
    for m in buckets:
        s_eff = K.effective_slices(comp.slices, m)
        parts = ([hi - lo for lo, hi in K.slice_bounds(m, s_eff)]
                 if s_eff > 1 else [m])
        for size in parts:
            rows, _, _ = K._replay_sizes(comp.stages, size, axis_sizes)
            for st, size_in, size_out in rows:
                n = 1
                for a in st.axes:
                    n *= axis_sizes[a]
                if st.primitive == "reduce_scatter":
                    total += (n - 1) * size_out * itemsize
                elif st.primitive == "allgather":
                    total += (n - 1) * size_in * itemsize
                elif st.primitive == "allreduce":
                    total += 2 * (n - 1) * size_in * itemsize // n
    return total


def _comp_child(tmp, rank):
    """One rank of phase 20 (b): rank ``rank`` of ``COMP_RANKS`` gloo
    processes on the one card, the 2 x 2 layout (``mesh=``), phase 7's
    LM cut to ``TOPO_LAYERS`` layers, B ``TOPO_B`` x T ``TOPO_T`` of this
    rank's own data, ``COMP_RANK_STEPS`` fp32 AdamW steps under each
    derived composition (``ar(inter+intra)`` first, the reference), a
    sliced and a zigzag one: parameters hashed each step and compared
    across the ranks, step 1's reduced gradient against the ``ar(all)``
    run's, the bytes sent a step against the composition's frame; then
    ``calibrate``. Exits non-zero when a check fails."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.examples.transformer.train_transformer_lm \
        import pack_documents
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.parallel import composition as K
    from chainermn_tpu_torch.parallel.cost_model import calibrate
    from chainermn_tpu_torch.parallel.mesh import make_mesh
    from chainermn_tpu_torch.training import (
        create_train_state,
        make_train_step,
    )

    tmp = Path(tmp)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/comp_store",
                            rank=rank, world_size=COMP_RANKS)
    fa.load_kernel()
    mesh = make_mesh(("inter", "intra"), (2, 2), device="cuda:0")
    comm = create_communicator("hierarchical", backend="gloo",
                               device="cuda:0", mesh=mesh)
    names = comm.axis_names
    sizes = comm.axis_groups.sizes()
    rng = np.random.default_rng(200 + rank)
    batches = [tuple(torch.from_numpy(x).cuda()
                     for x in pack_documents(rng, TOPO_B, TOPO_T))
               for _ in range(COMP_RANK_STEPS)]
    two = K.two_level_composition(names)
    sigs = [K.flat_composition(names).signature()]
    sigs += [c.signature() for c in K.derive_compositions(names)
             if c.signature() not in sigs]
    sigs += [K.sliced_composition(two, COMP_SLICES).signature(),
             K.sliced_composition(two, COMP_SLICES,
                                  layout="zigzag").signature()]
    out = {"rank": rank}
    failed = []
    ref = None
    for sig in sigs:
        torch.cuda.empty_cache()
        model = TransformerLM(seed=0, attention_fn=fa.flash_attention,
                              num_layers=TOPO_LAYERS)
        inner = _adamw(torch, model.parameters())
        opt = create_multi_node_optimizer(inner, comm,
                                          reduction_schedule=sig)
        params = [p for g in inner.param_groups for p in g["params"]]
        seen = {}
        stepper = opt.step
        inner_step = inner.step

        def wrapped_step():
            if "local_abs" not in seen:  # step 1: |local gradients|
                seen["local_abs"] = torch.cat(
                    [p.grad.detach().float().abs().reshape(-1)
                     for p in params])
            counter = _BytesDist()
            with counter as calls:
                stepper()
            seen.setdefault("calls", []).append(
                {k: v for k, v in calls.items() if v})
            seen.setdefault("bytes", []).append(counter.sent)

        def inner_wrapped(*a, **k):
            if "reduced" not in seen:
                seen["reduced"] = torch.cat(
                    [p.grad.detach().float().reshape(-1) for p in params])
            return inner_step(*a, **k)

        opt.step = wrapped_step
        inner.step = inner_wrapped
        state = create_train_state(model, opt, comm)
        step = make_train_step(_packed_loss, opt, comm)
        _reset_launches(fa)
        hashes, losses, ms = [], [], []
        for batch in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            h = hashlib.sha256()
            for p in params:
                h.update(p.detach().cpu().contiguous().view(-1)
                         .view(torch.uint8).numpy().tobytes())
            hashes.append(h.hexdigest())
        everyone = comm.allgather_obj(hashes)
        sum_abs = comm.allreduce(seen["local_abs"], "sum")
        comp = K.compile_schedule(sig, names)
        buckets = _comp_buckets(model, 4)
        row = {"losses": losses, "ms": ms,
               "params_equal_by_step": [
                   all(x[s] == everyone[0][s] for x in everyone)
                   for s in range(COMP_RANK_STEPS)],
               "calls_per_step": seen["calls"][-1],
               "expected_calls_per_step": {
                   k: v for k, v in _comp_expected_calls(
                       K, comp, buckets, 0).items() if v},
               "bytes_per_step": seen["bytes"],
               "expected_bytes_per_step": _comp_expected_bytes(
                   K, comp, sizes, 4, buckets),
               "bucket_elements": buckets,
               "launches_per_step": {k: v / COMP_RANK_STEPS
                                     for k, v in fa.LAUNCHES.items()}}
        if ref is None:
            ref = (seen["reduced"], sum_abs)
        else:  # fp32 sums in another order: 2^-20 of the sum of |g|
            bound = 2.0 ** -20 * ref[1] / COMP_RANKS + 1e-30
            err = (seen["reduced"] - ref[0]).abs()
            row["step1_share_of_bound"] = float((err / bound).max())
            row["step1_max_abs_diff_vs_ar_all"] = float(err.max())
            if row["step1_share_of_bound"] > 1.0:
                failed.append(f"{sig}: step-1 gradient")
        if not all(row["params_equal_by_step"]):
            failed.append(f"{sig}: params differ across ranks")
        if any(b != row["expected_bytes_per_step"]
               for b in row["bytes_per_step"]):
            failed.append(f"{sig}: bytes")
        if row["calls_per_step"] != row["expected_calls_per_step"]:
            failed.append(f"{sig}: calls")
        if any(v != TOPO_LAYERS for v in row["launches_per_step"].values()):
            failed.append(f"{sig}: launches")
        out[sig] = row
        del model, inner, opt, state, seen
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = calibrate(comm, payload_mb=COMP_CAL_MB, repeats=3)
    out["calibrate"] = {"world_shape": list(model.world_shape),
                        "alphas_ms": list(model.alphas),
                        "betas_ms_per_byte": list(model.betas),
                        "fit_err_pct": model.fit_err_pct,
                        "rows": list(model.fit_rows),
                        "seconds": time.perf_counter() - t0}
    out["failed"] = failed
    (tmp / f"comp_out{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    if failed:
        print(f"composition (b) rank {rank} failed: {failed}: "
              f"{json.dumps(out)}", file=sys.stderr, flush=True)
        sys.exit(1)


def phase_composition_ranks(torch, smi, tmp):
    """Phase 20 (b): ``COMP_RANKS`` processes on the one card (``python3
    chip_smoke.py --comp-child DIR RANK``), CUDA tensors over gloo on the
    2 x 2 layout; a failing rank fails the phase."""
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--comp-child",
         str(tmp), str(r)]) for r in range(COMP_RANKS)]
    deadline = time.monotonic() + COMP_CHILD_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    outs = [json.loads((tmp / f"comp_out{r}.json").read_text())
            for r in range(COMP_RANKS)
            if (tmp / f"comp_out{r}.json").exists()]
    print("composition (b) summary", json.dumps(outs), flush=True)
    if len(outs) != COMP_RANKS:
        raise AssertionError(f"composition (b) ranks exited with {codes}")
    for sig in [k for k in outs[0]
                if k not in ("rank", "failed", "calibrate")]:
        rows = [o[sig] for o in outs]
        r0 = rows[0]
        print(f"composition (b) {sig}, {COMP_RANKS} ranks (2 x 2) over "
              f"gloo on one card, {TOPO_LAYERS} layers, B {TOPO_B} x T "
              f"{TOPO_T} a rank, fp32: params equal across ranks by step "
              f"{r0['params_equal_by_step']}; losses per rank "
              f"{[[round(x, 4) for x in r['losses']] for r in rows]}"
              + (f"; step 1 reduced gradient vs the ar(inter+intra) run's: "
                 f"{[round(r['step1_share_of_bound'], 4) for r in rows]} "
                 f"of the fp32 summation bound (max |diff| "
                 f"{[r['step1_max_abs_diff_vs_ar_all'] for r in rows]})"
                 if "step1_share_of_bound" in r0 else "")
              + f"; calls a step {r0['calls_per_step']} (predicted "
              f"{r0['expected_calls_per_step']}); bytes sent a step per "
              f"rank {[r['bytes_per_step'] for r in rows]} (by the "
              f"composition's frame {r0['expected_bytes_per_step']} over "
              f"the buckets {r0['bucket_elements']}); K1/K2/K3 a step "
              f"{r0['launches_per_step']}; step ms over gloo "
              f"{[round(x, 1) for x in r0['ms']]}; card {smi}", flush=True)
    cal = outs[0]["calibrate"]
    print(f"composition (b) calibrate over gloo (4 processes on one card, "
          f"CUDA tensors through host copies: gloo figures, not a speed "
          f"of the card): world shape {cal['world_shape']}, alpha ms a "
          f"ring step {cal['alphas_ms']}, beta ms a byte "
          f"{cal['betas_ms_per_byte']}, fit error {cal['fit_err_pct']} % "
          f"over {cal['rows']}, {cal['seconds']:.1f} s; card {smi}",
          flush=True)
    if any(codes):
        raise AssertionError(f"composition (b) ranks exited with {codes}: "
                             f"{[o['failed'] for o in outs]}")
    return outs


# ---------------------------------------------------------------- main

#: the bf16 kernels whose tensor-core instructions are counted: K1-K3
#: in the flash_attention library, K4's prefill in paged_decode
MMA_KERNELS = ("flash_fwd_mma_kernel", "flash_dq_mma_kernel",
               "flash_dkv_mma_kernel")
K4_MMA_KERNELS = ("paged_prefill_mma_kernel",)


def _cuobjdump(flag, lib):
    from chainermn_tpu_torch.ops._build import find_nvcc

    tool = Path(find_nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        raise AssertionError(f"cuobjdump not found beside nvcc ({tool})")
    return subprocess.run([str(tool), flag, lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def _res_usage(lib):
    """(mangled kernel name, registers, stack bytes) of every kernel in
    ``lib`` (``cuobjdump -res-usage``; spills land in the stack)."""
    return [(fn, int(reg), int(stack)) for fn, reg, stack in re.findall(
        r"Function (\S+):\s*REG:(\d+) STACK:(\d+)",
        _cuobjdump("-res-usage", lib))]


def _sass_line(lib=None, k4_lib=None):
    """Count the tensor-core instructions (HMMA, HGMMA) of the bf16 K1,
    K2 and K3 kernels in the built flash_attention library (or ``lib``)
    and of K4's prefill kernel in the built paged_decode library (or
    ``k4_lib``; ``lib`` alone skips it) with ``cuobjdump -sass`` (beside
    nvcc): the proof that their products run on tensor cores (HGMMA, for
    K4's prefill). A ``registers:`` line gives each K1-K3 instance's
    registers and stack bytes (spills land there) from ``cuobjdump
    -res-usage``."""
    from chainermn_tpu_torch.ops._build import BUILD_LOG

    if lib is None:
        lib = BUILD_LOG["flash_attention"]["path"]
        k4_lib = k4_lib or BUILD_LOG["paged_decode"]["path"]
    counts, hgmma = {}, {}
    for path, kernels in ((lib, MMA_KERNELS), (k4_lib, K4_MMA_KERNELS)):
        if path is None:
            continue
        counts.update(dict.fromkeys(kernels, 0))
        hgmma.update(dict.fromkeys(kernels, 0))
        cur = None
        for line in _cuobjdump("-sass", path).splitlines():
            if "Function :" in line:
                cur = next((k for k in kernels if k in line), None)
            elif cur is not None and ("HMMA" in line or "HGMMA" in line):
                counts[cur] += 1
                hgmma[cur] += "HGMMA" in line
    print(f"sass: tensor-core instructions (HMMA/HGMMA) in the bf16 "
          f"kernels {json.dumps(counts)}, of them HGMMA "
          f"{json.dumps(hgmma)} (cuobjdump -sass {lib}"
          f"{' ' + k4_lib if k4_lib else ''})", flush=True)
    if k4_lib is not None and not all(hgmma[k] for k in K4_MMA_KERNELS):
        raise AssertionError(f"K4's prefill kernel has no HGMMA: {hgmma}")
    usage = {}
    for fn, reg, stack in _res_usage(lib):
        kernel = next((k for k in MMA_KERNELS if k in fn), None)
        d = re.search(r"ILi(\d+)E", fn)
        if kernel and d:
            usage[f"{kernel}<{d.group(1)}>"] = {"registers": reg,
                                                "stack_bytes": stack}
    print(f"registers: {json.dumps(dict(sorted(usage.items())))} "
          f"(cuobjdump -res-usage {lib})", flush=True)
    if not all(counts.values()):
        raise AssertionError(f"a bf16 flash kernel has no tensor-core "
                             f"instruction: {counts}")
    if not all(any(u.startswith(k) for u in usage) for k in MMA_KERNELS):
        raise AssertionError(f"cuobjdump -res-usage named not every bf16 "
                             f"flash kernel: {usage}")


def _k4_registers_line(lib):
    """A ``registers K4:`` line: each instance of K4's four kernels in
    ``lib`` (template arguments: head dim, rows of its q tile) with its
    registers and stack bytes."""
    usage = {}
    for fn, reg, stack in _res_usage(lib):
        kernel = next((k for k in K4_KERNELS if k + "I" in fn), None)
        if kernel:
            args = fn[fn.index(kernel) + len(kernel):].split("EEv")[0]
            ints = re.findall(r"Li(\d+)E", args)
            usage[f"{kernel}<{','.join(ints)}>"] = {"registers": reg,
                                                    "stack_bytes": stack}
    print(f"registers K4: {json.dumps(dict(sorted(usage.items())))} "
          f"(cuobjdump -res-usage {lib})", flush=True)
    if not all(any(u.startswith(k) for u in usage) for k in K4_KERNELS):
        raise AssertionError(f"cuobjdump -res-usage named not every K4 "
                             f"kernel: {sorted(usage)}")


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

    from chainermn_tpu_torch.ops import flash_attention as fa
    from chainermn_tpu_torch.ops import paged_decode as pd
    from chainermn_tpu_torch.ops._build import BUILD_LOG

    smi = _nvidia_smi()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        for f in [pool.submit(fn) for fn in (pd.load_kernel, fa.load_kernel)]:
            f.result()
    for name in ("paged_decode", "flash_attention"):
        log = BUILD_LOG[name]
        print(f"build: {name} {'built' if log['built'] else 'reused'} in "
              f"{log['seconds']:.3f} s -> {log['path']}", flush=True)
    print(f"build: both libraries ready in {time.perf_counter() - t0:.3f} s",
          flush=True)
    _sass_line()
    _k4_registers_line(BUILD_LOG["paged_decode"]["path"])

    rows = phase_kernels(torch, np, F)
    launches, routes, summary, engine, streams3 = phase_serving(torch, np)
    phase_equivalence(torch, np)
    phase_profile(torch, np, engine)
    del engine
    dense_rows = phase_dense_kernels(torch, np, F)
    dense_launches, dense_routes, _ = phase_dense_serving(torch, np, summary)
    phase_dense_streams(torch, np)
    phase_decoders(torch, np)
    flash_rows = phase_flash_kernels(torch, np, F)
    flash_launches, _ = phase_training(torch, np)
    phase_grad_equivalence(torch, np)
    phase_resnet(torch, np, smi)
    phase_mnist(torch, smi)
    batches, encoder = phase_encoder(torch, np, smi)
    phase_fused_loss(torch, np, smi)
    phase_remat_dropout(torch, np, smi, batches)
    del batches
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        phase_resume(torch, np, smi, Path(tmp))
        phase_preemption(torch, np, smi, Path(tmp))
        phase_mnist_resume(torch, smi, Path(tmp))
    t14 = time.perf_counter()
    stacked_rows, stacked_counted = phase_stacked_kernels(torch, np, F)
    comm = phase_cross_rank_functions(torch)
    phase_tensor_parallel(torch, np, comm)
    phase_mnbn(torch, comm)
    print(f"phase 14: {time.perf_counter() - t14:.1f} s", flush=True)
    t15 = time.perf_counter()
    tp_serving = phase_tp_serving(torch, np, comm, streams3)
    del streams3
    tp_two = phase_tp_two_ranks(torch, np, smi)
    tp_training = phase_tp_training(torch, np, comm, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fsdp_") as tmp:
        phase_zero_fsdp(torch, np, comm, smi, tp_training, Path(tmp))
    print(f"phase 15: {time.perf_counter() - t15:.1f} s", flush=True)
    t16 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pipe_") as tmp:
        pipe_rows, pipe_ranks = phase_pipeline(torch, np, comm, smi,
                                               Path(tmp))
    phase_pipeline_twin(torch, smi)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s", flush=True)
    t17 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_seq_") as tmp:
        seq_a1, seq_a2 = phase_seq_plan(torch, np, comm, smi, Path(tmp))
        seq_ranks = phase_seq_ranks(torch, smi, Path(tmp))
    print(f"phase 17: {time.perf_counter() - t17:.1f} s", flush=True)
    t18 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as tmp:
        moe = phase_moe(torch, np, comm, smi, Path(tmp))
        moe_ranks = phase_moe_ranks(torch, np, smi, Path(tmp))
    phase_moe_twin(torch, smi)
    print(f"phase 18: {time.perf_counter() - t18:.1f} s", flush=True)
    t19 = time.perf_counter()
    topo = phase_topology(torch, np, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_topo_") as tmp:
        topo_ranks = phase_topology_ranks(torch, smi, Path(tmp))
    phase_topology_twins(torch, smi)
    print(f"phase 19: {time.perf_counter() - t19:.1f} s", flush=True)
    t20 = time.perf_counter()
    comp = phase_composition(torch, np, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_comp_") as tmp:
        comp_ranks = phase_composition_ranks(torch, smi, Path(tmp))
    print(f"phase 20: {time.perf_counter() - t20:.1f} s", flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()  # the training phases' one-rank group

    main_row = next(r for r in rows
                    if r["case"] == "decode" and r["dtype"] == "bfloat16")
    kernels = {"kernels": [{
        "name": "paged_flash_decode",
        "route": "cuda",
        "impl": {"split": "bf16, R <= 16: split-K over the block table, "
                          "a cp.async bf16 ring per warp, fixed-order "
                          "merge launched as a programmatic dependent",
                 "mma": "bf16, R > 16 (every prefill): 64-row q tiles "
                        "on wgmma, 64-key K/V tiles gathered through the "
                        "block table by cp.async into a two-stage ring, "
                        "the causal/window tile skip counted on the card",
                 "rows": "fp32: one CTA per row tile, CUDA cores"},
        "source": "chainermn_tpu_torch/csrc/paged_decode_sm90.cu",
        "sources": ["chainermn_tpu_torch/csrc/paged_decode_sm90.cu",
                    "chainermn_tpu_torch/csrc/paged_prefill_sm90.cu",
                    "chainermn_tpu_torch/csrc/paged_decode.cu"],
        "replaces": "chainermn_tpu/ops/paged_decode.py:167",
        "launches": launches,
        "route_launches": routes,
        # each path's own run: phase 3, TP 1 serving (phase 15 (a)) and
        # each rank of TP 2 on the one card (phase 15 (b), bf16)
        "launches_by_path": {
            "serving_phase3": launches,
            "tp1_serving_phase15a": tp_serving["k4_launches"],
            "tp2_serving_per_rank_phase15b": [
                r["k4_launches"] for r in tp_two["bfloat16"]["per_rank"]],
            "moe_serving_phase18d": moe["d"]["k4_launches"],
            "moe_tp2_serving_per_rank_phase18c": [
                o["tp"]["bfloat16"]["k4_launches"] for o in moe_ranks]},
        "max_abs_err": main_row["max_abs_err"],
        "tolerance": main_row["tolerance"],
        "ms": main_row["ms"],
        "kernel_ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        # the rows route (fp32), off the serving path: phase 2's timed rows
        "rows_route": {r["case"]: {k: r[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")} for r in rows
            if r["route"] == "rows" and "ms" in r},
        "cases": rows,
    }]}
    # K4's prefill kernel (the mma route) on its own, at the serving
    # path's largest prompt bucket below max_len: T 512, bf16
    prefill_row = next(r for r in rows if r["case"] == "prefill_T512"
                       and r["dtype"] == "bfloat16")
    kernels["kernels"].append({
        "name": "paged_flash_decode_prefill",
        "route": "cuda",
        "impl": "mma",
        "source": "chainermn_tpu_torch/csrc/paged_prefill_sm90.cu",
        "replaces": "chainermn_tpu/ops/paged_decode.py:167",
        "launches": routes["mma"],
        **{k: prefill_row[k] for k in (
            "max_abs_err", "tolerance", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "tiles_visited", "tiles_skipped")},
        "kernel_ms": prefill_row["ms"],
        # the rows themselves are the K4 entry's cases
        "cases": [r["case"] for r in rows if r["route"] == "mma"],
    })
    # K4's dense entry: phase 13's dense engine, its decode tick row
    dense_main = next(r for r in dense_rows if r["case"] == "dense_decode"
                      and r["dtype"] == "bfloat16")
    kernels["kernels"].append({
        "name": "dense_flash_decode",
        "route": "cuda",
        "impl": "the dense ring viewed as blocks of _pick_block(128, L) "
                "keys with an identity table and no scratch block, "
                "through K4's split (decode ticks) and mma (prefills) "
                "routes",
        "source": "chainermn_tpu_torch/csrc/paged_decode_sm90.cu",
        "sources": ["chainermn_tpu_torch/csrc/paged_decode_sm90.cu",
                    "chainermn_tpu_torch/csrc/paged_prefill_sm90.cu",
                    "chainermn_tpu_torch/csrc/paged_decode.cu",
                    "chainermn_tpu_torch/ops/paged_decode.py"],
        "replaces": "chainermn_tpu/ops/paged_decode.py:305",
        "launches": dense_launches,
        "route_launches": dense_routes,
        **{k: dense_main[k] for k in (
            "max_abs_err", "tolerance", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        "kernel_ms": dense_main["ms"],
        "cases": dense_rows,
    })
    # K4's 5-D tensor-parallel stacked entry: phase 14 (a)'s main path
    stacked_main = stacked_rows[0]
    kernels["kernels"].append({
        "name": "paged_flash_decode_stacked",
        "route": "cuda",
        "impl": f"the 5-D entry: one 4-D call per shard into its slice of "
                f"one output ({STACK_SHARDS} shards of phase 3's pool), on "
                "K4's split (decode) and mma (prefill) routes",
        "source": "chainermn_tpu_torch/csrc/paged_decode_sm90.cu",
        "sources": ["chainermn_tpu_torch/csrc/paged_decode_sm90.cu",
                    "chainermn_tpu_torch/csrc/paged_prefill_sm90.cu",
                    "chainermn_tpu_torch/ops/paged_decode.py"],
        "replaces": "chainermn_tpu/ops/paged_decode.py:204",
        "launches": stacked_counted["stacked"],
        "route_launches": stacked_counted["routes"],
        **{k: stacked_main[k] for k in (
            "max_abs_err", "tolerance", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        "kernel_ms": stacked_main["ms"],
        "cases": stacked_rows,
    })
    # K1-K3 at the main path's inputs: the packed training rows, bf16
    packed = next(r for r in flash_rows
                  if r["case"] == "packed" and r["dtype"] == "bfloat16")
    for key, name, line, errs, src, impl in (
            ("fwd", "flash_attention_fwd", 313, ("O", "lse"),
             "flash_attention_fwd_sm90.cu", "wgmma"),
            ("dq", "flash_attention_bwd_dq", 404, ("dq",),
             "flash_attention_bwd_sm90.cu", "wgmma"),
            ("dkv", "flash_attention_bwd_dkv", 467, ("dk", "dv"),
             "flash_attention_bwd_sm90.cu", "wgmma")):
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "impl": impl,
            "source": f"chainermn_tpu_torch/csrc/{src}",
            "replaces": f"chainermn_tpu/ops/flash_attention.py:{line}",
            "launches": flash_launches[key],
            "launches_by_path": {
                "lm_training_phase7": flash_launches[key],
                "mlm_encoder_phase11": encoder["launches"][key],
                "tp1_training_phase15c": tp_training[
                    "k1_k3_launches_tp_first_steps"][key],
                "pipeline_step_phase16a": {
                    e: pipe_rows[e]["launches"][key]
                    for e in ("gpipe", "interleaved", "1f1b")},
                "pipeline_step_per_rank_phase16b": [
                    {e: r[e][key] for e in r} for r in pipe_ranks],
                "plan_step_phase17a": seq_a1["launches_plan"][-1][key],
                "seq1_plan_step_phase17a": {
                    i: seq_a2[i]["launches"][key]
                    for i in ("ring", "ulysses")},
                "seq2_plan_step_per_rank_phase17b": [
                    {i: o[i]["launches"][key] for i in ("ring", "ulysses")}
                    for o in seq_ranks],
                "window_zigzag_per_rank_phase17b": [
                    {c: o[c]["launches"][key] for c in ("window", "zigzag")}
                    for o in seq_ranks],
                "moe_lm_training_step_phase18a": moe["a"][
                    "launches_per_step"][-1][key],
                "topology_lm_training_step_phase19a": {
                    k: r["launches_per_step"][key]
                    for k, r in topo.items()},
                "topology_2layer_step_per_rank_phase19b": [
                    {k: o[k]["launches_per_step"][key] for k in o
                     if k not in ("rank", "failed")} for o in topo_ranks],
                "composition_lm_training_step_phase20a": {
                    k: r["launches_per_step"][key]
                    for k, r in comp["runs"].items()},
                "composition_plan_step_phase20a": {
                    k: r["launches_per_step"][key]
                    for k, r in comp["plan"].items()},
                "async_host_step_phase20a": comp["async"]["exchange"][
                    "launches_per_step"][key],
                "composition_2layer_step_per_rank_phase20b": [
                    {k: o[k]["launches_per_step"][key] for k in o
                     if k not in ("rank", "failed", "calibrate")}
                    for o in comp_ranks]},
            "max_abs_err": max(packed["max_abs_err"][e] for e in errs),
            "tolerance": packed["tolerance"],
            "ms": packed["ms"][key],
            "kernel_ms": packed["ms"][key],
            "plain_ms": packed["plain_ms"][key],
            "bound_ms": packed["bound"][key]["bound_ms"],
            "bound_by": packed["bound"][key]["bound_by"],
            "library_ms": packed["library_ms"][key],
            "cases": [{"case": r["case"], "dtype": r["dtype"],
                       "max_abs_err": r["max_abs_err"],
                       **({"ms": r["ms"][key],
                           "plain_ms": r["plain_ms"][key],
                           "library_ms": r["library_ms"][key],
                           **r["bound"][key]} if "ms" in r else {}),
                       # counted by the kernels themselves
                       **({"tiles_visited": r["tiles"][key][0],
                           "tiles_skipped": r["tiles"][key][1]}
                          if key in r.get("tiles", {}) else {})}
                      for r in flash_rows],
        })
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--drill-child"]:  # phase 12's child processes
        sys.path.insert(0, str(ROOT))
        _drill_child(sys.argv[2], sys.argv[3])
        sys.exit(0)
    if sys.argv[1:2] == ["--tp-child"]:  # phase 15 (b)'s ranks
        sys.path.insert(0, str(ROOT))
        _tp_child(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    if sys.argv[1:2] == ["--pipe-child"]:  # phase 16 (b)'s ranks
        sys.path.insert(0, str(ROOT))
        _pipe_child(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    if sys.argv[1:2] == ["--seq-child"]:  # phase 17 (b)'s ranks
        sys.path.insert(0, str(ROOT))
        _seq_child(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    if sys.argv[1:2] == ["--moe-child"]:  # phase 18 (c)'s ranks
        sys.path.insert(0, str(ROOT))
        _moe_child(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    if sys.argv[1:2] == ["--comm-child"]:  # phase 19 (b)'s ranks
        sys.path.insert(0, str(ROOT))
        _comm_child(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    if sys.argv[1:2] == ["--comp-child"]:  # phase 20 (b)'s ranks
        sys.path.insert(0, str(ROOT))
        _comp_child(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    sys.exit(main())
