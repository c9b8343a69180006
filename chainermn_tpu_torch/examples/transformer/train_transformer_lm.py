"""Transformer LM training, the port's twin of
``examples/transformer/train_transformer_lm.py``: the same flags, data and
``VOCAB``, the packed and the plain data-parallel modes.

    python -m chainermn_tpu_torch.examples.transformer.train_transformer_lm \\
        --packed --iterations 40
    python -m chainermn_tpu_torch.examples.transformer.train_transformer_lm \\
        --device cpu --communicator naive --iterations 8 --num-layers 2 \\
        --d-model 64 --seq-len 128 --batchsize 2 --window 24

``--device`` defaults to the CUDA card (and raises without one); the
communicator defaults to ``pure_nccl`` there and to ``naive`` (gloo) on
the CPU. Compute is bf16 on the card and fp32 on the CPU. The packed mode
and ``--window`` attend through the flash kernels; the plain mode takes
the blockwise reference. ``--mlm`` trains the bidirectional encoder
(``causal=False``) on the BERT recipe as the JAX example does: token
``VOCAB - 1`` is the mask symbol, targets are the synthetic tokens modulo
it, and each iteration's corruption is drawn from a generator seeded
with the iteration; like the JAX example it attends through the model's
default (blockwise) attention.

After training in the plain data-parallel mode, ``--generate N`` decodes
N tokens greedily on rank 0 from a two-row synthetic prompt with
:func:`~chainermn_tpu_torch.models.generate` (and, with ``--beam K``,
first runs :func:`~chainermn_tpu_torch.models.beam_search` with K beams),
as the JAX example does; ``--mlm`` refuses both.

``--sequence-parallel`` is the JAX example's long-context mode: ONE
sequence (2 rows of ``--seq-len`` tokens) sharded over every rank, each
rank on its own contiguous block with its blocks' global positions,
attention through :func:`~chainermn_tpu_torch.parallel.ring_attention.
ring_attention_local` (K1-K3 a live ring hop) or, with ``--window``,
:func:`~chainermn_tpu_torch.parallel.local_attention.
sliding_window_attention_local` (the predecessors' tails only); the
gradients and the loss are averaged over the ranks in fp32, and AdamW
steps the replicated weights. The other flags of the mode are the JAX
example's: it ignores ``--packed``, ``--mlm`` and ``--batchsize``.

``--local-sgd H`` averages the parameters every H steps (AdamW steps
each rank's own gradients in between); ``--error-feedback`` feeds the
int8 wire's rounding back (``--allreduce-grad-dtype int8``; with
``--communicator two_dimensional`` at the shard the inter stage rounds).
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from chainermn_tpu_torch import global_except_hook
from chainermn_tpu_torch._device import resolve_device
from chainermn_tpu_torch.communicators import example_communicator
from chainermn_tpu_torch.models import (
    TransformerLM,
    beam_search,
    generate,
    lm_loss,
    mlm_corrupt,
    mlm_loss,
)
from chainermn_tpu_torch.ops.flash_attention import flash_attention
from chainermn_tpu_torch.optimizers import (
    create_local_sgd,
    create_multi_node_optimizer,
)
from chainermn_tpu_torch.training import create_train_state, make_train_step

VOCAB = 1024

def synthetic_tokens(rng, batch, seqlen):
    """Markov-ish synthetic text: next token correlates with current."""
    x = np.zeros((batch, seqlen), np.int32)
    x[:, 0] = rng.integers(0, VOCAB, size=batch)
    drift = rng.integers(1, 17, size=batch)
    for t in range(1, seqlen):
        stay = rng.random(batch) < 0.8
        x[:, t] = np.where(stay, (x[:, t - 1] + drift) % VOCAB,
                           rng.integers(0, VOCAB, size=batch))
    return x


def pack_documents(rng, batch, seqlen):
    """Pack 2-5 variable-length synthetic documents per row: returns
    ``(tokens, segment_ids)``."""
    if seqlen < 32:
        raise SystemExit(
            f"--packed needs --seq-len >= 32 (got {seqlen}): rows hold up "
            "to 5 documents with 8-token margins")
    tokens = np.zeros((batch, seqlen), np.int32)
    seg = np.zeros((batch, seqlen), np.int32)
    for b in range(batch):
        n_docs = rng.integers(2, 6)
        cuts = np.sort(rng.choice(np.arange(8, seqlen - 8), n_docs - 1,
                                  replace=False))
        bounds = [0, *cuts.tolist(), seqlen]
        for d in range(n_docs):
            lo, hi = bounds[d], bounds[d + 1]
            tokens[b:b + 1, lo:hi] = synthetic_tokens(rng, 1, hi - lo)
            seg[b, lo:hi] = d
    return tokens, seg


def _make_optimizer(args, model, comm):
    """AdamW with optax.adamw's defaults (betas 0.9/0.999, eps 1e-8,
    weight decay 1e-4; torch's own default decay is 1e-2), wrapped for
    the multi-node reduction, or for local SGD with ``--local-sgd``."""
    inner = torch.optim.AdamW(model.parameters(), lr=args.lr,
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4)
    if args.local_sgd:
        return create_local_sgd(inner, comm, sync_every=args.local_sgd)
    return create_multi_node_optimizer(
        inner, comm, double_buffering=args.double_buffering,
        error_feedback=args.error_feedback)


def _parser():
    p = argparse.ArgumentParser(
        description="chainermn_tpu_torch example: Transformer LM")
    p.add_argument("--communicator", default=None,
                   help="default: pure_nccl on cuda, naive on cpu")
    p.add_argument("--device", default=None,
                   help="default: the current CUDA card")
    p.add_argument("--batchsize", type=int, default=8,
                   help="per-rank batch size")
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--iterations", type=int, default=40)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--double-buffering", action="store_true")
    p.add_argument("--allreduce-grad-dtype", default="bfloat16")
    p.add_argument("--mlm", action="store_true",
                   help="masked-LM pretraining of the bidirectional "
                        "encoder (causal=False)")
    p.add_argument("--local-sgd", type=int, default=0, metavar="H")
    p.add_argument("--error-feedback", action="store_true")
    p.add_argument("--sequence-parallel", action="store_true")
    p.add_argument("--packed", action="store_true",
                   help="pack variable-length documents into each row with "
                        "segment-id flash-attention masks (cross-document "
                        "attention and loss are masked)")
    p.add_argument("--num-kv-heads", type=int, default=None)
    p.add_argument("--pos-encoding", default="learned",
                   choices=("learned", "rope"))
    p.add_argument("--num-layers", type=int, default=6)
    p.add_argument("--d-model", type=int, default=512)
    p.add_argument("--generate", type=int, default=0, metavar="N")
    p.add_argument("--window", type=int, default=0, metavar="W",
                   help="causal sliding-window attention of width W via the "
                        "flash kernels (0 = full causal)")
    p.add_argument("--beam", type=int, default=0, metavar="K")
    return p


def main(argv=None, *, group=None):
    """Train; returns the last step's metrics (0-dim tensors).

    ``group`` (``--sequence-parallel`` only): the process group the
    sequence shards over, in place of the communicator's (ranks sharing
    one card over gloo, which the communicators do not run)."""
    p = _parser()
    args = p.parse_args(argv)
    if args.local_sgd and (args.double_buffering or args.error_feedback):
        p.error("--local-sgd replaces the per-step gradient wire; "
                "--double-buffering/--error-feedback would be silently "
                "ignored")
    if args.local_sgd and args.sequence_parallel:
        p.error("--local-sgd is not wired into the sequence-parallel path "
                "(it builds its own per-step mean loop); drop one of the "
                "flags")
    if args.mlm and (args.generate or args.beam):
        p.error("--mlm is an encoder: no autoregressive decode "
                "(--generate/--beam)")
    if group is not None and not args.sequence_parallel:
        p.error("group= is the --sequence-parallel mode's")
    device = resolve_device(args.device)
    compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if group is not None:
        return run_sequence_parallel(args, group, device, compute_dtype,
                                     np.random.default_rng(0))
    try:
        comm = example_communicator(
            args.communicator, device,
            allreduce_grad_dtype=args.allreduce_grad_dtype or None)
    except NotImplementedError as e:  # the 'auto' wire: ROADMAP queue 8
        p.error(str(e))
    global_except_hook._add_hook()
    if comm.rank == 0:
        print(f"communicator: {comm}")
    rng = np.random.default_rng(0)
    if args.sequence_parallel:
        return run_sequence_parallel(args, comm.group, device, compute_dtype,
                                     rng)
    attention_fn = None
    if args.packed or args.window:
        attention_fn = functools.partial(flash_attention,
                                         window=args.window or None)
    model = TransformerLM(
        vocab_size=VOCAB, num_layers=args.num_layers, d_model=args.d_model,
        d_ff=4 * args.d_model, max_len=args.seq_len,
        compute_dtype=compute_dtype, attention_fn=attention_fn,
        num_kv_heads=args.num_kv_heads, pos_encoding=args.pos_encoding,
        window=args.window or None, causal=not args.mlm, seed=0,
        device=device)
    optimizer = _make_optimizer(args, model, comm)
    state = create_train_state(model, optimizer, comm)

    if args.packed:
        def loss_fn(model, batch):
            tokens, seg = batch
            logits = model(tokens, segment_ids=seg)
            # mask targets that would cross a document boundary
            valid = torch.cat([torch.ones_like(seg[:, :1]),
                               (seg[:, 1:] == seg[:, :-1]).to(seg.dtype)],
                              dim=1)
            return lm_loss(logits, tokens, mask=valid)

        def make_batch(it):
            return tuple(torch.from_numpy(x).to(device) for x in
                         pack_documents(rng, args.batchsize, args.seq_len))
    elif args.mlm:
        mask_id = VOCAB - 1  # the top id is reserved as [MASK]

        def loss_fn(model, batch):
            x, targets, sel = batch
            return mlm_loss(model(x), targets, sel)

        def make_batch(it):
            # data lives in [0, mask_id): a real token must never equal
            # the mask symbol
            targets = torch.from_numpy(synthetic_tokens(
                rng, args.batchsize, args.seq_len) % mask_id).to(device)
            gen = torch.Generator(device=device).manual_seed(it)
            x, sel = mlm_corrupt(gen, targets, mask_id=mask_id,
                                 vocab_size=VOCAB, rate=0.15)
            return x, targets, sel
    else:
        def loss_fn(model, tokens):
            return lm_loss(model(tokens), tokens)

        def make_batch(it):
            return torch.from_numpy(synthetic_tokens(
                rng, args.batchsize, args.seq_len)).to(device)

    step = make_train_step(loss_fn, optimizer, comm)
    mode = ("packed" if args.packed else "mlm" if args.mlm
            else "data-parallel")
    metrics = None
    t0 = time.perf_counter()
    for it in range(args.iterations):
        state, metrics = step(state, make_batch(it))
        if comm.rank == 0 and ((it + 1) % 10 == 0
                               or it + 1 == args.iterations):
            loss = float(metrics["loss"])  # waits for the step
            tps = (args.batchsize * comm.size * args.seq_len * (it + 1)
                   / (time.perf_counter() - t0))
            print(f"iter {it + 1}/{args.iterations} loss={loss:.4f} "
                  f"({tps:,.0f} tok/s, {mode})")
    if args.generate and mode == "data-parallel" and comm.rank == 0:
        _decode_demo(args, model, rng, device)
    if comm.rank == 0:
        print(f"done ({mode})")
    return metrics


def run_sequence_parallel(args, group, device, compute_dtype, rng):
    """Long-context mode: ONE sequence sharded over the ranks of ``group``,
    K/V streaming around the ring (or, with ``--window``, only the
    predecessors' tails). Returns the last step's metrics, with
    ``'losses'``, every iteration's loss."""
    import torch.distributed as dist

    from chainermn_tpu_torch.parallel.collectives import _global
    from chainermn_tpu_torch.parallel.local_attention import (
        sliding_window_attention_local,
    )
    from chainermn_tpu_torch.parallel.ring_attention import (
        ring_attention_local,
    )

    n, r = dist.get_world_size(group), dist.get_rank(group)
    if args.seq_len % n:
        raise SystemExit(f"--seq-len must be divisible by the world size "
                         f"{n}")
    t_local = args.seq_len // n
    if args.window:
        def attn(q, k, v, *, causal, scale, **kw):
            return sliding_window_attention_local(
                q, k, v, group, window=args.window, scale=scale)
    else:
        def attn(q, k, v, *, causal, scale, **kw):
            return ring_attention_local(q, k, v, group, causal=causal,
                                        scale=scale)

    model = TransformerLM(
        vocab_size=VOCAB, num_layers=args.num_layers, d_model=args.d_model,
        d_ff=4 * args.d_model, max_len=args.seq_len,
        compute_dtype=compute_dtype, attention_fn=attn,
        num_kv_heads=args.num_kv_heads, pos_encoding=args.pos_encoding,
        seed=0, device=device)
    params = list(model.parameters())
    with torch.no_grad():
        for p in params:  # rank 0's weights on every rank
            dist.broadcast(p, src=_global(group, 0), group=group)
    opt = torch.optim.AdamW(params, lr=args.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    # the shard's GLOBAL positions serve both encodings: a learned table
    # gathers its rows, rotary rotates by them
    pos = r * t_local + torch.arange(t_local, device=device)
    batch = 2
    losses = []
    t0 = time.perf_counter()
    for it in range(args.iterations):
        tokens = torch.from_numpy(synthetic_tokens(
            rng, batch, args.seq_len)).to(device)
        local = tokens[:, r * t_local:(r + 1) * t_local]
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(model(local, positions=pos), local)
        loss.backward()
        with torch.no_grad():
            # the fp32 means over the ranks (the JAX pmean), one buffer
            flat = torch.cat([torch.zeros_like(p).reshape(-1)
                              if p.grad is None else p.grad.reshape(-1)
                              for p in params]
                             + [loss.detach().float().reshape(1)])
            dist.all_reduce(flat, group=group)
            flat /= n
            for p, g in zip(params, flat[:-1].split(
                    [p.numel() for p in params])):
                p.grad = g.view_as(p)
        opt.step()
        losses.append(flat[-1])
        if r == 0 and ((it + 1) % 10 == 0 or it + 1 == args.iterations):
            loss_v = float(losses[-1])
            tps = batch * args.seq_len * (it + 1) / (time.perf_counter() - t0)
            print(f"iter {it + 1}/{args.iterations} loss={loss_v:.4f} "
                  f"({tps:,.0f} tok/s, seq {args.seq_len} over {n} shards"
                  f"{f', window {args.window}' if args.window else ''})")
    if r == 0:
        print("done (sequence-parallel)")
    return {"loss": losses[-1], "losses": torch.stack(losses)}


def _decode_demo(args, model, rng, device):
    """The JAX example's inference demo on the just-trained weights:
    beam search (with ``--beam``), then greedy ``generate``, from a
    two-row synthetic prompt (pad id -1: synthetic tokens include 0)."""
    prompt = torch.from_numpy(
        synthetic_tokens(rng, 2, min(8, args.seq_len))).to(device)
    P = prompt.shape[1]
    n = min(args.seq_len, P + args.generate)
    if args.beam:
        beams, bscores = beam_search(model, prompt, n, args.beam, pad_id=-1)
        print(f"beam_search (K={args.beam}): best scores "
              f"{np.round(bscores[:, 0].cpu().numpy(), 2).tolist()}; top "
              f"continuations {beams[:, 0, P:].cpu().tolist()}")
    out = generate(model, prompt, n, pad_id=-1)
    print(f"generate: prompt {tuple(prompt.shape)} -> {tuple(out.shape)}; "
          f"continuations {out[:, P:].cpu().tolist()}")


if __name__ == "__main__":
    main()
