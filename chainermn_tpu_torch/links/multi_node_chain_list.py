"""Cross-rank model composition (counterpart of
``chainermn_tpu/links/multi_node_chain_list.py``; the reference
ChainerMN's ``links/multi_node_chain_list.py`` †, SURVEY.md §2.5, §3.4).

``MultiNodeChainList(comm).add_link(fn, rank=r, rank_in=..., rank_out=...)``
registers components on ranks, and ``apply`` walks them in registration
order. Each rank runs only its own components, as the reference's
processes did: the owner of a component runs its chain and sends the
output to each rank of ``rank_out`` (a list is a multicast); a component
with ``rank_in`` takes what those ranks sent (a list is a merge, a tuple
in that order). Activations cross through
:func:`~chainermn_tpu_torch.functions.send_recv`. A receiver does not run
the chain that made what it receives, so every rank learns each wire's
shape and dtype by running all the chains on meta tensors, which holds
no data and does no arithmetic (the JAX program's ``eval_shape`` on
every shard); the shapes are kept per input shape and parameter shapes,
so a training loop infers them once.

Each rank chains its transfers in program order: the input of every
transfer carries a zero-valued graft (a delegate, :func:`~chainermn_tpu_
torch.functions.pseudo_connect`) of the rank's previous transfer, and the
result of ``apply`` carries the last one. So a backward through the
result runs every transfer's backward on every rank, a rank without a
loss included, in the exact reverse of the forward — the reference's
delegate-variable discipline, which keeps a bidirectional graph free of
deadlock.

The JAX trace-time checks run before any communication, on every rank:
a component reading from a rank no earlier component sent to (a forward
reference, or a cycle) is rejected, so is a model without a terminal
component (``rank_out=None``), and so is a stage rank outside the group.

Gradients. ``apply`` gives the terminal output on its owner and zeros of
its shape and dtype elsewhere (the JAX function's convention), each
carrying the rank's delegates; every rank backs through what ``apply``
returned (a rank whose loss is zero still runs its transfers' backward),
and the parameters' gradients are those of the sum of the ranks' losses.
``build(replicate_output=True)`` broadcasts the terminal output to every
rank. Its backward takes the owner's cotangent alone: every rank is
meant to compute the same loss from the replicated output, and the
gradients are those of ONE copy of it — what differentiating the JAX
``build`` from outside ``shard_map`` gives (the JAX model-parallel
example's training discipline).

Chains are local computations, as in the reference. Each wire carries
one tensor.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist

from chainermn_tpu_torch.functions.point_to_point import (
    pseudo_connect,
    send_recv,
)
from chainermn_tpu_torch.parallel import collectives as C

Ranks = Union[int, Sequence[int], None]


def _as_list(r: Ranks) -> list:
    if r is None:
        return []
    if isinstance(r, int):
        return [r]
    return list(r)


def _meta(x):
    """``x`` (a tensor or a tuple of them) on the meta device."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("meta")
    return tuple(t.detach().to("meta") for t in x)


def _signature(params: dict) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype) for k, v in params.items())


class _Component:
    def __init__(self, fn, init_fn, rank, rank_in, rank_out, name):
        self.fn = fn
        self.init_fn = init_fn
        self.rank = rank
        self.rank_in = _as_list(rank_in)
        self.rank_out = _as_list(rank_out)
        self.name = name


class _Replicated(torch.autograd.Function):
    """The owner's value on every rank; the backward keeps the owner's
    own cotangent (one copy of a replicated loss) and gives the other
    ranks zeros, which still carry their delegates' backward."""

    @staticmethod
    def forward(ctx, x, group, root):
        ctx.mine = dist.get_rank(group) == root
        out = x.contiguous().clone()
        dist.broadcast(out, src=C._global(group, root), group=group)
        return out

    @staticmethod
    def backward(ctx, ct):
        return (ct if ctx.mine else torch.zeros_like(ct)), None, None


class MultiNodeChainList:
    """Registry of ``(chain, rank, rank_in, rank_out)`` components, each
    run by the rank that owns it.

    ``add_link(fn, rank, rank_in=None, rank_out=None, init_fn=None)``:

    - ``fn(params, x)``: the chain; ``x`` is the local input (the entry
      component) or the received activation (a tuple when ``rank_in`` is
      a list: a merge);
    - ``rank``: the rank of the group that runs the chain;
    - ``rank_in`` / ``rank_out``: where activations come from and go to;
    - ``init_fn(generator, x) -> params``: optional, for :meth:`init`.

    ``comm``: a communicator or a process group (``None``: the default
    group); the JAX ``axis_name`` is the group here.
    """

    def __init__(self, comm=None) -> None:
        self.group = C.as_group(comm)
        self.components: list[_Component] = []
        self._outputs: dict = {}  # shapes key -> the chains' meta outputs

    def add_link(self, fn: Callable, *, rank: int, rank_in: Ranks = None,
                 rank_out: Ranks = None, init_fn: Optional[Callable] = None,
                 name: Optional[str] = None) -> "MultiNodeChainList":
        self.components.append(_Component(
            fn, init_fn, rank, rank_in, rank_out,
            name or f"component_{len(self.components)}"))
        self._outputs.clear()
        return self

    def _walk(self, x: torch.Tensor, params_of: Callable) -> list:
        """Every chain in registration order on meta tensors, each given
        ``params_of(ci, comp, inp)`` and the meta activations that reach
        it (``x``'s shape for an entry component); their meta outputs."""
        acts: dict = {}
        outs = []
        for ci, comp in enumerate(self.components):
            for s in comp.rank_in:
                if (s, comp.rank) not in acts:
                    raise ValueError(
                        f"{comp.name} (rank {comp.rank}) expects an input "
                        f"from rank {s}, but no earlier component sent one "
                        f"— components must be registered in dependency "
                        f"order (reference parity: MultiNodeChainList "
                        f"rejects forward references)")
            got = [acts[(s, comp.rank)] for s in comp.rank_in]
            inp = (_meta(x) if not got else got[0] if len(got) == 1
                   else tuple(got))
            params = {k: v.detach().to("meta")
                      for k, v in params_of(ci, comp, inp).items()}
            with torch.no_grad():
                out = comp.fn(params, inp)
            outs.append(out)
            for dst in comp.rank_out:
                acts[(comp.rank, dst)] = out
        return outs

    def _shapes(self, params_list: Sequence[Any], x: torch.Tensor) -> list:
        """Each component's output on meta tensors, the same on every rank
        with no communication; kept per ``x``'s and the parameters' shapes
        and dtypes."""
        key = (tuple(x.shape), x.dtype,
               tuple(_signature(p) for p in params_list))
        if key not in self._outputs:
            self._outputs[key] = self._walk(
                x, lambda ci, comp, inp: params_list[ci])
        return self._outputs[key]

    # ------------------------------------------------------------------

    def _check(self, n: int) -> "_Component":
        """The JAX trace-time checks, on every rank before any transfer;
        returns the terminal component."""
        max_rank = max([c.rank for c in self.components]
                       + [r for c in self.components
                          for r in c.rank_in + c.rank_out])
        if max_rank >= n:
            raise ValueError(
                f"model uses stage rank {max_rank} but the group has only "
                f"{n} rank(s); run with >= {max_rank + 1} ranks")
        wires: set = set()
        terminal = None
        for comp in self.components:
            for src in comp.rank_in:
                if (src, comp.rank) not in wires:
                    raise ValueError(
                        f"{comp.name} on stage {comp.rank} expects input "
                        f"from stage {src}, but no earlier component sent "
                        f"one (forward references/cycles are rejected — "
                        f"reference parity: cycle detection)")
                wires.discard((src, comp.rank))
            for dst in comp.rank_out:
                if (comp.rank, dst) in wires:
                    raise ValueError(
                        f"{comp.name} sends stage {comp.rank} -> {dst}, but "
                        f"an earlier unconsumed transfer on that edge exists "
                        f"— insert the consumer between them (transfers on "
                        f"one edge are ordered, reference parity: "
                        f"delegate-variable ordering)")
                wires.add((comp.rank, dst))
            if not comp.rank_out:
                terminal = comp
        if terminal is None:
            raise ValueError(
                "no terminal component (one needs rank_out=None)")
        return terminal

    def apply(self, params_list: Sequence[Any], x: torch.Tensor):
        """This rank's part of the forward: its components' chains, the
        transfers it takes part in, and the terminal output (on its
        owner; zeros of its shape elsewhere), grafted with the rank's
        delegates. Every rank of the group calls it; ``x`` feeds the entry
        components (and gives the device of the wires)."""
        g = self.group
        me = dist.get_rank(g)
        terminal = self._check(dist.get_world_size(g))
        shapes = self._shapes(params_list, x)
        chain = None  # the rank's last transfer (its delegate)
        wires: dict = {}
        output = None
        for ci, comp in enumerate(self.components):
            out = None
            if comp.rank == me:
                if comp.rank_in:
                    got = [wires.pop((s, me)) for s in comp.rank_in]
                    inp = got[0] if len(got) == 1 else tuple(got)
                else:
                    inp = x
                out = comp.fn(params_list[ci], inp)
                if comp is terminal:
                    output = out
            for dst in comp.rank_out:
                if me not in (comp.rank, dst):
                    continue  # neither end: nothing to do
                if comp.rank == me:
                    t = out
                else:
                    t = torch.zeros_like(shapes[ci], device=x.device)
                if chain is not None:
                    t = pseudo_connect(chain, t)
                chain = send_recv(t, comp.rank, dst, g)
                if dst == me:
                    wires[(comp.rank, dst)] = chain
        if output is None:
            output = torch.zeros_like(
                shapes[self.components.index(terminal)], device=x.device)
            if chain is None:  # a rank with no part in the model
                return output.requires_grad_(output.is_floating_point())
        return output if chain is None else pseudo_connect(chain, output)

    def build(self, *, replicate_output: bool = True) -> Callable:
        """``fwd(params_list, x)``: :meth:`apply`, and with
        ``replicate_output`` the terminal output broadcast from its owner
        to every rank (the backward of which keeps the owner's cotangent
        alone: see the module docstring)."""

        def fwd(params_list, x):
            out = self.apply(params_list, x)
            if not replicate_output:
                return out
            root = self._check(dist.get_world_size(self.group)).rank
            return _Replicated.apply(out, self.group, root)

        return fwd

    # ------------------------------------------------------------------

    def init(self, seed: Union[int, torch.Generator],
             x: torch.Tensor) -> list:
        """Every component's parameters, the same on every rank: walks the
        components in order, the activations' shapes propagated through
        the chains on meta tensors, each ``init_fn`` drawing from one
        generator seeded with ``seed`` (the functional form of the
        reference's first-update ``bcast_data``)."""
        gen = (seed if isinstance(seed, torch.Generator)
               else torch.Generator().manual_seed(int(seed)))
        params_list = []

        def params_of(ci, comp, inp):
            if comp.init_fn is None:
                raise ValueError(f"{comp.name} registered without init_fn")
            real = (torch.zeros(inp.shape, dtype=inp.dtype)
                    if isinstance(inp, torch.Tensor) else
                    tuple(torch.zeros(i.shape, dtype=i.dtype) for i in inp))
            params_list.append(comp.init_fn(gen, real))
            return params_list[-1]

        self._walk(x, params_of)
        return params_list


__all__ = ["MultiNodeChainList"]
