"""Pipeline parallelism over the local SSM stack (mirrors
velocity_asr_tpu/parallel/pp.py).

A GPipe microbatch pipeline: the stack's L blocks split into S contiguous
stages over a mesh axis (stage s owns blocks [s L/S, (s+1) L/S)), the
batch into M microbatches. At tick t stage s runs microbatch t - s and
sends its output to stage s + 1 (``batch_isend_irecv``); after M + S - 1
ticks the last stage holds every microbatch's output and broadcasts the
whole to the axis. Parameters stay replicated, as in the JAX package,
so the checkpoint and the optimizer do not change. The bubble is
(S - 1) / (M + S - 1) of the ticks.

The backward runs the same schedule reversed: the last stage starts from
the output's cotangent (the same on every rank: what follows the stack is
computed everywhere), each stage backpropagates through the graphs its
forward kept and sends its input's cotangent upstream. A block's
gradient exists only on its owner and the stack input's only on stage 0,
so the backward all-reduces the stack's parameter gradients over the axis
(the other stages contribute zeros) and broadcasts the input's from stage
0: every rank returns the one-process gradients. Blocks after the stack
are not touched.

Dropout draws from a generator per (step seed, data index, tick, global
layer), as the JAX package folds its key per (tick, global layer): the
masks differ from the sequential stack's. With ``checkpoint`` each block
runs as ``models.ssm.CheckpointedBlock``.

The context is per thread and read at each offline, stateless forward of
the local stack (``models.ssm.LocalSSMProcessor``); streaming calls keep
the sequential loop.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, all_reduce_, data_shard

_PP_TLS = threading.local()


@contextlib.contextmanager
def pipeline_parallel(mesh: Mesh, axis: str = MODEL_AXIS, microbatches: Optional[int] = None):
    """Run the local SSM stack's offline forwards as a pipeline over `axis`
    of `mesh` while active (per thread)."""
    prev = getattr(_PP_TLS, "ctx", None)
    _PP_TLS.ctx = (mesh, axis, microbatches)
    try:
        yield
    finally:
        _PP_TLS.ctx = prev


def current_pipeline_parallel() -> Optional[Tuple[Mesh, str, Optional[int]]]:
    """The active (mesh, axis, microbatches) set by ``pipeline_parallel``."""
    return getattr(_PP_TLS, "ctx", None)


def _resolve_microbatches(batch: int, stages: int, requested: Optional[int]) -> int:
    """The largest microbatch count <= requested (default: stages) that
    is at most the batch and divides it (equal microbatches)."""
    m = min(requested or stages, batch)
    while batch % m:
        m -= 1
    return m


def stage_seed(seed: int, data_index: int, tick: int, layer: int) -> int:
    """The dropout generator's seed of global layer `layer` at tick `tick`."""
    return (seed * 1_000_003 + (data_index * 65_537 + tick) * 100_003 + layer) % (1 << 63)


@dataclass
class _Schedule:
    blocks: List[nn.Module]
    group: object
    ranks: List[int]  # the axis's global ranks, by stage
    stage: int
    per_stage: int
    microbatches: int
    seed: Optional[int]
    data_index: int
    checkpoint: bool

    @property
    def stages(self) -> int:
        return len(self.ranks)

    def my_blocks(self) -> List[nn.Module]:
        return self.blocks[self.stage * self.per_stage:(self.stage + 1) * self.per_stage]

    def run_stage(self, h: torch.Tensor, tick: int, record: bool) -> torch.Tensor:
        """This stage's blocks on one microbatch; `record` keeps the graph
        (and checkpoints the blocks where asked)."""
        from ..models.ssm import CheckpointedBlock

        for i, block in enumerate(self.my_blocks()):
            rng = None
            if self.seed is not None:
                rng = torch.Generator(device=h.device)
                rng.manual_seed(stage_seed(self.seed, self.data_index, tick,
                                           self.stage * self.per_stage + i))
            if record and self.checkpoint:
                h = CheckpointedBlock.apply(block, rng, False, h, *block.parameters())
            else:
                h = block(h, rng=rng)
        return h


def _exchange(ops) -> None:
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _forward(sched: _Schedule, x: torch.Tensor, record: bool):
    """The forward schedule: (the stack's output on every rank, {micro-
    batch: (input, output)} of this stage's kept graphs when `record`)."""
    s, n_st, m = sched.stage, sched.stages, sched.microbatches
    mb_shape = (x.shape[0] // m,) + tuple(x.shape[1:])
    x_mb = x.reshape((m,) + mb_shape)
    kept, outs, buf = {}, [None] * m, None
    with data_shard(None):  # a microbatch draws on its own generators
        for tick in range(m + n_st - 1):
            j = tick - s
            out = None
            if 0 <= j < m:
                inp = x_mb[j] if s == 0 else buf
                if record:
                    inp = inp.detach().requires_grad_(True)
                    with torch.enable_grad():
                        out = sched.run_stage(inp, tick, True)
                    kept[j] = (inp, out)
                else:
                    out = sched.run_stage(inp, tick, False)
                if s == n_st - 1:
                    outs[j] = out.detach()
            ops = []
            if s < n_st - 1 and out is not None:
                ops.append(dist.P2POp(dist.isend, out.detach().contiguous(), sched.ranks[s + 1],
                                      sched.group))
            if s > 0 and 0 <= tick + 1 - s < m:
                buf = torch.empty(mb_shape, dtype=x.dtype, device=x.device)
                ops.append(dist.P2POp(dist.irecv, buf, sched.ranks[s - 1], sched.group))
            _exchange(ops)
    out = torch.cat(outs) if s == n_st - 1 else torch.empty_like(x)
    dist.broadcast(out, src=sched.ranks[-1], group=sched.group)
    return out, kept


class _Pipeline(torch.autograd.Function):
    """The pipelined stack as one differentiable operation of the stack's
    input and every block's parameters."""

    @staticmethod
    def forward(ctx, sched, x, *params):
        out, kept = _forward(sched, x, record=True)
        ctx.sched, ctx.kept = sched, kept
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        sched, kept = ctx.sched, ctx.kept
        s, n_st, m = sched.stage, sched.stages, sched.microbatches
        g_mb = g.contiguous().reshape((m, -1) + tuple(g.shape[1:]))
        all_params = [p for block in sched.blocks for p in block.parameters()]
        own = [p for block in sched.my_blocks() for p in block.parameters()]
        start = s * len(own)
        p_grads = [torch.zeros_like(p) for p in all_params]
        dxs, gbuf = [None] * m, None
        for u in range(m + n_st - 1):
            j = m - 1 - (u - (n_st - 1 - s))
            dx = None
            if 0 <= j < m:
                gj = g_mb[j] if s == n_st - 1 else gbuf
                inp, out = kept.pop(j)
                grads = torch.autograd.grad(out, [inp] + own, gj, allow_unused=True)
                dx = grads[0]
                for k, gp in enumerate(grads[1:]):
                    if gp is not None:
                        p_grads[start + k] += gp
                if s == 0:
                    dxs[j] = dx
            ops = []
            if s > 0 and dx is not None:
                ops.append(dist.P2POp(dist.isend, dx.contiguous(), sched.ranks[s - 1],
                                      sched.group))
            jn = m - 1 - (u + 1 - (n_st - 1 - s))
            if s < n_st - 1 and 0 <= jn < m:
                gbuf = torch.empty_like(g_mb[0])
                ops.append(dist.P2POp(dist.irecv, gbuf, sched.ranks[s + 1], sched.group))
            _exchange(ops)
        dx = (torch.cat(dxs) if s == 0
              else torch.empty(ctx.x_shape, dtype=ctx.x_dtype, device=g.device))
        dist.broadcast(dx, src=sched.ranks[0], group=sched.group)
        flat = all_reduce_(torch.cat([t.reshape(-1) for t in p_grads]), sched.group)
        p_grads = [chunk.view_as(p) for chunk, p in
                   zip(flat.split([p.numel() for p in all_params]), all_params)]
        return (None, dx) + tuple(p_grads)


def pipeline_blocks(blocks: List[nn.Module], x: torch.Tensor, *, mesh: Mesh,
                    axis: str = MODEL_AXIS, microbatches: Optional[int] = None,
                    rng: Optional[torch.Generator] = None,
                    checkpoint: bool = False) -> torch.Tensor:
    """Run a stack of shape-preserving blocks (each ``block(h, rng=...)``)
    as an S-stage microbatch pipeline over `axis` of `mesh`.

    x (batch, time, d) is the same on every rank of the axis; S must
    divide the number of blocks; microbatches (default S) is clamped to a
    divisor of the batch (``_resolve_microbatches``). `rng` (training
    dropout) seeds the per-(tick, layer) generators. Returns the stack's
    output on every rank; differentiable under autograd (the one-process
    gradients on every rank)."""
    num_layers = len(blocks)
    stages = mesh.shape[axis]
    if mesh.group(axis) is None:
        raise ValueError("pipeline_parallel needs a process group: call init_distributed "
                         "before create_mesh")
    if num_layers % stages:
        raise ValueError(f"pipeline axis '{axis}' has {stages} stages which must divide "
                         f"the {num_layers}-layer stack")
    sched = _Schedule(
        blocks=list(blocks), group=mesh.group(axis), ranks=mesh.ranks(axis),
        stage=mesh.index(axis), per_stage=num_layers // stages,
        microbatches=_resolve_microbatches(x.shape[0], stages, microbatches),
        seed=None if rng is None else rng.initial_seed(),
        data_index=mesh.index(DATA_AXIS), checkpoint=checkpoint)
    params = [p for block in blocks for p in block.parameters()]
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        return _Pipeline.apply(sched, x, *params)
    return _forward(sched, x, record=False)[0]
