"""Tensor and expert parallelism over the mesh's model axis (mirrors
velocity_asr_tpu/parallel/tp.py).

The motivating case is the large-vocab preset (50,000 tokens): its CTC
head, a (vocab, d_model) projection of ~9.6M parameters, is larger than
the rest of the model, and Adam triples it. ``shard_params_tp`` keeps
each rank's slice of it as the live parameter (rows of the vocabulary:
column-parallel in the flax (d_model, vocab) layout) and marks the head,
which then computes its slice of the logits and gathers them over the
model group. MoE expert weights carry a leading expert axis and shard
over the same axis (expert parallelism): each rank computes its experts'
share of every token's output, and the shares are summed over the group.
The router and everything else stay replicated. The optimizer's moments
follow the live (local) parameters.

A checkpoint keeps the single-rank layout: ``full_state_dict`` gathers
the slices, ``shard_state_dict`` cuts a full state back to this rank's,
and ``unsharded`` lends a model its full parameters for a save.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from .mesh import MODEL_AXIS, Mesh, _all_gather, group_rank

# (name suffix, sharded dim): a parameter whose name ends with the suffix
# is split along that dim over the model axis; every other one is
# replicated. The port's Linear weights are (out, in), so the head's
# vocab axis is dim 0 (the flax kernel's last).
TP_RULES: List[Tuple[Tuple[str, ...], int]] = [
    (("ctc_head", "proj", "weight"), 0),
    (("ctc_head", "proj", "bias"), 0),
    (("moe", "w_in"), 0),
    (("moe", "b_in"), 0),
    (("moe", "w_out"), 0),
    (("moe", "b_out"), 0),
]


def tp_param_specs(model: nn.Module) -> Dict[str, Optional[int]]:
    """{parameter name: the dim it shards along, or None (replicated)}."""
    specs = {}
    for name, _ in model.named_parameters():
        parts = tuple(name.split("."))
        specs[name] = next((dim for suffix, dim in TP_RULES
                            if parts[-len(suffix):] == suffix), None)
    return specs


def _owner_name(name: str) -> str:
    """The module that a sharded parameter marks: the CTC head for its
    projection's weight and bias, the MoE FFN for its expert weights."""
    parts = name.split(".")
    return ".".join(parts[:-2] if parts[-2] == "proj" else parts[:-1])


def _local(t: torch.Tensor, dim: int, index: int, count: int) -> torch.Tensor:
    if t.shape[dim] % count:
        raise ValueError(f"a dim of {t.shape[dim]} does not split over {count} model ranks")
    size = t.shape[dim] // count
    return t.narrow(dim, index * size, size).clone()


def shard_params_tp(model: nn.Module, mesh: Mesh, axis: str = MODEL_AXIS) -> nn.Module:
    """Keep this rank's slice of every ``TP_RULES`` parameter as the live
    parameter and mark its module (the CTC head's ``tp_group``, an MoE
    FFN's ``ep``), in place. A sharded dim that does not divide over the
    axis (a 30-token head over 4 ranks) raises ValueError, as the JAX
    package's sharding does. A model axis of size 1 leaves the model as it
    is. Call it before building the optimizer."""
    count = mesh.shape[axis]
    if count == 1:
        return model
    # the slice's index is the rank's place in the group, the order the
    # gathers return the slices in
    group = mesh.group(axis)
    index = group_rank(group)
    params = dict(model.named_parameters())
    # every slice is cut before one is kept: a dim that does not divide
    # raises with the model still whole
    local = {n: _local(params[n].data, d, index, count)
             for n, d in tp_param_specs(model).items() if d is not None}
    for n, t in local.items():
        params[n].data = t
    for owner_name in {_owner_name(n) for n in local}:
        owner = model.get_submodule(owner_name)
        if hasattr(owner, "ep"):
            owner.ep = (group, index, count)
        else:
            owner.tp_group = group
    return model


def sharded_specs(model: nn.Module) -> Dict[str, int]:
    """{name: dim} of the parameters ``shard_params_tp`` split (those of
    marked modules)."""
    return {n: d for n, d in tp_param_specs(model).items()
            if d is not None and _marked(model.get_submodule(_owner_name(n)))}


def _marked(module: nn.Module) -> bool:
    return getattr(module, "tp_group", None) is not None or getattr(module, "ep", None) is not None


def gather_tensor(t: torch.Tensor, dim: int, mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """The full tensor of which each model rank holds the slice `t`
    (along `dim`), on every rank; a collective over the model group."""
    group = mesh.group(axis)
    if group is None or mesh.shape[axis] == 1:
        return t.detach()
    return torch.cat(_all_gather(t.detach(), group), dim=dim)


def full_state_dict(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with each sharded parameter gathered: the
    single-rank layout (a collective when the model is sharded)."""
    state = model.state_dict()
    specs = sharded_specs(model)
    return {k: gather_tensor(v, specs[k], mesh) if k in specs else v for k, v in state.items()}


def shard_state_dict(state: Dict[str, torch.Tensor], model: nn.Module,
                     mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A single-rank-layout state dict cut to this rank's slices of
    `model`'s sharded parameters."""
    specs = sharded_specs(model)
    count, index = mesh.shape[MODEL_AXIS], group_rank(mesh.group(MODEL_AXIS))
    return {k: _local(v, specs[k], index, count) if k in specs else v for k, v in state.items()}


@contextlib.contextmanager
def unsharded(model: nn.Module, mesh: Mesh):
    """Within the block, `model` holds its full parameters and computes as
    one rank (for ``save_pretrained`` and the like); its slices and marks
    come back after. A collective when the model is sharded."""
    specs = sharded_specs(model)
    if not specs:
        yield model
        return
    params = dict(model.named_parameters())
    local = {n: params[n].data for n in specs}
    marks = [(m, attr, getattr(m, attr)) for m in model.modules()
             for attr in ("tp_group", "ep") if getattr(m, attr, None) is not None]
    try:
        for n, t in local.items():
            params[n].data = gather_tensor(t, specs[n], mesh)
        for m, attr, _ in marks:
            setattr(m, attr, None)
        yield model
    finally:
        for n, t in local.items():
            params[n].data = t
        for m, attr, value in marks:
            setattr(m, attr, value)
