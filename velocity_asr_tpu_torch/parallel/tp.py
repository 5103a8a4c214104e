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

A QAT head (``quantize.QuantDense``) keeps the observers the JAX head
has: its weight observer's per-channel stats are cut with its rows (a
rank's channels are all local, so it reduces nothing), and its output
observer, which sees this rank's slice of the logits, reduces its range
over the model group (``FakeQuantize.groups``) besides the data group
the Trainer gives every activation observer.

A checkpoint keeps the single-rank layout: ``full_state_dict`` and
``full_quant_stats`` gather the slices, ``shard_state_dict`` and
``shard_quant_stats`` cut a full state back to this rank's, and
``unsharded`` lends a model its full parameters and stats for a save.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from .mesh import MODEL_AXIS, Mesh, _all_gather, group_rank

# (name suffix, sharded dim): a parameter or buffer whose name ends with
# the suffix is split along that dim over the model axis; every other one
# is replicated. The port's Linear weights are (out, in), so the head's
# vocab axis is dim 0 (the flax kernel's last); a QAT head's weight-
# observer stats are flax-shaped (1, vocab). The module a rule marks is
# the one its suffix starts with: the CTC head, an MoE FFN.
TP_RULES: List[Tuple[Tuple[str, ...], int]] = [
    (("ctc_head", "proj", "weight"), 0),
    (("ctc_head", "proj", "bias"), 0),
    *((("ctc_head", "proj", "weight_quantizer", key), 1)
      for key in ("scale", "zero_point", "range_min", "range_max")),
    (("moe", "w_in"), 0),
    (("moe", "b_in"), 0),
    (("moe", "w_out"), 0),
    (("moe", "b_out"), 0),
]


def _rule(name: str) -> Optional[Tuple[int, str]]:
    """(sharded dim, the module it marks) of a ``TP_RULES`` name, or None."""
    parts = name.split(".")
    for suffix, dim in TP_RULES:
        if tuple(parts[-len(suffix):]) == suffix:
            return dim, ".".join(parts[:len(parts) - len(suffix) + 1])
    return None


def tp_param_specs(model: nn.Module) -> Dict[str, Optional[int]]:
    """{parameter name: the dim it shards along, or None (replicated)}."""
    return {name: (_rule(name) or (None,))[0] for name, _ in model.named_parameters()}


def _tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters and buffers by name (the ``TP_RULES`` ones
    are swapped through ``.data``, which keeps each tensor object)."""
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


def _local(t: torch.Tensor, dim: int, index: int, count: int) -> torch.Tensor:
    if t.shape[dim] % count:
        raise ValueError(f"a dim of {t.shape[dim]} does not split over {count} model ranks")
    size = t.shape[dim] // count
    return t.narrow(dim, index * size, size).clone()


def shard_params_tp(model: nn.Module, mesh: Mesh, axis: str = MODEL_AXIS) -> nn.Module:
    """Keep this rank's slice of every ``TP_RULES`` parameter as the live
    parameter and mark its module (the CTC head's ``tp_group``, an MoE
    FFN's ``ep``), in place; a QAT head's weight-observer stats are cut
    with its rows and its output observer reduces over the model group
    too. A sharded dim that does not divide over the axis (a 30-token head
    over 4 ranks) raises ValueError, as the JAX package's sharding does. A
    model axis of size 1 leaves the model as it is. Call it before
    building the optimizer."""
    count = mesh.shape[axis]
    if count == 1:
        return model
    # the slice's index is the rank's place in the group, the order the
    # gathers return the slices in
    group = mesh.group(axis)
    index = group_rank(group)
    tensors = _tensors(model)
    rules = {n: r for n in tensors if (r := _rule(n)) is not None}
    # every slice is cut before one is kept: a dim that does not divide
    # raises with the model still whole
    local = {n: _local(tensors[n].data, dim, index, count) for n, (dim, _) in rules.items()}
    for n, t in local.items():
        tensors[n].data = t
    for owner_name in {owner for _, owner in rules.values()}:
        owner = model.get_submodule(owner_name)
        if hasattr(owner, "ep"):
            owner.ep = (group, index, count)
        else:
            owner.tp_group = group
            observer = getattr(owner.proj, "activation_quantizer", None)
            if observer is not None:
                observer.groups[MODEL_AXIS] = group
    return model


def sharded_specs(model: nn.Module) -> Dict[str, int]:
    """{name: dim} of the parameters and observer buffers
    ``shard_params_tp`` split (those of marked modules)."""
    specs = {}
    for name in _tensors(model):
        rule = _rule(name)
        if rule is not None and _marked(model.get_submodule(rule[1])):
            specs[name] = rule[0]
    return specs


def _marked(module: nn.Module) -> bool:
    return getattr(module, "tp_group", None) is not None or getattr(module, "ep", None) is not None


def gather_tensor(t: torch.Tensor, dim: int, mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """The full tensor of which each model rank holds the slice `t`
    (along `dim`), on every rank; a collective over the model group."""
    group = mesh.group(axis)
    if group is None or mesh.shape[axis] == 1:
        return t.detach()
    return torch.cat(_all_gather(t.detach(), group), dim=dim)


def _gather(tensors: Dict[str, torch.Tensor], model: nn.Module,
            mesh: Mesh) -> Dict[str, torch.Tensor]:
    """`tensors` (by name) with each of `model`'s sharded ones gathered."""
    specs = sharded_specs(model)
    return {k: gather_tensor(v, specs[k], mesh) if k in specs else v for k, v in tensors.items()}


def _cut(tensors: Dict[str, torch.Tensor], model: nn.Module,
         mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Single-rank-layout `tensors` (by name) with each of `model`'s
    sharded ones cut to this rank's slice."""
    specs = sharded_specs(model)
    count, index = mesh.shape[MODEL_AXIS], group_rank(mesh.group(MODEL_AXIS))
    return {k: _local(torch.as_tensor(v), specs[k], index, count) if k in specs else v
            for k, v in tensors.items()}


def full_state_dict(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` in the single-rank layout (a collective when
    the model is sharded)."""
    return _gather(model.state_dict(), model, mesh)


def shard_state_dict(state: Dict[str, torch.Tensor], model: nn.Module,
                     mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A single-rank-layout state dict cut to this rank's slices."""
    return _cut(state, model, mesh)


def full_quant_stats(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """``quantize.quant_stats_buffers`` in the single-rank layout (a
    collective when the head is sharded)."""
    # imported here: quantize imports the layers, which import this package
    from ..quantize import quant_stats_buffers

    return _gather(quant_stats_buffers(model), model, mesh)


def shard_quant_stats(stats: Dict[str, torch.Tensor], model: nn.Module,
                      mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Single-rank-layout observer stats cut to this rank's slices."""
    return _cut(stats, model, mesh)


@contextlib.contextmanager
def unsharded(model: nn.Module, mesh: Mesh):
    """Within the block, `model` holds its full parameters and observer
    stats and computes as one rank (for ``save_pretrained``,
    ``quant_stats_to_numpy`` and the like); its slices, marks and the
    observers' model groups come back after. A collective when the model
    is sharded."""
    from ..quantize import fake_quantizers

    specs = sharded_specs(model)
    if not specs:
        yield model
        return
    tensors = _tensors(model)
    local = {n: tensors[n].data for n in specs}
    marks = [(m, attr, getattr(m, attr)) for m in model.modules()
             for attr in ("tp_group", "ep") if getattr(m, attr, None) is not None]
    observers = [(fq, fq.groups[MODEL_AXIS]) for fq in fake_quantizers(model)
                 if MODEL_AXIS in fq.groups]
    try:
        for n, t in local.items():
            tensors[n].data = gather_tensor(t, specs[n], mesh)
        for m, attr, _ in marks:
            setattr(m, attr, None)
        for fq, _ in observers:
            del fq.groups[MODEL_AXIS]
        yield model
    finally:
        for n, t in local.items():
            tensors[n].data = t
        for m, attr, value in marks:
            setattr(m, attr, value)
        for fq, group in observers:
            fq.groups[MODEL_AXIS] = group
