"""Interop: converters from the reference PyTorch checkpoints."""

from .torch_convert import convert_torch_state_dict, load_torch_checkpoint

__all__ = ["convert_torch_state_dict", "load_torch_checkpoint"]
