"""The VELOCITY-ASR model in PyTorch."""

from .attention import AdaptivePool, GatedFusion, HierarchicalGlobalContext, MultiHeadAttention
from .config import VelocityASRConfig
from .layers import CTCOutputHead, PositionalEncoding2D, TemporalBindingLayer
from .model import (VelocityASR, count_parameters, create_model, forward, from_pretrained,
                    get_output_length, init_params, save_pretrained)
from .ssm import GlobalSSM, LocalSSMProcessor, SelectiveSSM, SSMBlock

__all__ = [
    "AdaptivePool", "CTCOutputHead", "GatedFusion", "GlobalSSM", "HierarchicalGlobalContext",
    "LocalSSMProcessor", "MultiHeadAttention", "PositionalEncoding2D", "SelectiveSSM",
    "SSMBlock", "TemporalBindingLayer", "VelocityASR", "VelocityASRConfig", "count_parameters",
    "create_model", "forward", "from_pretrained", "get_output_length", "init_params",
    "save_pretrained",
]
