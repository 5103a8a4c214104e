"""The VELOCITY-ASR model in PyTorch."""

from .config import VelocityASRConfig
from .model import VelocityASR, create_model, forward, from_pretrained

__all__ = ["VelocityASR", "VelocityASRConfig", "create_model", "forward", "from_pretrained"]
