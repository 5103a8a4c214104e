"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Validate `device` and fix the fp32 matmul and convolution precision.

    Asking for CUDA without a card raises: an entry point never falls
    back to the CPU on its own.

    TF32 is switched off for matmuls and cuDNN convolutions. It keeps
    about three decimal digits, the Hopper form of the reduced-precision
    fp32 dot that the JAX package guards against in its Pallas scan
    (velocity_asr_tpu/ops/scan_pallas.py); the port's fp32 paths (the
    mel front-end's plain version, fp32 models) must stay true fp32.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device
