"""The lower precisions the controls compute in."""

from __future__ import annotations

import torch

__all__ = ["round_tf32", "round_bf16"]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest, ties to
    even (a float64 input is taken to float32 first)."""
    x = x.float().contiguous()
    bits = x.view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    out = ((bits + bias) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bfloat16 and back."""
    return x.float().to(torch.bfloat16).float()
