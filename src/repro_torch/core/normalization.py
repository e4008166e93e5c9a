"""Normalization unit (port of ``repro.core.normalization``): always f32."""
from __future__ import annotations

import torch

__all__ = ["rmsnorm", "layernorm", "nonparametric_ln"]


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (out * weight.to(torch.float32)).to(x.dtype)


def layernorm(x: torch.Tensor, weight, bias, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.reciprocal(torch.sqrt(var + eps))
    if weight is not None:
        out = out * weight.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def nonparametric_ln(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo-style LayerNorm without affine parameters."""
    return layernorm(x, None, None, eps)

