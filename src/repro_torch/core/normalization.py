"""Normalization unit (port of ``repro.core.normalization``): always f32.

On a CUDA device the layernorm runs as ``torch.nn.functional.layer_norm``,
one block a row whatever the number of rows: a row's bits then do not
depend on how many rows share the call. (ATen's generic reductions, the
CPU path's ``mean`` and ``var``, lay their threads out by the number of
rows.) A speculative verify normalizes k+1 rows a slot where token-by-token
decoding normalizes one, and greedy speculation must give each position the
decode's bits. The rmsnorm keeps the reductions: the archs that use it are
not yet held to that identity on the card.
"""
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
    if xf.is_cuda:
        out = torch.nn.functional.layer_norm(
            xf, xf.shape[-1:], None if weight is None else weight.to(torch.float32),
            None if bias is None else bias.to(torch.float32), eps)
        return out.to(x.dtype)
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
