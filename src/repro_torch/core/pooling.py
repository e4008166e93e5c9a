"""AAD (Average-Absolute-Deviation) pooling unit (port of
``repro.core.pooling``: ``aad_pool`` and ``aad_pool_1d``).

Within each window, the elements whose deviation from the window mean is at
most the mean absolute deviation are averaged; outliers are excluded. The
audio frontend stub of the encoder-decoder model downsamples its frames with
``aad_pool_1d``.

Bitwise the reference's. Its selection ``dev <= aad + 1e-12`` sits on an f32
boundary: above ~1e-5 the 1e-12 is lost in the sum, so one ulp of difference
between two deviations keeps one element and drops the other. So every sum
here runs over the window axis in index order, as XLA's reduction does, and a
mean is that sum divided by the count.
"""
from __future__ import annotations

import torch

__all__ = ["aad_pool", "aad_pool_1d"]


def _window_sum(pat: torch.Tensor) -> torch.Tensor:
    """Sum over the window axis (-2), element by element in index order."""
    out = pat[..., 0, :]
    for i in range(1, pat.shape[-2]):
        out = out + pat[..., i, :]
    return out


def _select_mean(pat: torch.Tensor) -> torch.Tensor:
    """The AAD selection over windows ``pat`` (..., K, C) -> (..., C)."""
    count = torch.tensor(float(pat.shape[-2]), dtype=pat.dtype, device=pat.device)
    mean = (_window_sum(pat) / count).unsqueeze(-2)
    dev = torch.abs(pat - mean)
    aad = (_window_sum(dev) / count).unsqueeze(-2)
    keep = (dev <= aad + 1e-12).to(pat.dtype)
    ksum = _window_sum(keep)
    out = _window_sum(pat * keep) / torch.clamp(ksum, min=1.0)
    # the empty selection cannot happen for real windows; kept as in the reference
    return torch.where(ksum > 0, out, mean.squeeze(-2))


def aad_pool(x: torch.Tensor, window: int = 2, stride: int | None = None) -> torch.Tensor:
    """AAD pooling over NHWC feature maps: (B, H, W, C) -> (B, Ho, Wo, C)."""
    stride = stride or window
    b, h, w, c = x.shape
    ho, wo = (h - window) // stride + 1, (w - window) // stride + 1
    dev = x.device
    idx_h = (torch.arange(ho, device=dev) * stride)[:, None] + torch.arange(window, device=dev)
    idx_w = (torch.arange(wo, device=dev) * stride)[:, None] + torch.arange(window, device=dev)
    rows = x[:, idx_h]                      # (B, Ho, win, W, C)
    pat = rows[:, :, :, idx_w]              # (B, Ho, win, Wo, win, C)
    pat = torch.movedim(pat, 3, 2)          # (B, Ho, Wo, win, win, C)
    return _select_mean(pat.reshape(b, ho, wo, window * window, c))


def aad_pool_1d(x: torch.Tensor, window: int, stride: int | None = None) -> torch.Tensor:
    """AAD pooling over (..., T, C) sequences -> (..., To, C)."""
    stride = stride or window
    to = (x.shape[-2] - window) // stride + 1
    idx = (torch.arange(to, device=x.device) * stride)[:, None] + torch.arange(window,
                                                                               device=x.device)
    pat = x[..., idx, :]                    # (..., To, win, C)
    return _select_mean(pat)
