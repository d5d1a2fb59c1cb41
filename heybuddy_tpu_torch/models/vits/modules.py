"""
VITS building blocks as ``nn.Module``s over (batch, channels, time) tensors.

Counterpart of the JAX package's ``models/vits/modules.py``. The submodules
carry the names of Piper's (VITS's) state-dict keys, so that a module's
``state_dict()`` reads as a Piper checkpoint: a conv is an ``nn.Conv1d``
(``weight`` (out, in, k), ``bias``), a transposed conv an
``nn.ConvTranspose1d`` (``weight`` (in, out, k) as Piper stores it, applied
by ``F.conv_transpose1d``: the JAX package flips and transposes it for its
input-dilation form instead), a channel LayerNorm has ``gamma`` / ``beta``,
and flow lists hold parameterless ``Flip`` entries where Piper's do. The
padding and dilation of each conv are arguments of the call, as in the JAX
functions; the JAX tree's ``Static`` leaves (kernel sizes, dilation rates,
bin counts) are constructor integers here.

The arithmetic is the JAX functions', including where it departs from
Piper: DDSConv's GELU is the tanh approximation (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from heybuddy_tpu_torch.models.vits.transforms import rational_quadratic_spline

__all__ = [
    "conv1d",
    "conv_transpose1d",
    "LayerNorm",
    "sequence_mask",
    "fused_add_tanh_sigmoid_multiply",
    "DDSConv",
    "WN",
    "ResBlock2",
    "ElementwiseAffine",
    "Flip",
    "log_flow",
    "flip_flow",
    "ResidualCouplingLayer",
    "ConvFlow",
]


def conv1d(conv: nn.Conv1d, x: torch.Tensor, padding: int = 0, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """Torch-semantics Conv1d with this call's padding, dilation and groups."""
    return F.conv1d(x, conv.weight, conv.bias, padding=padding, dilation=dilation, groups=groups)


def conv_transpose1d(conv: nn.ConvTranspose1d, x: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    return F.conv_transpose1d(x, conv.weight, conv.bias, stride=stride, padding=padding)


class LayerNorm(nn.Module):
    """LayerNorm over the channel axis of (b, c, t), Piper's ``gamma`` / ``beta``."""

    def __init__(self, channels: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=1, keepdim=True)
        var = (x - mean).square().mean(dim=1, keepdim=True)
        normed = (x - mean) * torch.rsqrt(var + self.eps)
        return normed * self.gamma[None, :, None] + self.beta[None, :, None]


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(b,) lengths -> (b, max_length) float 0/1 mask."""
    positions = torch.arange(max_length, device=lengths.device)[None, :]
    return (positions < lengths[:, None]).float()


def fused_add_tanh_sigmoid_multiply(a: torch.Tensor, b: torch.Tensor, n_channels: int) -> torch.Tensor:
    total = a + b
    return torch.tanh(total[:, :n_channels]) * torch.sigmoid(total[:, n_channels:])


class DDSConv(nn.Module):
    """Dilated depth-separable conv stack (Piper ``DDSConv``), dropout-free."""

    def __init__(self, channels: int, kernel_size: int, n_layers: int) -> None:
        super().__init__()
        self.kernel_size = kernel_size
        self.convs_sep = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, groups=channels) for _ in range(n_layers))
        self.convs_1x1 = nn.ModuleList(nn.Conv1d(channels, channels, 1) for _ in range(n_layers))
        self.norms_1 = nn.ModuleList(LayerNorm(channels) for _ in range(n_layers))
        self.norms_2 = nn.ModuleList(LayerNorm(channels) for _ in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor] = None) -> torch.Tensor:
        k = self.kernel_size
        if g is not None:
            x = x + g
        for i, (sep, pw) in enumerate(zip(self.convs_sep, self.convs_1x1)):
            dilation = k ** i
            y = conv1d(sep, x * x_mask, padding=((k - 1) * dilation) // 2, dilation=dilation, groups=x.shape[1])
            y = F.gelu(self.norms_1[i](y), approximate="tanh")
            y = F.gelu(self.norms_2[i](conv1d(pw, y)), approximate="tanh")
            x = x + y
        return x * x_mask


class WN(nn.Module):
    """WaveNet-style gated residual stack (Piper ``WN``), dropout-free."""

    def __init__(
        self, hidden_channels: int, kernel_size: int, dilation_rate: int, n_layers: int, gin_channels: int = 0
    ) -> None:
        super().__init__()
        self.hidden_channels = hidden_channels
        self.kernel_size = kernel_size
        self.dilation_rate = dilation_rate
        self.in_layers = nn.ModuleList(
            nn.Conv1d(hidden_channels, 2 * hidden_channels, kernel_size) for _ in range(n_layers))
        self.res_skip_layers = nn.ModuleList(
            nn.Conv1d(hidden_channels, 2 * hidden_channels if i < n_layers - 1 else hidden_channels, 1)
            for i in range(n_layers))
        if gin_channels > 0:
            self.cond_layer = nn.Conv1d(gin_channels, 2 * hidden_channels * n_layers, 1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden = x.shape[1]
        n_layers = len(self.in_layers)
        output = torch.zeros_like(x)
        g_all = conv1d(self.cond_layer, g) if (g is not None and hasattr(self, "cond_layer")) else None
        for i in range(n_layers):
            dilation = self.dilation_rate ** i
            padding = ((self.kernel_size - 1) * dilation) // 2
            x_in = conv1d(self.in_layers[i], x, padding=padding, dilation=dilation)
            g_l = g_all[:, i * 2 * hidden: (i + 1) * 2 * hidden] if g_all is not None else torch.zeros_like(x_in)
            acts = fused_add_tanh_sigmoid_multiply(x_in, g_l, hidden)
            res_skip = conv1d(self.res_skip_layers[i], acts)
            if i < n_layers - 1:
                x = (x + res_skip[:, :hidden]) * x_mask
                output = output + res_skip[:, hidden:]
            else:
                output = output + res_skip
        return output * x_mask


class ResBlock2(nn.Module):
    """HiFiGAN ResBlock2 (Piper ``ResBlock2``), leaky ReLU 0.1."""

    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int]) -> None:
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.convs = nn.ModuleList(nn.Conv1d(channels, channels, kernel_size) for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, dilation in zip(self.convs, self.dilations):
            y = conv1d(conv, F.leaky_relu(x, 0.1), padding=((self.kernel_size - 1) * dilation) // 2,
                       dilation=dilation)
            x = x + y
        return x


class ElementwiseAffine(nn.Module):
    def __init__(self, channels: int) -> None:
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def forward(
        self, x: torch.Tensor, x_mask: torch.Tensor, reverse: bool = False
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if not reverse:
            y = (self.m[None] + torch.exp(self.logs[None]) * x) * x_mask
            return y, (self.logs[None] * x_mask).sum(dim=(1, 2))
        return (x - self.m[None]) * torch.exp(-self.logs[None]) * x_mask, None


class Flip(nn.Module):
    """The channel flip between flows; it holds no parameters (Piper's ``Flip``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flip_flow(x)


def log_flow(
    x: torch.Tensor, x_mask: torch.Tensor, reverse: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    if not reverse:
        y = torch.log(torch.clamp(x, min=1e-5)) * x_mask
        return y, (-y).sum(dim=(1, 2))
    return torch.exp(x) * x_mask, None


def flip_flow(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=(1,))


class ResidualCouplingLayer(nn.Module):
    """Mean-only residual coupling (Piper ``ResidualCouplingLayer``)."""

    def __init__(
        self, channels: int, hidden_channels: int, kernel_size: int, dilation_rate: int, n_layers: int,
        gin_channels: int = 0,
    ) -> None:
        super().__init__()
        half = channels // 2
        self.pre = nn.Conv1d(half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.post = nn.Conv1d(hidden_channels, half, 1)

    def forward(
        self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor] = None, reverse: bool = False
    ) -> torch.Tensor:
        half = x.shape[1] // 2
        x0, x1 = x[:, :half], x[:, half:]
        h = conv1d(self.pre, x0) * x_mask
        h = self.enc(h, x_mask, g=g)
        m = conv1d(self.post, h) * x_mask
        x1 = (m + x1) * x_mask if not reverse else (x1 - m) * x_mask
        return torch.cat([x0, x1], dim=1)


class ConvFlow(nn.Module):
    """Spline coupling flow (Piper ``ConvFlow`` over ``transforms.py``)."""

    def __init__(
        self, in_channels: int, filter_channels: int, kernel_size: int, n_layers: int, num_bins: int = 10
    ) -> None:
        super().__init__()
        half = in_channels // 2
        self.num_bins = num_bins
        self.filter_channels = filter_channels
        self.pre = nn.Conv1d(half, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers)
        self.proj = nn.Conv1d(filter_channels, half * (num_bins * 3 - 1), 1)

    def forward(
        self,
        x: torch.Tensor,
        x_mask: torch.Tensor,
        g: Optional[torch.Tensor] = None,
        reverse: bool = False,
        tail_bound: float = 5.0,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        bins = self.num_bins
        half = x.shape[1] // 2
        x0, x1 = x[:, :half], x[:, half:]
        h = self.convs(conv1d(self.pre, x0), x_mask, g=g)
        h = conv1d(self.proj, h) * x_mask  # (b, half * (3 bins - 1), t)
        b, _, t = x0.shape
        h = h.reshape(b, half, 3 * bins - 1, t).permute(0, 1, 3, 2)  # (b, half, t, 3 bins - 1)
        denom = math.sqrt(self.filter_channels)
        x1_new, logabsdet = rational_quadratic_spline(
            x1, h[..., :bins] / denom, h[..., bins: 2 * bins] / denom, h[..., 2 * bins:],
            inverse=reverse, tail_bound=tail_bound,
        )
        x_out = torch.cat([x0, x1_new], dim=1) * x_mask
        if reverse:
            return x_out, None
        return x_out, (logabsdet * x_mask).sum(dim=(1, 2))
