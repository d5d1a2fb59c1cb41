"""
Relative-position multi-head attention and the post-norm transformer encoder
of the VITS text encoder, the JAX package's ``models/vits/attention.py`` as
``nn.Module``s named after Piper's keys (``attn_layers.{i}.conv_q``,
``emb_rel_k``, ``norm_layers_1``, ``ffn_layers.{i}.conv_1``, ...): window 4,
relative key and value tables shared across heads, a conv FFN with ReLU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from heybuddy_tpu_torch.models.vits.modules import LayerNorm, conv1d

__all__ = ["MultiHeadAttention", "FFN", "Encoder"]


def _relative_to_absolute(x: torch.Tensor) -> torch.Tensor:
    """(b, h, t, 2t - 1) relative logits -> (b, h, t, t) absolute."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, 1))
    x_flat = F.pad(x.reshape(b, h, t * 2 * t), (0, t - 1))
    return x_flat.reshape(b, h, t + 1, 2 * t - 1)[:, :, :t, t - 1:]


def _absolute_to_relative(x: torch.Tensor) -> torch.Tensor:
    """(b, h, t, t) -> (b, h, t, 2t - 1)."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, t - 1))
    x_flat = F.pad(x.reshape(b, h, t * t + t * (t - 1)), (t, 0))
    return x_flat.reshape(b, h, t, 2 * t)[:, :, :, 1:]


def _relative_embeddings(emb: torch.Tensor, t: int, window_size: int) -> torch.Tensor:
    """The (1, 2w + 1, d) table sliced or zero-padded to (1, 2t - 1, d)."""
    pad = max(t - (window_size + 1), 0)
    start = max((window_size + 1) - t, 0)
    padded = F.pad(emb, (0, 0, pad, pad))
    return padded[:, start: start + 2 * t - 1]


class MultiHeadAttention(nn.Module):
    """Self-attention over (b, c, t) with relative positions (Piper's ``MultiHeadAttention``)."""

    def __init__(self, channels: int, n_heads: int, window_size: int = 4) -> None:
        super().__init__()
        self.n_heads = n_heads
        self.window_size = window_size
        head_dim = channels // n_heads
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, channels, 1)
        self.emb_rel_k = nn.Parameter(torch.zeros(1, 2 * window_size + 1, head_dim))
        self.emb_rel_v = nn.Parameter(torch.zeros(1, 2 * window_size + 1, head_dim))

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        b, c, t = x.shape
        heads = self.n_heads
        d = c // heads

        def split(conv: nn.Conv1d) -> torch.Tensor:
            return conv1d(conv, x).reshape(b, heads, d, t).permute(0, 1, 3, 2)

        q, k, v = split(self.conv_q), split(self.conv_k), split(self.conv_v)
        q = q * (1.0 / math.sqrt(d))
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k)
        rel_k = _relative_embeddings(self.emb_rel_k, t, self.window_size)
        scores = scores + _relative_to_absolute(torch.einsum("bhqd,md->bhqm", q, rel_k[0]))
        scores = torch.where(attn_mask > 0, scores, torch.full_like(scores, -1e4))
        weights = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", weights, v)
        rel_v = _relative_embeddings(self.emb_rel_v, t, self.window_size)
        out = out + torch.einsum("bhqm,md->bhqd", _absolute_to_relative(weights), rel_v[0])
        return conv1d(self.conv_o, out.permute(0, 1, 3, 2).reshape(b, c, t))


class FFN(nn.Module):
    def __init__(self, channels: int, filter_channels: int, kernel_size: int) -> None:
        super().__init__()
        self.kernel_size = kernel_size
        self.conv_1 = nn.Conv1d(channels, filter_channels, kernel_size)
        self.conv_2 = nn.Conv1d(filter_channels, channels, kernel_size)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        padding = self.kernel_size // 2
        y = torch.relu(conv1d(self.conv_1, x * x_mask, padding=padding))
        return conv1d(self.conv_2, y * x_mask, padding=padding) * x_mask


class Encoder(nn.Module):
    """Post-norm transformer encoder over (b, c, t); ``x_mask`` is (b, 1, t)."""

    def __init__(
        self, hidden_channels: int, filter_channels: int, n_heads: int, n_layers: int, kernel_size: int,
        window_size: int = 4,
    ) -> None:
        super().__init__()
        self.attn_layers = nn.ModuleList(
            MultiHeadAttention(hidden_channels, n_heads, window_size) for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            FFN(hidden_channels, filter_channels, kernel_size) for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        attn_mask = x_mask[:, :, :, None] * x_mask[:, :, None, :]  # (b, 1, t, t)
        x = x * x_mask
        for attn, norm1, ffn, norm2 in zip(self.attn_layers, self.norm_layers_1, self.ffn_layers,
                                           self.norm_layers_2):
            x = norm1(x + attn(x, attn_mask))
            x = norm2(x + ffn(x, x_mask))
        return x * x_mask
