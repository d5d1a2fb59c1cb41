"""
Piecewise rational-quadratic spline transforms, the JAX package's
``models/vits/transforms.py`` in PyTorch: monotonic rational-quadratic splines
inside [-tail_bound, tail_bound] with linear tails, the identity outside. The
bin search is a comparison sum and the bin's values are gathered, as there.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["rational_quadratic_spline"]

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _knots(unnormalized: torch.Tensor, min_bin: float, tail_bound: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax bin sizes -> (knot positions (..., bins + 1), bin sizes (..., bins))."""
    num_bins = unnormalized.shape[-1]
    sizes = min_bin + (1.0 - min_bin * num_bins) * torch.softmax(unnormalized, dim=-1)
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = (2.0 * tail_bound) * cum - tail_bound
    cum = torch.cat([torch.full_like(cum[..., :1], -tail_bound), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], tail_bound)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 5.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    ``inputs`` (...,); widths / heights (..., bins); interior derivatives
    (..., bins - 1). Returns (outputs, logabsdet), the identity outside the
    tail bound.
    """
    num_bins = unnormalized_widths.shape[-1]
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)

    # linear tails: the boundary derivatives pinned to 1
    constant = math.log(math.exp(1.0 - min_derivative) - 1.0)
    pad = torch.full_like(unnormalized_derivatives[..., :1], constant)
    unnormalized_derivatives = torch.cat([pad, unnormalized_derivatives, pad], dim=-1)

    cumwidths, widths = _knots(unnormalized_widths, min_bin_width, tail_bound)
    # jax.nn.softplus is logaddexp(x, 0)
    derivatives = min_derivative + torch.logaddexp(unnormalized_derivatives, torch.zeros_like(unnormalized_derivatives))
    cumheights, heights = _knots(unnormalized_heights, min_bin_height, tail_bound)

    # clamped for the bin search, so that inputs outside the tails index bin 0 harmlessly
    clamped = torch.clamp(inputs, -tail_bound, tail_bound)
    bins = cumheights if inverse else cumwidths
    bin_idx = (clamped[..., None] >= bins[..., 1:-1]).to(torch.int64).sum(dim=-1)
    bin_idx = torch.clamp(bin_idx, 0, num_bins - 1)[..., None]

    def take(arr: torch.Tensor) -> torch.Tensor:
        return torch.gather(arr, -1, bin_idx)[..., 0]

    input_cumwidths = take(cumwidths[..., :-1])
    input_bin_widths = take(widths)
    input_cumheights = take(cumheights[..., :-1])
    input_heights = take(heights)
    delta = input_heights / input_bin_widths
    d0 = take(derivatives[..., :-1])
    d1 = take(derivatives[..., 1:])
    slope_sum = d0 + d1 - 2.0 * delta

    if inverse:
        y = clamped - input_cumheights
        a = input_heights * (delta - d0) + y * slope_sum
        b = input_heights * d0 - y * slope_sum
        c = -delta * y
        discriminant = torch.clamp(b * b - 4.0 * a * c, min=0.0)
        root = (2.0 * c) / (-b - torch.sqrt(discriminant))
        outputs = root * input_bin_widths + input_cumwidths
        theta_one_minus_theta = root * (1.0 - root)
        denominator = delta + slope_sum * theta_one_minus_theta
        derivative_numerator = delta * delta * (
            d1 * root * root + 2.0 * delta * theta_one_minus_theta + d0 * (1.0 - root) ** 2
        )
        logabsdet = -(torch.log(derivative_numerator + 1e-12) - 2.0 * torch.log(denominator + 1e-12))
    else:
        theta = (clamped - input_cumwidths) / input_bin_widths
        theta_one_minus_theta = theta * (1.0 - theta)
        numerator = input_heights * (delta * theta * theta + d0 * theta_one_minus_theta)
        denominator = delta + slope_sum * theta_one_minus_theta
        outputs = input_cumheights + numerator / denominator
        derivative_numerator = delta * delta * (
            d1 * theta * theta + 2.0 * delta * theta_one_minus_theta + d0 * (1.0 - theta) ** 2
        )
        logabsdet = torch.log(derivative_numerator + 1e-12) - 2.0 * torch.log(denominator + 1e-12)

    outputs = torch.where(inside, outputs, inputs)
    logabsdet = torch.where(inside, logabsdet, torch.zeros_like(logabsdet))
    return outputs, logabsdet
