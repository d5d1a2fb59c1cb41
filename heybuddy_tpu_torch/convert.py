"""
Weight bridge between the JAX package's parameter trees, as numpy arrays, and
the port's modules, both ways.

Both packages keep parameters in the same tree (dense weights stored
(in, out), lists for repeated blocks), and the port's module attribute names
follow it, so the flat key ``trunk/0/up/w`` is the state-dict key
``trunk.0.up.w``. With the same arrays in, both packages compute the same
function, which is what the parity tests rely on. The reverse bridge gives a module's
parameters back as that tree; checkpoints and the ONNX exporter are written
from it.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from heybuddy_tpu_torch.models.embedding_net import (
    EmbeddingNet,
    EmbeddingNetConfig,
    flatten_params,
    unflatten_params,
)

__all__ = [
    "state_from_numpy",
    "embedding_params_from_numpy",
    "wakeword_params_from_numpy",
    "wakeword_params_to_numpy",
    "restore_empty_lists",
]

# the list-valued nodes of each wake-word architecture: an empty list leaves
# no key in the flat layout, so it is restored by name
_LIST_NODES = {"perceptron": ("half_layers", "layers"), "transformer": ("blocks",)}


def state_from_numpy(tree: Any) -> Dict[str, torch.Tensor]:
    """Nested numpy tree (or flat ``a/0/b`` dict) -> float32 state dict (``a.0.b``)."""
    return {
        key.replace("/", "."): torch.from_numpy(np.array(value, dtype=np.float32))
        for key, value in flatten_params(tree).items()
    }


def _embedding_config(state: Dict[str, torch.Tensor]) -> EmbeddingNetConfig:
    patch_dim, hidden = state["patch_proj.w"].shape
    blocks = sum(1 for k in state if k.startswith("trunk.") and k.endswith(".up.w"))
    mel_bins = EmbeddingNetConfig().mel_bins
    patch_frames = patch_dim // mel_bins
    return EmbeddingNetConfig(
        window_size=state["pos"].shape[0] * patch_frames,
        mel_bins=mel_bins,
        patch_frames=patch_frames,
        hidden_dim=hidden,
        trunk_hidden_dim=state["trunk.0.up.w"].shape[1],
        trunk_blocks=blocks,
        pool_heads=state["pool_query"].shape[1],
        embedding_dim=state["head.w"].shape[1],
    )


def embedding_params_from_numpy(tree: Any) -> EmbeddingNet:
    """JAX embedding parameter tree (numpy) -> ``EmbeddingNet`` on the CPU."""
    state = state_from_numpy(tree)
    net = EmbeddingNet(_embedding_config(state))
    net.load_state_dict(state, strict=True)
    return net.eval()


def wakeword_params_from_numpy(tree: Any) -> Dict[str, torch.Tensor]:
    """JAX wake-word parameter tree (numpy) -> state dict of ``WakeWordMLPModel``."""
    return state_from_numpy(tree)


def restore_empty_lists(tree: Dict[str, Any], architecture: str) -> Dict[str, Any]:
    """Put back the empty ``half_layers`` / ``layers`` / ``blocks`` lists a flat layout drops."""
    for name in _LIST_NODES[architecture]:
        tree.setdefault(name, [])
    return tree


def wakeword_params_to_numpy(model: nn.Module) -> Dict[str, Any]:
    """A wake-word module's parameters as the JAX parameter tree of float32 numpy arrays."""
    tree = unflatten_params(
        {k: np.asarray(v, dtype=np.float32) for k, v in flatten_params(model).items()}
    )
    return restore_empty_lists(tree, model.architecture)
