"""
K2, the fused embedding kernel: patch trunk -> banded window pooling -> head.

Counterpart of the JAX package's ``ops/pallas/embedding_kernel.py::
fused_embedding_from_patches``. ``fused_embedding_from_patches`` takes the
padded patch layout that ``mel_patches`` emits, (b, p_pad, 128) float32 with
``num_patches`` real rows, and returns (b, W, 96) float32 embeddings for the
window starts of the clip length. ``fused_embedding_windows`` is the
spectrogram-layout entry (the JAX function of that name): it lays a
(b, frames, 32) spectrogram out as patches and runs the same kernel.

The rounding points are the TPU kernel's: bf16 operands with float32
accumulation, ``feats`` rounded to bf16 after ``patch_proj`` and after each
residual add, the GELU output rounded to bf16, the softmax weights rounded
after normalisation, the positional code in bf16, centred RMS (eps 1e-6) and
the grouped RMS over each window's 4 x 192 values in float32. GELU uses the
exact erf.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/embedding_pool.cu`` on ``csrc/trunk_pool.cuh``; their headers say what
bounds it and how it is laid out). It reads the trunk's and the head's bf16
weights as wgmma operand streams laid out once on the host
(``trunk_operands``, ``kmajor_tiles``) and kept in the weight cache behind
``wp``'s and ``wh``'s own bytes, so a launch through ``_kernel_weights``
passes the same pointers as before; ``check_weights`` refuses buffers that
lack them. On a CPU tensor it runs ``fused_embedding_plain``, the same
arithmetic in plain PyTorch (bf16 products emulated as
``a.bfloat16().float() @ w.bfloat16().float()``), which the tests and the
chip check compare against. The Pallas selector matmuls become indexing.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from heybuddy_tpu_torch.models.embedding_net import EmbeddingNet, EmbeddingNetConfig, _band_constants
from heybuddy_tpu_torch.ops.kernels import build

__all__ = ["fused_embedding_from_patches", "fused_embedding_plain", "fused_embedding_windows"]

# the geometry compiled into csrc/trunk_pool.cuh (K2 and K4)
KERNEL_CONFIG = EmbeddingNetConfig()


def _bf(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16, kept in float32."""
    return x.to(torch.bfloat16).float()


def _rms(v: torch.Tensor) -> torch.Tensor:
    centered = v - v.mean(dim=-1, keepdim=True)
    ms = (centered * centered).mean(dim=-1, keepdim=True)
    return centered * torch.rsqrt(ms + 1e-6)


def _cache(net: EmbeddingNet) -> Dict:
    # derived tensors of a frozen net, per device and geometry
    return net.__dict__.setdefault("_kernel_cache", {})


def _pool_constants(
    net: EmbeddingNet, starts: Tuple[int, ...], num_patches: int, p_pad: int
) -> Dict[str, torch.Tensor]:
    """
    Pooling constants of (params, window starts), built by indexing and cached
    on the net's device:
      band  (W*H, p_pad) f32   exp(pos @ Q - max) at each window's patches
      posp  (W*H, p_pad, D) bf16  pos[k(w, p)] on the band, zero elsewhere
      p0    (W,) int32         first patch of each window
      exp_c (19, H) f32, pos_bf16 (19, D) bf16: the compact form the CUDA kernel reads
    """
    key = ("pool", starts, num_patches, p_pad)
    cache = _cache(net)
    if key in cache:
        return cache[key]
    cfg = net.config
    selector_np, k_index_np = _band_constants(starts, cfg.patch_frames, cfg.window_patches, num_patches)
    dev = net.pos.device
    n_windows, heads, hidden = len(starts), cfg.pool_heads, cfg.hidden_dim
    selector = torch.from_numpy(selector_np).to(dev)
    k_index = torch.from_numpy(k_index_np).to(dev)
    q = net.pool_query.float()
    pos = net.pos.float()
    c = torch.matmul(pos, q)  # (19, H)
    exp_c = torch.exp(c - c.max())
    band = (exp_c[k_index].permute(0, 2, 1) * selector[:, None, :]).reshape(n_windows * heads, num_patches)
    posp = pos[k_index] * selector[:, :, None]  # (W, P, D)
    posp = posp[:, None].expand(n_windows, heads, num_patches, hidden).reshape(
        n_windows * heads, num_patches, hidden
    )
    consts = {
        "band": torch.nn.functional.pad(band, (0, p_pad - num_patches)),
        "posp": torch.nn.functional.pad(posp, (0, 0, 0, p_pad - num_patches)).to(torch.bfloat16),
        "p0": torch.tensor([s // cfg.patch_frames for s in starts], dtype=torch.int32, device=dev),
        "exp_c": exp_c.contiguous(),
        "pos_bf16": pos.to(torch.bfloat16).contiguous(),
    }
    cache[key] = consts
    return consts


# The wgmma operand streams the trunk and the head read (csrc/trunk_pool.cuh):
# k16 x N bf16 operand tiles in the K-major layout, in the order the kernels
# consume them, behind wp's and wh's own bytes.
UP_N = 96  # hidden columns of an up pass
WP_BYTES = 128 * 192 * 2
WH_BYTES = 768 * 96 * 2
HEAD_OPS_BYTES = 768 * 96 * 2


def trunk_ops_bytes(n_blocks: int) -> int:
    """Bytes of the trunk's operand stream: patch_proj, then per block 4 x (up pass, its down k-steps)."""
    return WP_BYTES + n_blocks * 2 * 192 * 384 * 2


def kmajor_tiles(w: torch.Tensor) -> torch.Tensor:
    """
    A (K, N) matrix as wgmma's k16 x N operand tiles in the K-major layout
    without swizzle: per k-step s, core matrices of 8 columns (n) by 8 rows
    (k), 128 contiguous bytes each, the two along k next to each other and
    those along n 256 bytes apart. Returns (K / 16, N / 8, 2, 8, 8): k-step,
    n group, k half, n, k; element [s, ng, kh, n, k] is w[16 s + 8 kh + k, 8 ng + n].
    """
    k, n = w.shape
    return w.reshape(k // 16, 2, 8, n // 8, 8).permute(0, 3, 1, 4, 2).contiguous()


def trunk_operands(wp: torch.Tensor, upw: torch.Tensor, dnw: torch.Tensor) -> torch.Tensor:
    """
    The trunk's operand stream as bytes: patch_proj's 8 tiles (k16 x 192);
    then for each block and each of its four up passes p, the up product's
    12 tiles of hidden columns 96 p .. 96 p + 95 (k16 x 96) and the down
    product's 6 tiles of those hidden rows (k16 x 192).
    """
    parts = [kmajor_tiles(wp)]
    for up, down in zip(upw, dnw):
        for p in range(up.shape[1] // UP_N):
            parts.append(kmajor_tiles(up[:, p * UP_N : (p + 1) * UP_N]))
            parts.append(kmajor_tiles(down[p * UP_N : (p + 1) * UP_N]))
    return torch.cat([t.reshape(-1).view(torch.uint8) for t in parts])


def _with_bytes(head: torch.Tensor, behind: torch.Tensor) -> torch.Tensor:
    """A buffer of ``head``'s bytes followed by ``behind``'s; returns the view of its head."""
    raw = torch.cat([head.contiguous().view(torch.uint8).reshape(-1), behind])
    return raw.view(head.dtype)[: head.numel()].view(head.shape)


def _kernel_weights(net: EmbeddingNet) -> Dict[str, torch.Tensor]:
    """
    The net's weights in the kernel's types (bf16 matrices, f32 biases); wp
    and wh head buffers that hold the trunk's and the head's operand streams
    behind them.
    """
    cache = _cache(net)
    if "weights" not in cache:
        b16 = torch.bfloat16
        wp = net.patch_proj.w.to(b16).contiguous()
        upw = torch.stack([blk.up.w for blk in net.trunk]).to(b16).contiguous()
        dnw = torch.stack([blk.down.w for blk in net.trunk]).to(b16).contiguous()
        wh = net.head.w.to(b16).contiguous()
        cache["weights"] = {
            "wp": _with_bytes(wp, trunk_operands(wp, upw, dnw)),
            "bp": net.patch_proj.b.float().contiguous(),
            "upw": upw,
            "upb": torch.stack([blk.up.b for blk in net.trunk]).float().contiguous(),
            "dnw": dnw,
            "dnb": torch.stack([blk.down.b for blk in net.trunk]).float().contiguous(),
            "q": net.pool_query.to(b16).contiguous(),
            "wh": _with_bytes(wh, kmajor_tiles(wh).reshape(-1).view(torch.uint8)),
            "bh": net.head.b.float().contiguous(),
        }
    return cache["weights"]


def check_weights(w: Dict[str, torch.Tensor], n_blocks: int) -> None:
    """
    Raise unless ``w["wp"]`` and ``w["wh"]`` head buffers that hold the
    operand streams the kernels read behind them (``_kernel_weights``'s own):
    a copy made with ``clone``, ``contiguous`` or ``to`` ends at its last value.
    """
    for what, need in (("wp", WP_BYTES + trunk_ops_bytes(n_blocks)), ("wh", WH_BYTES + HEAD_OPS_BYTES)):
        t = w[what]
        held = t.untyped_storage().nbytes() - t.storage_offset() * t.element_size()
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or held < need:
            raise ValueError(
                f"the trunk kernels read {need} B from {what}'s buffer, which holds {held}: "
                "pass the tensors of _kernel_weights, not copies"
            )


def fused_embedding_plain(
    net: EmbeddingNet,
    patches: torch.Tensor,
    starts: Tuple[int, ...],
    num_patches: int,
    accumulate: torch.dtype = torch.float32,
) -> torch.Tensor:
    """
    The kernel's arithmetic in plain PyTorch: (b, p_pad, 128) -> (b, W, 96).
    ``accumulate=torch.float64`` sums the products in double precision: the
    chip check uses it to measure how far the float32 summation order alone
    moves the output through the bf16 rounding points.
    """

    def mm(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        return torch.matmul(a.to(accumulate), m.to(accumulate)).float()

    cfg = net.config
    b, p_pad, _ = patches.shape
    heads, hidden = cfg.pool_heads, cfg.hidden_dim
    n_windows = len(starts)
    w = _kernel_weights(net)
    pool = _pool_constants(net, starts, num_patches, p_pad)

    x = patches.reshape(b * p_pad, cfg.patch_dim).float()
    feats = _bf(mm(_bf(_rms(x)), w["wp"].float()) + w["bp"])
    for i in range(len(net.trunk)):
        h = mm(_bf(_rms(feats)), w["upw"][i].float()) + w["upb"][i]
        h = _bf(torch.nn.functional.gelu(h))  # exact erf GELU in float32
        d = _bf(mm(h, w["dnw"][i].float()) + w["dnb"][i])
        feats = _bf(feats + d)
    a = mm(feats, w["q"].float()).reshape(b, p_pad, heads)
    # the shift cancels in the ratio; the kernel takes the max over real patches
    a = a - a[:, :num_patches].max(dim=1, keepdim=True).values
    ea = torch.exp(a).permute(0, 2, 1)  # (b, H, P)
    e_sel = ea.repeat(1, n_windows, 1)  # row w*H + h holds head h
    bw = pool["band"][None] * e_sel  # (b, WH, P)
    weights = _bf(bw / (bw.sum(dim=2, keepdim=True) + 1e-30))
    feats3 = feats.reshape(b, p_pad, hidden)
    numer1 = mm(weights, feats3)  # (b, WH, D)
    numer2 = torch.einsum("bwp,wpd->bwd", weights.to(accumulate), pool["posp"].to(accumulate)).float()
    pooled = (numer1 + numer2).reshape(b * n_windows, heads * hidden)
    norm = _bf(_rms(pooled))
    out = mm(norm, w["wh"].float()) + w["bh"]
    return out.reshape(b, n_windows, cfg.embedding_dim)


def require_kernel_config(net: EmbeddingNet) -> None:
    """Raise unless ``net`` has the geometry the CUDA kernels are compiled for."""
    if net.config != KERNEL_CONFIG:
        raise ValueError(
            f"the CUDA kernel is built for {KERNEL_CONFIG.as_dict()}, not {net.config.as_dict()}"
        )


def launch_trunk(
    name: str,
    net: EmbeddingNet,
    inputs: Sequence[int],
    sizes: Sequence[int],
    b: int,
    p_pad: int,
    num_patches: int,
    starts: Tuple[int, ...],
) -> torch.Tensor:
    """
    Launch a kernel built on ``csrc/trunk_pool.cuh`` (K2 ``embedding_pool``,
    K4 ``featurize``) on the net's device and return its (b, W, 96) output.
    Its C entry takes the ``inputs`` pointers, then the output, the L2 scratch
    for features and scores, the weights and pooling constants; then the
    ``sizes`` ints, then p_pad, num_patches, W and the trunk depth.
    """
    require_kernel_config(net)
    cfg = net.config
    dev = net.pos.device
    pool = _pool_constants(net, starts, num_patches, p_pad)
    w = _kernel_weights(net)
    check_weights(w, len(net.trunk))
    out = torch.empty((b, len(starts), cfg.embedding_dim), device=dev, dtype=torch.float32)
    feats = torch.empty((b, p_pad, cfg.hidden_dim), device=dev, dtype=torch.bfloat16)
    scores = torch.empty((b, p_pad, cfg.pool_heads), device=dev, dtype=torch.float32)
    build.launch(
        name,
        dev,
        [*inputs, out.data_ptr(), feats.data_ptr(), scores.data_ptr()]
        + [w[k].data_ptr() for k in ("wp", "bp", "upw", "upb", "dnw", "dnb", "q", "wh", "bh")]
        + [pool[k].data_ptr() for k in ("exp_c", "pos_bf16", "p0")],
        [*sizes, p_pad, num_patches, len(starts), len(net.trunk)],
    )
    return out


def check_window_starts(
    cfg: EmbeddingNetConfig, window_starts: Sequence[int], num_patches: int
) -> Tuple[int, ...]:
    """The window starts as a tuple; raise unless each window is whole on the patch grid."""
    starts = tuple(int(s) for s in window_starts)
    if not starts or any(s % cfg.patch_frames for s in starts):
        raise ValueError("window starts must be non-empty and align to the patch grid")
    if min(starts) < 0 or max(starts) // cfg.patch_frames + cfg.window_patches > num_patches:
        raise ValueError("a window reaches past the last real patch")
    return starts


def fused_embedding_from_patches(
    net: EmbeddingNet,
    patches: torch.Tensor,
    window_starts: Sequence[int],
    num_patches: int,
) -> torch.Tensor:
    """
    (b, p_pad, 128) float32 patches (rows >= ``num_patches`` ignored) ->
    (b, W, 96) float32. Launches the CUDA kernel for a CUDA tensor, the plain
    version for a CPU one.
    """
    cfg = net.config
    if not isinstance(patches, torch.Tensor) or patches.dtype != torch.float32 or patches.ndim != 3:
        raise ValueError("fused_embedding_from_patches takes a 3-D float32 tensor")
    if not patches.is_contiguous():
        raise ValueError("fused_embedding_from_patches needs contiguous patches")
    b, p_pad, patch_dim = patches.shape
    if patch_dim != cfg.patch_dim:
        raise ValueError(f"patch dim {patch_dim} != config {cfg.patch_dim}")
    if not 1 <= num_patches <= p_pad or b < 1:
        raise ValueError(f"num_patches {num_patches} does not fit patches {tuple(patches.shape)}")
    starts = check_window_starts(cfg, window_starts, num_patches)
    if net.pos.device != patches.device:
        raise ValueError(f"net on {net.pos.device}, patches on {patches.device}")
    if patches.device.type == "cpu":
        return fused_embedding_plain(net, patches, starts, num_patches)
    if patches.device.type != "cuda":
        raise ValueError(f"fused_embedding_from_patches: unsupported device {patches.device}")
    if patches.data_ptr() % 16:
        raise ValueError("fused_embedding_from_patches needs 16-byte aligned patches (the kernel copies rows by TMA)")
    return launch_trunk("embedding_pool", net, [patches.data_ptr()], [b], b, p_pad, num_patches, starts)


def fused_embedding_windows(
    net: EmbeddingNet, spectrogram: torch.Tensor, window_starts: Sequence[int]
) -> torch.Tensor:
    """
    Spectrogram-layout entry to K2: (b, frames, 32) float32 scaled log-mel ->
    (b, W, 96). Cuts the spectrogram to whole patches, lays them out as the
    (b, p_pad, 128) patch tensor with zero pad rows, and runs
    ``fused_embedding_from_patches`` (the CUDA kernel for a CUDA tensor).
    """
    cfg = net.config
    if (
        not isinstance(spectrogram, torch.Tensor)
        or spectrogram.dtype != torch.float32
        or spectrogram.ndim != 3
    ):
        raise ValueError("fused_embedding_windows takes a 3-D float32 tensor")
    b, frames, mel = spectrogram.shape
    if mel != cfg.mel_bins:
        raise ValueError(f"mel bins {mel} != config {cfg.mel_bins}")
    num_patches = frames // cfg.patch_frames
    if num_patches < 1:
        raise ValueError(f"spectrogram of shape {tuple(spectrogram.shape)} holds no whole patch")
    p_pad = -(-num_patches // 8) * 8
    patches = spectrogram.new_zeros((b, p_pad, cfg.patch_dim))
    patches[:, :num_patches] = spectrogram[:, : num_patches * cfg.patch_frames].reshape(
        b, num_patches, cfg.patch_dim
    )
    return fused_embedding_from_patches(net, patches, window_starts, num_patches)
