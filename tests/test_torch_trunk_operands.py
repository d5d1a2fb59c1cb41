"""
The wgmma operand streams of the embedding trunk and head (K2, K4).

The kernels (``csrc/trunk_pool.cuh``) read the trunk's and the head's bf16
weights as streams of 6 KB slots of k16 x N operand tiles in wgmma's K-major
layout, laid out once on the host behind ``wp`` and ``wh`` in
``embedding_kernel._kernel_weights``. These tests walk the streams in the
order the kernels consume them, decode every tile, and hold the result to the
bf16 matrices of the same cache, bit for bit; they tie the streams' sizes to
the header's geometry and check that a copy of a weight buffer, which lacks
the streams, is refused.
"""

import os
import re

import numpy as np
import pytest
import torch

from heybuddy_tpu_torch.models.embedding_net import EmbeddingNet
from heybuddy_tpu_torch.ops.kernels import build
from heybuddy_tpu_torch.ops.kernels import embedding_kernel as ek


@pytest.fixture(scope="module")
def weights():
    torch.manual_seed(0)
    net = EmbeddingNet()
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(np.random.default_rng(7).normal(0.0, 0.5, p.shape).astype(np.float32)))
    return net, ek._kernel_weights(net)


def header_constants():
    """The integer constants of trunk_pool.cuh that the host streams depend on."""
    with open(os.path.join(build.CSRC, "trunk_pool.cuh")) as f:
        text = f.read()
    return {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def stream_of(t: torch.Tensor, offset: int) -> torch.Tensor:
    """The bytes of ``t``'s buffer from ``offset`` on."""
    storage = t.untyped_storage()
    raw = torch.empty(0, dtype=torch.uint8).set_(storage, t.storage_offset() * t.element_size(),
                                                  (storage.nbytes() - t.storage_offset() * t.element_size(),))
    return raw[offset:]


def decode_tile(raw: torch.Tensor, n: int) -> torch.Tensor:
    """One k16 x n operand tile (K-major, core matrices) -> the (16, n) bf16 block it holds."""
    tile = raw[: 16 * n * 2].view(torch.bfloat16).reshape(n // 8, 2, 8, 8)  # n group, k half, n, k
    return tile.permute(1, 3, 0, 2).reshape(16, n)


def walk(raw: torch.Tensor, slots: int, tiles_per_slot: int, n: int, consts) -> torch.Tensor:
    """Decode ``slots`` slots of the stream as the kernel reads them: (k, n) rows in k-step order."""
    slot, width = consts["SLOT"], 16 * n * 2
    rows = []
    for s in range(slots):
        for kk in range(tiles_per_slot):
            rows.append(decode_tile(raw[s * slot + kk * width :], n))
    return torch.cat(rows)


def geometry(c):
    """k-steps a slot and slots a product, as the header derives them."""
    hid, up_n, emb, slot = c["HID"], c["UP_N"], c["EMB"], c["SLOT"]
    hid_ks, up_ks, emb_ks = slot // (16 * hid * 2), slot // (16 * up_n * 2), slot // (16 * emb * 2)
    return {
        "hid_ks": hid_ks, "up_ks": up_ks, "emb_ks": emb_ks,
        "proj": c["PD"] // 16 // hid_ks, "up": hid // 16 // up_ks, "down": up_n // 16 // hid_ks,
        "head": c["HEADS"] * hid // 16 // emb_ks,
    }


def test_trunk_stream_maps_back_to_the_weights(weights):
    net, w = weights
    consts = header_constants()
    geo = geometry(consts)
    hid, up_n, slot = consts["HID"], consts["UP_N"], consts["SLOT"]
    raw = stream_of(w["wp"], ek.WP_BYTES)
    assert torch.equal(walk(raw, geo["proj"], geo["hid_ks"], hid, consts), w["wp"])
    off = geo["proj"] * slot
    for blk in range(len(net.trunk)):
        for p in range(consts["TH"] // up_n):
            up = walk(raw[off:], geo["up"], geo["up_ks"], up_n, consts)
            assert torch.equal(up, w["upw"][blk][:, p * up_n : (p + 1) * up_n]), (blk, p)
            off += geo["up"] * slot
            down = walk(raw[off:], geo["down"], geo["hid_ks"], hid, consts)
            assert torch.equal(down, w["dnw"][blk][p * up_n : (p + 1) * up_n]), (blk, p)
            off += geo["down"] * slot
    assert off == ek.trunk_ops_bytes(len(net.trunk)) == raw.numel()


def test_head_stream_maps_back_to_the_weights(weights):
    _, w = weights
    consts = header_constants()
    geo = geometry(consts)
    raw = stream_of(w["wh"], ek.WH_BYTES)
    assert raw.numel() == ek.HEAD_OPS_BYTES == geo["head"] * consts["SLOT"]
    assert torch.equal(walk(raw, geo["head"], geo["emb_ks"], consts["EMB"], consts), w["wh"])


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
def test_stream_sizes_are_what_the_kernels_read(n_blocks):
    c = header_constants()
    geo = geometry(c)
    pd, hid, emb, up_n, slot = c["PD"], c["HID"], c["EMB"], c["UP_N"], c["SLOT"]
    block_slots = c["TH"] // up_n * (geo["up"] + geo["down"])
    assert geo["hid_ks"] * 16 * hid * 2 == geo["up_ks"] * 16 * up_n * 2 == geo["emb_ks"] * 16 * emb * 2 == slot
    assert ek.trunk_ops_bytes(n_blocks) == (geo["proj"] + n_blocks * block_slots) * slot
    assert ek.HEAD_OPS_BYTES == geo["head"] * slot
    assert (ek.WP_BYTES, ek.WH_BYTES, ek.UP_N) == (pd * hid * 2, c["HEADS"] * hid * emb * 2, up_n)
    # the ring holds a product phase and a slot held by each warpgroup
    assert c["RING"] >= max(geo["proj"], geo["up"], geo["down"]) + 2


@pytest.mark.parametrize("what", ["wp", "wh"])
@pytest.mark.parametrize("copy", [torch.clone, lambda t: t.to(torch.float32).to(torch.bfloat16),
                                  lambda t: t.t().contiguous().t()])
def test_a_copy_of_a_weight_buffer_is_refused(weights, what, copy):
    net, w = weights
    ek.check_weights(w, len(net.trunk))
    with pytest.raises(ValueError, match=f"{what}'s buffer"):
        ek.check_weights({**w, what: copy(w[what])}, len(net.trunk))


def test_the_trunk_stream_follows_the_depth(weights):
    net, w = weights
    with pytest.raises(ValueError, match="wp's buffer"):
        ek.check_weights(w, len(net.trunk) + 1)


def test_kmajor_tiles_places_each_element():
    w = torch.arange(32 * 24, dtype=torch.float32).reshape(32, 24)
    tiles = ek.kmajor_tiles(w)
    assert tiles.shape == (2, 3, 2, 8, 8)
    for s, ng, kh, n, k in [(0, 0, 0, 0, 0), (1, 2, 1, 7, 5), (0, 1, 1, 3, 2)]:
        assert tiles[s, ng, kh, n, k] == w[16 * s + 8 * kh + k, 8 * ng + n]


def test_a_launch_with_a_cache_that_lacks_the_streams_raises(weights, monkeypatch):
    """The kernels' launch path refuses, before any build, a net whose cached
    weight buffers were replaced by copies."""
    net, w = weights
    cache = ek._cache(net)
    monkeypatch.setitem(cache, "weights", {**w, "wh": w["wh"].clone()})
    monkeypatch.setattr(ek.build, "launch", lambda *a, **k: pytest.fail("launched without the streams"))
    starts = (0,)
    with pytest.raises(ValueError, match="wh's buffer"):
        ek.launch_trunk("embedding_pool", net, [0], [1], 1, 24, 19, starts)
