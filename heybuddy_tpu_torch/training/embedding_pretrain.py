"""
Self-supervised pretraining of the speech-embedding network.

Counterpart of the JAX package's ``training/embedding_pretrain.py``: the
contrastive objective (NT-Xent) pulls two views of one utterance together
(two speaker renderings, each through its own augmentation draws: noise,
reverb, EQ, placement) and pushes the other utterances of the batch away;
the hard-pair margin loss also pushes apart renderings of phonetic-neighbour
texts ("hey buddy" / "hey bunny"). The trained npz is what
``HEYBUDDY_EMBEDDING_WEIGHTS`` selects in either package, and what
``export_mel_spectrogram`` / ``export_embedding_net`` ship to the browser.

The clip pool (texts x speakers renderings, synthesised once) and the noise
and impulse banks are uploaded to the device once; each step uploads only
its indices and pair mask. A step, on the device: gather both views from the
pool -> ``ops.augment.augment_batch`` per view -> the mel spectrogram of
``view * 32767`` (K3, ``melspec_kernel.mel_spectrogram``, on a CUDA device)
-> ``EmbeddingNet.apply_spectrogram`` in bf16 compute, the mean over its 16
windows -> NT-Xent + ``hard_pair_weight`` x the margin loss -> autograd ->
``torch.optim.Adam``. The mel has no parameters, so no gradient flows
through K3; the embedding's forward and backward are plain PyTorch, as the
JAX step's are plain XLA. The loss is fetched to the host only at the
logged steps, so no other step waits for the device.

Randomness: the text pool, the clip pool's per-rendering draws and every
step's indices, speaker pairs, bank rows and pair masks come from numpy
generators seeded as the JAX package seeds them, so they equal its values.
The augmentation draws come from ``seeded_generator(device, seed, 13, step,
view)`` (``jax.random`` cannot be reproduced), and ``init_params`` draws the
initial weights from a ``torch.Generator`` seeded with ``seed``; tests inject
the JAX draws (``step(..., draws=...)``) and start from its parameters
(``init_weights``).

``mesh`` (``parallel.get_mesh``) shards pretraining over the mesh's data
axis, as the JAX pretrainer's mesh does: the clip pool's text axis is padded
to a multiple of the data axis and each rank holds its share of the texts;
a step gathers the batch's clips across the ranks (each contributes the
rows it owns, one ``all_reduce``), every rank draws the augmentation of the
whole batch from the same generator and keeps its rows of the views, runs
K3 and the embedding on them, and gathers ``z1`` / ``z2`` with autograd to
build the (2b, 2b) NT-Xent and the margin loss, the same loss on every
rank. The gather's backward sums the ranks' upstream gradients, which are
equal, so each rank's gradient comes out W times the loss's: the summed
parameter gradient is divided by W before Adam. ``batch_size`` must divide
over the data axis, as in the JAX package.

Left out on purpose: ``steps_per_call`` (the JAX package runs several steps
per dispatch under ``lax.scan`` to amortise a remote device's per-call cost;
eager PyTorch queues each step without a host round trip, so there is
nothing to amortise).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from heybuddy_tpu_torch.constants import CLIP_SAMPLES
from heybuddy_tpu_torch.convert import embedding_params_from_numpy
from heybuddy_tpu_torch.device import DeviceLike, resolve_device
from heybuddy_tpu_torch.models import embedding_net
from heybuddy_tpu_torch.models.embedding_net import EmbeddingNet
from heybuddy_tpu_torch.ops.augment import AugmentConfig, Draws, augment_batch, seeded_generator
from heybuddy_tpu_torch.ops.kernels.melspec_kernel import mel_spectrogram
from heybuddy_tpu_torch.ops.windows import embedding_window_starts
from heybuddy_tpu_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce_sum
from heybuddy_tpu_torch.utils.log import logger
from heybuddy_tpu_torch.utils.profiling import stage_timer

__all__ = [
    "EmbeddingPretrainer",
    "PretrainBatch",
    "nt_xent_loss",
    "hard_pair_margin_loss",
    "clip_embedding",
    "contrastive_loss",
    "pretrain_views",
]

# the generator namespace of the augmentation draws: (seed, 13, step, view)
DRAW_NAMESPACE = 13
NOISE_BANK_ROWS = 256
IMPULSE_BANK_ROWS = 64


def _unit(z: torch.Tensor) -> torch.Tensor:
    return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-8)


def nt_xent_loss(z1: torch.Tensor, z2: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """Normalised-temperature cross-entropy over both views (SimCLR)."""
    z = torch.cat([_unit(z1), _unit(z2)], dim=0)  # (2b, d)
    b = z1.shape[0]
    logits = (z @ z.T) / temperature
    logits = logits - 1e9 * torch.eye(2 * b, device=z.device, dtype=z.dtype)  # mask self-similarity
    labels = torch.cat([torch.arange(b, device=z.device) + b, torch.arange(b, device=z.device)])
    return -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None]).mean()


def hard_pair_margin_loss(
    z1: torch.Tensor, z2: torch.Tensor, pair_mask: torch.Tensor, margin: float = 0.4
) -> torch.Tensor:
    """
    Cosine-margin repulsion of phonetic-neighbour pairs: ``pair_mask`` (b, b)
    is True where texts i and j are different members of one cluster, and
    every view combination of such a pair must sit below ``margin`` cosine
    similarity (a squared hinge, averaged over the masked entries).
    """
    z = torch.cat([_unit(z1), _unit(z2)], dim=0)  # (2b, d)
    sims = z @ z.T
    mask4 = pair_mask.repeat(2, 2)  # the pair repels in all 4 view quadrants
    viol = torch.where(mask4, torch.clamp(sims - margin, min=0.0), torch.zeros_like(sims))
    return torch.sum(viol * viol) / torch.clamp(mask4.sum().to(sims.dtype), min=1.0)


class PretrainBatch(NamedTuple):
    """One step's host-drawn indices (the JAX step's arguments)."""

    text_idx: np.ndarray  # (b,) pool text rows
    spk_idx: np.ndarray  # (b, 2) the two views' speaker columns
    noise_idx: np.ndarray  # (2, b) noise-bank rows per view
    imp_idx: np.ndarray  # (2, b) impulse-bank rows per view
    pair_mask: np.ndarray  # (b, b) bool, same-cluster pairs


def clip_embedding(net: EmbeddingNet, audio: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(b, t) audio in [-1, 1] -> (b, 96): K3's mel of the int16-range audio, the
    gather formulation, the mean over the embedding windows."""
    spec = mel_spectrogram(audio * 32767.0)
    windows = net.apply_spectrogram(spec, embedding_window_starts(audio.shape[1]), compute_dtype=compute_dtype)
    return windows.mean(dim=1)


def contrastive_loss(
    z1: torch.Tensor, z2: torch.Tensor, pair_mask: torch.Tensor, temperature: float, margin: float, hard_weight: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(NT-Xent + ``hard_weight`` x the margin loss, NT-Xent, the margin loss) of the two views' embeddings."""
    base = nt_xent_loss(z1, z2, temperature)
    hard = hard_pair_margin_loss(z1, z2, pair_mask, margin)
    return base + hard_weight * hard, base, hard


def _sharded_clips(
    resident: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], mesh: Mesh
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both views' (2, b, t) clips and (2, b) lengths on every rank, from a pool
    whose texts are sharded over the data axis: each rank fills the rows of
    the texts it holds, zeros elsewhere, and one sum over the ranks completes them."""
    shard = resident["pool"].shape[0]
    local = batch["text_idx"] - mesh.rank * shard
    mine = (local >= 0) & (local < shard)
    rows = local.clamp(0, shard - 1)[None, :]
    spk = batch["spk_idx"].T  # (2, b)
    clips = torch.where(mine[None, :, None], resident["pool"][rows, spk], 0.0)
    lengths = torch.where(mine[None, :], resident["lengths"][rows, spk], 0)
    return all_reduce_sum(clips, mesh), all_reduce_sum(lengths, mesh)


def pretrain_views(
    resident: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    augment_config: AugmentConfig,
    generators: Optional[Tuple[torch.Generator, torch.Generator]] = None,
    draws: Optional[Tuple[Draws, Draws]] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    One step's two augmented views on the device: ``resident`` holds "pool"
    (texts, speakers, t), "lengths", "noise" and "impulse" banks; ``batch``
    the uploaded ``PretrainBatch`` (``EmbeddingPretrainer.upload``). Each view
    draws its augmentation from its generator, or takes injected ``draws``.
    Under ``mesh`` the pool holds this rank's texts: every rank augments the
    whole batch with the same draws and returns its rows of both views.
    """
    text_idx = batch["text_idx"]
    if mesh is not None:
        clips, lengths = _sharded_clips(resident, batch, mesh)
    views = []
    for v in range(2):
        spk = batch["spk_idx"][:, v]
        views.append(augment_batch(
            resident["pool"][text_idx, spk] if mesh is None else clips[v],
            resident["lengths"][text_idx, spk] if mesh is None else lengths[v],
            resident["noise"][batch["noise_idx"][v]], resident["impulse"][batch["imp_idx"][v]],
            augment_config,
            generator=None if generators is None else generators[v],
            draws=None if draws is None else draws[v],
        ))
    if mesh is not None:
        per = text_idx.shape[0] // mesh.size
        views = [view[mesh.rank * per : (mesh.rank + 1) * per] for view in views]
    return views[0], views[1]


class EmbeddingPretrainer:
    """Contrastive pretraining of the embedding network on ``device``."""

    def __init__(
        self,
        texts: Optional[Sequence[str]] = None,
        num_texts: int = 512,
        speakers_per_text: int = 4,
        batch_size: int = 64,
        temperature: float = 0.1,
        learning_rate: float = 1e-3,
        augment_config: Optional[AugmentConfig] = None,
        tts_backend: Optional[str] = None,
        seed: int = 0,
        config: Optional[embedding_net.EmbeddingNetConfig] = None,
        init_weights: Optional[str] = None,
        adversarial_fraction: float = 0.0,
        focus_phrase: Optional[str] = None,
        focus_swap_depth: int = 0,
        focus_swap_max_swaps: int = 1,
        hard_pair_margin: float = 0.4,
        hard_pair_weight: float = 1.0,
        cluster_slots_fraction: float = 0.25,
        device: DeviceLike = "cuda",
        mesh: Optional[Mesh] = None,
    ) -> None:
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        if texts is not None:
            self.texts = list(texts)
            self.cluster_ids = np.full(len(self.texts), -1, dtype=np.int64)
        else:
            self.texts, self.cluster_ids = self._default_texts(
                num_texts, seed, adversarial_fraction, focus_phrase, focus_swap_depth, focus_swap_max_swaps,
            )
        self.focus_phrase = focus_phrase
        self.hard_pair_margin = hard_pair_margin
        self.hard_pair_weight = hard_pair_weight
        self.cluster_slots_fraction = cluster_slots_fraction
        if mesh is not None and batch_size % mesh.size != 0:
            raise ValueError(
                f"batch_size ({batch_size}) must divide evenly over the mesh "
                f"data axis ({mesh.size} devices)"
            )
        if batch_size > len(self.texts):
            # fail before the clip pool's synthesis: the batch draws texts without replacement
            raise ValueError(
                f"batch_size ({batch_size}) exceeds the text pool "
                f"({len(self.texts)}); pass more texts or a smaller batch"
            )
        self.speakers_per_text = speakers_per_text
        self.batch_size = batch_size
        self.temperature = temperature
        self.config = config or embedding_net.EmbeddingNetConfig()
        # gentler SNRs than the wake-word chain, so positives stay learnable early on
        self.augment_config = augment_config or AugmentConfig(
            background_noise_min_snr_db=0.0,
            background_noise_max_snr_db=20.0,
            reverb_prob=0.5,
        )
        self.tts_backend = tts_backend
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        if init_weights is not None:
            self.params = embedding_net.load_params(init_weights)
            logger.info(f"Warm-starting pretraining from {init_weights}")
        else:
            self.params = embedding_net.init_params(torch.Generator().manual_seed(seed), self.config)
        self.net = embedding_params_from_numpy(self.params).to(self.device).requires_grad_(True)
        self.optimizer = torch.optim.Adam(self.net.parameters(), lr=learning_rate)
        self._pool: Optional[np.ndarray] = None
        self._pool_lengths: Optional[np.ndarray] = None
        self._resident: Optional[Dict[str, torch.Tensor]] = None

    @staticmethod
    def _default_texts(
        num_texts: int,
        seed: int,
        adversarial_fraction: float = 0.0,
        focus_phrase: Optional[str] = None,
        focus_swap_depth: int = 0,
        focus_swap_max_swaps: int = 1,
    ) -> Tuple[List[str], np.ndarray]:
        """
        Random 1-3 word phrases from the bundled lexicon, deduplicated, and
        their cluster ids (-1: a random filler). ``adversarial_fraction``
        turns that share of the pool into clusters of a base phrase and 3
        near-collisions (``text/adversarial.py``). ``focus_phrase`` builds
        cluster 0: the phrase and 11 of its near-collisions, plus
        ``focus_swap_depth`` texts with at most ``focus_swap_max_swaps`` of
        its words swapped for phonetic neighbours; the sampler puts it in
        every batch. Equal to the JAX function for the same arguments.
        """
        from heybuddy_tpu_torch.text.wordlist import WORDS

        rng = np.random.default_rng(seed + 7)
        words = sorted(set(WORDS))
        cluster_size = 4  # base + 3 neighbours
        n_clusters = int(num_texts * adversarial_fraction) // cluster_size
        texts: List[str] = []
        cluster_of: List[int] = []
        seen: set = set()

        def add(text: str, cluster: int = -1) -> bool:
            # a duplicate could land in one batch as a negative of itself
            if text and text not in seen:
                seen.add(text)
                texts.append(text)
                cluster_of.append(cluster)
                return True
            return False

        def add_random(max_words: int = 3, cluster: int = -1) -> None:
            for _ in range(100):
                n = int(rng.integers(1, max_words + 1))
                if add(" ".join(rng.choice(words, size=n, replace=False)), cluster):
                    return

        next_cluster = 0
        if focus_phrase:
            from heybuddy_tpu_torch.text.adversarial import get_adversarial_text_generator

            adv = get_adversarial_text_generator()
            focus_size = 12  # the phrase + a deep near-collision pool
            add(focus_phrase, cluster=0)
            for neighbor in adv(focus_phrase, num_samples=focus_size - 1, seed=seed + 997):
                add(neighbor, cluster=0)
            if focus_swap_depth > 0:
                from heybuddy_tpu_torch.text.adversarial import single_swap_collision_texts

                for text in single_swap_collision_texts(
                    focus_phrase, num_samples=focus_swap_depth, seed=seed + 991, max_swaps=focus_swap_max_swaps,
                ):
                    add(text, cluster=0)
            next_cluster = 1

        for _ in range(num_texts - n_clusters * cluster_size - len(texts)):
            add_random()
        if n_clusters > 0:
            from heybuddy_tpu_torch.text.adversarial import get_adversarial_text_generator

            adv = get_adversarial_text_generator()
            for c in range(n_clusters):
                cid = next_cluster + c
                before = len(texts)
                for _ in range(100):
                    n = int(rng.integers(1, 3))
                    base = " ".join(rng.choice(words, size=n, replace=False))
                    if base not in seen:
                        break
                add(base, cid)
                for neighbor in adv(base, num_samples=cluster_size - 1, seed=seed + 31 * c):
                    add(neighbor, cid)
                for _ in range(4 * cluster_size):  # top up a short or duplicate neighbour list
                    if len(texts) >= before + cluster_size:
                        break
                    add_random(cluster=cid)
        return texts, np.asarray(cluster_of, dtype=np.int64)

    def build_clip_pool(self) -> None:
        """
        Synthesise ``speakers_per_text`` renderings of every text on the host
        (numpy pool): each rendering draws its own speaker pair and prosody
        (slerp weight, length, noise scales) from ``seed + 104729``, all
        drawn before any rendering, then peak-normalised through int16 with
        its zero edges trimmed, as ``BaseTTS.__call__`` does. The
        ``formant-device`` backend plans and renders 256 clips a batch
        (``DeviceFormantTTS.plan_voices`` / ``render_items``: the clips the
        device cannot express render on the host), each clip as a one-clip
        ``synthesize_batch`` would; the host backends render each clip from
        its own seed on a pool of threads, equal to rendering them in turn.
        """
        from heybuddy_tpu_torch.constants import (
            DEFAULT_TTS_LENGTH_SCALES,
            DEFAULT_TTS_NOISE_SCALE_WEIGHTS,
            DEFAULT_TTS_NOISE_SCALES,
            DEFAULT_TTS_SLERP_WEIGHTS,
            SAMPLE_RATE,
        )
        from heybuddy_tpu_torch.models.tts import DeviceFormantTTS, get_tts_model
        from heybuddy_tpu_torch.utils.audio_io import resample_audio

        tts = get_tts_model(backend=self.tts_backend, device=self.device)
        n_texts, n_speakers = len(self.texts), tts.num_speakers
        pool = np.zeros((n_texts, self.speakers_per_text, CLIP_SAMPLES), dtype=np.float32)
        lengths = np.zeros((n_texts, self.speakers_per_text), dtype=np.int32)
        logger.info(
            f"Synthesizing clip pool: {n_texts} texts x {self.speakers_per_text} speakers "
            f"(random speaker + prosody per rendering, {n_speakers} voices)"
        )
        rng = np.random.default_rng(self.seed + 104729)
        tasks = []
        for i, text in enumerate(self.texts):
            for j in range(self.speakers_per_text):
                s_pair = (int(rng.integers(n_speakers)), int(rng.integers(n_speakers)))
                tasks.append((
                    i, j, text, s_pair,
                    float(rng.choice(DEFAULT_TTS_SLERP_WEIGHTS)),
                    float(rng.choice(DEFAULT_TTS_LENGTH_SCALES)),
                    float(rng.choice(DEFAULT_TTS_NOISE_SCALES)),
                    float(rng.choice(DEFAULT_TTS_NOISE_SCALE_WEIGHTS)),
                    self.seed + i * 131 + j,
                ))

        def store(i: int, j: int, clip: np.ndarray) -> None:
            if tts.sample_rate != SAMPLE_RATE:
                clip = resample_audio(clip, tts.sample_rate, SAMPLE_RATE)
            peak = max(0.01, float(np.abs(clip).max()))
            pcm = np.clip(clip * (32767.0 / peak), -32768, 32767).astype(np.int16)
            clip = np.trim_zeros(pcm).astype(np.float32) / 32768.0
            n = min(len(clip), CLIP_SAMPLES)
            pool[i, j, :n] = clip[:n]
            lengths[i, j] = n

        with stage_timer("pretrain/clip_pool"):
            if isinstance(tts, DeviceFormantTTS):
                chunk = 256
                for c0 in range(0, len(tasks), chunk):
                    batch = tasks[c0:c0 + chunk]
                    voices = [tts.voice(text, s_pair, slerp, ls, ns, seed)
                              for (_i, _j, text, s_pair, slerp, ls, ns, _nsw, seed) in batch]
                    for (i, j, *_), clip in zip(batch, tts.render_items(tts.plan_voices(voices))):
                        store(i, j, clip)
            else:
                def render(task: Tuple) -> np.ndarray:
                    _i, _j, text, s_pair, slerp, ls, ns, nsw, seed = task
                    clips = tts.synthesize_batch([text], [s_pair], slerp_weight=slerp, length_scale=ls,
                                                 noise_scale=ns, noise_scale_w=nsw, seed=seed)
                    return np.asarray(clips[0], dtype=np.float32)

                with ThreadPoolExecutor(max_workers=min(os.cpu_count() or 1, 8)) as threads:
                    for task, clip in zip(tasks, threads.map(render, tasks)):
                        store(task[0], task[1], clip)
        self._pool = pool
        self._pool_lengths = lengths

    def resident(self) -> Dict[str, torch.Tensor]:
        """The clip pool, its lengths and the noise / impulse banks on the
        device, uploaded once (the banks from a ``NoiseProvider`` seeded with
        ``seed``, the JAX package's synthetic banks offline). Under a mesh the
        pool's text axis is padded to a multiple of the data axis (zero clips
        of length 1, which the sampler never draws) and this rank holds its
        share of the texts; the banks are replicated."""
        if self._resident is None:
            if self._pool is None:
                self.build_clip_pool()
            from heybuddy_tpu_torch.data.augmented import NoiseProvider

            pool, lengths = self._pool, self._pool_lengths.astype(np.int64)
            if self.mesh is not None:
                pad = (-len(pool)) % self.mesh.size
                pool = np.concatenate([pool, np.zeros_like(pool[:pad])])
                lengths = np.concatenate([lengths, np.ones_like(lengths[:pad])])
                shard = len(pool) // self.mesh.size
                pool = pool[self.mesh.rank * shard : (self.mesh.rank + 1) * shard]
                lengths = lengths[self.mesh.rank * shard : (self.mesh.rank + 1) * shard]
            with stage_timer("pretrain/upload"):
                provider = NoiseProvider(seed=self.seed, use_remote=self.augment_config.background_noise_prob > 0)
                dev = self.device
                self._resident = {
                    "pool": torch.from_numpy(np.ascontiguousarray(pool)).to(dev),
                    "lengths": torch.from_numpy(np.ascontiguousarray(lengths)).to(dev),
                    "noise": torch.from_numpy(provider.noise_batch(NOISE_BANK_ROWS)).to(dev),
                    "impulse": torch.from_numpy(provider.impulse_batch(IMPULSE_BANK_ROWS)).to(dev),
                }
        return self._resident

    def _cluster_members(self) -> Dict[int, np.ndarray]:
        """cluster id -> member text indices."""
        return {int(cid): np.flatnonzero(self.cluster_ids == cid) for cid in np.unique(self.cluster_ids) if cid >= 0}

    def _sample_batch(self, cluster_members: Dict[int, np.ndarray], n_texts: int) -> np.ndarray:
        """
        Text indices with guaranteed cluster co-occurrence: a
        ``cluster_slots_fraction`` share of the batch is whole clusters (the
        focus cluster, id 0, in every batch, capped at half of it), the rest
        uniform without replacement.
        """
        if not cluster_members or self.cluster_slots_fraction <= 0:
            return self.rng.choice(n_texts, size=self.batch_size, replace=False)
        chosen: List[np.ndarray] = []
        if self.focus_phrase is not None and 0 in cluster_members:
            chosen.append(cluster_members[0][: self.batch_size // 2])
        other = [cid for cid in cluster_members if not (self.focus_phrase is not None and cid == 0)]
        budget = int(self.batch_size * self.cluster_slots_fraction)
        used = 0
        for cid in self.rng.permutation(other):
            members = cluster_members[int(cid)]
            if used + len(members) > budget:
                continue  # a smaller cluster may still fit
            chosen.append(members)
            used += len(members)
            if used >= budget:
                break
        taken = np.concatenate(chosen) if chosen else np.empty(0, np.int64)
        mask = np.ones(n_texts, dtype=bool)
        mask[taken] = False
        filler = self.rng.choice(np.flatnonzero(mask), size=self.batch_size - len(taken), replace=False)
        return self.rng.permutation(np.concatenate([taken, filler]))

    def sample_step(self, cluster_members: Dict[int, np.ndarray], n_texts: int, n_speakers: int) -> PretrainBatch:
        """One step's indices, drawn from ``rng`` in the JAX loop's order."""
        text_idx = self._sample_batch(cluster_members, n_texts)
        ids = self.cluster_ids[text_idx]
        pair_mask = (ids[:, None] == ids[None, :]) & (ids[:, None] >= 0)
        np.fill_diagonal(pair_mask, False)
        spk = np.stack([
            self.rng.choice(n_speakers, size=2, replace=n_speakers < 2) for _ in range(self.batch_size)
        ])
        noise_idx = self.rng.integers(0, NOISE_BANK_ROWS, (2, self.batch_size))
        imp_idx = self.rng.integers(0, IMPULSE_BANK_ROWS, (2, self.batch_size))
        return PretrainBatch(text_idx, spk, noise_idx, imp_idx, pair_mask)

    def upload(self, batch: PretrainBatch) -> Dict[str, torch.Tensor]:
        """A step's indices and pair mask on the device, in one host-to-device copy."""
        b = len(batch.text_idx)
        flat = np.concatenate([
            batch.text_idx, batch.spk_idx.T.ravel(), batch.noise_idx.ravel(), batch.imp_idx.ravel(),
            batch.pair_mask.ravel(),
        ]).astype(np.int64)
        t = torch.from_numpy(flat).to(self.device)
        return {
            "text_idx": t[:b],
            "spk_idx": t[b:3 * b].view(2, b).T,
            "noise_idx": t[3 * b:5 * b].view(2, b),
            "imp_idx": t[5 * b:7 * b].view(2, b),
            "pair_mask": t[7 * b:].view(b, b).bool(),
        }

    def loss(
        self,
        batch: PretrainBatch,
        step: int,
        draws: Optional[Tuple[Draws, Draws]] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One step's (loss, nt-xent, hard-pair) on the device, before its
        update: the two views (their draws from ``seeded_generator(device,
        seed, 13, step, view)``, or ``draws``), K3 and the embedding per
        view, then the losses."""
        generators = None if draws is not None else tuple(
            seeded_generator(self.device, self.seed, DRAW_NAMESPACE, step, v) for v in range(2))
        uploaded = self.upload(batch)
        views = pretrain_views(self.resident(), uploaded, self.augment_config, generators, draws, self.mesh)
        z1, z2 = (clip_embedding(self.net, view, compute_dtype) for view in views)
        if self.mesh is not None:
            z1, z2 = all_gather_rows(z1, self.mesh), all_gather_rows(z2, self.mesh)
        return contrastive_loss(z1, z2, uploaded["pair_mask"], self.temperature, self.hard_pair_margin,
                                self.hard_pair_weight)

    def step(
        self,
        batch: PretrainBatch,
        step: int,
        draws: Optional[Tuple[Draws, Draws]] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
    ) -> torch.Tensor:
        """One training step (loss, backward, Adam); returns the device tensor
        [loss, nt-xent, hard-pair], not synchronised."""
        loss, base, hard = self.backward(batch, step, draws, compute_dtype)
        self.optimizer.step()
        return torch.stack([loss, base, hard]).detach()

    def backward(
        self,
        batch: PretrainBatch,
        step: int,
        draws: Optional[Tuple[Draws, Draws]] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The step's losses, with the whole batch's gradient in the
        parameters' ``.grad`` (under a mesh, summed over the ranks and divided
        by the W-fold sum of the gathers' backward)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, base, hard = self.loss(batch, step, draws, compute_dtype)
        loss.backward()
        if self.mesh is not None:
            params = list(self.net.parameters())
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            flat = all_reduce_sum(flat, self.mesh) / self.mesh.size
            for p, g in zip(params, flat.split([p.numel() for p in params])):
                p.grad.copy_(g.view_as(p))
        return loss, base, hard

    def train(self, steps: int = 1000, log_every: int = 50) -> Dict[str, Any]:
        """Run contrastive training; returns the trained parameter tree (numpy).
        Logs the loss at every ``log_every``-th step and the last."""
        self.resident()
        n_texts, n_speakers, _ = self._pool.shape  # the real texts: a mesh pads and shards the device pool
        cluster_members = self._cluster_members()
        with stage_timer("pretrain/steps"):
            for i in range(steps):
                with stage_timer("pretrain/sample"):
                    batch = self.sample_step(cluster_members, n_texts, n_speakers)
                with stage_timer("pretrain/step"):
                    metrics = self.step(batch, i)
                if i % log_every == 0 or i == steps - 1:
                    with stage_timer("pretrain/log"):
                        m = metrics.cpu().numpy()  # waits for this step
                    logger.info(
                        f"pretrain step {i}/{steps}: loss {m[0]:.4f} (nt-xent {m[1]:.4f}, hard-pair {m[2]:.4f})"
                    )
            self.params = embedding_net.unflatten_params(embedding_net.flatten_params(self.net))
        return self.params

    def save(self, path: str) -> None:
        embedding_net.save_params(self.params, path)
        logger.info(f"Saved pretrained embedding weights to {path}")
