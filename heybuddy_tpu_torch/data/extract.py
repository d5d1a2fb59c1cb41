"""
Offline extraction of labeled negative-feature shards from audio datasets.

Counterpart of the JAX package's ``data/extract.py``: stream an audio dataset
(a Hugging Face dataset or local WAV files with sidecar transcripts), window
it into 1.44 s clips (the tail zero-padded, dropped when shorter than a
quarter clip), featurize each clip to (16, 96) on the device, append the
transcript's token ids as row 17, and flush ``[n, 17, 96]`` float32 shards to
numbered appendable ``.npy`` files. Shard names, row counts and token rows
equal the JAX package's for the same input.

With ``mesh`` (``extract --mesh``) every rank reads the whole source and
featurizes its rows of each batch through ``SpeechEmbeddings(mesh=...)``;
rank 0 alone writes the shards, whose bytes equal the one-rank run's, and
the other ranks wait for it at the end.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

from heybuddy_tpu_torch.constants import CLIP_SAMPLES, SAMPLE_RATE
from heybuddy_tpu_torch.device import DeviceLike, resolve_device
from heybuddy_tpu_torch.parallel.mesh import Mesh, barrier, is_main_process
from heybuddy_tpu_torch.text.tokens import BERTTokenizer
from heybuddy_tpu_torch.utils.audio_io import resample_audio
from heybuddy_tpu_torch.utils.codecs import read_wav_any
from heybuddy_tpu_torch.utils.log import logger
from heybuddy_tpu_torch.utils.npy import AppendableNpyFile

__all__ = ["LabeledFeatureExtractor", "iter_hf_dataset", "iter_wav_files"]


def iter_hf_dataset(
    repo_id: str,
    config: Optional[str] = None,
    split: str = "train",
    streaming: bool = True,
    audio_key: str = "audio",
    audio_array_key: str = "array",
    audio_sample_rate_key: str = "sampling_rate",
    transcript_key: str = "transcript",
    trust_remote_code: bool = False,
) -> Iterator[Dict[str, Any]]:
    """Stream (audio, transcript) samples of a Hugging Face dataset (needs ``datasets``)."""
    from datasets import load_dataset

    dataset = load_dataset(
        repo_id, config, split=split, streaming=streaming, trust_remote_code=trust_remote_code
    )
    for sample in dataset:
        audio = sample[audio_key]
        yield {
            "array": np.asarray(audio[audio_array_key], dtype=np.float32),
            "sampling_rate": int(audio[audio_sample_rate_key]),
            "transcript": str(sample.get(transcript_key, "")),
        }


def iter_wav_files(paths: Iterable[str]) -> Iterator[Dict[str, Any]]:
    """Local-file source: WAV files, the transcript from a sidecar ``.txt`` if present."""
    for path in paths:
        audio, rate = read_wav_any(path)
        transcript = ""
        sidecar = os.path.splitext(path)[0] + ".txt"
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                transcript = f.read().strip()
        yield {"array": audio.mean(axis=0), "sampling_rate": rate, "transcript": transcript}


class LabeledFeatureExtractor:
    """Window + featurize + tokenize a sample stream into labeled shards."""

    def __init__(
        self,
        directory: str,
        name: str,
        samples_per_file: int = 10000,
        process_batch_size: int = 128,
        tokenizer_max_length: int = 96,
        sample_rate: int = SAMPLE_RATE,
        clip_samples: int = CLIP_SAMPLES,
        device: DeviceLike = "cuda",
        mesh: Optional[Mesh] = None,
    ) -> None:
        self.mesh = mesh
        self.directory = directory
        self.name = name
        self.samples_per_file = samples_per_file
        self.process_batch_size = process_batch_size
        self.sample_rate = sample_rate
        self.clip_samples = clip_samples
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.tokenizer = BERTTokenizer(length=tokenizer_max_length)
        os.makedirs(directory, exist_ok=True)

    def windows(self, audio: np.ndarray) -> Iterator[np.ndarray]:
        """Chunk into ``clip_samples`` windows, zero-padding the tail; drop a tail under a quarter."""
        for start in range(0, max(len(audio), 1), self.clip_samples):
            chunk = audio[start : start + self.clip_samples]
            if len(chunk) < self.clip_samples // 4:
                break
            if len(chunk) < self.clip_samples:
                chunk = np.pad(chunk, (0, self.clip_samples - len(chunk)))
            yield chunk.astype(np.float32)

    def __call__(
        self,
        source: Iterable[Dict[str, Any]],
        max_hours: float = 1000.0,
        on_progress: Optional[Callable[[float, float], None]] = None,
    ) -> List[str]:
        """Process the stream; returns the list of shard paths written."""
        from heybuddy_tpu_torch.models.featurizer import SpeechEmbeddings, get_speech_embeddings

        if self.mesh is not None:
            embeddings: Any = SpeechEmbeddings(mesh=self.mesh)
        else:
            embeddings = get_speech_embeddings(device=self.device)
        writer = is_main_process(self.mesh)
        shard_paths: List[str] = []
        shard_index = 0
        shard: Optional[AppendableNpyFile] = None
        shard_rows = 0  # the current shard's rows (the file's own count on the writing rank)
        clips: List[np.ndarray] = []
        tokens: List[np.ndarray] = []
        total_seconds = 0.0
        max_seconds = max_hours * 3600.0

        def flush() -> None:
            nonlocal clips, tokens, shard, shard_index, shard_rows
            if not clips:
                return
            feats = embeddings(np.stack(clips))  # (n, 16, 96)
            keep = ~np.isnan(feats).any(axis=(1, 2))
            feats = feats[keep]
            kept_tokens = [t for t, k in zip(tokens, keep) if k]
            clips, tokens = [], []
            if not kept_tokens:
                return  # every clip of the batch gave NaN features: drop the batch
            token_rows = np.stack(kept_tokens).astype(np.float32)[:, None, :]
            labeled = np.concatenate([feats, token_rows], axis=1)  # (n, 17, 96)
            path = os.path.join(self.directory, f"{self.name}-{shard_index}.npy")
            if not shard_paths or shard_paths[-1] != path:
                shard_paths.append(path)
                shard = AppendableNpyFile(path) if writer else None
                shard_rows = len(shard) if writer else 0
            if shard is not None:
                shard.append(labeled)
            shard_rows += labeled.shape[0]
            if shard_rows >= self.samples_per_file:
                shard_index += 1

        for sample in source:
            audio = sample["array"]
            if sample["sampling_rate"] != self.sample_rate:
                audio = resample_audio(audio, sample["sampling_rate"], self.sample_rate)
            token_ids = self.tokenizer(sample.get("transcript", ""))
            for window in self.windows(audio):
                clips.append(window)
                tokens.append(token_ids)
                total_seconds += self.clip_samples / self.sample_rate
                if len(clips) >= self.process_batch_size:
                    flush()
                if on_progress is not None:
                    on_progress(total_seconds, max_seconds)
            if total_seconds >= max_seconds:
                break
        flush()
        barrier(self.mesh)  # the shards are whole before any rank returns
        logger.info(f"Extracted {total_seconds / 3600:.2f} hours into {len(shard_paths)} shard(s)")
        return shard_paths
