"""
Train a tiny VITS voice end to end with the port's training graph.

    python -m heybuddy_tpu_torch.tools.train_tiny_voice [--steps 400] [--device cuda]

The counterpart of the JAX package's ``scripts/train_tiny_voice.py``: it
distils the offline formant synthesizer into a small VITS (text encoder,
SDP, flow, posterior encoder and HiFiGAN decoder, the modules that load Piper
checkpoints) with the full VITS objective (45 x the L1 distance of
log-magnitude spectrograms of randomly sliced decoder segments, plus the KL
term and the SDP duration NLL), then synthesizes "hey buddy" with ``infer``
from the initial and the trained weights. The report is the loss (the mean
of the first and of the last 20 steps) and the mel envelope's distance from
the formant target at the start and at the end: 1 minus the correlation of
the two log-mel trajectories, each resampled to 64 frames (a tempo-free
measure: the SDP's pace drifts before the spectra do).

``torch.optim.Adam`` replaces optax's Adam (its bias correction in float64),
and the draws come from explicit generators (``--seed``): the weights and
batches are not the JAX script's. Each step runs the alignment on the host
(one copy off the device); ``ALIGN_SECONDS`` of ``models/vits/training.py``
sums its time. The script exits non-zero if the loss does not fall.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from heybuddy_tpu_torch.device import resolve_device
from heybuddy_tpu_torch.models.formant import FormantSynthesizer
from heybuddy_tpu_torch.models.vits.synthesizer import Vits, VitsConfig, init_params
from heybuddy_tpu_torch.models.vits.training import (
    ALIGN_SECONDS,
    PosteriorEncoder,
    posterior_encoder_init,
    sdp_posterior_init,
    training_forward,
)
from heybuddy_tpu_torch.ops.kernels.melspec_kernel import mel_spectrogram
from heybuddy_tpu_torch.utils.log import logger

N_FFT = 128
HOP = 64
SEGMENT_FRAMES = 32
SAMPLE_RATE = 16000

TEXTS = [
    "hey buddy", "good morning", "hello there", "play some music",
    "turn on the lights", "what time is it", "set a timer", "stop the alarm",
    "how are you", "thank you", "see you later", "open the door",
    "close the window", "call my friend", "read the news", "start the show",
]


def tiny_config(speakers: int) -> VitsConfig:
    """The JAX script's configuration: hop 64, to match the spectrogram frames."""
    return VitsConfig(
        n_vocab=256, inter_channels=64, hidden_channels=64, filter_channels=128, n_heads=2, n_layers=2,
        kernel_size=3, resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 2), (2, 6)),
        upsample_rates=(4, 4, 4), upsample_initial_channel=128, upsample_kernel_sizes=(8, 8, 8),
        n_speakers=speakers, gin_channels=16, use_sdp=True, sample_rate=SAMPLE_RATE,
    )


def log_spec_np(audio: np.ndarray) -> np.ndarray:
    """(L,) -> (N_FFT // 2 + 1, frames) log-magnitude STFT without centring: frame i covers
    samples [i HOP, i HOP + N_FFT), the framing of ``graph_log_spec``."""
    n_frames = (len(audio) - N_FFT) // HOP + 1
    window = np.hanning(N_FFT).astype(np.float32)
    frames = np.stack([audio[i * HOP: i * HOP + N_FFT] * window for i in range(n_frames)])
    return np.log(np.abs(np.fft.rfft(frames, axis=-1)).T.astype(np.float32) + 1e-5)


def dataset(speakers: int) -> Dict[str, np.ndarray]:
    """Formant renderings of ``TEXTS`` by each speaker, byte ids and linear log-spectrograms."""
    synth = FormantSynthesizer(sample_rate=SAMPLE_RATE)
    clips, ids_list = [], []
    for text in TEXTS:
        for spk in range(speakers):
            audio = synth.synthesize(text, speaker=spk).astype(np.float32)
            peak = np.abs(audio).max()
            if peak > 0:
                audio = audio / max(peak, 1.0)
            clips.append(audio)
            ids_list.append(np.frombuffer(text.encode("ascii"), np.uint8))
    min_samples = (SEGMENT_FRAMES + 1) * HOP
    lengths = [max(len(c), min_samples) for c in clips]
    t_y_max = max((n - N_FFT) // HOP + 1 for n in lengths)
    n = len(clips)
    out = {
        "ids": np.zeros((n, max(len(i) for i in ids_list)), np.int64),
        "id_len": np.zeros((n,), np.int64),
        "specs": np.zeros((n, N_FFT // 2 + 1, t_y_max), np.float32),
        "spec_len": np.zeros((n,), np.int64),
        "audio": np.zeros((n, t_y_max * HOP + N_FFT), np.float32),
        "speakers": np.tile(np.arange(speakers), len(TEXTS)),
    }
    for i, (clip, cid) in enumerate(zip(clips, ids_list)):
        out["ids"][i, : len(cid)] = cid
        out["id_len"][i] = len(cid)
        buf = np.zeros(lengths[i], np.float32)
        buf[: len(clip)] = clip
        sp = log_spec_np(buf)
        out["specs"][i, :, : sp.shape[1]] = sp
        out["spec_len"][i] = sp.shape[1]
        out["audio"][i, : len(buf)] = buf
    return out


class GraphLogSpec:
    """``log_spec_np``'s framing as matmuls on the device, for the reconstruction loss."""

    def __init__(self, samples: int, device: torch.device) -> None:
        bins = np.arange(N_FFT // 2 + 1)
        angle = 2.0 * np.pi * np.outer(np.arange(N_FFT), bins) / N_FFT
        self.window = torch.from_numpy(np.hanning(N_FFT).astype(np.float32)).to(device)
        self.cos = torch.from_numpy(np.cos(angle).astype(np.float32)).to(device)
        self.sin = torch.from_numpy(np.sin(angle).astype(np.float32)).to(device)
        frames = (samples - N_FFT) // HOP + 1
        idx = np.arange(frames)[:, None] * HOP + np.arange(N_FFT)[None, :]
        self.idx = torch.from_numpy(idx).to(device)

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        frames = audio[:, self.idx] * self.window  # (b, frames, N_FFT)
        re, im = frames @ self.cos, frames @ self.sin
        return torch.log(torch.sqrt(re * re + im * im + 1e-12) + 1e-5)


def envelope_distance(audio: np.ndarray, target: np.ndarray, device: torch.device) -> float:
    """1 - the correlation of the two log-mel trajectories resampled to 64 frames (1.0 if too short or flat)."""
    if len(audio) < 4 * HOP:
        return 1.0

    def resampled(a: np.ndarray) -> np.ndarray:
        mel = mel_spectrogram(torch.from_numpy(a[None] * 32768.0).to(device))[0].cpu().numpy()
        src, dst = np.linspace(0.0, 1.0, mel.shape[0]), np.linspace(0.0, 1.0, 64)
        return np.stack([np.interp(dst, src, mel[:, k]) for k in range(mel.shape[1])], 1).ravel()

    e_a, e_t = resampled(audio), resampled(target)
    if e_a.std() < 1e-6 or e_t.std() < 1e-6:
        return 1.0
    return 1.0 - float(np.corrcoef(e_a, e_t)[0, 1])


@torch.no_grad()
def infer_audio(model: Vits, device: torch.device) -> np.ndarray:
    """ "hey buddy" by speaker 0, near-deterministic (noise 0.1, duration noise 0)."""
    ids = torch.from_numpy(np.frombuffer(b"hey buddy", np.uint8).astype(np.int64))[None].to(device)
    audio, length = model.infer(
        ids, torch.tensor([ids.shape[1]], device=device), model.emb_g.weight[:1], noise_scale=0.1,
        noise_scale_w=0.0, max_frames=256, generator=torch.Generator(device=device).manual_seed(7),
    )
    return audio[0, : int(length[0])].cpu().numpy()


def train(steps: int = 400, batch_size: int = 8, speakers: int = 4, lr: float = 2e-4, seed: int = 0,
          device: Any = "cuda") -> Dict[str, Any]:
    """Train the tiny voice; returns the report (``metrics``) and the trained modules."""
    dev = resolve_device(device)
    cfg = tiny_config(speakers)
    data = dataset(speakers)
    n = data["ids"].shape[0]
    logger.info(f"tiny-voice dataset: {n} clips, t_x<={data['ids'].shape[1]}, "
                f"t_y<={data['specs'].shape[2]} frames")
    tensors = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}

    gen = torch.Generator().manual_seed(seed)
    init_tree = init_params(gen, cfg)
    model = Vits.from_jax_params(init_tree, cfg, sdp_posterior=sdp_posterior_init(gen, cfg.hidden_channels),
                                 device=dev)
    posterior = PosteriorEncoder.from_jax_params(posterior_encoder_init(
        gen, in_channels=N_FFT // 2 + 1, out_channels=cfg.inter_channels, hidden_channels=cfg.hidden_channels,
        n_layers=4, gin_channels=cfg.gin_channels), device=dev)
    optimizer = torch.optim.Adam(list(model.parameters()) + list(posterior.parameters()), lr=lr)

    seg_samples = SEGMENT_FRAMES * HOP
    log_spec = GraphLogSpec(seg_samples, dev)
    offsets = torch.arange(seg_samples, device=dev)
    rng = np.random.default_rng(seed)
    step_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    first, last = [], []
    ALIGN_SECONDS[0] = 0.0
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(steps):
        sel = torch.from_numpy(rng.choice(n, size=batch_size, replace=False)).to(dev)
        b = {k: v[sel] for k, v in tensors.items()}
        out = training_forward(
            model, posterior, b["ids"], b["id_len"], b["specs"], b["spec_len"],
            speaker_embedding=model.emb_g.weight[b["speakers"]], segment_size=SEGMENT_FRAMES, generator=step_gen,
        )
        decoded = out["audio_segment"].reshape(batch_size, -1)[:, :seg_samples]
        starts = torch.clamp(out["ids_slice"].long() * HOP, 0, b["audio"].shape[1] - (seg_samples + N_FFT - HOP))
        target = torch.gather(b["audio"], 1, starts[:, None] + offsets[None, :])
        recon = (log_spec(decoded) - log_spec(target)).abs().mean()
        loss = 45.0 * recon + out["kl_loss"] + out["duration_loss"]
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        values = torch.stack([loss, recon, out["kl_loss"], out["duration_loss"]]).detach().cpu().numpy()
        if not np.isfinite(values).all():
            raise RuntimeError(f"non-finite loss at step {step}: {values}")
        (first if step < 20 else last).append(values[:2])
        if step % 50 == 0 or step == steps - 1:
            logger.info(f"step {step}/{steps}: loss={values[0]:.3f} recon={values[1]:.3f} "
                        f"kl={values[2]:.3f} dur={values[3]:.3f}")
    train_s = time.perf_counter() - t0

    synth = FormantSynthesizer(sample_rate=SAMPLE_RATE)
    target_audio = synth.synthesize("hey buddy", speaker=0).astype(np.float32)
    target_audio = target_audio / max(np.abs(target_audio).max(), 1e-6)
    model.eval()
    init_model = Vits.from_jax_params(init_tree, cfg, device=dev)
    audio_init, audio_trained = infer_audio(init_model, dev), infer_audio(model, dev)
    tail = last[-20:] if last else first
    metrics = {
        "steps": steps,
        "clips": n,
        "train_s": train_s,
        "steps_per_s": steps / train_s,
        "align_ms_per_step": ALIGN_SECONDS[0] / steps * 1e3,
        "loss_first20": float(np.mean([v[0] for v in first])),
        "loss_last20": float(np.mean([v[0] for v in tail])),
        "recon_first20": float(np.mean([v[1] for v in first])),
        "recon_last20": float(np.mean([v[1] for v in tail])),
        "envelope_distance_init": envelope_distance(audio_init, target_audio, dev),
        "envelope_distance_trained": envelope_distance(audio_trained, target_audio, dev),
        "infer_samples_init": int(len(audio_init)),
        "infer_samples_trained": int(len(audio_trained)),
        "target_samples": int(len(target_audio)),
    }
    return {"metrics": metrics, "model": model, "posterior": posterior}


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Train a tiny VITS voice distilled from the formant synthesizer.")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--speakers", type=int, default=4)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="write the trained voice's state dict (a Piper-layout .pt)")
    p.add_argument("--metrics-out", default=None)
    args = p.parse_args(argv)
    result = train(args.steps, args.batch_size, args.speakers, args.lr, args.seed, args.device)
    metrics = result["metrics"]
    if args.out:
        torch.save(result["model"].state_dict(), args.out)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(metrics, f, indent=2)
    print(json.dumps(metrics))
    if metrics["loss_last20"] >= metrics["loss_first20"]:
        raise SystemExit("tiny-voice training did not reduce the loss")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
