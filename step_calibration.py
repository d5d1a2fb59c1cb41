"""
Calibration of ``chip_smoke.py``'s transformer step check on one NVIDIA GPU.

    python3 step_calibration.py init [SEEDS]
    python3 step_calibration.py trained [TRUNKS] [SEEDS]

Builds the train caches on the card as ``chip_smoke.py`` does, then takes
one fired transformer step (dropout 0, the trajectory's index stream) on the
card, on the card with TF32 on, and on the CPU, from a trunk with a seeded
random final layer (N(0, 0.1), the first seed ``chip_smoke.SEED``), and
prints for each seed the loss (relative) and gradient (|d| / |g|) gaps to
the CPU's step.

- ``init``: the seed's initial trunk, as the check uses. It also runs the
  card's step twice (bit-equal?) and the CPU's from parameters perturbed by
  1e-7 relative (how far float32 rounding alone carries the gradient).
- ``trained``: TRUNKS trunks from ``train --transformer`` through the CLI
  entry (1,000 steps each; ``train`` shuffles its caches without a seed, so
  every trunk differs). It also prints each row's margin between its two
  largest channel logits (the max over channels routes the gradient) and
  how many rows' top channel differs card vs CPU.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

import chip_smoke as cs
from heybuddy_tpu_torch.cli import main as cli_main
from heybuddy_tpu_torch.convert import wakeword_params_to_numpy
from heybuddy_tpu_torch.models.featurizer import get_speech_embeddings
from heybuddy_tpu_torch.models.wakeword import WakeWordTransformerModel, read_checkpoint
from heybuddy_tpu_torch.ops.kernels import build
from heybuddy_tpu_torch.training.trainer import WakeWordTrainer


def with_final_layer(params: Dict, seed: int) -> Dict:
    """``params`` with a seeded N(0, 0.1) final-layer weight (the rest shared)."""
    fc = params["final"]["fc"]
    w = np.random.default_rng(seed).normal(0.0, 0.1, fc["w"].shape).astype(np.float32)
    return {**params, "final": {"fc": {"w": w, "b": fc["b"].copy()}}}


def channel_logits(params: Dict, x: torch.Tensor, device: torch.device) -> np.ndarray:
    """The (rows, channels) logits the head's max runs over."""
    model = WakeWordTransformerModel(params=params, dropout=0.0, device=device)
    got = {}
    model.final.register_forward_hook(lambda mod, inputs, out: got.setdefault("z", out.detach()))
    with torch.no_grad():
        model(x.to(device))
    return got["z"].double().cpu().numpy()


def steps(params: Dict, data: str, tmp: str, keys) -> Dict[str, Dict]:
    """One fired step per key ("cpu", "card...", "card_tf32", "cpu_perturbed"), gaps to "cpu"."""
    runs = {k: cs.trajectory_run("transformer", torch.device("cuda" if k.startswith("card") else "cpu"), data,
                                 os.path.join(tmp, f"step-{time.monotonic_ns()}"), tf32=k == "card_tf32",
                                 perturb=k == "cpu_perturbed", params=params, steps=1)
            for k in ("cpu",) + tuple(keys)}
    gaps = {k: cs.step_gap(runs[k], runs["cpu"]) for k in keys}
    gaps["cpu"] = {"loss": runs["cpu"]["history"]["loss"][0]}
    if "card2" in runs:
        gaps["card2"]["bit_equal"] = bool(np.array_equal(runs["card"]["grad"], runs["card2"]["grad"]))
    return gaps


def text(gaps: Dict[str, Dict]) -> str:
    return "; ".join(f"{k} loss {g['loss_rel']:.3e} grad {g['grad_rel']:.3e} fired {g['fired']}"
                     + (f" bit-equal to card {g['bit_equal']}" if "bit_equal" in g else "")
                     for k, g in gaps.items() if k != "cpu")


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("step_calibration.py needs a CUDA device")
    mode = argv[0] if argv else "init"
    trunks = int(argv[1]) if mode == "trained" and len(argv) > 1 else 1
    seeds = int(argv[-1]) if len(argv) > (2 if mode == "trained" else 1) else 16
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    print(cs.nvidia_smi_line(), flush=True)
    build.build_all()
    net = get_speech_embeddings(device=dev).net
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "train-data")
        os.makedirs(data)
        cs.build_caches(net, dev, data, torch.Generator(device=dev).manual_seed(cs.SEED))
        seed_list = [cs.SEED] + list(range(1, seeds))
        if mode == "init":
            init = wakeword_params_to_numpy(WakeWordTrainer(
                checkpoint_dir=os.path.join(tmp, "init"), device=cpu, architecture="transformer", seed=cs.SEED,
                dropout=0.0).model)
            for seed in seed_list:
                gaps = steps(with_final_layer(init, seed), data, tmp, ("card", "card2", "card_tf32", "cpu_perturbed"))
                print(f"init trunk, final-layer seed {seed}: CPU loss {gaps['cpu']['loss']:.5f}; {text(gaps)}",
                      flush=True)
            return 0
        iterator = cs.trajectory_iterator(data)  # the plan holds it weakly
        plan = iterator.device_plan(10 ** 12)
        x = torch.from_numpy(np.concatenate([p[i] for p, i in zip(plan.pools, plan.sample())]))
        os.environ.update({"HEYBUDDY_DATASET_DIR": data, "HEYBUDDY_OFFLINE": "1"})
        rows = {name: str(n) for name, (n, _, _) in cs.TRAIN_CACHES.items()}
        for trunk in range(trunks):
            ckpt = os.path.join(tmp, f"ckpt-{trunk}")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli_main(["train", cs.TRAIN_PHRASE, "--transformer", "--steps", str(cs.TRANSFORMER_STEPS),
                               "--stages", "1", "--positive-samples", rows["hey-buddy"],
                               "--adversarial-samples", rows["hey-buddy-adversarial"],
                               "--validation-samples", rows["hey-buddy-testing-validation"],
                               "--testing-positive-samples", "0", "--testing-adversarial-samples", "0",
                               "--num-batch-threads", "1", "--checkpoint-dir", ckpt])
            if rc != 0:
                raise RuntimeError(f"train --transformer failed ({rc})")
            trained = read_checkpoint(os.path.join(ckpt, "hey-buddy_final.npz"))[1]
            for seed in seed_list:
                params = with_final_layer(trained, seed)
                z_cpu, z_card = channel_logits(params, x, cpu), channel_logits(params, x, dev)
                top = np.sort(z_cpu, axis=1)
                margin = top[:, -1] - top[:, -2]
                flips = int((z_cpu.argmax(1) != z_card.argmax(1)).sum())
                gaps = steps(params, data, tmp, ("card", "card_tf32"))
                print(f"trained trunk {trunk}, final-layer seed {seed}: margins min {margin.min():.3e}, rows under "
                      f"1e-5 / 1e-4 / 1e-3: {int((margin < 1e-5).sum())} / {int((margin < 1e-4).sum())} / "
                      f"{int((margin < 1e-3).sum())} of {len(margin)}; logits card vs CPU max |d| "
                      f"{np.abs(z_cpu - z_card).max():.3e}, top channel differs in {flips} rows; {text(gaps)}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
