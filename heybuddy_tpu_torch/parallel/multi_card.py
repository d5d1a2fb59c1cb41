"""
The data-parallel paths across several cards, one rank each, on NCCL:

    python -m heybuddy_tpu_torch.parallel.multi_card [N]

on a machine with N >= 2 cards (default: all of them). It builds the
kernels, then runs and times (host clock):

1. ``dryrun N`` (featurize + a head step, the production trainer with its
   evaluation and npz / DCP checkpoints, two sharded pretrain steps);
2. the distributed smoke under ``torchrun``, each rank's parameters against
   the others' (equal) and against one process's step on the concatenated
   batch (the trainer's parameter rule: 99% within 1e-5 + 1e-4 |x|, all
   within 2e-4);
3. ``train "hey buddy"`` under ``torchrun`` from an empty dataset directory
   on the ``formant-device`` route (rank 0 generates, the others wait),
   300 steps: its return code, one "Training complete", the checkpoints.

Any failure raises. ``chip_smoke.py`` covers one card (one rank on NCCL, two
ranks on gloo sharing it); this covers NCCL between cards.
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TRAIN_ARGS = ["train", "hey buddy", "--tts-backend", "formant-device", "--positive-samples", "2048",
              "--adversarial-samples", "2048", "--validation-samples", "512", "--testing-positive-samples", "0",
              "--testing-adversarial-samples", "0", "--training-no-default-dataset", "--steps", "300",
              "--stages", "1", "--validation-steps", "100", "--checkpoint-steps", "100", "--num-batch-threads", "1"]


def torchrun(n: int, args, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={n}",
                           "-m", *args], cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)


def main() -> None:
    from heybuddy_tpu_torch.ops.kernels import build
    from heybuddy_tpu_torch.parallel import distributed_smoke, dryrun
    from heybuddy_tpu_torch.utils.cuda_timing import nvidia_smi_line

    cards = torch.cuda.device_count()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else cards
    if n < 2 or n > cards:
        raise RuntimeError(f"needs 2 <= N <= {cards} cards, got N = {n}")
    print(nvidia_smi_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {cards} cards, {n} ranks on NCCL", flush=True)
    print(f"build: {build.build_all():.1f} s", flush=True)
    os.environ["HEYBUDDY_OFFLINE"] = "1"

    t0 = time.perf_counter()
    outputs = dryrun.launch(n)
    check = [line for out in outputs for line in out.splitlines() if line.startswith(("[dryrun", "dryrun("))]
    print("\n".join(check), flush=True)
    if f"dryrun({n}): OK" not in outputs[0]:
        raise RuntimeError("the dryrun did not finish")
    print(f"dryrun {n}: {time.perf_counter() - t0:.1f} s", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        smoke = torchrun(n, ["heybuddy_tpu_torch.parallel.distributed_smoke", "--out",
                             os.path.join(tmp, "smoke{rank}.npz")])
        if smoke.returncode != 0:
            raise RuntimeError(f"distributed smoke failed:\n{smoke.stdout[-3000:]}{smoke.stderr[-3000:]}")
        ranks = [np.load(os.path.join(tmp, f"smoke{r}.npz")) for r in range(n)]
        dev = torch.device("cuda", 0)
        x = torch.from_numpy(np.concatenate([r["x"] for r in ranks])).to(dev)
        y = torch.from_numpy(np.concatenate([r["y"] for r in ranks])).to(dev)
        model, loss, _ = distributed_smoke.smoke_step(x, y, None, dev)
        names = sorted(name for name, _ in model.named_parameters())
        same = all(np.array_equal(r[f"param/{k}"], ranks[0][f"param/{k}"]) for r in ranks for k in names)
        got = np.concatenate([ranks[0][f"param/{k}"].ravel() for k in names])
        params = dict(model.named_parameters())
        want = np.concatenate([params[k].detach().cpu().numpy().ravel() for k in names])
        err = np.abs(got - want)
        share = float(np.mean(err <= 1e-5 + 1e-4 * np.abs(want)))
        print(f"distributed smoke, {n} ranks: parameters equal across ranks {same}; loss "
              f"{float(ranks[0]['loss']):.6f} vs one process {loss:.6f}; parameters max |d| {err.max():.3e}, "
              f"{share:.5f} within 1e-5 + 1e-4 |x|; {time.perf_counter() - t0:.1f} s", flush=True)
        if not (same and share >= 0.99 and err.max() <= 2e-4):
            raise RuntimeError("the distributed smoke disagrees")

        env = {**os.environ, "HEYBUDDY_DATASET_DIR": os.path.join(tmp, "data")}
        t0 = time.perf_counter()
        train = torchrun(n, ["heybuddy_tpu_torch", *TRAIN_ARGS, "--checkpoint-dir", os.path.join(tmp, "ckpt")],
                         env=env)
        wall = time.perf_counter() - t0
        log = train.stdout + train.stderr
        lines = [line for line in log.splitlines()
                 if any(k in line for k in ("Running over mesh", "Fused", "finished in", "Overall loss"))]
        print("\n".join(lines), flush=True)
        done = log.count("Training complete")
        ckpts = sorted(os.path.basename(p) for p in glob.glob(os.path.join(tmp, "ckpt", "*.npz")))
        print(f"train under torchrun, {n} ranks from an empty cache: rc {train.returncode}, {wall:.1f} s; "
              f"'Training complete' printed {done} time(s); checkpoints {ckpts}", flush=True)
        if train.returncode != 0 or done != 1 or "hey-buddy_final.npz" not in ckpts:
            raise RuntimeError(f"train under torchrun failed:\n{log[-4000:]}")
    print(f"multi_card({n}): OK", flush=True)


if __name__ == "__main__":
    main()
