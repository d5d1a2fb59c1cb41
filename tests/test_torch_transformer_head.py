"""The transformer head trained on featurized clips: the port against the JAX
package on the CPU.

The clips are ``chip_smoke.synth_clips``' seeded patterns (positives a tone
then a rising chirp, adversarials the chirp falling, negatives noise), made
into features by the port's featurizer. Both packages train from the JAX
trainer's initial parameters with dropout 0 on the same seeded index draws,
through the stage driver (one stage), and score the same held-out clips.

Run as a script, it repeats the card's transformer run of ``chip_smoke.py``
at its batches (50 / 50 / 1000) and steps (1,000) on the CPU, with the
patterns at a random start (as in the card's caches) and at one fixed start,
and prints each package's held-out scores::

    PYTHONPATH=. python tests/test_torch_transformer_head.py

It takes about 30 minutes on 8 CPU cores, most of it the 4,000 train steps.

With ``generated`` it instead repeats the generate phase's held-out run:
the port makes the caches of ``train "hey buddy" --tts-backend
formant-device`` on the CPU (2,048 positives and adversaries, 512 of each
for testing), then both packages train each head on those same files
(batches 50 / 50, 1,000 steps, dropout 0) and score the testing caches::

    PYTHONPATH=. python tests/test_torch_transformer_head.py generated
"""

import os
import sys
import tempfile
import time

import jax
import numpy as np
import pytest
import torch

from chip_smoke import synth_clips
from heybuddy_tpu.data import precalculated as jax_pre
from heybuddy_tpu.data import training as jax_training
from heybuddy_tpu.training import trainer as jax_trainer
from heybuddy_tpu_torch.data import precalculated, training
from heybuddy_tpu_torch.models.featurizer import featurize_batch, get_speech_embeddings
from heybuddy_tpu_torch.training import trainer
from test_torch_trainer import _assert_history_close, _assert_params_close

# the start of the pattern in the clip: drawn per clip as in the card's caches, or one fixed start
STARTS = {"random": (0.1, 0.7), "fixed": (0.4, 0.4)}
# held-out scores, the port against JAX after training from one state
# (float32 both, only the summation order differs)
SCORE_ATOL = 1e-5


def featurize(sizes, seed, start_s, chunk=512):
    """{kind: (n, 16, 96) features} of ``sizes[kind]`` synthetic clips of each kind."""
    gen = torch.Generator().manual_seed(seed)
    net = get_speech_embeddings(device="cpu").net
    out = {}
    for name, (kind, n) in sizes.items():
        parts = []
        for i in range(0, n, chunk):
            audio = synth_clips(kind, min(chunk, n - i), gen, torch.device("cpu"), start_s=start_s)
            parts.append(featurize_batch(net, audio * 32767.0).numpy())
        out[name] = np.concatenate(parts)
    return out


def composition(pre, train, feats, batches):
    """Positives, adversaries and (with a third batch size) negatives."""
    def source(name, seed):
        return pre.PrecalculatedDatasetIterator(name, data=feats[name], seed=seed)

    negative = [(source("adversarial", 2), batches[1])]
    if len(batches) > 2:
        negative.append((source("negative", 3), batches[2]))
    return train.WakeWordTrainingDatasetIterator(
        num_batch_threads=1,
        positive=[(source("positive", 1), batches[0])],
        negative=negative,
    )


def train_both(feats, batches, steps, directory, architecture="transformer"):
    """Both packages' heads (defaults, dropout 0) trained alike; their
    histories, trainers and held-out scores."""
    jax_t = jax_trainer.WakeWordTrainer(
        checkpoint_dir=os.path.join(directory, "jax"), architecture=architecture, dropout=0.0
    )
    port_t = trainer.WakeWordTrainer(
        checkpoint_dir=os.path.join(directory, "port"), architecture=architecture, dropout=0.0,
        device="cpu", params=jax.tree_util.tree_map(np.asarray, jax_t.model.params),
    )
    held = np.concatenate([feats["held_positive"], feats["held_negative"]])
    out = {}
    for label, t, pre, train in (("jax", jax_t, jax_pre, jax_training), ("port", port_t, precalculated, training)):
        start = time.perf_counter()
        history = t(composition(pre, train, feats, batches), num_steps=steps, num_stages=1,
                    graph_dir=os.path.join(directory, label))
        scores = np.asarray(t.model(held) if label == "jax" else t.model.scores(held)).reshape(-1)
        out[label] = {"history": history, "trainer": t, "scores": scores,
                      "seconds": time.perf_counter() - start}
    return out


def _sizes(n_train, n_held):
    return {
        "positive": ("positive", n_train), "adversarial": ("adversarial", n_train),
        "negative": ("negative", 4 * n_train), "held_positive": ("positive", n_held),
        "held_negative": ("negative", n_held),
    }


@pytest.mark.parametrize("start", sorted(STARTS))
def test_transformer_trains_like_jax_on_featurized_clips(tmp_path, start):
    """20 steps of 8 / 8 / 48 rows: the same history, parameters and held-out
    scores. Longer runs drift apart in the parameters as far as rounding in
    the initial parameters carries either package alone: the max over
    channels picks among near-equal logits (``chip_smoke.py`` measures it)."""
    feats = featurize(_sizes(192, 64), seed=5, start_s=STARTS[start])
    runs = train_both(feats, (8, 8, 48), 20, str(tmp_path))
    jax_run, port_run = runs["jax"], runs["port"]
    assert port_run["history"]["loss"].shape == (20,)
    np.testing.assert_array_equal(port_run["history"]["high_loss_rate"], jax_run["history"]["high_loss_rate"])
    _assert_history_close(port_run["history"], jax_run["history"])
    _assert_params_close(jax_run["trainer"].model.params, port_run["trainer"].model)
    np.testing.assert_allclose(port_run["scores"], jax_run["scores"], rtol=0.0, atol=SCORE_ATOL)


def generated_caches(directory, rows):
    """{name: features} of the fused route's caches, made by the port on the
    CPU as ``train`` makes them: positives and adversaries (250 texts) for
    training and for testing."""
    from heybuddy_tpu_torch.data.features import TrainingFeaturesGenerator

    os.environ["HEYBUDDY_OFFLINE"] = "1"
    os.environ.setdefault("HEYBUDDY_FUSED_TTS_BATCH", "128")  # a batch's render arrays stay under 0.5 GB
    gen = TrainingFeaturesGenerator("hey buddy", directory=directory, device="cpu", tts_backend="formant-device")
    gen.get_training_features(rows["positive"])
    gen.get_training_features(rows["adversarial"], adversarial=True, adversarial_phrases=250)
    gen.get_training_features(rows["held_positive"], testing=True)
    gen.get_training_features(rows["held_negative"], adversarial=True, adversarial_phrases=250, testing=True)
    files = {"positive": "hey-buddy", "adversarial": "hey-buddy-adversarial",
             "held_positive": "hey-buddy-testing", "held_negative": "hey-buddy-adversarial-testing"}
    return {k: np.load(os.path.join(directory, f"{name}.npy")) for k, name in files.items()}


def generated_main() -> int:
    """Both heads of both packages on the same generated cache files."""
    rows = {"positive": 2048, "adversarial": 2048, "held_positive": 512, "held_negative": 512}
    with tempfile.TemporaryDirectory() as tmp:
        start = time.perf_counter()
        feats = generated_caches(os.path.join(tmp, "data"), rows)
        print(f"generated {sum(rows.values())} clips on the CPU in {time.perf_counter() - start:.1f} s; "
              f"{', '.join(f'{k} {v.shape}' for k, v in feats.items())}", flush=True)
        for architecture in ("transformer", "perceptron"):
            runs = train_both(feats, (50, 50), 1000, os.path.join(tmp, architecture), architecture)
            for label, run in runs.items():
                loss, scores = run["history"]["loss"], run["scores"]
                pos, neg = scores[:rows["held_positive"]], scores[rows["held_positive"]:]
                print(f"{architecture}, {label}: 1000 steps in {run['seconds']:.1f} s; loss mean of the first 50 "
                      f"steps {loss[:50].mean():.5f}, of the last 50 {loss[-50:].mean():.5f}; testing positives "
                      f"{pos.mean():.4f} (recall {np.mean(pos > 0.5):.4f}), adversaries {neg.mean():.4f} "
                      f"(false accepts {np.mean(neg > 0.5):.4f}); scores spread {np.ptp(scores):.3e}", flush=True)
            print(f"{architecture}: testing scores, port vs JAX: max |d| "
                  f"{np.abs(runs['port']['scores'] - runs['jax']['scores']).max():.3e}, mean |d| "
                  f"{np.abs(runs['port']['scores'] - runs['jax']['scores']).mean():.3e}", flush=True)
    return 0


def main() -> int:
    """The card's transformer run on the CPU, in both packages, per pattern start."""
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:] == ["generated"]:
        return generated_main()
    n_held = 512
    for start, start_s in STARTS.items():
        feats = featurize(_sizes(4096, n_held), seed=20261016, start_s=start_s)
        with tempfile.TemporaryDirectory() as tmp:
            runs = train_both(feats, (50, 50, 1000), 1000, tmp)
        for label, run in runs.items():
            loss, scores = run["history"]["loss"], run["scores"]
            pos, neg = scores[:n_held], scores[n_held:]
            print(f"{start} start, {label}: 1000 steps in {run['seconds']:.1f} s; loss mean of the first 50 "
                  f"steps {loss[:50].mean():.5f}, of the last 50 {loss[-50:].mean():.5f}; held-out positives "
                  f"{pos.mean():.6f}, negatives {neg.mean():.6f} (gap {pos.mean() - neg.mean():.6f}); all "
                  f"scores {scores.min():.6f}-{scores.max():.6f} (spread {np.ptp(scores):.3e})")
        print(f"{start} start: held-out scores, port vs JAX: max |d| "
              f"{np.abs(runs['port']['scores'] - runs['jax']['scores']).max():.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
