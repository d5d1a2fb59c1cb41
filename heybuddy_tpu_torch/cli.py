"""
Command line of the port (argparse):

    python -m heybuddy_tpu_torch train PHRASE [the JAX command's options] [--mesh/--no-mesh]
        [--device cuda|cpu]
    python -m heybuddy_tpu_torch convert CHECKPOINT [OUTPUT] [--opset-version 19]
    python -m heybuddy_tpu_torch predict CHECKPOINT AUDIO [--threshold T] [--device cuda|cpu]
    python -m heybuddy_tpu_torch listen CHECKPOINT... [--input-wav WAV] [--vad] [--threshold T]
        [--buffer-size N] [--consecutive N] [--device cuda|cpu]
    python -m heybuddy_tpu_torch extract NAME SOURCE [--local-files] [--directory D]
        [--samples-per-file N] [--process-batch-size N] [--tokenizer-max-length N]
        [--hours H] [--mesh] [--device cuda|cpu] [Hugging Face dataset options]
    python -m heybuddy_tpu_torch combine SOURCE... TARGET [--directory D] [--no-reset] [--half]
        [--delete] [--batch-size N]
    python -m heybuddy_tpu_torch pretrain-embedding [-o OUTPUT] [the JAX command's options]
        [--device cuda|cpu]

Every command takes ``--debug`` (debug-level logs), as the JAX commands do.
``train`` and ``extract`` run data-parallel over several cards under
``torchrun --nproc-per-node W -m heybuddy_tpu_torch ...``: ``train``'s
``--mesh`` is on by default and takes effect when the world size is above 1;
``extract --mesh`` is off by default. Rank 0 generates missing feature caches
while the others wait, and writes the checkpoints, the shards and the
printed results; the other ranks log warnings only.

``train`` trains a wake-word head for PHRASE end to end with the JAX
``heybuddy train``'s options, names and defaults: the feature caches in
``$HEYBUDDY_DATASET_DIR`` that are missing or short are generated (TTS ->
augmentation -> featurization, ``data/features.py``; ``--tts-backend``,
else ``HEYBUDDY_TTS_BACKEND``, else ``vits`` when ``HEYBUDDY_TTS_CHECKPOINT``
names a file, else ``formant`` picks the TTS (``models/tts.py``'s
``resolve_tts_backend``): ``formant`` and ``vits`` take the classic route,
``formant-device`` the fused one, which ``HEYBUDDY_FUSED_TTS=0`` turns
off; ``--stream-negative-samples``, ``--collision-negative-samples`` and
``--validation-stream-negative-samples`` synthesise continuous streams and
featurize their sliding runtime windows), ``--prefix-negative-phrases`` /
``--collision-swap-phrases`` add their texts to the adversarial pool,
checkpoints go to ``--checkpoint-dir``, and it prints "Training complete;
final checkpoint: DIR/NAME_final.npz". ``convert`` writes a perceptron checkpoint as the ONNX head the
browser runtime loads (default OUTPUT: the checkpoint's path with ``.onnx``)
and prints "Wrote OUTPUT"; it reads the npz's numpy arrays and needs no device.

``predict`` prints the wake-word timecodes found in AUDIO (a WAV file), one
line each, or "No wake words detected.", as the JAX package's ``heybuddy
predict`` does. ``predict`` and ``listen`` load npz checkpoints, reference
``.pt`` state dicts and exported ``.onnx`` heads. ``listen`` scores a rolling
2 s buffer after every chunk of the microphone (pyaudio) or of
``--input-wav`` and prints a line "NAME @ T.TTs score=S" per detection;
``--vad`` skips chunks without speech. ``extract`` writes labeled
negative-feature shards ``NAME-<i>.npy`` ([n, 17, 96] float32) from SOURCE,
a Hugging Face dataset id or, with ``--local-files``, a glob of WAV files with
sidecar ``.txt`` transcripts, and prints "Wrote N shard(s):" and their paths,
as ``heybuddy extract`` does. ``combine`` merges feature shards (paths or globs, also looked up in
``--directory``) into one appendable ``.npy`` (TARGET, or
``DIRECTORY/TARGET.npy``) and prints "Combined N rows from K shard(s) into
PATH"; it is numpy only. ``pretrain-embedding`` trains the embedding network
contrastively (``training/embedding_pretrain.py``) with the JAX command's
options and defaults, writes its npz to OUTPUT and prints "Wrote OUTPUT; set
HEYBUDDY_EMBEDDING_WEIGHTS=OUTPUT to use it."; the npz loads in either
package.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import glob
import logging
import os
import sys
from typing import Any, Dict, List, Optional

from heybuddy_tpu_torch import constants as C
from heybuddy_tpu_torch.constants import DEFAULT_ACTIVATION_THRESHOLD, DEFAULT_LISTEN_BUFFER_SIZE
from heybuddy_tpu_torch.device import DeviceLike

__all__ = ["main", "build_parser"]

# how long the ranks of a mesh wait for each other: rank 0 may generate the
# feature caches for hours while the others wait at a barrier
MESH_TIMEOUT = datetime.timedelta(hours=24)


def _add_debug(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--debug", action=argparse.BooleanOptionalAction, default=False)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="heybuddy_tpu_torch", description="heybuddy wake-word tools (PyTorch / CUDA port)"
    )
    commands = parser.add_subparsers(dest="command", required=True)
    predict = commands.add_parser("predict", help="print wake-word timecodes found in AUDIO")
    predict.add_argument("checkpoint", help="wake-word checkpoint (.npz, .pt or .onnx)")
    predict.add_argument("audio", help="audio file (.wav)")
    predict.add_argument("--threshold", type=float, default=DEFAULT_ACTIVATION_THRESHOLD)
    predict.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    _add_debug(predict)

    listen = commands.add_parser("listen", help="score live audio (or a wav) with wake-word checkpoints")
    listen.add_argument("checkpoints", nargs="+", help="wake-word checkpoints (.npz, .pt or .onnx)")
    listen.add_argument("--threshold", type=float, default=DEFAULT_ACTIVATION_THRESHOLD)
    listen.add_argument("--buffer-size", type=int, default=DEFAULT_LISTEN_BUFFER_SIZE)
    listen.add_argument("--input-wav", default=None, help="stream a wav file instead of the microphone")
    listen.add_argument("--vad", dest="use_vad", action=argparse.BooleanOptionalAction, default=False,
                        help="skip chunks without speech (VAD hysteresis), like the browser runtime")
    listen.add_argument("--consecutive", type=int, default=1,
                        help="consecutive above-threshold chunks needed for a detection")
    listen.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    _add_debug(listen)

    combine = commands.add_parser("combine", help="merge feature shards into one appendable .npy")
    combine.add_argument("source", nargs="*", help="shard paths or globs")
    combine.add_argument("target", help="output .npy path, or a name in --directory")
    combine.add_argument("--directory", default=None, help="directory of the shards and of a named target")
    combine.add_argument("--reset", action=argparse.BooleanOptionalAction, default=True)
    combine.add_argument("--half", action=argparse.BooleanOptionalAction, default=False)
    combine.add_argument("--delete", action=argparse.BooleanOptionalAction, default=False)
    combine.add_argument("--batch-size", type=int, default=10000, help="rows copied per append")
    _add_debug(combine)

    extract = commands.add_parser(
        "extract", help="extract labeled negative-feature shards from an audio dataset"
    )
    extract.add_argument("name", help="shard name prefix")
    extract.add_argument("source", help="Hugging Face dataset id, or a glob with --local-files")
    extract.add_argument("--directory", default=None, help="directory to save the shards to")
    extract.add_argument("--local-files", action="store_true",
                         help="treat SOURCE as a glob of local wav files")
    extract.add_argument("--hours", type=float, default=1000.0)
    extract.add_argument("--samples-per-file", type=int, default=10000)
    extract.add_argument("--process-batch-size", type=int, default=100)
    extract.add_argument("--tokenizer-max-length", type=int, default=96)
    extract.add_argument("--config", default=None, help="dataset configuration name")
    extract.add_argument("--split", default="train")
    extract.add_argument("--audio-key", default="audio")
    extract.add_argument("--audio-array-key", default="array")
    extract.add_argument("--audio-sample-rate-key", default="sampling_rate")
    extract.add_argument("--transcript-key", default="transcript")
    extract.add_argument("--streaming", action=argparse.BooleanOptionalAction, default=True)
    extract.add_argument("--trust-remote-code", action=argparse.BooleanOptionalAction,
                         default=False)
    extract.add_argument("--mesh", action=argparse.BooleanOptionalAction, default=False,
                         help="shard featurization batches over the ranks of the mesh (data parallel)")
    extract.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    _add_debug(extract)

    convert = commands.add_parser("convert", help="write a checkpoint as ONNX for the browser runtime")
    convert.add_argument("checkpoint", help="wake-word checkpoint (.npz)")
    convert.add_argument("output", nargs="?", default=None, help="output .onnx path")
    convert.add_argument("--opset-version", type=int, default=19)
    _add_debug(convert)
    _add_train_parser(commands)
    _add_pretrain_parser(commands)
    return parser


def _add_pretrain_parser(commands: Any) -> None:
    pretrain = commands.add_parser("pretrain-embedding",
                                   help="contrastively pretrain the speech-embedding network")
    add = pretrain.add_argument
    add("--output", "-o", default="embedding-pretrained.npz")
    add("--num-texts", type=int, default=512)
    add("--speakers-per-text", type=int, default=4)
    add("--steps", type=int, default=1000)
    add("--batch-size", type=int, default=64)
    add("--learning-rate", type=float, default=1e-3)
    add("--temperature", type=float, default=0.1)
    add("--tts-backend", choices=["vits", "formant", "formant-device"], default=None)
    add("--adversarial-fraction", type=float, default=0.0,
        help="share of the text pool built as phonetic-neighbour clusters (a base phrase + 3 near-collisions)")
    add("--focus-phrase", default=None,
        help="wake phrase whose deep near-collision cluster joins every batch under the margin loss")
    add("--focus-swap-depth", type=int, default=0,
        help="add this many texts with words of the focus phrase swapped for phonetic neighbours")
    add("--focus-swap-max-swaps", type=int, default=1, help="the most words swapped in such a text")
    add("--hard-pair-margin", type=float, default=0.4,
        help="cosine-similarity ceiling for same-cluster rendered pairs")
    add("--hard-pair-weight", type=float, default=1.0, help="weight of the margin loss against NT-Xent")
    add("--seed", type=int, default=0)
    add("--device", default="cuda", help="cuda (default) or cpu")
    _add_debug(pretrain)


# (option, type, default, AugmentConfig field) of train's augmentation options,
# in the JAX command's order
_AUGMENT_OPTIONS = (
    ("seven-band-prob", float, C.DEFAULT_AUGMENT_SEVEN_BAND_PROB, "seven_band_prob"),
    ("seven-band-gain-db", float, C.DEFAULT_AUGMENT_SEVEN_BAND_GAIN_DB, "seven_band_gain_db"),
    ("tanh-distortion-prob", float, C.DEFAULT_AUGMENT_TANH_DISTORTION_PROB, "tanh_distortion_prob"),
    ("tanh-distortion-min", float, C.DEFAULT_AUGMENT_TANH_MIN_DISTORTION, "tanh_min_distortion"),
    ("tanh-distortion-max", float, C.DEFAULT_AUGMENT_TANH_MAX_DISTORTION, "tanh_max_distortion"),
    ("pitch-shift-prob", float, C.DEFAULT_AUGMENT_PITCH_SHIFT_PROB, "pitch_shift_prob"),
    ("pitch-shift-semitones", int, C.DEFAULT_AUGMENT_PITCH_SHIFT_SEMITONES, "pitch_shift_semitones"),
    ("band-stop-prob", float, C.DEFAULT_AUGMENT_BAND_STOP_PROB, "band_stop_prob"),
    ("colored-noise-prob", float, C.DEFAULT_AUGMENT_COLORED_NOISE_PROB, "colored_noise_prob"),
    ("colored-noise-min-snr-db", float, C.DEFAULT_AUGMENT_COLORED_NOISE_MIN_SNR_DB, "colored_noise_min_snr_db"),
    ("colored-noise-max-snr-db", float, C.DEFAULT_AUGMENT_COLORED_NOISE_MAX_SNR_DB, "colored_noise_max_snr_db"),
    ("colored-noise-min-f-decay", float, C.DEFAULT_AUGMENT_COLORED_NOISE_MIN_F_DECAY, "colored_noise_min_f_decay"),
    ("colored-noise-max-f-decay", float, C.DEFAULT_AUGMENT_COLORED_NOISE_MAX_F_DECAY, "colored_noise_max_f_decay"),
    ("background-noise-prob", float, C.DEFAULT_AUGMENT_BACKGROUND_NOISE_PROB, "background_noise_prob"),
    ("background-noise-min-snr-db", float, C.DEFAULT_AUGMENT_BACKGROUND_NOISE_MIN_SNR_DB, "background_noise_min_snr_db"),
    ("background-noise-max-snr-db", float, C.DEFAULT_AUGMENT_BACKGROUND_NOISE_MAX_SNR_DB, "background_noise_max_snr_db"),
    ("gain-prob", float, C.DEFAULT_AUGMENT_GAIN_PROB, "gain_prob"),
    ("reverb-prob", float, C.DEFAULT_AUGMENT_REVERB_PROB, "reverb_prob"),
)


def _add_train_parser(commands: Any) -> None:
    train = commands.add_parser("train", help="train a wake-word model for PHRASE end to end")
    add = train.add_argument
    add("phrase")
    add("--additional-phrase", action="append", default=[])
    add("--wandb-entity", default=None)
    add("--perceptron", dest="architecture", action="store_const", const="perceptron",
        default=C.DEFAULT_ARCHITECTURE)
    add("--transformer", dest="architecture", action="store_const", const="transformer")
    add("--use-half-layers", action=argparse.BooleanOptionalAction, default=C.DEFAULT_USE_HALF_LAYERS)
    add("--use-gating", action=argparse.BooleanOptionalAction, default=C.DEFAULT_USE_GATING)
    add("--layer-dim", type=int, default=C.DEFAULT_LAYER_DIM)
    add("--num-layers", type=int, default=C.DEFAULT_LAYERS)
    add("--num-heads", type=int, default=C.DEFAULT_HEADS)
    add("--steps", type=int, default=C.DEFAULT_STEPS)
    add("--stages", type=int, default=C.DEFAULT_STAGES)
    add("--threshold", type=float, default=DEFAULT_ACTIVATION_THRESHOLD)
    add("--learning-rate", type=float, default=C.DEFAULT_LEARNING_RATE)
    add("--high-loss-threshold", type=float, default=C.DEFAULT_HIGH_LOSS_THRESHOLD)
    add("--target-false-positive-rate", type=float, default=C.DEFAULT_TARGET_FALSE_POSITIVE_RATE)
    add("--validation-gate-consecutive", type=int, default=1,
        help="count a stream-window validation false accept only after this many consecutive windows")
    add("--dynamic-negative-weight", action=argparse.BooleanOptionalAction, default=True)
    add("--negative-weight", type=float, default=C.DEFAULT_NEGATIVE_WEIGHT)
    add("--training-large-default-dataset", dest="training_default_size", action="store_const", const="large",
        default="medium")
    add("--training-medium-default-dataset", dest="training_default_size", action="store_const",
        const="medium")
    add("--training-no-default-dataset", dest="training_default_size", action="store_const", const="none")
    add("--training-dataset", default=None, help="an extra negative feature .npy")
    add("--augment-phrase-prob", type=float, default=C.DEFAULT_AUGMENT_PHRASE_PROB)
    for option, kind, default, _ in _AUGMENT_OPTIONS:
        add(f"--augmentation-{option}", type=kind, default=default)
    add("--logging-steps", type=int, default=C.DEFAULT_LOGGING_STEPS)
    add("--validation-steps", type=int, default=C.DEFAULT_VALIDATION_STEPS)
    add("--checkpoint-steps", type=int, default=C.DEFAULT_CHECKPOINT_STEPS)
    add("--positive-samples", type=int, default=C.DEFAULT_POSITIVE_SAMPLES)
    add("--adversarial-samples", type=int, default=C.DEFAULT_ADVERSARIAL_SAMPLES)
    add("--adversarial-phrases", type=int, default=C.DEFAULT_ADVERSARIAL_PHRASES)
    add("--adversarial-phrase-custom", action="append", default=[])
    add("--prefix-negative-phrases", type=int, default=0)
    add("--collision-swap-phrases", type=int, default=0)
    add("--collision-swap-depth", type=int, default=1)
    add("--positive-batch-size", type=int, default=C.DEFAULT_POSITIVE_BATCH_SIZE)
    add("--negative-batch-size", type=int, default=C.DEFAULT_NEGATIVE_BATCH_SIZE)
    add("--synthetic-negative-samples", type=int, default=0)
    add("--partial-samples", type=int, default=0)
    add("--partial-batch-size", type=int, default=C.DEFAULT_PARTIAL_BATCH_SIZE)
    add("--stream-negative-samples", type=int, default=0)
    add("--collision-negative-samples", type=int, default=0)
    add("--clean-positive-samples", type=int, default=0)
    add("--reverb-positive-samples", type=int, default=0)
    add("--adversarial-batch-size", type=int, default=C.DEFAULT_ADVERSARIAL_BATCH_SIZE)
    add("--num-batch-threads", type=int, default=C.DEFAULT_BATCH_THREADS)
    add("--validation-positive-batch-size", type=int, default=C.DEFAULT_VALIDATION_POSITIVE_BATCH_SIZE)
    add("--validation-negative-batch-size", type=int, default=C.DEFAULT_VALIDATION_NEGATIVE_BATCH_SIZE)
    add("--validation-samples", type=int, default=C.DEFAULT_VALIDATION_SAMPLES)
    add("--validation-stream-negative-samples", type=int, default=0)
    add("--testing-positive-samples", type=int, default=C.DEFAULT_TESTING_POSITIVE_SAMPLES)
    add("--testing-adversarial-samples", type=int, default=C.DEFAULT_TESTING_ADVERSARIAL_SAMPLES)
    add("--checkpoint-dir", default="./checkpoints")
    add("--tts-backend", choices=["vits", "formant", "formant-device"], default=None)
    add("--mesh", action=argparse.BooleanOptionalAction, default=True,
        help="train data-parallel over every rank (torchrun) when there is more than one")
    add("--resume", action=argparse.BooleanOptionalAction, default=False)
    add("--device", default="cuda", help="cuda (default) or cpu")
    _add_debug(train)


def _mesh(device: DeviceLike, timeout: Optional[datetime.timedelta] = None) -> Any:
    """The data-parallel mesh of this process's ranks (torchrun's environment,
    or one rank); only rank 0 logs below warnings."""
    from heybuddy_tpu_torch.parallel.mesh import distributed_init, get_mesh
    from heybuddy_tpu_torch.utils.log import logger

    if int(os.environ.get("RANK", "0")) != 0:
        logger.setLevel(logging.WARNING)
    distributed_init(device=device, timeout=timeout)
    mesh = get_mesh(device=device)
    logger.info(f"Running over mesh: {mesh}")
    return mesh


def _load_any_model(path: str, device: DeviceLike = "cuda") -> Any:
    """An npz checkpoint, a reference ``.pt`` state dict or an ``.onnx`` head, on ``device``."""
    from heybuddy_tpu_torch.models.wakeword import WakeWordMLPModel, load_model

    if path.endswith(".pt"):
        return WakeWordMLPModel.from_torch_file(path, device=device)
    if path.endswith(".onnx"):
        from heybuddy_tpu_torch.runtime.onnx_model import WakeWordONNXModel

        return WakeWordONNXModel(path, device=device)
    return load_model(path, device=device)


def _predict(args: argparse.Namespace) -> int:
    model = _load_any_model(args.checkpoint, device=args.device)
    times = model.predict_timecodes(args.audio, threshold=args.threshold)
    if not times:
        print("No wake words detected.")
    for t in times:
        print(f"Wake word detected at {t:.1f}s")
    return 0


def _listen(args: argparse.Namespace) -> int:
    from heybuddy_tpu_torch.runtime.listen import run_listen

    for path in [*args.checkpoints, *([args.input_wav] if args.input_wav else [])]:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{path} does not exist")
    run_listen(list(args.checkpoints), threshold=args.threshold, buffer_size=args.buffer_size,
               input_wav=args.input_wav, use_vad=args.use_vad, consecutive=args.consecutive, device=args.device)
    return 0


def _combine(args: argparse.Namespace) -> int:
    import numpy as np

    from heybuddy_tpu_torch.data.precalculated import get_default_dataset_dir
    from heybuddy_tpu_torch.utils.npy import AppendableNpyFile

    directory = args.directory or get_default_dataset_dir()
    target = args.target
    target_path = target if target.endswith(".npy") else os.path.join(directory, f"{target}.npy")
    if args.reset and os.path.exists(target_path):
        os.remove(target_path)
    store = AppendableNpyFile(target_path)
    sources: List[str] = []
    for pattern in args.source:
        if os.path.exists(pattern):
            sources.append(pattern)
        else:
            sources.extend(sorted(glob.glob(pattern)))
            sources.extend(sorted(glob.glob(os.path.join(directory, pattern))))
    if not sources:
        print("Error: No source shards found", file=sys.stderr)
        return 1
    total = 0
    for path in sources:
        shard = np.load(path, mmap_mode="r")
        for start in range(0, shard.shape[0], args.batch_size):
            rows = np.asarray(shard[start : start + args.batch_size])
            if args.half:
                rows = rows.astype(np.float16)
            store.append(rows)
            total += rows.shape[0]
        if args.delete:
            os.remove(path)
    print(f"Combined {total} rows from {len(sources)} shard(s) into {target_path}")
    return 0


def _extract(args: argparse.Namespace) -> int:
    from heybuddy_tpu_torch.data.extract import LabeledFeatureExtractor, iter_hf_dataset, iter_wav_files
    from heybuddy_tpu_torch.data.precalculated import get_default_dataset_dir

    mesh = _mesh(args.device) if args.mesh else None
    extractor = LabeledFeatureExtractor(
        directory=args.directory or get_default_dataset_dir(),
        name=args.name,
        samples_per_file=args.samples_per_file,
        process_batch_size=args.process_batch_size,
        tokenizer_max_length=args.tokenizer_max_length,
        device=args.device,
        mesh=mesh,
    )
    if args.local_files:
        source = iter_wav_files(sorted(glob.glob(args.source)))
    else:
        source = iter_hf_dataset(
            args.source,
            config=args.config,
            split=args.split,
            streaming=args.streaming,
            audio_key=args.audio_key,
            audio_array_key=args.audio_array_key,
            audio_sample_rate_key=args.audio_sample_rate_key,
            transcript_key=args.transcript_key,
            trust_remote_code=args.trust_remote_code,
        )
    paths = extractor(source, max_hours=args.hours)
    if mesh is None or mesh.rank == 0:
        print(f"Wrote {len(paths)} shard(s):")
        for path in paths:
            print(f"  {path}")
    return 0


def _train(args: argparse.Namespace) -> int:
    from heybuddy_tpu_torch.parallel.mesh import broadcast_seed, main_process_first, world_size
    from heybuddy_tpu_torch.training.trainer import WakeWordTrainer
    from heybuddy_tpu_torch.utils.log import logger

    # as JAX's device_count() > 1 check: a mesh only over several ranks
    mesh = _mesh(args.device, MESH_TIMEOUT) if args.mesh and world_size() > 1 else None
    # JAX's one program draws one batch a step for the whole mesh: the sets
    # without a seed of their own shuffle from a seed rank 0 drew, and the
    # threaded host path serves rank 0's batches
    seed = broadcast_seed(mesh) if mesh is not None else None
    with main_process_first(mesh):  # rank 0 generates missing caches; the others then load them
        training, validation, testing = _train_data(args, logger, args.device if mesh is None else mesh.device,
                                                    negative_seed=seed)
    for iterator in (training, validation, testing):
        if iterator is not None:
            iterator.mesh = mesh
    trainer = WakeWordTrainer(
        checkpoint_dir=args.checkpoint_dir,
        learning_rate=args.learning_rate,
        architecture=args.architecture,
        layer_dim=args.layer_dim,
        num_layers=args.num_layers,
        num_heads=args.num_heads,
        use_gating=args.use_gating,
        use_half_layers=args.use_half_layers,
        device=args.device,
        mesh=mesh,
    )
    name = "-".join(args.phrase.split())
    if args.resume:
        trainer.resume(name)
    trainer(
        training,
        validation=validation,
        testing=testing,
        num_steps=args.steps,
        num_stages=args.stages,
        max_negative_weight=args.negative_weight,
        logging_steps=args.logging_steps,
        validation_steps=args.validation_steps,
        checkpoint_steps=args.checkpoint_steps,
        target_false_positive_rate=args.target_false_positive_rate,
        validation_gate_consecutive=args.validation_gate_consecutive,
        dynamic_negative_weight=args.dynamic_negative_weight,
        learning_rate=args.learning_rate,
        high_loss_threshold=args.high_loss_threshold,
        activation_threshold=args.threshold,
        wandb_entity=args.wandb_entity,
        name=name,
    )
    if mesh is None or mesh.rank == 0:
        print(f"Training complete; final checkpoint: {trainer.checkpoint_dir}/{name}_final.npz")
    return 0


def _train_data(args: argparse.Namespace, logger: Any, device: DeviceLike, negative_seed: Optional[int] = None) -> Any:
    """train's (training, validation, testing) iterators; building them
    generates the feature caches that are missing or short. The sets without
    a seed of their own (the hosted ones, ``--training-dataset``) shuffle from
    ``negative_seed``, ``+ 1``, ``+ 2`` (fresh entropy without one)."""
    from heybuddy_tpu_torch.data.precalculated import PrecalculatedDatasetIterator
    from heybuddy_tpu_torch.data.training import WakeWordTrainingDatasetIterator
    from heybuddy_tpu_torch.ops.augment import AugmentConfig
    from heybuddy_tpu_torch.text.adversarial import prefix_negative_texts, single_swap_collision_texts

    phrase = args.phrase
    phrases = [phrase] + list(args.additional_phrase)
    phrase_arg: Any = phrases if len(phrases) > 1 else phrase
    augment_config = AugmentConfig(**{
        field: getattr(args, f"augmentation_{option.replace('-', '_')}")
        for option, _, _, field in _AUGMENT_OPTIONS
    })
    custom_texts = list(args.adversarial_phrase_custom)
    if args.prefix_negative_phrases:
        prefix_texts = prefix_negative_texts(phrase, num_samples=args.prefix_negative_phrases)
        logger.info(f"Prefix-negative pool: {len(prefix_texts)} texts (e.g. {prefix_texts[:3]})")
        custom_texts.extend(prefix_texts)
    if args.collision_swap_phrases:
        swap_texts = single_swap_collision_texts(
            phrase, num_samples=args.collision_swap_phrases, max_swaps=args.collision_swap_depth
        )
        logger.info(f"Swap-collision pool (depth<={args.collision_swap_depth}): {len(swap_texts)} texts "
                    f"(e.g. {swap_texts[:3]})")
        custom_texts.extend(swap_texts)
    feature_kwargs: Dict[str, Any] = dict(
        augment_config=augment_config,
        phrase_augment_prob=args.augment_phrase_prob,
        custom_adversarial_texts=custom_texts or None,
        tts_backend=args.tts_backend,
        device=device,
    )
    # no hosted negative set at all with --training-no-default-dataset, even
    # when a --training-dataset is given (it is appended below)
    negative_batch_size = 0 if args.training_default_size == "none" else args.negative_batch_size
    training = WakeWordTrainingDatasetIterator.default(
        phrase_arg,
        positive_samples=args.positive_samples,
        adversarial_samples=args.adversarial_samples,
        adversarial_phrases=args.adversarial_phrases,
        positive_batch_size=args.positive_batch_size,
        adversarial_batch_size=args.adversarial_batch_size,
        negative_batch_size=negative_batch_size,
        partial_samples=args.partial_samples,
        partial_batch_size=args.partial_batch_size,
        stream_negative_samples=args.stream_negative_samples,
        collision_negative_samples=args.collision_negative_samples,
        clean_positive_samples=args.clean_positive_samples,
        reverb_positive_samples=args.reverb_positive_samples,
        num_batch_threads=args.num_batch_threads,
        large_negative_dataset=args.training_default_size == "large",
        synthetic_negative_samples=args.synthetic_negative_samples,
        negative_seed=negative_seed,
        **feature_kwargs,
    )

    def seed(offset: int) -> Optional[int]:
        return None if negative_seed is None else negative_seed + offset

    if args.training_dataset is not None:
        import numpy as np

        if not os.path.isfile(args.training_dataset):
            raise FileNotFoundError(f"--training-dataset {args.training_dataset} does not exist")
        custom = PrecalculatedDatasetIterator(
            os.path.splitext(os.path.basename(args.training_dataset))[0],
            directory=os.path.dirname(os.path.abspath(args.training_dataset)),
            labeled=np.load(args.training_dataset, mmap_mode="r").shape[1] == 17,
            exclude_phrase=phrase,
            seed=seed(1),
        )
        training.negative.append((custom, C.DEFAULT_NEGATIVE_BATCH_SIZE))

    validation = None
    if args.validation_samples > 0:
        validation = WakeWordTrainingDatasetIterator.validation(
            phrase_arg,
            validation_samples=args.validation_samples,
            positive_batch_size=args.validation_positive_batch_size,
            negative_batch_size=args.validation_negative_batch_size,
            stream_negative_samples=args.validation_stream_negative_samples,
            negative_seed=seed(2),
            **feature_kwargs,
        )
    testing = None
    if args.testing_positive_samples > 0 or args.testing_adversarial_samples > 0:
        testing = WakeWordTrainingDatasetIterator.testing(
            phrase_arg,
            positive_samples=args.testing_positive_samples,
            adversarial_samples=args.testing_adversarial_samples,
            **feature_kwargs,
        )
    return training, validation, testing


def _convert(args: argparse.Namespace) -> int:
    from heybuddy_tpu_torch.export.onnx_export import export_mlp_model
    from heybuddy_tpu_torch.models.wakeword import read_checkpoint

    config, params = read_checkpoint(args.checkpoint)
    if config["architecture"] != "perceptron":
        raise NotImplementedError(
            "ONNX export currently supports the perceptron architecture; "
            "use architecture='perceptron' for browser deployment."
        )
    output = args.output or os.path.splitext(args.checkpoint)[0] + ".onnx"
    export_mlp_model(params, config, output, opset_version=args.opset_version)
    print(f"Wrote {output}")
    return 0


def _pretrain_embedding(args: argparse.Namespace) -> int:
    from heybuddy_tpu_torch.training.embedding_pretrain import EmbeddingPretrainer
    from heybuddy_tpu_torch.utils.log import logger
    from heybuddy_tpu_torch.utils.profiling import GLOBAL_STAGE_TIMES

    pretrainer = EmbeddingPretrainer(
        num_texts=args.num_texts,
        speakers_per_text=args.speakers_per_text,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        temperature=args.temperature,
        tts_backend=args.tts_backend,
        adversarial_fraction=args.adversarial_fraction,
        focus_phrase=args.focus_phrase,
        focus_swap_depth=args.focus_swap_depth,
        focus_swap_max_swaps=args.focus_swap_max_swaps,
        hard_pair_margin=args.hard_pair_margin,
        hard_pair_weight=args.hard_pair_weight,
        seed=args.seed,
        device=args.device,
    )
    pretrainer.train(steps=args.steps)
    pretrainer.save(args.output)
    logger.info(f"Stage times:\n{GLOBAL_STAGE_TIMES.summary()}")
    print(f"Wrote {args.output}; set HEYBUDDY_EMBEDDING_WEIGHTS={args.output} to use it.")
    return 0


_COMMANDS = {
    "train": _train, "convert": _convert, "predict": _predict, "listen": _listen, "extract": _extract,
    "combine": _combine, "pretrain-embedding": _pretrain_embedding,
}


def main(argv: Optional[List[str]] = None) -> int:
    from heybuddy_tpu_torch.utils.log import debug_logger

    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    with debug_logger() if args.debug else contextlib.nullcontext():
        return _COMMANDS[args.command](args)
