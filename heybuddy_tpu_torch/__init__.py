"""
heybuddy_tpu_torch: the PyTorch / CUDA (NVIDIA H100) port of heybuddy_tpu.

Everything the JAX package does, on PyTorch: feature generation (TTS:
formant, the fused formant-device route and VITS; augmentation; stream
negatives), featurization in every formulation (audio -> log-mel -> frozen
speech embedding, or an imported ONNX embedding), the three-stage wake-word
trainer, contrastive embedding pretraining, ``extract``, ``predict``,
``listen`` with the VAD, ONNX export and import, and data parallelism over
several ranks (``parallel/``, on ``torch.distributed``), with hand-written
Hopper kernels for every Pallas kernel of the JAX package
(``ops/kernels``). The package imports torch, numpy and scipy, and never jax
or the JAX package.

Public API (imported on first use), the JAX package's names::

    from heybuddy_tpu_torch import (
        SpeechEmbeddings, WakeWordMLPModel, WakeWordTransformerModel,
        WakeWordTrainer, WakeWordTrainingDatasetIterator,
        TrainingFeaturesGenerator, AugmentConfig,
    )
"""

from heybuddy_tpu_torch import device as _device  # noqa: F401  (TF32 settings)

__version__ = "0.1.0"

_EXPORTS = {
    "SpeechEmbeddings": "heybuddy_tpu_torch.models.featurizer",
    "get_speech_embeddings": "heybuddy_tpu_torch.models.featurizer",
    "WakeWordMLPModel": "heybuddy_tpu_torch.models.wakeword",
    "WakeWordTransformerModel": "heybuddy_tpu_torch.models.wakeword",
    "load_model": "heybuddy_tpu_torch.models.wakeword",
    "WakeWordTrainer": "heybuddy_tpu_torch.training.trainer",
    "WakeWordTrainingDatasetIterator": "heybuddy_tpu_torch.data.training",
    "TrainingFeaturesGenerator": "heybuddy_tpu_torch.data.features",
    "PrecalculatedDatasetIterator": "heybuddy_tpu_torch.data.precalculated",
    "AugmentConfig": "heybuddy_tpu_torch.ops.augment",
    "augment_batch": "heybuddy_tpu_torch.ops.augment",
    "mel_spectrogram": "heybuddy_tpu_torch.ops.kernels.melspec_kernel",
    "get_tts_model": "heybuddy_tpu_torch.models.tts",
    "get_vad_model": "heybuddy_tpu_torch.models.vad",
    "EmbeddingPretrainer": "heybuddy_tpu_torch.training.embedding_pretrain",
}

__all__ = ["__version__"] + sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        module = importlib.import_module(_EXPORTS[name])
        value = getattr(module, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'heybuddy_tpu_torch' has no attribute {name!r}")
