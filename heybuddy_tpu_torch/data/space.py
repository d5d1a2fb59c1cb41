"""
Feature-space coherence guards for feature caches.

Counterpart of the JAX package's ``data/space.py``, with the same rules and
warnings:

1. Each cache carries a ``<name>.space.json`` sidecar with the producing
   embedding's ``space_id`` (the port's ``SpeechEmbeddings.space_id`` equals
   the JAX package's for the same weights), its backend and the synthesis
   source (``tts_provenance``). A cache whose sidecar disagrees is stale
   (``HEYBUDDY_KEEP_STALE_FEATURES=1`` keeps it); one without a sidecar is
   stamped.
2. The hosted precalculated sets were featurized by the reference's frozen
   ONNX embedding, so they are used when the active featurizer is that
   imported graph (``HEYBUDDY_EMBEDDING_ONNX``, backend "onnx"), or when a
   local file of that name carries a sidecar of the active space, and are
   disabled otherwise (``HEYBUDDY_ALLOW_SPACE_MISMATCH=1`` forces them).

``device`` names the shared featurizer whose space is active; it defaults to
the card, as every entry point of the port does.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from heybuddy_tpu_torch.device import DeviceLike
from heybuddy_tpu_torch.utils.log import logger

__all__ = [
    "active_space",
    "tts_provenance",
    "write_space_sidecar",
    "read_space_sidecar",
    "check_cache_space",
    "hosted_sets_compatible",
]

# the only synthesis source that existed before sidecars recorded one: a
# legacy sidecar without a "tts" field is read as this
_LEGACY_TTS = "formant:2"


def _g2p_name() -> str:
    """The name of the phonemizer synthesis uses (``text/phonemizer.py``)."""
    from heybuddy_tpu_torch.text.phonemizer import get_phonemizer

    return getattr(get_phonemizer(), "name", "simple")


def tts_provenance(backend: Optional[str] = None) -> str:
    """Stable id of the synthesis source that feeds a cache (backend, versions, G2P)."""
    from heybuddy_tpu_torch.models.formant import FORMANT_VERSION
    from heybuddy_tpu_torch.models.formant_device import DEVICE_FORMANT_VERSION
    from heybuddy_tpu_torch.models.tts import SAMPLING_VERSION, resolve_tts_backend

    backend = resolve_tts_backend(backend)
    g2p = _g2p_name()
    g2p_tag = "" if g2p == "simple" else f";g2p:{g2p}"
    if backend == "formant":
        return f"formant:{FORMANT_VERSION};s{SAMPLING_VERSION}{g2p_tag}"
    if backend == "formant-device":
        return f"formant-device:{FORMANT_VERSION}.{DEVICE_FORMANT_VERSION};s{SAMPLING_VERSION}{g2p_tag}"
    ckpt = os.environ.get("HEYBUDDY_TTS_CHECKPOINT", "")
    return f"vits:{os.path.basename(ckpt)};s{SAMPLING_VERSION}{g2p_tag}"


def active_space(tts_backend: Optional[str] = None, device: DeviceLike = "cuda") -> Dict[str, str]:
    """The active featurizer's space descriptor."""
    from heybuddy_tpu_torch.models.featurizer import get_speech_embeddings

    emb = get_speech_embeddings(device=device)
    return {"space_id": emb.space_id, "backend": emb.backend, "tts": tts_provenance(tts_backend)}


def _sidecar_path(npy_path: str) -> str:
    return os.path.splitext(npy_path)[0] + ".space.json"


def write_space_sidecar(npy_path: str, space: Dict[str, str]) -> None:
    with open(_sidecar_path(npy_path), "w") as f:
        json.dump(space, f)


def read_space_sidecar(npy_path: str) -> Optional[Dict[str, Any]]:
    path = _sidecar_path(npy_path)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def check_cache_space(
    npy_path: str, tts_backend: Optional[str] = None, device: DeviceLike = "cuda"
) -> bool:
    """
    True when ``npy_path`` may be used with the active embedding and synthesis
    source: no store, a matching sidecar, or a legacy store without a sidecar
    (stamped, with a warning). False means the cache is stale.
    """
    if not os.path.exists(npy_path):
        return True
    sidecar = read_space_sidecar(npy_path)
    current = active_space(tts_backend, device)
    name = os.path.basename(npy_path)
    if sidecar is None:
        logger.warning(
            f"Feature store {name} predates space tracking; stamping it with the active "
            f"embedding space {current['space_id']}. Delete the .npy if it was produced by "
            "a different embedding."
        )
        try:
            write_space_sidecar(npy_path, current)
        except OSError as ex:
            # a read-only dataset directory stays usable: the stamp is not required
            logger.warning(f"Could not stamp {name}: {ex}")
        return True
    sidecar_tts = sidecar.get("tts", _LEGACY_TTS)
    keep = bool(os.environ.get("HEYBUDDY_KEEP_STALE_FEATURES"))
    if sidecar.get("space_id") == current["space_id"]:
        if sidecar_tts == current["tts"]:
            return True
        if keep:
            logger.warning(
                f"Feature store {name} was synthesized by {sidecar_tts} but the active TTS is "
                f"{current['tts']}; keeping it because HEYBUDDY_KEEP_STALE_FEATURES is set."
            )
            return True
        logger.warning(
            f"Feature store {name} was synthesized by {sidecar_tts} but the active TTS is "
            f"{current['tts']}; regenerating. Set HEYBUDDY_KEEP_STALE_FEATURES=1 to keep stale caches."
        )
        return False
    if keep:
        logger.warning(
            f"Feature store {name} was produced by embedding space {sidecar.get('space_id')} "
            f"but the active space is {current['space_id']}; keeping it because "
            "HEYBUDDY_KEEP_STALE_FEATURES is set. Training on mixed feature spaces degrades "
            "the classifier."
        )
        return True
    logger.warning(
        f"Feature store {name} was produced by embedding space {sidecar.get('space_id')} "
        f"(backend {sidecar.get('backend')}) but the active space is {current['space_id']} "
        f"(backend {current['backend']}); regenerating. Set HEYBUDDY_KEEP_STALE_FEATURES=1 "
        "to keep stale caches."
    )
    return False


def hosted_sets_compatible(
    context: str, local_path: Optional[str] = None, device: DeviceLike = "cuda"
) -> bool:
    """
    Whether the hosted precalculated sets (the reference embedding's space)
    may be used with the active featurizer; logs the decision. A local file
    at ``local_path`` whose sidecar matches the active space is a store of
    this space that shares the hosted name, and is always allowed.
    """
    from heybuddy_tpu_torch.models.featurizer import get_speech_embeddings

    if local_path and os.path.exists(local_path):
        sidecar = read_space_sidecar(local_path)
        if sidecar is not None:
            if sidecar.get("space_id") == active_space(device=device)["space_id"]:
                return True
            name = os.path.basename(local_path)
            if os.environ.get("HEYBUDDY_ALLOW_SPACE_MISMATCH"):
                logger.warning(
                    f"{context}: {name} was produced in embedding space "
                    f"{sidecar.get('space_id')}, not the active space; proceeding because "
                    "HEYBUDDY_ALLOW_SPACE_MISMATCH is set."
                )
                return True
            logger.warning(
                f"{context}: {name} was produced in embedding space {sidecar.get('space_id')}, "
                "which does not match the active embedding — disabling it. Delete the file to "
                "regenerate/redownload, or set HEYBUDDY_ALLOW_SPACE_MISMATCH=1."
            )
            return False

    emb = get_speech_embeddings(device=device)
    if emb.backend == "onnx":
        return True
    if os.environ.get("HEYBUDDY_ALLOW_SPACE_MISMATCH"):
        logger.warning(
            f"{context}: hosted precalculated features are in the reference Google embedding "
            f"space but the active embedding is '{emb.backend}' ({emb.space_id}); proceeding "
            "because HEYBUDDY_ALLOW_SPACE_MISMATCH is set. Expect the classifier to key on the "
            "space difference."
        )
        return True
    logger.warning(
        f"{context}: hosted precalculated features are in the reference Google embedding "
        f"space, which does not match the active embedding '{emb.backend}' ({emb.space_id}) "
        "— disabling them. Point HEYBUDDY_EMBEDDING_ONNX at the reference speech-embedding.onnx to "
        "use hosted sets, place a store of this space (with its .space.json sidecar) at the hosted "
        "name, or set HEYBUDDY_ALLOW_SPACE_MISMATCH=1 to force."
    )
    return False
