"""The port imports neither jax nor any module of the JAX package."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
import heybuddy_tpu_torch
names = [m.name for m in pkgutil.walk_packages(heybuddy_tpu_torch.__path__, "heybuddy_tpu_torch.")]
for name in names:
    if not name.endswith("__main__"):  # running it would parse argv
        importlib.import_module(name)
import chip_smoke  # the chip check imports the port only
import step_calibration  # and so does its calibration of the transformer step
jax_like = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
reference = sorted(m for m in sys.modules if m == "heybuddy_tpu" or m.startswith("heybuddy_tpu."))
print(len(names), jax_like, reference)
assert not jax_like, jax_like
assert not reference, reference
print(" ".join(names))
"""

# the modules of the generation slice: TTS, text front end, augmentation, the
# fused render path and the generation half of the feature caches
GENERATION_MODULES = (
    "heybuddy_tpu_torch.text.phonemizer",
    "heybuddy_tpu_torch.text.espeak",
    "heybuddy_tpu_torch.text.wordlist",
    "heybuddy_tpu_torch.text.adversarial",
    "heybuddy_tpu_torch.models.formant",
    "heybuddy_tpu_torch.models.tts",
    "heybuddy_tpu_torch.models.formant_device",
    "heybuddy_tpu_torch.ops.augment",
    "heybuddy_tpu_torch.data.augmented",
    "heybuddy_tpu_torch.data.tts_generator",
    "heybuddy_tpu_torch.data.features",
)

# the modules of the stream and listen slice: stream synthesis, the VAD and
# the runtime
STREAM_LISTEN_MODULES = (
    "heybuddy_tpu_torch.data.streams",
    "heybuddy_tpu_torch.models.vad",
    "heybuddy_tpu_torch.runtime.onnx_model",
    "heybuddy_tpu_torch.runtime.model_thread",
    "heybuddy_tpu_torch.runtime.listen",
)

# the modules of the pretraining slice: the pretrainer, the neural G2P, the
# browser exporters' module, codecs and profiling
PRETRAIN_MODULES = (
    "heybuddy_tpu_torch.training.embedding_pretrain",
    "heybuddy_tpu_torch.text.neural_g2p",
    "heybuddy_tpu_torch.export.onnx_export",
    "heybuddy_tpu_torch.utils.codecs",
    "heybuddy_tpu_torch.utils.profiling",
)

# the modules of the ONNX importer and VITS slice
ONNX_VITS_MODULES = (
    "heybuddy_tpu_torch.export.onnx_to_torch",
    "heybuddy_tpu_torch.models.vits.modules",
    "heybuddy_tpu_torch.models.vits.attention",
    "heybuddy_tpu_torch.models.vits.transforms",
    "heybuddy_tpu_torch.models.vits.synthesizer",
    "heybuddy_tpu_torch.models.vits.training",
    "heybuddy_tpu_torch.ops.monotonic_align",
    "heybuddy_tpu_torch.text.piper_maps",
    "heybuddy_tpu_torch.tools.train_tiny_voice",
)


# the modules of the mesh slice: the parallel package and its runs
PARALLEL_MODULES = (
    "heybuddy_tpu_torch.parallel",
    "heybuddy_tpu_torch.parallel.mesh",
    "heybuddy_tpu_torch.parallel.distributed_smoke",
    "heybuddy_tpu_torch.parallel.dryrun",
)

# the quality harness (scripts/quality_eval.py's counterpart)
QUALITY_MODULES = ("heybuddy_tpu_torch.tools.quality_eval",)

# the last tools (the scripts' and the example's counterparts)
TOOLS_MODULES = (
    "heybuddy_tpu_torch.tools.g2p_accuracy",
    "heybuddy_tpu_torch.tools.train_neural_g2p",
    "heybuddy_tpu_torch.tools.mel_precision_probe",
    "heybuddy_tpu_torch.tools.diagnose_stream_fps",
    "heybuddy_tpu_torch.tools.embedding_separation_probe",
    "heybuddy_tpu_torch.examples",
    "heybuddy_tpu_torch.examples.train_wake_word",
    "heybuddy_tpu_torch.tools.kernel_perf_sweep",
    "heybuddy_tpu_torch.tools.end_to_end_bench",
)


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    result = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert result.returncode == 0, result.stderr + result.stdout
    lines = result.stdout.strip().splitlines()
    count = int(lines[-2].split()[0])
    assert count >= 26  # every module of the port was walked
    walked = set(lines[-1].split())
    assert set(GENERATION_MODULES) <= walked, sorted(set(GENERATION_MODULES) - walked)
    assert set(STREAM_LISTEN_MODULES) <= walked, sorted(set(STREAM_LISTEN_MODULES) - walked)
    assert set(PRETRAIN_MODULES) <= walked, sorted(set(PRETRAIN_MODULES) - walked)
    assert set(ONNX_VITS_MODULES) <= walked, sorted(set(ONNX_VITS_MODULES) - walked)
    assert set(PARALLEL_MODULES) <= walked, sorted(set(PARALLEL_MODULES) - walked)
    assert set(QUALITY_MODULES) <= walked, sorted(set(QUALITY_MODULES) - walked)
    assert set(TOOLS_MODULES) <= walked, sorted(set(TOOLS_MODULES) - walked)
