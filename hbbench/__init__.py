"""
The benchmark of ``heybuddy_tpu_torch`` on an NVIDIA H100.

    python -m hbbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json``: a model configuration
(``hbbench/configs/<name>.json``) under a traffic mix
(``hbbench/traffic/<name>.json``, read by the generator of its kind,
``hbbench/traffic/<kind>.py``). It builds the inputs and the weights from the
seed, warms every shape the cell uses, measures for ``--seconds`` seconds,
checks what the timed path produced against the plain reference
(``hbbench/reference/``) and prints one JSON line. With ``--trace 1`` the
window runs under ``torch.profiler`` and the line holds the per-layer
metrics, each computed by its own reader (``hbbench/metrics/<metric>.py``).
A new cell, configuration, traffic mix or metric is a new file.
"""
