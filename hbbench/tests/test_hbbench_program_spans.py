"""The program's spans in a trace (``hbbench/program_spans.py``): on a made-up
timeline, self times, launches put down to the innermost range of their
runtime call, idle gaps named by program ranges, the existing keys
unchanged; each new reader with and without its span; a traced run of each
cell on the CPU at small sizes; and on the card, a span around a known
count of launches."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from hbbench import program_spans, run, spec, tracing
from small import SMALL

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _event(name, device, start, end, id=0, annotation=False, thread=1):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation, id=id, thread=thread,
                           time_range=SimpleNamespace(start=start, end=end))


def _range(name, start, end, thread=1):
    return _event(name, CPU, start, end, annotation=True, thread=thread)


def _launch(start, id, name="cudaLaunchKernel", thread=1):
    return _event(name, CPU, start, start + 5, id=id, thread=thread)


def _kernel(name, start, end, id):
    return _event(name, CUDA, start, end, id=id)


def _timeline():
    """A step of two phases and an evaluation, under the benchmark's own spans."""
    return [
        _event("hbbench/window", CPU, 0, 1000, annotation=True),
        _event("hbbench/step", CPU, 0, 600, annotation=True),
        _event("hbbench/eval", CPU, 600, 1000, annotation=True),
        _range("trainer/step", 10, 590),
        _range("trainer/forward", 20, 200),
        _range("trainer/backward", 250, 450),
        _range("trainer/eval", 610, 990),
        _event("aten::mm", CPU, 30, 60, id=101),  # an op's id may equal a launch's: it is no launch
        _launch(40, 101), _kernel("kernel_a", 100, 300, 101),
        _launch(260, 102, "cuLaunchKernel"), _kernel("kernel_b", 300, 400, 102),
        _launch(470, 103), _kernel("kernel_a", 470, 480, 103),  # in the step, outside its phases
        _launch(620, 104), _kernel("kernel_c", 700, 800, 104),
        _launch(995, 105), _kernel("kernel_a", 995, 999, 105),  # after every program range
        _event("trainer/step", CUDA, 10, 590, annotation=True),  # a device-side annotation is no operation
    ]


def _trace(events):
    trace = tracing.summary(events, 1e-3)
    trace.update(program_spans.reduce(events, trace))
    return trace


def test_reduction_on_a_made_up_timeline():
    t = _trace(_timeline() + [_kernel("kernel_d", 700, 701, 106)])  # no runtime call: unattributed
    spans = t["program_spans"]
    assert spans["trainer/step"]["host_s"] == pytest.approx([580e-6])
    assert spans["trainer/step"]["self_s"] == pytest.approx([(580 - 180 - 200) * 1e-6])
    assert spans["trainer/forward"]["self_s"] == pytest.approx([180e-6])
    launches = {name: (s["launches"], s["device_s"]) for name, s in spans.items() if s["launches"]}
    assert launches == {
        "trainer/forward": (1, pytest.approx(200e-6)), "trainer/backward": (1, pytest.approx(100e-6)),
        "trainer/step": (1, pytest.approx(10e-6)), "trainer/eval": (1, pytest.approx(100e-6)),
        program_spans.OUTSIDE: (1, pytest.approx(4e-6)),
    }
    assert spans[program_spans.OUTSIDE]["unattributed_launches"] == 1
    # idle gaps [0, 100) [400, 470) [480, 700) [800, 995) [999, 1000), each named by the range
    # the host was in at its start
    assert t["idle_by_program_span"] == pytest.approx({
        program_spans.OUTSIDE: 101e-6, "trainer/backward": 70e-6, "trainer/step": 220e-6, "trainer/eval": 195e-6,
    })
    # the same seconds split by the range open while they passed: [0, 100) is 10 outside,
    # 10 in the step, 80 in its forward; [480, 700) the step's until 590, outside until the
    # evaluation opens at 610, then the evaluation's
    assert t["idle_in_program_span"] == pytest.approx({
        program_spans.OUTSIDE: (10 + 20 + 5 + 1) * 1e-6, "trainer/forward": 80e-6, "trainer/backward": 50e-6,
        "trainer/step": (10 + 20 + 110) * 1e-6, "trainer/eval": (90 + 190) * 1e-6,
    })


def test_existing_keys_keep_their_values():
    events = _timeline()
    without = [e for e in events if not program_spans._is_range(e)]
    base, added = tracing.summary(without, 1e-3), _trace(events)
    for key in ("busy_s", "window_s", "kernels", "kernel_seconds", "idle_by_span"):
        assert added[key] == base[key], key
    b, a = tracing.breakdown(base), program_spans.breakdown(added)
    assert a["device_ops"] == b["device_ops"] and a["idle_gaps"] == b["idle_gaps"]
    assert a["idle_gaps_program"][0] == ["trainer/step", pytest.approx(220e-6)]
    assert program_spans.breakdown(None) is None and "idle_gaps_program" not in program_spans.breakdown(base)


def test_threads_and_nesting():
    """A launch goes to the innermost range on its own thread; a thread that
    opened no range has its launches put down by any thread's innermost."""
    events = [
        _range("listen/score", 0, 100, thread=1), _range("wakeword/head", 60, 90, thread=1),
        _range("trainer/step", 0, 100, thread=2),
        _launch(70, 1, thread=2), _kernel("k", 70, 80, 1),  # thread 2's range, not thread 1's head
        _launch(75, 2, thread=1), _kernel("k", 80, 85, 2),
        _launch(65, 3, thread=9), _kernel("k", 85, 95, 3),  # thread 9 opened nothing: the innermost open
    ]
    spans = _trace(events)["program_spans"]
    assert spans["trainer/step"]["launches"] == 1 and spans["wakeword/head"]["launches"] == 2
    assert spans["listen/score"]["self_s"] == pytest.approx([70e-6])


def _ctx(trace):
    return SimpleNamespace(recorder=SimpleNamespace(trace=trace))


def _reader_trace():
    events = [
        _event("hbbench/window", CPU, 0, 10_000, annotation=True),
        _range("features/drain/copy", 0, 3000), _range("features/drain/copy", 5000, 6000),
        _range("formant/render", 100, 200), _range("formant/render", 300, 400),
        _launch(110, 1), _kernel("r", 110, 120, 1), _launch(120, 2), _kernel("r", 120, 130, 2),
        _launch(310, 3), _kernel("r", 310, 320, 3),
        _range("trainer/step", 7000, 7010), _range("trainer/step", 7100, 7130), _range("trainer/step", 7200, 7220),
        _range("listen/score", 8000, 8100), _range("wakeword/prepare", 8000, 8010),
        _range("featurizer/embed", 8010, 8060), _range("wakeword/contexts", 8060, 8065),
        _range("wakeword/head", 8065, 8095),
        _range("listen/score", 9000, 9200), _range("wakeword/prepare", 9000, 9020),
        _range("featurizer/embed", 9020, 9100), _range("wakeword/contexts", 9100, 9110),
        _range("wakeword/head", 9110, 9180),
    ]
    return _trace(events)


@pytest.mark.parametrize("metric, value", [
    ("drain_wait_ms.gen", 2.0), ("render_launches.gen", 1.5), ("step_host_ms_p50.train", 0.02),
    ("head_ms_p50.listen", 0.05), ("score_self_ms_p50.listen", 0.035),
])
def test_each_reader_reads_its_span_and_nothing_without_it(metric, value):
    reader = spec.reader(metric)
    assert reader.read(_ctx(_reader_trace())) == pytest.approx(value)
    assert reader.read(_ctx(None)) is None
    assert reader.read(_ctx({"kernels": []})) is None  # a trace without the program's spans
    assert reader.read(_ctx(_trace([_event("hbbench/window", CPU, 0, 10, annotation=True)]))) is None


def test_the_metrics_are_benchmark_entries():
    for m in program_spans.METRICS:
        assert spec.NAME.match(m["name"]) and spec.UNIT.match(m["unit"])
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in spec.benchmark()["end_to_end"]}
        assert all(w in {c["name"] for c in spec.benchmark()["workloads"]} for w in m["workloads"])


def test_added_restores_the_harness():
    with program_spans.added() as traces:
        assert tracing.summary is not program_spans._ORIGINAL["summary"] and run.breakdown is program_spans.breakdown
        trace = tracing.summary(_timeline(), 1e-3)
        assert traces == [trace] and "program_spans" in trace
    assert tracing.summary is program_spans._ORIGINAL["summary"]
    assert run.breakdown is program_spans._ORIGINAL["breakdown"]


@pytest.mark.parametrize("cell", ["gen-fused.v8-mlp", "train.v8-transformer", "listen.v8-mlp"])
def test_a_traced_run_on_the_cpu_reads_the_programs_spans(cell):
    bench = spec.benchmark()
    bench = dict(bench, per_layer=bench["per_layer"] + program_spans.METRICS)
    with program_spans.added():
        result = run.run_cell(cell, 11, 0.5, True, torch.device("cpu"), bench=bench, overrides=SMALL[cell])
    assert result["correct"], result["checks"]
    for m in program_spans.METRICS:
        if cell in m["workloads"]:
            assert m["name"] in result["metrics"], m["name"]
    assert "idle_gaps_program" in result["breakdown"]


@pytest.mark.card
def test_spans_count_their_launches_and_device_time(cuda_device):
    """A span around a known count of launches, and one around K1 and K2,
    which are launched through ``build.launch`` and not an aten op. One
    profiler session: a second one in a process records no ``cuLaunchKernel`` launch
    (measured on torch 2.11)."""
    from heybuddy_tpu_torch.models.featurizer import featurize_batch, get_speech_embeddings
    from heybuddy_tpu_torch.utils.profiling import span

    a = torch.randn(4096, 4096, device=cuda_device)
    net = get_speech_embeddings(device=cuda_device).net
    audio = torch.randn(64, 23040, device=cuda_device) * 3000.0
    for _ in range(3):
        a @ a  # warm
    featurize_batch(net, audio)  # build and warm
    recorder = tracing.Recorder(cuda_device)
    with program_spans.added():
        recorder.start_trace()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with span("test/launches"):
            start.record()
            for _ in range(20):
                a @ a
            end.record()
        torch.cuda.synchronize(cuda_device)
        with span("test/featurize"):
            featurize_batch(net, audio)
        recorder.reduce()
    recorder.close()
    spans = recorder.trace["program_spans"]
    assert spans["test/launches"]["launches"] == 20
    assert spans["test/launches"]["device_s"] == pytest.approx(start.elapsed_time(end) / 1e3, rel=0.05)
    names = [k[0] for k in recorder.trace["kernels"]]
    assert any("mel_patches" in n for n in names) and any("embedding_trunk" in n for n in names), names
    assert spans["test/featurize"]["launches"] == len(names) - 20, (spans, names)
    assert program_spans.OUTSIDE not in spans, spans[program_spans.OUTSIDE]
