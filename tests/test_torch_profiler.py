"""The port's ``mx.profiler`` over ``torch.profiler``, held against the
JAX package's on the CPU where they share a format.

Mirrors the reference's ``tests/test_profiler.py``: ``set_config`` and
its unknown-key refusal, the scoped ``Task``/``Event`` in the aggregate
table, ``Counter``/``Marker``, the memory lines of ``profile_memory``,
and a start/stop round trip that writes the file; then the table's
header lines and columns against the reference's table for the same
spans, counters and markers, the paused time excluded and reported, a
``reset``, the chrome trace (torch's events, the spans, ``ph:"C"``
counters, instant markers and ``mx.telemetry``'s counters) parsing as
JSON, and the kernel entry-point section fed by ``kernels/_build.call``'s
ranges (a stand-in entry point, since no kernel runs on the CPU).
"""
import json
import time

import numpy as np
import pytest
import torch

from mxnet_tpu import profiler as jprof

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import profiler, telemetry


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    for mod in (profiler, jprof):
        mod.set_state("stop")
        mod.dumps(reset=True)
        mod.set_config(filename=str(tmp_path / "prof.json"),
                       profile_memory=False)
    profiler._traces.clear()
    # the reference names its XProf directory in every table once any
    # run in this process has started a trace (its own tests' too): each
    # test starts from a process that has run none
    jprof._trace_dir = None
    yield
    profiler.set_state("stop")
    profiler.dumps(reset=True)
    profiler._traces.clear()


def test_config_and_state(tmp_path):
    profiler.set_config(filename=str(tmp_path / "prof.json"),
                        profile_all=True)
    with pytest.raises(ValueError):
        profiler.set_config(bogus_key=1)
    assert profiler.state() == "stop"
    with pytest.raises(ValueError):
        profiler.set_state("sprint")


def test_scopes_counters_markers_aggregate():
    with profiler.Task("unit-task"):
        with mx.cpu():
            x = mx.nd.ones((4, 4))
            (x + x).asnumpy()
    ev = profiler.Event("unit-event").start()
    ev.stop()
    c = profiler.Counter("unit-counter", 5)
    c += 3
    c -= 1
    profiler.Marker("unit-marker").mark()
    table = profiler.dumps(reset=True)
    assert "Task::unit-task" in table and "Event::unit-event" in table
    line = [ln for ln in table.splitlines() if ln.startswith("unit-counter")]
    assert line and float(line[0].split()[-1]) == 7.0
    assert "Marker::unit-marker (process)" in table
    assert "unit-task" not in profiler.dumps()


def _fill(mod):
    mod.record_span("Frame::step", 0.002)
    mod.record_span("Frame::step", 0.004)
    mod.record_span("Event::load", 0.001)
    mod.Counter("images", 3)
    mod.Marker("epoch").mark("global")
    mod.Marker("epoch").mark("global")


def test_table_matches_the_reference_format():
    _fill(profiler)
    _fill(jprof)
    ours = profiler.dumps(reset=True).splitlines()
    theirs = jprof.dumps(reset=True).splitlines()
    assert ours == theirs


def test_pause_excluded_and_reset():
    profiler.set_state("run")
    with profiler.Frame("work"):
        torch.ones(8).sum()
    profiler.pause()
    assert profiler.state() == "pause"
    time.sleep(0.05)
    profiler.resume()
    profiler.stop()
    table = profiler.dumps()
    paused = [ln for ln in table.splitlines() if "excluded paused" in ln]
    assert paused and float(paused[0].split(":")[1].split()[0]) >= 50.0
    assert "Frame::work" in table and "torch trace:" in table
    profiler.dumps(reset=True)
    assert "excluded paused" not in profiler.dumps()
    assert "Frame::work" not in profiler.dumps()


def test_start_stop_writes_the_trace_and_dump(tmp_path):
    profiler.set_config(filename=str(tmp_path / "p.json"))
    profiler.start()
    with mx.cpu():
        (mx.nd.ones((8, 8)) * 2).asnumpy()
    profiler.stop()
    assert profiler.state() == "stop"
    assert (tmp_path / "p_torch_trace.json").exists()
    out = profiler.dump()
    assert (tmp_path / "p.json").exists() and out == str(tmp_path / "p.json")
    profiler.start()
    profiler.stop()
    assert (tmp_path / "p_torch_trace_1.json").exists()


def test_chrome_trace_merges_torch_spans_counters_markers(tmp_path):
    telemetry.enable()
    try:
        telemetry.record_images_decoded(5)
        profiler.start()
        with profiler.Event("chrome"):
            torch.ones(16).add(1)
        profiler.stop()
        profiler.Counter("depth", 2)
        profiler.Marker("here").mark()
        doc = json.loads(profiler.dumps(format="chrome_trace"))
    finally:
        telemetry.disable()
        telemetry.reset()
    events = doc["traceEvents"]
    names = {e.get("name") for e in events}
    assert "Event::chrome" in names and "here" in names
    assert any(e.get("ph") == "C" and e["name"] == "depth" for e in events)
    assert any(e.get("ph") == "C" and e["name"] ==
               "mxnet_data_decoded_images_total" for e in events)
    assert any(e.get("ph") == "i" and e["name"] == "here" for e in events)
    assert any(e.get("name") == "aten::add" for e in events)  # torch's own
    assert doc["otherData"]["torch_traces"]
    with pytest.raises(ValueError):
        profiler.dumps(format="xml")


def test_profile_memory_lines():
    profiler.set_config(profile_memory=True)
    try:
        table = profiler.dumps()
    finally:
        profiler.set_config(profile_memory=False)
    mem = [ln for ln in table.splitlines() if ln.startswith("Memory::")]
    assert len(mem) == 1 + torch.cuda.device_count()
    assert "bytes_in_use=0" in mem[0] and "total=0" in mem[0]
    assert not [ln for ln in profiler.dumps().splitlines()
                if ln.startswith("Memory::")]


def test_entry_point_section_names_the_c_entry(monkeypatch):
    """``_build.call`` opens a range named after its C entry point when a
    profile is on; the table lists it (here a stand-in library: no
    kernel runs on the CPU)."""
    import ctypes

    from mxnet_tpu_torch.kernels import _build

    class _Fn:
        argtypes = None

        def __call__(self, *args):
            torch.ones(64).mul(3)
            return 0

    class _Lib:
        mx_sgd_sweep = _Fn()

    monkeypatch.setattr(_build, "load", lambda src: _Lib())
    _build.call("fused_optimizer.cu", "mx_sgd_sweep", [ctypes.c_int],
                "sweep", 1)                   # not profiled: no range
    profiler.start()
    _build.call("fused_optimizer.cu", "mx_sgd_sweep", [ctypes.c_int],
                "sweep", 1)
    profiler.stop()
    table = profiler.dumps()
    assert "Kernel entry points:" in table
    row = [ln for ln in table.splitlines() if ln.startswith("mx_sgd_sweep")]
    assert row and int(row[0].split()[1]) == 1
    assert np.isfinite(float(row[0].split()[2]))
