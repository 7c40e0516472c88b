"""The port's ``mx.callback`` held against the JAX package's on the CPU.

``Speedometer``, ``log_train_metric`` and ``ProgressBar`` are driven
through the same batch-end parameters in both packages, with the clock
injected (``time.time`` of each module), and their log lines compared
text for text; with ``flops_per_sample`` and a card peak the MFU field
is the same arithmetic. ``do_checkpoint`` needs the Module API and
raises; ``device_peak_flops`` is the telemetry module's card peak.
"""
import collections
import logging

import pytest

import mxnet_tpu as jmx
from mxnet_tpu import callback as jcb
from mxnet_tpu import metric as jmetric

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import callback as pcb
from mxnet_tpu_torch import metric as pmetric
from mxnet_tpu_torch.base import MXNetError

Param = collections.namedtuple("Param", "epoch nbatch eval_metric locals")


class _Clock:
    def __init__(self, step):
        self.t, self.step = 100.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def _drive(cb_mod, metric_mod, m_mx, make, monkeypatch, caplog, n=12,
           with_metric=True):
    monkeypatch.setattr(cb_mod.time, "time", _Clock(0.25))
    cb = make(cb_mod)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        for epoch in range(2):
            metric = metric_mod.Accuracy() if with_metric else None
            for i in range(n):
                if metric is not None:
                    with mx.cpu():
                        metric.update([m_mx.nd.array([i % 3, 1.0])],
                                      [m_mx.nd.array([[0.2, 0.8, 0.0],
                                                      [0.1, 0.9, 0.0]])])
                cb(Param(epoch, i, metric, None))
    return [r.getMessage() for r in caplog.records]


_CALLBACKS = {
    "speedometer": lambda c: c.Speedometer(32, frequent=4),
    "speedometer_no_reset": lambda c: c.Speedometer(32, frequent=3,
                                                    auto_reset=False),
    "log_train_metric": lambda c: c.log_train_metric(5),
    "log_train_metric_reset": lambda c: c.log_train_metric(2, True),
    "progress_bar": lambda c: c.ProgressBar(12, length=20),
}


@pytest.mark.parametrize("with_metric", [True, False])
@pytest.mark.parametrize("name", sorted(_CALLBACKS))
def test_callback_lines_are_the_references(name, with_metric, monkeypatch,
                                           caplog):
    want = _drive(jcb, jmetric, jmx, _CALLBACKS[name], monkeypatch, caplog,
                  with_metric=with_metric)
    got = _drive(pcb, pmetric, mx, _CALLBACKS[name], monkeypatch, caplog,
                 with_metric=with_metric)
    assert got == want
    assert got or (name.startswith("log_train") and not with_metric)
    if name.startswith("speedometer"):
        # the injected clock moves 0.25 s a read, one read a window:
        # frequent * 32 samples over 0.25 s
        freq = 4 if name == "speedometer" else 3
        assert f"Speed: {freq * 32 / 0.25:.2f} samples/sec" in got[0]


def test_speedometer_mfu_against_the_card_peak(monkeypatch, caplog):
    """With a card peak (an H100's 989 TFLOP/s, injected here where no
    card is) the MFU field is the reference's arithmetic over the same
    peak."""
    monkeypatch.setattr(pcb, "device_peak_flops", lambda device=None: 989e12)
    monkeypatch.setattr(jcb, "device_peak_flops", lambda device=None: 989e12)
    make = lambda c: c.Speedometer(8, frequent=2,  # noqa: E731
                                   flops_per_sample=3e12, num_devices=2)
    want = _drive(jcb, jmetric, jmx, make, monkeypatch, caplog, n=5)
    got = _drive(pcb, pmetric, mx, make, monkeypatch, caplog, n=5)
    assert got == want and any("MFU=" in g for g in got)


def test_device_peak_flops_is_the_telemetry_peak():
    from mxnet_tpu_torch import telemetry

    assert pcb.device_peak_flops() == telemetry._device_peak_flops()


def test_do_checkpoint_needs_the_module_api():
    with pytest.raises(MXNetError, match="item 12"):
        pcb.do_checkpoint("prefix")


def test_callback_surface_is_the_references():
    assert set(pcb.__all__) == set(jcb.__all__)
    assert mx.callback is pcb
    assert not hasattr(pcb, "_TPU_PEAK_TFLOPS")
