"""The port's small utilities and CLIs against the JAX package's, on the CPU.

* ``StepTimer`` on a fake clock: the same intervals, steps/s and samples/s
  as the JAX timer's arithmetic on those intervals (exact);
* ``get_logger``: one console handler, one file handler per path, the
  file's lines;
* ``model_constructor`` / ``NetConstructor``: the ``.constructor`` of a
  built module survives the JSON round trip and rebuilds the same
  architecture (same state-dict keys and shapes), as the JAX record does;
* ``trace`` / ``annotate``: a Chrome trace file holding the annotated range;
* ``watch_metrics --once``: the same printed table as JAX's;
* ``video_to_frames``: on a tiny video written by OpenCV, the same files
  with the same pixels as JAX's, numbered from ``--offset``;
* the utils package exports named after JAX's.
"""

import json
import logging
import os

import cv2
import numpy as np
import pytest

import dmhomo_tpu.utils as jutils
from dmhomo_tpu.cli import video_to_frames as jv2f
from dmhomo_tpu.cli import watch_metrics as jwatch
from dmhomo_tpu.utils.constructor import NetConstructor as JaxNetConstructor

import dmhomo_torch.utils as tutils
from dmhomo_torch.cli import video_to_frames as tv2f
from dmhomo_torch.cli import watch_metrics as twatch
from dmhomo_torch.utils.constructor import NetConstructor, model_constructor
from dmhomo_torch.utils.logging import get_logger
from dmhomo_torch.utils.profiling import StepTimer, annotate, trace


class FakeClock:
    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


@pytest.mark.parametrize("window", [2, 50])
def test_step_timer_on_a_fake_clock(window):
    ticks = [10.0, 10.5, 11.25, 12.0, 14.0]
    t = StepTimer(window=window, clock=FakeClock(ticks))
    assert t.steps_per_sec == 0.0 and t.tick() is None
    dts = [t.tick() for _ in ticks[1:]]
    assert dts == [b - a for a, b in zip(ticks, ticks[1:])]
    kept = dts[-window:]
    assert t.steps_per_sec == len(kept) / sum(kept)
    assert t.samples_per_sec(32) == t.steps_per_sec * 32


def test_step_timer_arithmetic_equals_jax(monkeypatch):
    import dmhomo_tpu.utils.profiling as jprof

    ticks = [1.0, 1.1, 1.35, 1.5]
    monkeypatch.setattr(jprof.time, "perf_counter", FakeClock(ticks))
    j = jprof.StepTimer(window=3)
    p = StepTimer(window=3, clock=FakeClock(ticks))
    for _ in ticks:
        assert j.tick() == p.tick()
    assert (j.steps_per_sec, j.samples_per_sec(8)) == (p.steps_per_sec, p.samples_per_sec(8))


def test_get_logger(tmp_path):
    path = str(tmp_path / "logs" / "run.log")
    log = get_logger("dmhomo_torch_test_logger", path)
    assert log is get_logger("dmhomo_torch_test_logger", path)
    assert log.level == logging.INFO
    kinds = [type(h) for h in log.handlers]
    assert kinds.count(logging.FileHandler) == 1 and len(kinds) == 2
    log.info("hello %d", 3)
    for h in log.handlers:
        h.flush()
    assert open(path).read().rstrip().endswith("INFO: hello 3")


@model_constructor
def build_small_net(crop_size=(64, 96), layers=(1, 1, 1, 1)):
    from dmhomo_torch.models.baseshomo import BasesHomoConfig, BasesHomoNet

    return BasesHomoNet(BasesHomoConfig(crop_size=tuple(crop_size), layers=tuple(layers)))


def test_constructor_round_trip(tmp_path):
    net = build_small_net(crop_size=[32, 48], layers=[1, 2, 1, 1])
    c = net.constructor
    assert (c.fun_name, c.fun_module) == ("build_small_net", __name__)
    path = c.save(str(tmp_path))
    on_disk = json.load(open(path))
    # the same file layout as the JAX record's
    assert JaxNetConstructor.load(str(tmp_path)).kwds == on_disk["kwds"] == c.kwds
    again = NetConstructor.load(str(tmp_path))
    assert again == c
    net2 = again.get()
    assert net2.constructor == c
    assert {k: v.shape for k, v in net2.state_dict().items()} == {
        k: v.shape for k, v in net.state_dict().items()}
    assert net2.config.layers == (1, 2, 1, 1)


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with trace(str(tmp_path / "tr")):
        with annotate("port_range"):
            torch.ones(8).sum()
    (name,) = os.listdir(tmp_path / "tr")
    events = json.load(open(tmp_path / "tr" / name))["traceEvents"]
    assert any(e.get("name") == "port_range" for e in events)


def test_watch_metrics_once_equals_jax(tmp_path, capsys):
    for i, m in enumerate(({"RE": 1.25, "AVG": 2.0}, {"LT": 0.5}, None)):
        d = tmp_path / f"exp_{i}"
        d.mkdir()
        with open(d / "val_metrics_best.json", "w") as f:
            f.write("{not json" if m is None else json.dumps(m))
    pattern = str(tmp_path / "*" / "val_metrics*.json")
    outs = []
    for mod in (jwatch, twatch):
        mod.main(["--glob", pattern, "--once"])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "1.2500" in outs[1] and "nan" in outs[1]
    for mod in (jwatch, twatch):
        mod.main(["--glob", str(tmp_path / "none*.json"), "--once"])
    assert capsys.readouterr().out == "(no metric files)\n" * 2


def test_video_to_frames_equals_jax(tmp_path):
    os.makedirs(tmp_path / "videos")
    rng = np.random.default_rng(0)
    for name, n in (("0000011", 3), ("0000038", 2)):
        vw = cv2.VideoWriter(str(tmp_path / "videos" / f"{name}.avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 5, (32, 24))
        assert vw.isOpened()
        for _ in range(n):
            vw.write(rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
        vw.release()
    pattern = str(tmp_path / "videos" / "*.avi")
    jv2f.main(["--videos", pattern, "--out", str(tmp_path / "j"), "--offset", "10000"])
    counts = tv2f.main(["--videos", pattern, "--out", str(tmp_path / "p")])
    assert counts == {"0000011": 3, "0000038": 2}
    for vid in counts:
        files = sorted(os.listdir(tmp_path / "p" / vid))
        assert files == sorted(os.listdir(tmp_path / "j" / vid))
        assert files == [f"{10000 + i}.png" for i in range(counts[vid])]
        for f in files:
            np.testing.assert_array_equal(cv2.imread(str(tmp_path / "p" / vid / f)),
                                          cv2.imread(str(tmp_path / "j" / vid / f)))


def test_utils_exports_follow_jax():
    ported = set(tutils.__all__)
    # JAX's with a counterpart: all but the orbax step lookup and the XLA cache
    assert ported == set(jutils.__all__) - {"latest_step", "enable_persistent_compile_cache"}
    assert all(hasattr(tutils, n) for n in ported)
