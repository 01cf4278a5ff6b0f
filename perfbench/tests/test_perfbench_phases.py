"""The readers of the port's span recorder: nothing without a traced record
of one process, the phase means of a session timed by CUDA events, and
nothing where the session's steps are not the traced window's."""

import pytest

from perfbench import harness
from semantic_embeddings_torch import spans

READERS = ("forward_device_ms", "backward_device_ms", "update_device_ms",
           "step_gap_device_ms", "first_step_s")


def _session(clock="cuda", steps=(5, 6, 7)):
    session = spans.Session()
    session.recording = False
    session.spans = [spans.Span("step", step=s) for s in steps]
    session.clock = clock
    session.phases = {"forward": [40.0, 42.0, 44.0], "backward": [90.0, 91.0, 92.0],
                      "update": [3.0, 3.5, 4.0], "gap": [0.25, 0.75]}
    return session


def _setup_span(seconds):
    record = spans.Span("setup.first_step")
    record.start_ns, record.end_ns = 10**18, 10**18 + int(seconds * 1e9)
    return record


def _record(traced=True, chips=1, steps=3):
    return {"chips": chips, "traces": [{"steps": steps}] if traced else None}


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(spans, "last_session", lambda: _session())
    monkeypatch.setattr(spans, "setup_spans", lambda: [_setup_span(7.5), _setup_span(1.0)])


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_a_traced_record_of_one_process(recorded, name):
    read = harness.reader(name)
    assert read(_record(traced=False)) is None
    assert read(_record(chips=4)) is None


def test_the_phase_means_of_a_session(recorded):
    values = {name: harness.reader(name)(_record()) for name in READERS}
    assert values == pytest.approx({"forward_device_ms": 42.0, "backward_device_ms": 91.0,
                                    "update_device_ms": 3.5, "step_gap_device_ms": 0.5,
                                    "first_step_s": 7.5})


@pytest.mark.parametrize("clock,steps", [("host", 3), ("cuda", 10)])
def test_nothing_from_host_times_or_another_window(monkeypatch, clock, steps):
    monkeypatch.setattr(spans, "last_session", lambda: _session(clock))
    for name in READERS[:4]:
        assert harness.reader(name)(_record(steps=steps)) is None
