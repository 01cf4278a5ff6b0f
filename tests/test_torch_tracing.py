"""The port's span recorder (``semantic_embeddings_torch/spans.py``): nothing
is recorded outside a ``torch.profiler`` session; inside one a train step
records its phases with their parents and step, on the profiler's clock;
the first call of each step function is a set-up span; ranks of a group
record their exchange; ``fit --profile_dir``'s trace names the spans.  The
``cuda`` tests hold the clock against a kernel launch and the phase events
against the steps' time on the card.  torch only (no JAX): the ``cuda``
tests run with ``--noconftest`` on the card."""

import _torch_threads  # noqa: F401  (first: the worker's share of the cores)

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from semantic_embeddings_torch import parallel, spans
from semantic_embeddings_torch.data import SyntheticDataset
from semantic_embeddings_torch.models import EmbeddingModel, build_network
from semantic_embeddings_torch.train import (
    fit,
    make_classifier_train_step,
    make_eval_step,
    make_train_step,
    new_train_state,
)
from semantic_embeddings_torch.train.schedules import PiecewiseSchedule

STEP = ["step", "step.prepare", "step.forward", "step.backward", "step.update"]


def _tiny(device="cpu", arch="simple", classes=4, size=8, batch=8, shard=False):
    """A state, its train step, the first epoch's batches and the
    augmentation's generator, for ``arch`` on synthetic images."""
    device = torch.device(device)
    data = SyntheticDataset(num_classes=classes, n_train=4 * batch, n_test=8, size=size)
    g = torch.Generator().manual_seed(0)
    model = EmbeddingModel(build_network(classes, arch, generator=g).module,
                           output="l2norm").to(device)
    step = make_train_step(model, data.make_prepare(device), class_embedding=np.eye(classes))
    batches = list(data.train_batches(batch, 0, 0, shard=shard))
    rng = torch.Generator(device=device).manual_seed(0)
    return new_train_state(model), step, batches, rng


def _absolute(prof, event):
    """An event's start and end in epoch ns, the spans' clock."""
    base = prof.profiler.kineto_results.trace_start_ns()
    return base + event.time_range.start * 1e3, base + event.time_range.end * 1e3


def test_without_a_session_a_step_records_nothing(monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(a))
    before = spans.last_session()
    count = len(before.spans) if before is not None else 0
    state, step, batches, rng = _tiny()
    for raw in batches[:2]:
        step(state, raw, 0.1, rng)
    assert spans.last_session() is before
    assert (len(before.spans) if before is not None else 0) == count
    assert made == []
    # an off span is one shared null context
    assert spans.span("step", 3) is spans.span("step.forward")


def test_a_step_under_a_session_records_its_phases_in_order():
    state, step, batches, rng = _tiny()
    step(state, batches[0], 0.1, rng)
    with profile(activities=[ProfilerActivity.CPU]):
        for raw in batches[1:3]:
            step(state, raw, 0.1, rng)
    session = spans.last_session()
    assert [s.name for s in session.spans] == STEP * 2
    assert session.steps == [1, 2]
    for k, step_id in enumerate((1, 2)):
        root, *inner = session.spans[5 * k:5 * k + 5]
        assert root.parent is None and all(s.parent is root for s in inner)
        assert {s.step for s in inner} == {root.step} == {step_id}
        assert root.start_ns <= inner[0].start_ns and inner[-1].end_ns <= root.end_ns
        for a, b in zip(inner, inner[1:]):
            assert a.start_ns < a.end_ns <= b.start_ns
    # on the CPU the phases are the host's times between the marks
    phases = session.phases
    assert session.clock == "host"
    assert [len(phases[p]) for p in spans.PHASES] == [2, 2, 2, 1]
    assert all(v > 0 for p in spans.PHASES for v in phases[p])
    first = session.spans[0]
    whole = phases["forward"][0] + phases["backward"][0] + phases["update"][0]
    assert whole <= (first.end_ns - first.start_ns) / 1e6
    assert phases["gap"][0] <= (session.spans[5].start_ns - first.start_ns) / 1e6 - whole


def test_a_span_holds_its_operators_on_the_profilers_clock():
    a = torch.randn(256, 256)
    torch.mm(a, a)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("mm") as span:
            torch.mm(a, a)
    assert spans.last_session().spans == [span]
    mm = [e for e in prof.events() if e.name == "aten::mm"]
    assert len(mm) == 1
    start, end = _absolute(prof, mm[0])
    assert span.start_ns <= start < end <= span.end_ns
    # the span is a profiler range around the operator too
    ranges = [e for e in prof.events() if e.name == "mm"]
    assert len(ranges) == 1 and ranges[0].time_range.start <= mm[0].time_range.start


def test_the_first_call_of_each_step_function_is_a_setup_span():
    before = len(spans.setup_spans())
    state, step, batches, rng = _tiny()
    g = torch.Generator().manual_seed(1)
    classifier = build_network(4, "simple", generator=g, classification=True).module
    data = SyntheticDataset(num_classes=4, n_train=32, n_test=8, size=8)
    cstep = make_classifier_train_step(classifier, data.make_prepare("cpu"), num_classes=4)
    cstate = new_train_state(classifier)
    for raw in batches[:3]:
        step(state, raw, 0.1, rng)
        cstep(cstate, raw, 0.1, rng)
    added = spans.setup_spans()[before:]
    assert [s.name for s in added] == ["setup.first_step"] * 2
    assert all(0 < s.start_ns < s.end_ns for s in added)
    assert added[0].end_ns <= added[1].start_ns


def _exchange_rank(out):
    """A rank of a gloo group: one step, then one under a CPU session; its
    spans go to ``out/rank{r}.json``."""
    parallel.initialize_distributed("cpu")
    state, step, batches, rng = _tiny(shard=True)
    step(state, batches[0], 0.1, rng)
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, batches[1], 0.1, rng)
    recorded = [[s.name, s.parent and s.parent.name, s.step]
                for s in spans.last_session().spans]
    (Path(out) / f"rank{parallel.rank()}.json").write_text(json.dumps(recorded))
    parallel.finalize_distributed()


def test_two_gloo_ranks_each_record_the_exchange(tmp_path):
    parallel.launch(_exchange_rank, 2, str(tmp_path))
    expected = [["step", None, 1]] + [
        [name, "step", 1] for name in
        ("step.prepare", "step.forward", "step.backward", "step.exchange", "step.update")]
    for rank in (0, 1):
        assert json.loads((tmp_path / f"rank{rank}.json").read_text()) == expected


def test_profile_dir_trace_names_the_spans(tmp_path):
    data = SyntheticDataset(num_classes=4, n_train=16, n_test=8, size=8)
    g = torch.Generator().manual_seed(0)
    model = EmbeddingModel(build_network(4, "simple", generator=g).module, output="l2norm")
    prepare = data.make_prepare("cpu")
    emb = np.eye(4, dtype=np.float32)
    fit(new_train_state(model), make_train_step(model, prepare, class_embedding=emb),
        make_eval_step(model, prepare, class_embedding=emb), data,
        PiecewiseSchedule([(0, 0.1)]), epochs=2, batch_size=8, verbose=False,
        snapshot=str(tmp_path / "snap.pt"), profile_dir=str(tmp_path / "trace"),
        profile_steps=(1, 3))
    events = json.loads((tmp_path / "trace" / "trace_rank0.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert set(STEP) | {"fit.batch", "fit.validate", "fit.snapshot"} <= names
    assert "step.exchange" not in names
    # the window's steps 1 and 2, and the session ended with the window
    session = spans.last_session()
    assert session.steps == [1, 2] and not session.recording


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_span_holds_its_kernel_launch_on_the_profilers_clock(card):
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with spans.span("sleep") as span:
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
    launches = [e for e in prof.events() if e.name.startswith("cudaLaunchKernel")]
    assert len(launches) == 1
    start, end = _absolute(prof, launches[0])
    assert span.start_ns <= start < end <= span.end_ns


@pytest.mark.cuda
def test_phase_times_and_gaps_fill_the_steps_on_the_card(card):
    state, step, batches, rng = _tiny(card, "resnet-50", classes=10, size=64, batch=16)
    step(state, batches[0], 0.1, rng)
    torch.cuda.synchronize()
    first, last = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CUDA]):
        first.record()
        for raw in batches[1:4]:
            step(state, raw, 0.1, rng)
        last.record()
        torch.cuda.synchronize()
    session = spans.last_session()
    assert session.clock == "cuda" and session.steps == [1, 2, 3]
    assert [len(session.phases[p]) for p in spans.PHASES] == [3, 3, 3, 2]
    assert all(v > 0 for p in ("forward", "backward", "update") for v in session.phases[p])
    total = sum(sum(session.phases[p]) for p in spans.PHASES)
    window = first.elapsed_time(last)
    assert abs(total - window) <= 0.02 * window
