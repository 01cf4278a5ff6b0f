"""The port's own record of a traced run's steps, read in the process that
ran them: the span recorder of ``semantic_embeddings_torch/spans.py``,
whose ``step`` and ``step.backward`` spans mark each step's start, backward
start, update start and end with CUDA events on the card.  A program
without the recorder, a group's ranks (their spans live in the ranks'
processes) and a session whose steps are not the traced window's read
nothing."""


def _spans(record):
    """The recorder's module where ``record`` is a one-process traced run
    of a program that has one, else None."""
    if not record.get("traces") or record.get("chips") != 1:
        return None
    try:
        from semantic_embeddings_torch import spans
    except ImportError:
        return None
    return spans


def session(record):
    """The recorder's last session where it timed the traced window's steps
    with CUDA events, else None."""
    spans = _spans(record)
    last = spans.last_session() if spans is not None else None
    if last is None or last.clock != "cuda":
        return None
    steps = record["traces"][0]["steps"]
    if len(last.steps) != steps or len(last.phases["forward"]) != steps:
        return None
    return last


def phase_ms(record, phase):
    """The mean of ``phase``'s milliseconds over the traced steps (``gap``:
    over the pairs of consecutive steps), from the CUDA events."""
    last = session(record)
    values = last.phases[phase] if last is not None else None
    return sum(values) / len(values) if values else None


def first_step_s(record):
    """Seconds of the process's first ``setup.first_step`` span."""
    spans = _spans(record)
    setup = [s for s in spans.setup_spans() if s.name == "setup.first_step"] if spans else []
    return (setup[0].end_ns - setup[0].start_ns) * 1e-9 if setup else None
