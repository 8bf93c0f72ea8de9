"""Mean host ms per traced step in the `step.sync` spans (the `bool(finite)` reads
of `TrainStep.update`): the host waiting for the card. Read through
`benchmark/spans.py`'s host part: the spans and the trace's host-side events,
whatever the card's clock."""

from benchmark import spans


def read(run: dict):
    return spans.host_metric(run, "sync_wait_ms")
