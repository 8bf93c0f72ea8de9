"""Mean host ms per traced step in `step.update` (the two masked Adam updates),
enqueued after a sync, with the card drained. Read through
`benchmark/spans.py`'s host part: the spans and the trace's host-side events,
whatever the card's clock."""

from benchmark import spans


def read(run: dict):
    return spans.host_metric(run, "update_host_ms")
