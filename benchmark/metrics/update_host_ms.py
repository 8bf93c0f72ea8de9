"""Mean host ms per traced step in `step.update` (the two masked Adam updates),
enqueued after a sync, with the card drained. Read through
`benchmark/spans.py`."""

from benchmark import spans


def read(run: dict):
    return spans.metric(run, "update_host_ms")
