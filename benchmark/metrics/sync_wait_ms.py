"""Mean host ms per traced step in the `step.sync` spans (the `bool(finite)` reads
of `TrainStep.update`): the host waiting for the card. Read through
`benchmark/spans.py`."""

from benchmark import spans


def read(run: dict):
    return spans.metric(run, "sync_wait_ms")
