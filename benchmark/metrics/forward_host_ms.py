"""Mean host ms per traced step in `step.forward` (`TrainStep.forward_loss`): the
forward's enqueue. Read through `benchmark/spans.py`'s host part: the spans and
the trace's host-side events, whatever the card's clock."""

from benchmark import spans


def read(run: dict):
    return spans.host_metric(run, "forward_host_ms")
