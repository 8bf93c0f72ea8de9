"""Mean host ms per traced step in `step.forward` (`TrainStep.forward_loss`): the
forward's enqueue. Read through `benchmark/spans.py`."""

from benchmark import spans


def read(run: dict):
    return spans.metric(run, "forward_host_ms")
