"""Mean host ms per traced step in `step.backward` (`torch.autograd.grad`): the
main thread waiting while autograd's device thread enqueues the backward. Read
through `benchmark/spans.py`'s host part: the spans and the trace's host-side
events, whatever the card's clock."""

from benchmark import spans


def read(run: dict):
    return spans.host_metric(run, "backward_host_ms")
