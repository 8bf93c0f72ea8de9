"""Mean host ms per traced step in `step.backward` (`torch.autograd.grad`): the
main thread waiting while autograd's device thread enqueues the backward. Read
through `benchmark/spans.py`."""

from benchmark import spans


def read(run: dict):
    return spans.metric(run, "backward_host_ms")
