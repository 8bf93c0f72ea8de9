"""Mean host ms per traced step in `loop.queue_get`: the main thread waiting for
the producer's next batch (`Trainer.train_epoch`). Read through
`benchmark/spans.py`'s host part: the spans and the trace's host-side events,
whatever the card's clock."""

from benchmark import spans


def read(run: dict):
    return spans.host_metric(run, "queue_wait_ms")
