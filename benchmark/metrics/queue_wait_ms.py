"""Mean host ms per traced step in `loop.queue_get`: the main thread waiting for
the producer's next batch (`Trainer.train_epoch`). Read through
`benchmark/spans.py`."""

from benchmark import spans


def read(run: dict):
    return spans.metric(run, "queue_wait_ms")
