"""Host ms per batch the producer thread made in the window: item draw
(`get_train_item`), `make_batch` and, in pose traffic, `pose_loss_batch`."""


def read(run: dict):
    return run.get("producer_ms")
