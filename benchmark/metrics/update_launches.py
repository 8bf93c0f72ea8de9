"""Device events per traced step that the main thread launched while `step.update`
was open (by the launch's correlation id). Read through `benchmark/spans.py`."""

from benchmark import spans


def read(run: dict):
    return spans.metric(run, "update_launches")
