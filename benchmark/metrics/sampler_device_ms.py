"""Device ms per traced step of the events that the main thread launched while
`render.sampler` (`error_bound_sample`) was open. Read through
`benchmark/spans.py`."""

from benchmark import spans


def read(run: dict):
    return spans.metric(run, "sampler_device_ms")
