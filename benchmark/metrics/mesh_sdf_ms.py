"""Host ms per traced pose batch in the producer's `mesh.sdf` spans (a MISE point
batch: the copy in, the network, the `.cpu()` wait behind the step). Read
through `benchmark/spans.py`'s host part: the spans and the trace's host-side
events, whatever the card's clock."""

from benchmark import spans


def read(run: dict):
    return spans.host_metric(run, "mesh_sdf_ms")
