"""Host ms per traced pose batch in the producer's `mesh.sdf` spans (a MISE point
batch: the copy in, the network, the `.cpu()` wait behind the step). Read
through `benchmark/spans.py`."""

from benchmark import spans


def read(run: dict):
    return spans.metric(run, "mesh_sdf_ms")
