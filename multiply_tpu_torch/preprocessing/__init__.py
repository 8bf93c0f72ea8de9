"""Subpackage of the PyTorch port: tracker output to a training directory."""

NOT_PORTED = "is not ported to the PyTorch package yet (ROADMAP.md, queue 1)"
