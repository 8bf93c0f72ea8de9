"""Subpackage of the PyTorch port: tracker output to a training directory."""
