"""Command-line entries of the port: `python -m multiply_tpu_torch.cli.train`
and `python -m multiply_tpu_torch.cli.test`."""
