"""Seconds from the harness's start to the end of set-up: imports, the
training directory, the trainer (bakes, smpl_init), the epoch-0 mask and
SAM stages and the warm steps."""


def read(run: dict):
    return run.get("setup_s")
