"""All rays of the steps completed in the window over the window's seconds
(first step's start to a synchronize after the last step)."""


def read(run: dict):
    if not run["steps"] or not run["window_s"]:
        return None
    return run["rays"] / run["window_s"]
