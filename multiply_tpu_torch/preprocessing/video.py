"""External-binary stages: ffmpeg frame extraction and TRACE tracking.

Counterpart of `multiply_tpu/preprocessing/video.py`: the same argv through
`subprocess`, the same messages when a binary is not on PATH. The binaries
are not part of the repository; a stub executable on PATH stands in for one.
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess


class MissingBinaryError(RuntimeError):
    pass


def _require(binary: str, hint: str) -> str:
    path = shutil.which(binary)
    if path is None:
        raise MissingBinaryError(f"`{binary}` not found on PATH. {hint}")
    return path


def extract_frames(video: str, frames_dir: str, time_start: str | None = None, time_duration: str | None = None,
                   ffmpeg_bin: str = "ffmpeg") -> list[str]:
    """ffmpeg -i video [-ss start] [-t duration] -vsync 0 frames/%04d.png;
    returns the extracted frame paths."""
    ffmpeg = _require(ffmpeg_bin, "Install ffmpeg or extract frames yourself into --frames and rerun without --video.")
    os.makedirs(frames_dir, exist_ok=True)
    cmd = [ffmpeg, "-i", video]
    if time_start:
        cmd += ["-ss", time_start]
    if time_duration:
        cmd += ["-t", time_duration]
    cmd += ["-vsync", "0", os.path.join(frames_dir, "%04d.png")]
    subprocess.run(cmd, check=True)
    frames = sorted(glob.glob(os.path.join(frames_dir, "*.png")))
    if not frames:
        raise RuntimeError(f"ffmpeg produced no frames in {frames_dir}")
    return frames


def run_trace(frames_dir: str, results_dir: str, subject_num: int, time2forget: int = 40, trace_bin: str = "trace2",
              extra_args: list[str] | None = None) -> str:
    """trace2 -i frames --subject_num=N --results_save_dir=... --time2forget=T;
    returns the newest result npz under `results_dir`."""
    trace = _require(
        trace_bin,
        "Install TRACE (https://github.com/Arthur151/ROMP) in its own env, or run it yourself and pass its npz via --trace.",
    )
    os.makedirs(results_dir, exist_ok=True)
    cmd = [trace, "-i", frames_dir, f"--subject_num={subject_num}", f"--results_save_dir={results_dir}",
           f"--time2forget={time2forget}", *(extra_args or [])]
    subprocess.run(cmd, check=True)
    npzs = sorted(glob.glob(os.path.join(results_dir, "**", "*.npz"), recursive=True), key=os.path.getmtime)
    if not npzs:
        raise RuntimeError(f"trace produced no npz under {results_dir}")
    return npzs[-1]
