"""Preprocessing entry of the port: TRACE npz + frames -> training directory.

    python -m multiply_tpu_torch.preprocessing \
        --trace raw_data/<seq>/trace/<seq>.npz --frames raw_data/<seq>/frames --out data/<seq> \
        [--keypoints <dir of per-frame (D, J, 3) npys> | --vitpose <from_pretrained dir>] \
        [--smpl_model <SMPL .pkl or directory>] \
        [--genders neutral neutral] [--focal F --center CX CY] [--scale_factor 2] [--refine_iters 150] \
        [--video raw.mp4 ...] [--device cuda]

Counterpart of `python -m multiply_tpu.preprocessing`, with the same flags
plus --device: reformat -> mask (PnP init) -> refine -> final -> normalize.
ffmpeg and TRACE stay external programs (--video runs them). The frames are
PNG or JPEG; --vitpose runs the ViTPose model of a local `from_pretrained`
directory over them. Runs on the card; `--device cpu` is for tests.
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m multiply_tpu_torch.preprocessing")
    ap.add_argument("--trace", required=True,
                    help="TRACE npz (raw or reformatted); with --video, the path TRACE's output is produced at")
    ap.add_argument("--frames", required=True,
                    help="directory of extracted frames (with --video, the extraction destination)")
    ap.add_argument("--video", default=None,
                    help="raw video: run ffmpeg frame extraction into --frames and trace2 tracking to produce "
                         "--trace first")
    ap.add_argument("--time_start", default=None, help="ffmpeg -ss (e.g. 00:00:00), with --video")
    ap.add_argument("--time_duration", default=None, help="ffmpeg -t (e.g. 00:00:15), with --video")
    ap.add_argument("--subject_num", type=int, default=2, help="TRACE --subject_num, with --video")
    ap.add_argument("--time2forget", type=int, default=40, help="TRACE --time2forget, with --video")
    ap.add_argument("--out", required=True, help="output training data directory")
    ap.add_argument("--keypoints", default=None,
                    help="dir of per-frame keypoint npys (D,J,3); falls back to TRACE's projected joints")
    ap.add_argument("--vitpose", default=None,
                    help="local ViTPose from_pretrained dir: detect the keypoints in the frames (COCO-17)")
    ap.add_argument("--kp_format", default="coco17", choices=["coco17", "openpose25"],
                    help="keypoint layout: ViTPose/COCO-17 or OpenPose BODY_25")
    ap.add_argument("--smpl_model", default=None,
                    help="SMPL model .pkl or a directory of SMPL_{GENDER}.pkl (default: synthetic test body)")
    ap.add_argument("--genders", nargs="*", default=None)
    ap.add_argument("--focal", type=float, default=None)
    ap.add_argument("--center", type=float, nargs=2, default=None)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=None)
    ap.add_argument("--skip", type=int, default=1)
    ap.add_argument("--scale_factor", type=int, default=2)
    ap.add_argument("--refine_iters", type=int, default=150)
    ap.add_argument("--device", default="cuda", help="torch device (cpu for tests)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Preprocess as asked; returns the seconds of each stage."""
    args = parse_args(argv)

    from ..body.server import SMPLServer
    from ..body.smpl import load_smpl_model, synthetic_body_model
    from .pipeline import preprocess_sequence
    from .trace import trace_inputs_from_files

    if args.video is not None:
        from .video import extract_frames, run_trace

        frames = extract_frames(args.video, args.frames, time_start=args.time_start,
                                time_duration=args.time_duration)
        print(f"extracted {len(frames)} frames -> {args.frames}")
        if not os.path.exists(args.trace):
            npz = run_trace(args.frames, os.path.join(os.path.dirname(args.trace) or ".", "trace_results"),
                            subject_num=args.subject_num, time2forget=args.time2forget)
            os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
            shutil.copyfile(npz, args.trace)
            print(f"trace results -> {args.trace}")

    K = None
    if args.focal is not None:
        cx, cy = args.center if args.center else (0.0, 0.0)
        K = np.array([[args.focal, 0, cx], [0, args.focal, cy], [0, 0, 1]], np.float32)

    inputs = trace_inputs_from_files(args.trace, args.frames, K=K, genders=args.genders,
                                     keypoints_dir=args.keypoints, start=args.start, end=args.end, skip=args.skip,
                                     kp_format=args.kp_format, vitpose_checkpoint=args.vitpose, device=args.device)
    F, P = inputs.poses.shape[:2]
    print(f"{F} frames, {P} persons, image {inputs.images[0].shape[:2]}")

    if args.smpl_model:
        model = load_smpl_model(args.smpl_model, device=args.device)
    else:
        print("no --smpl_model given: using the synthetic test body")
        model = synthetic_body_model(device=args.device)
    servers = [SMPLServer.create(model, betas=inputs.betas[p]) for p in range(P)]

    os.makedirs(args.out, exist_ok=True)
    seconds = preprocess_sequence(args.out, inputs, servers, refine_iters=args.refine_iters,
                                  scale_factor=args.scale_factor)
    print(f"wrote training directory: {args.out} (seconds: {seconds})")
    return seconds


if __name__ == "__main__":
    main()
