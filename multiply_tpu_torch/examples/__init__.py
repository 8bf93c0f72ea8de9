"""The example drivers of the port, one counterpart of each JAX driver under
`examples/`, each run as `python -m multiply_tpu_torch.examples.<name>`:

  * `train_synthetic`: the minimal flow, a `TrainStep` driven directly, then a
    full-frame render and its PSNR;
  * `longrun_synthetic`: the whole self-refinement schedule on one timeline
    (optionally from corrupted masks and translations), with a runlog;
  * `optdepth_demo`: perturbed translations of the long run's checkpoint,
    pulled back by the opt_depth pass;
  * `mask_refinement_demo`: corrupted masks and translations on half the
    frames, which the certainty ranking must flag and the loop recover;
  * `scaling_curve`: one global ray batch over 1/2/4/8 ranks.

Each takes `--device` (default `cuda`) and writes under
`outputs/torch_examples/` unless told otherwise.
"""

import os

OUT_DIR = os.path.join("outputs", "torch_examples")  # every driver's default --out and --run_dir
