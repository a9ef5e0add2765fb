"""Warm ms/step of the train entry of one checkout, for timing two trees in
turns on one GPU.

    python nerf_lidar_tpu_torch/experiments/step_turns.py ROOT CONFIG [STEPS]

Imports `nerf_lidar_tpu_torch` from the checkout at ROOT (for example an
earlier commit unpacked with `git archive` into a gitignored directory),
runs its `train` entry on CONFIG (the synthetic scene, full width, a fresh
experiment directory that is removed afterwards) for STEPS steps (30), and
prints one JSON line: the median of the last 20 steps' ms and those steps.
Run it once per tree in turns (old, new, new, old) in one session: runs of
one tree move by more than the gains measured with it.
"""

import json
import os
import shutil
import statistics
import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    root = os.path.abspath(argv[0])
    config, steps = argv[1], int(argv[2]) if len(argv) > 2 else 30
    sys.path.insert(0, root)
    import torch
    from nerf_lidar_tpu_torch import cli
    if not os.path.abspath(cli.__file__).startswith(os.path.join(root, "")):
        raise SystemExit(f"imported {cli.__file__}, not from {root}")
    train = ["train", "--config", config, "--set", "dataset_loader=synthetic",
             "--set", "print_every=1", "--device", "cuda", "--exp_name",
             f"step_turns_{os.getpid()}", "--steps", str(steps)]
    out = cli.exp_dir(cli.build_config(cli.parse_args(train)))
    shutil.rmtree(out, ignore_errors=True)
    try:
        run = cli.main(train)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(out, ignore_errors=True)
    ms = [1e3 * h["step_s"] for h in run.history][-20:]
    print(json.dumps(dict(root=root, config=config,
                          ms_per_step=statistics.median(ms),
                          last20=[round(x, 2) for x in ms])), flush=True)


if __name__ == "__main__":
    main()
