"""Train steps on the demo pair with the PyTorch port.

    python -m ref_geotransformer_tpu_torch.train [--full] [--steps N] [--device cuda]

The counterpart of `bench.py::measure_train`: the demo pair
(data/demo/{ref,src,gt}.npy) with its ground-truth transform, the 3DMatch
stage-4 model at its published widths (bf16 backbone) with seeded random
weights, Adam at the configuration's learning rate, one pair per step.
Each step builds the pyramid, runs the forward with sampled targets, the
overall loss, the backward (through the structure embedding's backward
kernel on the card) and the guarded Adam update. One warm-up step, then
N timed steps; prints each step's losses, ms/step and peak device memory.
"""

from __future__ import annotations

import argparse
import time

import torch

from ref_geotransformer_tpu_torch.config import GeoTransformerConfig
from ref_geotransformer_tpu_torch.config.threedmatch import make_cfg
from ref_geotransformer_tpu_torch.demo import build_model, load_pair
from ref_geotransformer_tpu_torch.engine import TrainState, train_step

STEPS_PER_EPOCH = 1000  # the schedule's epoch length, as bench.py::measure_train sets it


def make_train_run(cfg: GeoTransformerConfig, device: torch.device):
    """(model, pair, state, generator) of a train run on the demo pair: the
    model with seeded random weights, the pair with its ground-truth
    transform, Adam on the staircase schedule and the targets' generator."""
    model = build_model(cfg, device, seed=0)
    pair = load_pair(cfg, device)
    state = TrainState(model, cfg.optim, STEPS_PER_EPOCH)
    generator = torch.Generator(device=device).manual_seed(0)
    return model, pair, state, generator


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--full", action="store_true", help="full 3DMatch capacities (default: demo capacities)")
    parser.add_argument("--steps", type=int, default=5, help="timed steps after the warm-up step")
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    args = parser.parse_args()

    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, pair, state, generator = make_train_run(make_cfg(demo=not args.full), device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def report(tag, losses):
        print(f"{tag}: loss {float(losses['loss']):.6f}, c_loss {float(losses['c_loss']):.6f}, "
              f"f_loss {float(losses['f_loss']):.6f}, lr {state.lr():.3e}, skipped so far {state.skipped}")

    t0 = time.perf_counter()
    report("warm-up step", train_step(model, state, pair, generator))
    sync()
    print(f"warm-up step: {time.perf_counter() - t0:.2f} s (includes building the kernels on first use)")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    for step in range(args.steps):
        t0 = time.perf_counter()
        losses = train_step(model, state, pair, generator)
        sync()
        times.append(time.perf_counter() - t0)
        report(f"step {step}", losses)
    if times:
        ms = 1e3 * sum(times) / len(times)
        print(f"steady state: {ms:.2f} ms/step ({1e3 / ms:.2f} pairs/s) over {len(times)} steps on {device}")
    if device.type == "cuda":
        print(f"peak device memory: {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
