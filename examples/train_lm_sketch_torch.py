"""End-to-end driver of the PyTorch port: train an LM with the SJPC stream
monitor riding the data pipeline, under the fault-tolerant runtime
(checkpoint/restart, failure injection, straggler detection).  The port's
counterpart of ``examples/train_lm_sketch.py``, with the same presets and
flags plus ``--device``.

    PYTHONPATH=src python examples/train_lm_sketch_torch.py                   # smoke, on the card
    PYTHONPATH=src python examples/train_lm_sketch_torch.py --device cpu      # smoke, on the CPU
    PYTHONPATH=src python examples/train_lm_sketch_torch.py --preset 100m --steps 300

On the card the monitor's update runs the port's ``sample_weights``,
``fingerprint`` and ``sketch_update`` kernels every step.  The monitor logs
continuous g_s estimates (the near-duplicate density of the training
stream) next to the loss.
"""
import argparse
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import platform  # noqa: E402
from repro_torch.data.loader import to_device, token_batches  # noqa: E402
from repro_torch.launch.train import make_train_state, make_train_step  # noqa: E402
from repro_torch.models.config import ArchConfig, compute_dims  # noqa: E402
from repro_torch.optim import make_adamw, warmup_cosine  # noqa: E402
from repro_torch.runtime import DriverConfig, SimulatedFailure, TrainDriver  # noqa: E402
from repro_torch.sketchstream.monitor import SketchMonitorConfig  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

PRESETS = {
    # ~100M params: the end-to-end target scale
    "100m": ArchConfig(name="lm-100m", family="dense", num_layers=8,
                       d_model=512, num_heads=8, num_kv_heads=4, d_ff=2048,
                       vocab_size=32768, head_dim=64, rope_theta=10_000.0),
    # smoke default
    "smoke": ArchConfig(name="lm-smoke", family="dense", num_layers=2,
                        d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                        vocab_size=512, head_dim=16, rope_theta=10_000.0),
}
MONITOR = SketchMonitorConfig(d=6, s=3, ratio=0.5, width=1024, depth=3, shards=1)


def build(preset: str, steps: int, batch: int, seq: int, device, ckpt_dir: str, *,
          seed: int = 0, log_every: int = 5):
    """The example's driver: its model, AdamW on a warmup-cosine schedule,
    the monitor, f32 compute without remat, the seeded batches of
    ``token_batches`` (kept so that a replayed step gets its batch)."""
    cfg = PRESETS[preset]
    dims = compute_dims(cfg, tp=1)
    optimizer = make_adamw(warmup_cosine(3e-4, 20, max(steps, 100)), weight_decay=0.1)
    device = platform.resolve(device)
    gen_device = device if device.type == "cuda" else torch.device("cpu")
    state, mparams = make_train_state(torch.Generator(gen_device).manual_seed(seed), cfg, dims,
                                      optimizer, monitor_cfg=MONITOR, device=device)
    step_fn = make_train_step(cfg, dims, optimizer, monitor_cfg=MONITOR,
                              monitor_params=mparams, remat="none", ssm_chunk=32,
                              compute_dtype=torch.float32)
    gen = token_batches(batch, seq, cfg.vocab_size, seed=7, dup_fraction=0.2)
    batches = {}

    def make_batch(step):          # deterministic in step (replay-safe)
        while len(batches) <= step:
            batches[len(batches)] = next(gen)
        return to_device(batches[step], device)

    driver = TrainDriver(step_fn, state, make_batch,
                         DriverConfig(ckpt_dir=ckpt_dir, ckpt_every=10, log_every=log_every,
                                      sketch_log_every=10),
                         monitor_cfg=MONITOR)
    return cfg, driver


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="smoke", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--inject-failure", type=int, default=None,
                    help="simulate a node failure at this step")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    cfg, driver = build(args.preset, args.steps, args.batch, args.seq, args.device, ckpt_dir)
    n_params = sum(x.numel() for x in tree_leaves(driver.state.params))
    print(f"model: {cfg.name} ({n_params / 1e6:.1f}M params) on "
          f"{driver.state.step.device}")
    if args.inject_failure is not None:
        driver.inject_failure_at = {
            args.inject_failure: SimulatedFailure("injected node failure")}

    driver.run(args.steps)

    print("\nstep   loss     gnorm")
    for m in driver.metrics_log:
        print(f"{m['step']:>4} {m['loss']:8.4f} {m.get('grad_norm', 0):8.3f}")
    print("\nSJPC stream monitor (g_s estimates over the token stream):")
    for row in driver.sketch_log:
        gs = {k: f"{v:.0f}" for k, v in row.items() if k != "step"}
        print(f"  step {row['step']:>4}: {gs}")
    if driver.events:
        print("\nruntime events:")
        for e in driver.events:
            print(f"  {e}")


if __name__ == "__main__":
    main()
