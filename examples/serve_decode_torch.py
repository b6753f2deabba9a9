"""Batched serving on the PyTorch port: prefill a batch of prompts,
greedy-decode with a KV cache, and monitor the REQUEST stream for
near-duplicate prompts with SJPC.  The port's counterpart of
``examples/serve_decode.py``, with ``--device`` and size flags.

    PYTHONPATH=src python examples/serve_decode_torch.py                # on the card
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu   # on the CPU

The model is reduced qwen2-7b with random weights drawn from a seed
(``models.model.init_params``); prompts 0, 3 and 5 are the same request.
On the card the monitor's update runs the ``sample_weights``,
``fingerprint`` and ``sketch_update`` kernels.
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import configs, platform  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import compute_dims  # noqa: E402
from repro_torch.sketchstream.monitor import (MonitorState, SketchMonitorConfig,  # noqa: E402
                                              init_monitor, monitor_estimate,
                                              monitor_update_local)

MONITOR = SketchMonitorConfig(d=4, s=4, ratio=1.0, width=1024, depth=3, shards=1)


def prompts_of(cfg, batch: int, prompt: int) -> np.ndarray:
    """The reference's requests: seeded tokens, prompts 3 and 5 copies of 0."""
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, size=(batch, prompt), dtype=np.int32)
    prompts[3] = prompts[0]            # duplicate requests
    prompts[5] = prompts[0]
    return prompts


def serve(params, cfg, dims, prompts: np.ndarray, gen: int) -> np.ndarray:
    """Greedy tokens (B, gen) of ``prompts`` on the parameters' device."""
    device = params["embed"].device
    return greedy_generate(params, cfg, dims, torch.as_tensor(prompts, device=device),
                           gen).cpu().numpy()


def monitor(prompts: np.ndarray, device) -> float:
    """The request monitor's estimate of duplicate prompt pairs."""
    mparams, mstate = init_monitor(MONITOR, device=device)
    c, n = monitor_update_local(MONITOR, mparams, mstate.counters[0], mstate.n[0],
                                torch.as_tensor(prompts, device=device),
                                torch.zeros((), dtype=torch.int32, device=device),
                                update_fn=ops.make_sjpc_update_fn())
    est = monitor_estimate(MONITOR, MonitorState(c[None], n[None], mstate.step))
    return float((est["g"][4] - prompts.shape[0]) / 2)


def main(argv=None) -> dict:
    """Prints the served tokens and the monitor's estimate; returns
    ``{"tokens": (B, GEN) numpy, "dup_pairs": float}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=24)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0, help="the weights' generator seed")
    args = ap.parse_args(argv)
    device = platform.resolve(args.device)
    B, PROMPT, GEN = args.batch, args.prompt, args.gen

    cfg = configs.reduced("qwen2-7b")
    dims = compute_dims(cfg, tp=1)
    gen_device = device if device.type == "cuda" else torch.device("cpu")
    params = M.init_params(torch.Generator(gen_device).manual_seed(args.seed), cfg, dims,
                           device=device)

    prompts = prompts_of(cfg, B, PROMPT)
    out = serve(params, cfg, dims, prompts, GEN)
    print(f"served {B} requests, prompt={PROMPT} tokens, generated {GEN} each")
    for i in range(B):
        print(f"  req {i}: ...{prompts[i, -4:].tolist()} -> {out[i].tolist()}")

    # --- request-stream dedup monitor ---
    dup_pairs = monitor(prompts, device)
    print(f"\nSJPC request monitor: ~{dup_pairs:.1f} duplicate prompt pairs (true: 3)")
    return {"tokens": out, "dup_pairs": dup_pairs}


if __name__ == "__main__":
    main()
