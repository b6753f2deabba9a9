"""How far the port's float32 one-process gradients of a reduced config lie
from exact, on the CPU: the witness behind ``tests/test_torch_tp_train.py``'s
``GRAD_RTOL`` (1e-5 of each leaf's max |g|).

    PYTHONPATH=src python3 tools/tp_grad_noise.py [name ...]

For each reduced config (by default the five of the TP training tests),
at ``compute_dims(cfg, tp=2)``, on the tests' initial parameters and
global batch (``tests/torch_tp_train_cases.py``), the gradients of the
train step's total loss (remat full, ``ssm_chunk=8``) are taken three
ways: float32 on one thread (what the tests' one-process reference runs),
float32 on the default threads, and float64 (the float32 parameters cast
up; the model's modules, which widen to float32 by name where the JAX
package does, see ``torch.float32`` as float64 for this run alone, so
every product and sum is float64).  Prints, per float32 run, the
largest distance of a leaf's gradient from the float64 one over that
leaf's max |g|, the leaf that reaches it, and the distance between the two
float32 runs on the same scale.
"""
from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

import torch_tp_train_cases as ttc  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.train import MOE_LB_WEIGHT, MOE_Z_WEIGHT  # noqa: E402
from repro_torch.models import attention, blocks, layers, moe, ssm  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import compute_dims  # noqa: E402
from repro_torch.optim import make_adamw  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402


class _Widened:
    """``torch`` with ``float32`` read as float64."""

    float32 = torch.float64

    def __getattr__(self, name):
        return getattr(torch, name)


@contextlib.contextmanager
def _float32_as(dtype):
    if dtype == torch.float32:
        yield
        return
    modules = (M, attention, blocks, layers, moe, ssm)
    for mod in modules:
        mod.torch = _Widened()
    try:
        yield
    finally:
        for mod in modules:
            mod.torch = torch


def gradients(name: str, dtype, threads: int | None) -> list[torch.Tensor]:
    """The total loss's gradient leaves of reduced ``name`` in ``dtype``."""
    cfg = configs.reduced(name)
    dims = compute_dims(cfg, tp=ttc.TP)
    state, _ = train.make_train_state(torch.Generator().manual_seed(0), cfg, dims,
                                      make_adamw(constant(ttc.LR)), device="cpu")
    leaves, treedef = tree_flatten(state.params)
    leaves = [p.to(dtype).requires_grad_(True) for p in leaves]
    batch = {k: torch.from_numpy(v) for k, v in ttc.train_batch(name).items()}
    if "enc_feats" in batch:
        batch["enc_feats"] = batch["enc_feats"].to(dtype)
    saved = torch.get_num_threads()
    torch.set_num_threads(threads or saved)
    try:
        with _float32_as(dtype):
            logits, aux = M.forward(treedef.unflatten(leaves), cfg, dims, batch["tokens"],
                                    enc_feats=batch.get("enc_feats"), compute_dtype=dtype,
                                    remat="full", ssm_chunk=8)
            total = M.lm_loss(logits, batch["labels"], cfg.vocab_size)
            if cfg.num_experts:
                total = (total + MOE_LB_WEIGHT * aux["moe_lb_loss"]
                         + MOE_Z_WEIGHT * aux["moe_z_loss"])
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
    finally:
        torch.set_num_threads(saved)
    return [torch.zeros_like(p) if g is None else g.detach()
            for p, g in zip(leaves, grads)]


def worst(got: list[torch.Tensor], want: list[torch.Tensor]) -> tuple[float, int]:
    """The largest leaf distance over the leaf's max |want|, and its leaf."""
    gaps = [float((g.double() - w.double()).abs().max()
                  / w.double().abs().max().clamp_min(1e-300)) for g, w in zip(got, want)]
    i = max(range(len(gaps)), key=gaps.__getitem__)
    return gaps[i], i


def main(names: list[str]) -> None:
    print(f"torch {torch.__version__}, {torch.get_num_threads()} default threads")
    for name in names or ttc.ARCHS:
        exact = gradients(name, torch.float64, None)
        one = gradients(name, torch.float32, 1)
        many = gradients(name, torch.float32, None)
        (g1, i1), (gm, im), (d, idd) = worst(one, exact), worst(many, exact), worst(one, many)
        print(f"{name}: f32 one thread {g1:.3e} (leaf {i1}, {tuple(exact[i1].shape)}), f32 "
              f"default threads {gm:.3e} (leaf {im}) of a leaf's max |g| from float64; the "
              f"two f32 runs {d:.3e} apart (leaf {idd}); {len(exact)} leaves")


if __name__ == "__main__":
    main(sys.argv[1:])
