"""Carry SJPC parameters, estimator states and model parameters between
this package and numpy.

The JAX package's states hold uint32 / int32 / float32 arrays; as numpy
arrays they come in here and go back out, so both packages can hold the
same sketch, sample or model.  uint32 leaves (records) are int64 tensors
here.
"""
from __future__ import annotations

import numpy as np
import torch

from . import platform
from .core.hashing import as_field_tensor
from .core.sjpc import SJPCParams, SJPCState


def params_from_numpy(bucket_coeffs, sign_coeffs, fp_bases, device=None) -> SJPCParams:
    """uint32 arrays (levels, t, 2, 4), (levels, t, 2, 4), (2,) -> params."""
    device = platform.resolve(device)
    return SJPCParams(*(as_field_tensor(np.asarray(a), device)
                        for a in (bucket_coeffs, sign_coeffs, fp_bases)))


def state_from_numpy(counters, n, step, device=None) -> SJPCState:
    """int32 counters (levels, t, w), float32 n, int32 step -> state."""
    device = platform.resolve(device)
    return SJPCState(
        counters=torch.from_numpy(np.array(counters, dtype=np.int32)).to(device),
        n=torch.tensor(np.float32(n), dtype=torch.float32, device=device),
        step=torch.tensor(np.int32(step), dtype=torch.int32, device=device))


def state_to_numpy(state: SJPCState) -> tuple[np.ndarray, np.float32, np.int32]:
    """state -> (int32 counters, float32 n, int32 step)."""
    return (state.counters.cpu().numpy().astype(np.int32),
            np.float32(state.n.cpu().item()), np.int32(state.step.cpu().item()))


def _is_items(field: str) -> bool:
    return field.endswith("items")


def sample_state_from_numpy(cls, *leaves, device=None):
    """A reservoir or LSH-SS state (``cls``: ``ReservoirState`` or
    ``LSHSSState``) from the JAX state's numpy leaves, in field order:
    uint32 record leaves become int64 tensors, the rest int32.  Leaves may
    carry a leading stream axis."""
    device = platform.resolve(device)
    if len(leaves) != len(cls._fields):
        raise ValueError(f"{cls.__name__} has {len(cls._fields)} leaves, got {len(leaves)}")
    return cls(*(as_field_tensor(np.asarray(leaf), device) if _is_items(field)
                 else torch.from_numpy(np.array(leaf, dtype=np.int32)).to(device)
                 for field, leaf in zip(cls._fields, leaves)))


def sample_state_to_numpy(state) -> tuple:
    """A reservoir or LSH-SS state -> its leaves as the JAX package holds
    them: uint32 records, int32 everything else."""
    return tuple(leaf.cpu().numpy().astype(np.uint32 if _is_items(field) else np.int32)
                 for field, leaf in zip(state._fields, state))


def model_params_from_numpy(tree, device=None):
    """The JAX package's ``strip_p(params)`` tree with numpy leaves (nested
    dicts, lists and tuples) -> the same tree of tensors on ``device``
    (None: the CUDA card), dtypes kept."""
    device = platform.resolve(device)
    if isinstance(tree, dict):
        return {k: model_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(model_params_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def _train_types() -> dict:
    """The port's NamedTuples of a train state, by the JAX package's names
    (its ``Q8State`` is local to ``make_q8adam``; its name is the same)."""
    from .launch.train import TrainState
    from .optim.adamw import AdamWState
    from .optim.q8adam import Q8State, QTensor
    from .sketchstream.monitor import MonitorState
    return {cls.__name__: cls for cls in (TrainState, AdamWState, Q8State, QTensor,
                                          MonitorState)}


def _carry(tree, leaf_fn, types):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _carry(v, leaf_fn, types) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        cls = types.get(type(tree).__name__)
        if cls is None or cls._fields != type(tree)._fields:
            raise TypeError(f"no train-state type matches {type(tree).__name__}"
                            f"{type(tree)._fields}")
        return cls(*(_carry(v, leaf_fn, types) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_carry(v, leaf_fn, types) for v in tree)
    return leaf_fn(tree)


def train_state_from_numpy(tree, device=None):
    """The JAX package's ``TrainState`` with numpy leaves (as
    ``jax.tree_util.tree_map(np.asarray, state)`` gives it: AdamW or Q8
    moments, a ``MonitorState`` or None) -> the port's ``TrainState`` of
    tensors on ``device`` (None: the CUDA card), dtypes kept.  Every
    NamedTuple becomes the port's type of the same name and fields, so
    the leaves keep the JAX package's order."""
    device = platform.resolve(device)
    return _carry(tree, lambda x: torch.from_numpy(np.array(x)).to(device), _train_types())


def train_state_to_numpy(state):
    """The port's ``TrainState`` -> the same tree with numpy leaves (on the
    host), in the JAX package's leaf order."""
    return _carry(state, lambda x: x.detach().cpu().numpy(), _train_types())
