"""Kernel registry of the port: for each kernel op, its hand-written CUDA
kernel and its plain PyTorch version.

Every op registers one :class:`KernelOp` with two implementations:

  * ``cuda_sm90`` -- the kernel, CUDA tensors only;
  * ``torch_ref`` -- the plain version in :mod:`.ref`, any device.  It is the
    kernel's **mandatory oracle**: :meth:`KernelRegistry.register` refuses an
    op without a callable one, so the conformance matrix generated from the
    registry holds every kernel against it.

:meth:`KernelRegistry.select` decides from the device of the call's
tensors: CUDA tensors run the kernel, CPU tensors the plain version, and
``meta`` tensors the op's shape function (``work.SHAPES``: the outputs'
shapes and dtypes, nothing computed), which the dry run traces with.  A
caller may name ``impl=`` for one call; the oracle calls that hold a kernel
against its plain version on the card name ``torch_ref``.  Nothing else
changes the choice.  A kernel that cannot build or launch raises; it never
falls back to the plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

TORCH_REF = "torch_ref"
CUDA_SM90 = "cuda_sm90"
IMPLS = (TORCH_REF, CUDA_SM90)
META = "meta"       # the shape function, meta tensors only; not an implementation


class RegistryError(ValueError):
    """A registration or an implementation name the registry refuses."""


@dataclasses.dataclass(frozen=True)
class KernelOp:
    """One op: its kernel and the plain version the kernel must match."""

    name: str
    kernel: Callable    # cuda_sm90
    oracle: Callable    # torch_ref, in kernels/ref.py
    shape: Callable | None = None   # meta

    def impl(self, impl: str) -> Callable:
        if impl == CUDA_SM90:
            return self.kernel
        if impl == TORCH_REF:
            return self.oracle
        if impl == META and self.shape is not None:
            return self.shape
        raise RegistryError(f"{self.name!r} has no implementation named {impl!r} "
                            f"(registered: {list(IMPLS)})")


class KernelRegistry:
    """The per-process op table.  :func:`kernel_registry` is the instance
    ``kernels.ops`` fills at import; tests may build their own."""

    def __init__(self):
        self._ops: dict[str, KernelOp] = {}

    def register(self, name: str, *, kernel: Callable, oracle: Callable,
                 shape: Callable | None = None) -> KernelOp:
        """Register one op; the oracle is mandatory, the shape function
        (the ``meta`` tier) optional."""
        if not callable(oracle):
            raise RegistryError(f"{name}: every registered kernel must point at its "
                                f"oracle in kernels/ref.py (got {oracle!r})")
        if not callable(kernel):
            raise RegistryError(f"{name}: kernel must be callable")
        if name in self._ops:
            raise RegistryError(f"{name}: already registered")
        self._ops[name] = KernelOp(name, kernel, oracle, shape)
        return self._ops[name]

    def ops(self) -> tuple[str, ...]:
        return tuple(sorted(self._ops))

    def get(self, name: str) -> KernelOp:
        try:
            return self._ops[name]
        except KeyError:
            raise RegistryError(f"unknown kernel op {name!r}") from None

    def select(self, name: str, device: torch.device,
               impl: str | None = None) -> tuple[str, Callable]:
        """(implementation name, function) for a call on ``device``:
        ``impl`` when the caller names one, else the kernel for CUDA
        tensors, the shape function for ``meta`` tensors and the plain
        version for the rest."""
        if impl is None:
            impl = {"cuda": CUDA_SM90, "meta": META}.get(device.type, TORCH_REF)
        return impl, self.get(name).impl(impl)


_REGISTRY = KernelRegistry()


def kernel_registry() -> KernelRegistry:
    """The process-global registry, filled by importing ``kernels.ops``."""
    return _REGISTRY
