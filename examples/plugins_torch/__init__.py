"""Plugin estimator kinds of the PyTorch port: ``examples/plugins/`` on
tensors.

Importing this package registers two estimator kinds with
``repro_torch.estimators``; no module of ``src/repro_torch`` knows their
names:

  "theta_kmv"  a KMV/theta bottom-K distinct-value sketch with retained
               multiplicities; sample-window semantics, no join support,
               no exact-replay oracle (the accuracy auditor skips it with
               ``reason="no_exact_oracle"``).
  "ipf"        an inner-product filter estimator: per-subset partitioned
               CountSketch rows per level, served through the same Eq. 4/7
               inversions as the paper's sketch; linear, join-capable,
               audited by the shared pairwise exact oracle.

Point ``REPRO_PLUGINS=examples.plugins_torch`` at this package (and call
``repro_torch.estimators.load_plugins()``), or import it, and both kinds
serve through the port's ``EstimationService``, planner, wire format and
coordinator.  Their states on the wire are byte for byte the JAX
package's plugins' states.
"""
from . import inner_product, theta_sketch  # noqa: F401  (registration)
from .inner_product import IPFConfig, IPFEstimator, IPFState
from .theta_sketch import ThetaConfig, ThetaEstimator, ThetaState

__all__ = [
    "IPFConfig", "IPFEstimator", "IPFState",
    "ThetaConfig", "ThetaEstimator", "ThetaState",
]
