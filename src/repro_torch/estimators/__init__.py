"""repro_torch.estimators -- every similarity-join size estimator behind
one streaming protocol.

Importing this package registers the built-in kinds:

  "sjpc"       the paper's sketch estimator (Algorithm 1); linear,
               joinable, analytical error bounds (sjpc_backend.py)
  "reservoir"  one-pass uniform record sampling (§2.1 / Fig. 8), queried
               through the fused all-pairs kernel (reservoir.py)
  "lsh_ss"     one-pass stratified LSH sampling (§2.3): bucket-count
               sketch + online pair reservoirs (lsh_ss.py)

Plugin kinds register from outside the package (``examples/plugins_torch``);
``load_plugins()`` imports the modules ``REPRO_PLUGINS`` names.

``make(kind, sjpc_cfg)`` derives each competitor's configuration from the
group's SJPCConfig, so all kinds are equal-space by construction.
"""
from .base import (EstimateTable, Estimator, EstimatorSpec, available, index_state,
                   load_plugins, make, pairwise_exact_oracle, register, register_spec,
                   register_state_type, scan_rounds, spec, spec_of, stack_states, state_type,
                   zeros_like_stack)
from .lsh_ss import LSHSSConfig, LSHSSEstimator, LSHSSState, derive_config
from .reservoir import ReservoirConfig, ReservoirEstimator, ReservoirState, capacity_for_bytes
from .sjpc_backend import SJPCEstimator

__all__ = [
    "EstimateTable", "Estimator", "EstimatorSpec", "LSHSSConfig", "LSHSSEstimator",
    "LSHSSState", "ReservoirConfig", "ReservoirEstimator", "ReservoirState", "SJPCEstimator",
    "available", "capacity_for_bytes", "derive_config", "index_state", "load_plugins", "make",
    "pairwise_exact_oracle", "register", "register_spec", "register_state_type",
    "scan_rounds", "spec", "spec_of", "stack_states", "state_type", "zeros_like_stack",
]
