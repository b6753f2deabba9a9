"""repro_torch.core -- SJPC (Algorithm 1): hashing, fingerprints, the
projection lattice, Fast-AGMS sketches and the estimator.

The estimator's names are exported here, as the JAX package's
``repro.core`` exports them, on first access: ``core.sjpc`` imports the
kernel ops, whose plain versions import ``core.prng``, so importing
``core.sjpc`` with this package would be circular."""

_SJPC_NAMES = (
    "SJPCConfig", "SJPCParams", "SJPCState", "SJPCEstimate", "ShardedIngest",
    "init", "update", "update_fused", "merge", "all_reduce", "estimate", "estimate_join",
    "f2_to_pair_count", "inner_to_join_count", "level_f2",
    "offline_variance_bound", "online_variance_bound",
)


def __getattr__(name):
    if name in _SJPC_NAMES:
        from . import sjpc
        return getattr(sjpc, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
