"""repro_torch.core -- SJPC (Algorithm 1): hashing, fingerprints, the
projection lattice, Fast-AGMS sketches and the estimator."""
