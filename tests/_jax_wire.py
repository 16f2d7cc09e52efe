"""Chunk wire dicts as the JAX package's ``ChunkSpec.to_wire()`` writes
them, for tests that must not import JAX (the card-only tests).

``tests/test_torch_serve_core.py`` holds each literal equal to a fresh
dict from the JAX package's ``PricingService`` on a clock fixed at 0, so
they stay JAX-made.  ``"backend": "jnp"`` and ``"interpret": None`` are
the JAX service's defaults.
"""

JAX_CHUNK_WIRES = {
    "notc": {
        "version": 1, "kind": "chunk_spec", "bucket": (8, "notc"),
        "requests": (
            (0, (95.0, 0.2, 0.1, 0.25, 0.0, "put", 100.0, 110.0, 8, 1,
                 None), 0.0),
            (1, (105.0, 0.2, 0.1, 0.25, 0.0, "call", 100.0, 110.0, 8, 1,
                 None), 0.0),
            (2, (100.0, 0.2, 0.1, 0.25, 0.0, "bull_spread", 95.0, 105.0, 8,
                 1, None), 0.0)),
        "n_steps": 8, "engine": "notc", "capacity": 16, "backend": "jnp",
        "padded": 4,
        "cols": ((95.0, 105.0, 100.0), (0.2, 0.2, 0.2), (0.1, 0.1, 0.1),
                 (0.25, 0.25, 0.25), (0.0, 0.0, 0.0),
                 ("put", "call", "bull_spread"), (100.0, 100.0, 95.0),
                 (110.0, 110.0, 105.0)),
        "devices": None, "shard_plan": None, "n_assets": 1,
        "exercise_steps": None, "n_paths": 4096, "mc_seed": 0,
        "interpret": None, "basis": "poly", "degree": 3, "antithetic": True,
    },
    "rz": {
        "version": 1, "kind": "chunk_spec", "bucket": (8, "rz"),
        "requests": (
            (0, (98.0, 0.2, 0.1, 0.25, 0.01, "put", 100.0, 110.0, 8, 1,
                 None), 0.0),
            (1, (102.0, 0.2, 0.1, 0.25, 0.005, "call", 95.0, 105.0, 8, 1,
                 None), 0.0)),
        "n_steps": 8, "engine": "rz", "capacity": 16, "backend": "jnp",
        "padded": 2,
        "cols": ((98.0, 102.0), (0.2, 0.2), (0.1, 0.1), (0.25, 0.25),
                 (0.01, 0.005), ("put", "call"), (100.0, 95.0),
                 (110.0, 105.0)),
        "devices": None, "shard_plan": None, "n_assets": 1,
        "exercise_steps": None, "n_paths": 4096, "mc_seed": 0,
        "interpret": None, "basis": "poly", "degree": 3, "antithetic": True,
    },
}
