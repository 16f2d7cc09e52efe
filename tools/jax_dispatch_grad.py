"""JAX's ``moe_dispatch`` gradient against ``moe_dense``'s, on a (1, 2) mesh.

    PYTHONPATH=src JAX_PLATFORMS=cpu \\
        XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tools/jax_dispatch_grad.py

JAX runs ``moe_dispatch``'s ``shard_map`` with ``check_vma=False``,
under which a ``psum``'s transpose could sum the cotangents over the
expert axis once more (the experts' gradients ``tp`` times too large).
This measures it on the CPU (about 10 s): reduced dbrx-132b's MoE at
capacity factor 8 (nothing dropped), experts split over tp = 2, the
gradient of ``sum(out * w)`` for a fixed random ``w`` with respect to
every MoE leaf and to ``x``, through ``moe_dispatch`` and through
``moe_dense``.  Prints one JSON object a leaf: the ratio
``<g_dispatch, g_dense> / <g_dense, g_dense>`` (1 when they agree, 2
for a doubled gradient) and the largest gap beside the largest
``|g_dense|``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

import repro.core  # noqa: F401
from repro.configs import get_config, reduced_config
from repro.models import layers as L
from repro.models.sharding import MeshRules


def main():
    cfg = reduced_config(get_config("dbrx-132b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    key = jax.random.PRNGKey(0)
    p, _ = L.init_moe(key, cfg)
    x = jax.random.normal(key, (2, 8, cfg.d_model), jnp.float32)
    w = jax.random.normal(jax.random.PRNGKey(3), x.shape, jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    rules = MeshRules(mesh=mesh, fsdp=("data",), tp=("model",))

    def dense(p, x):
        return jnp.sum(L.moe_dense(p, x, cfg, jnp.float32)[0] * w)

    def dispatch(p, x):
        return jnp.sum(L.moe_dispatch(p, x, cfg, rules, jnp.float32)[0] * w)
    gd = jax.jit(jax.grad(dense, argnums=(0, 1)))(p, x)
    gs = jax.jit(jax.grad(dispatch, argnums=(0, 1)))(p, x)
    leaves = {**{k: (gd[0][k], gs[0][k]) for k in gd[0]}, "x": (gd[1], gs[1])}
    for name, (a, b) in leaves.items():
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        print(json.dumps({"leaf": name,
                          "ratio": float(np.sum(a * b) / np.sum(a * a)),
                          "max_abs_gap": float(np.abs(a - b).max()),
                          "max_abs_dense": float(np.abs(a).max()),
                          "jax": jax.__version__}))


if __name__ == "__main__":
    main()
