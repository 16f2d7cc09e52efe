"""PyTorch/CUDA port of the binomial American option pricer.

A second package beside the JAX reference (``src/repro``): the same
scenario-grid pricing path (``ScenarioGrid`` -> ``api.price_grid`` ->
``scenarios.route_engine`` -> ``price_grid_rz`` / ``price_grid_notc``),
with the TPU Pallas kernels replaced by hand-written CUDA kernels for
Hopper (``csrc/``).  The package imports ``torch`` and ``numpy`` only.
"""
