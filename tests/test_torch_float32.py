"""Port parity in float32: the platform dtype policy and the pricing
kernels' float32 variants, against the JAX package on the CPU.

The JAX package runs its pricing kernels in float32 on an accelerator
(``core/platform.py``: gpu and tpu resolve to float32) and holds each
float32 kernel to its ``kernels/contracts.py`` entry: 1e-5 for the two
lattice kernels, 1e-4 for ``rz_round``.  The same numpy inputs go through
JAX's jnp references (Pallas interpret mode only where JAX's own entry
point takes it: ``price_notc_kernel``) and the port's plain versions on
the CPU, which the card tests hold each CUDA float32 instance to.

Float32 knot counts are not stable (JAX's own float32 white-box test
compares values only), and the PWL algebra's relative 1e-9 tolerance is
below float32's resolution, so a float32 walk's knot count grows by
several a level in both packages: ``rz_backward`` in float32 fits K=48
at N=10 (values held to JAX's to 1e-4) and overflows it at N=25.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64)
from repro.configs.pricing import PricingConfig as JPricingConfig
from repro.core import platform as jplat
from repro.core.payoff import american_put as j_put
from repro.core.rz import _leaf_level as j_leaf_level
from repro.core.rz import rz_backward as j_rz_backward
from repro.core.rz import rz_level_step_lanes as j_rz_level_step_lanes
from repro.kernels.binomial_ref import lattice_levels_ref as j_levels_ref
from repro.kernels.ops import price_notc_kernel as j_price_notc_kernel
from repro.core.lattice import LatticeModel as JLatticeModel

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.configs.pricing import PricingConfig
from repro_torch.core import distributed as D
from repro_torch.core import platform as plat
from repro_torch.core import pwl as P
from repro_torch.core import rz as R
from repro_torch.core.lattice import LatticeModel
from repro_torch.core.payoff import american_put
from repro_torch.kernels import binomial_step as TB
from repro_torch.kernels import rz_step as RS
from repro_torch.kernels.binomial_ref import lattice_levels_ref
from repro_torch.kernels.contracts import CONTRACTS
from repro_torch.kernels.ops import price_notc_kernel

F32 = torch.float32
LATTICE_TOL = CONTRACTS["lattice_round"].tolerance(F32)        # 1e-5
RZ_TOL = CONTRACTS["rz_round"].tolerance(F32)                  # 1e-4


# --------------------------------------------------------------------- #
# the platform policy and PricingConfig.resolve_execution
# --------------------------------------------------------------------- #
def test_policy_table_matches_jax():
    assert plat.PLATFORMS == jplat.PLATFORMS
    for name in jplat.PLATFORMS:
        a, b = plat.POLICIES[name], jplat.POLICIES[name]
        assert (a.platform, a.interpret, a.compiled_pallas,
                a.default_dtype) == (b.platform, b.interpret,
                                     b.compiled_pallas, b.default_dtype)
    with pytest.raises(ValueError, match="unknown platform"):
        plat.resolve_interpret(None, "npu")
    with pytest.raises(ValueError, match="no path in the port"):
        plat.default_dtype("tpu")


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_resolve_execution_matches_jax(platform):
    """Every dtype knob, with the platform given and with it pinned
    (``set_platform``), gives JAX's dict; the policy functions agree."""
    try:
        jplat.set_platform(platform, configure_jax=False)
        plat.set_platform(platform)
        assert plat.active_platform() == jplat.active_platform() == platform
        assert plat.resolve_interpret() == jplat.resolve_interpret()
        assert plat.default_dtype() == getattr(torch,
                                               jplat.default_dtype().name)
        summary = plat.platform_summary()
        for key in ("platform", "interpret", "compiled_pallas",
                    "default_dtype"):
            assert summary[key] == jplat.platform_summary()[key]
        for dtype in (None, "float32", "float64"):
            for pinned in (None, platform):
                kw = dict(name="t", n_steps=8, platform=pinned, dtype=dtype)
                assert (PricingConfig(**kw).resolve_execution()
                        == JPricingConfig(**kw).resolve_execution())
        # the dtype does not reach the execution config in either package
        ex = PricingConfig(name="t", n_steps=8, platform="cpu",
                           dtype="float32").execution()
        assert ex.device == "cpu" and "dtype" not in ex.set_fields()
    finally:
        jplat.set_platform(None, configure_jax=False)
        plat.set_platform(None)
    assert plat.active_platform() == plat.detect_platform()
    with pytest.raises(ValueError, match="float16"):
        PricingConfig(name="t", n_steps=8, dtype="float16").execution()


def test_kernel_registry_matches_jax_contracts():
    """One entry per CUDA kernel, both ways: JAX's names, dtypes and
    per-dtype tolerances; each entry's wrapper and plain version, its
    CUDA source and the TPU kernel's file."""
    import pathlib
    from repro.kernels.contracts import CONTRACTS as JCONTRACTS
    root = pathlib.Path(__file__).resolve().parents[1]
    assert set(CONTRACTS) == set(JCONTRACTS)
    for name, c in CONTRACTS.items():
        j = JCONTRACTS[name]
        assert c.name == name and c.dtypes == j.dtypes
        assert dict(c.tol) == dict(j.tol)
        for d in c.dtypes:
            assert c.tolerance(getattr(torch, d)) == j.tolerance(d)
        assert callable(c.wrapper) and callable(c.plain)
        assert (root / c.source).is_file()
        path, line = c.replaces.split(":")
        assert path == "src/" + j.module.replace(".", "/") + ".py"
        assert (root / path).is_file() and int(line) > 0


# --------------------------------------------------------------------- #
# the lattice kernels' plain versions in float32
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("block,levels,P", [
    (128, 1, 512), (128, 7, 512), (128, 64, 512), (64, 32, 256),
    (256, 100, 1024)])
def test_lattice_plain_float32_matches_jax_reference(block, levels, P):
    """Both lattice kernels' plain versions in float32 against JAX's
    ``lattice_levels_ref`` on the lanes a round owns (all but the last,
    clamped block), at the shapes of JAX's own sweep; the port's copy of
    ``lattice_levels_ref`` equals JAX's as well."""
    rng = np.random.default_rng(P + levels)
    v = (rng.uniform(0.0, 50.0, P)).astype(np.float32)
    sc = np.asarray([100.0, 0.53, 0.999, 100.0, 95.0, 0.01], np.float32)
    want = np.asarray(j_levels_ref(jnp.asarray(v), jnp.asarray(sc),
                                   levels=levels))
    valid = P - block
    put = TB.lattice_round(torch.tensor(v), torch.tensor(sc), levels=levels,
                           block=block, kind="put")
    # the put of the 4-parameter family: alpha 1, zeta -1, strike 100
    psc = torch.tensor([100.0, 0.53, 0.999, 95.0, 0.01, 1.0, -1.0, 0.0, 0.0,
                        100.0, 100.0], dtype=F32)
    param = TB.lattice_round_param(torch.tensor(v), psc, levels=levels,
                                   block=block)
    ref = lattice_levels_ref(torch.tensor(v), torch.tensor(sc), levels=levels)
    for got in (put, param):
        assert got.dtype == F32
        np.testing.assert_allclose(got.numpy()[:valid], want[:valid],
                                   rtol=LATTICE_TOL, atol=LATTICE_TOL)
    np.testing.assert_allclose(ref.numpy(), want, rtol=LATTICE_TOL,
                               atol=LATTICE_TOL)


@pytest.mark.parametrize("kind,n", [("put", 24), ("call", 19)])
def test_price_notc_kernel_float32_matches_jax(kind, n):
    m = LatticeModel(s0=100.0, sigma=0.3, rate=0.06, maturity=1.0, n_steps=n)
    jm = JLatticeModel(s0=100.0, sigma=0.3, rate=0.06, maturity=1.0,
                       n_steps=n)
    got = price_notc_kernel(m, 100.0, kind=kind, levels=8, block=16,
                            device="cpu", dtype=F32)
    want = j_price_notc_kernel(jm, 100.0, kind=kind, levels=8, block=16,
                               interpret=True, dtype=jnp.float32)
    f64 = price_notc_kernel(m, 100.0, kind=kind, levels=8, block=16,
                            device="cpu")
    assert got == pytest.approx(want, abs=LATTICE_TOL)
    assert got != f64 and got == pytest.approx(f64, abs=1e-4)
    # the policy: float64 on the CPU, float32 for the card's platform
    assert price_notc_kernel(m, 100.0, kind=kind, levels=8, block=16,
                             device="cpu", dtype=torch.float64) == f64
    assert plat.default_dtype("gpu") == F32


def test_wrappers_refuse_mixed_and_other_dtypes():
    v = torch.zeros(1, 64, dtype=F32)
    with pytest.raises(TypeError, match="one dtype"):
        TB.lattice_round(v, torch.zeros(1, 6, dtype=torch.float64),
                         levels=4, block=32)
    with pytest.raises(TypeError, match="one dtype"):
        TB.lattice_round(v.half(), torch.zeros(1, 6).half(), levels=4,
                         block=32)
    z = P.make_affine(torch.zeros(1, 2, 8), torch.zeros(1, 2, 8), 4,
                      dtype=F32)
    with pytest.raises(TypeError, match="scalars must be torch.float32"):
        RS.rz_round(z, torch.zeros(1, 11, dtype=torch.float64), levels=2,
                    block=8)
    with pytest.raises(TypeError, match="float64 or float32"):
        RS.rz_round(z.map(lambda a: a.half() if a.is_floating_point()
                          else a), torch.zeros(1, 11).half(), levels=2,
                    block=8)


# --------------------------------------------------------------------- #
# rz_round's plain version and the RZ walk in float32
# --------------------------------------------------------------------- #
def test_rz_round_plain_float32_matches_jax_level_chain():
    """One float32 round (N=9, K=12, block 4, 3 levels, as JAX's white-box
    test) against JAX's float32 chain of full-width level steps: the
    functions' values on the owned live lanes within 1e-4, every knot
    count within the capacity."""
    n_steps, capacity, block, levels = 9, 12, 4, 3
    dt = 0.25 / n_steps
    jparams = dict(s0=jnp.asarray(100.0, jnp.float32),
                   k=jnp.asarray(0.01, jnp.float32),
                   sig_sqrt_dt=0.2 * jnp.sqrt(jnp.asarray(dt, jnp.float32)),
                   r=jnp.exp(jnp.asarray(0.1 * dt, jnp.float32)))
    lanes, lvl0 = 12, n_steps + 1
    z = j_leaf_level(n_steps, jparams, capacity, jnp.float32, lanes=lanes)
    sides, pay = jnp.asarray([True, False])[:, None], j_put(100.0)
    step = jax.jit(lambda z, lvl: j_rz_level_step_lanes(
        z, lvl, jparams, capacity=capacity, seller=sides, payoff=pay,
        dtype=jnp.float32))
    zj = jax.tree.map(lambda a: jnp.stack([a, a]), z)
    for j in range(levels):
        zj, _ = step(zj, jnp.asarray(lvl0 - (j + 1), jnp.float32))

    t = lambda a: torch.tensor(np.asarray(a))
    z0 = P.PWL(*(t(a)[None, None].expand((1, 2) + a.shape).contiguous()
                 for a in z))
    sc = torch.tensor([[lvl0, 100.0, float(jparams["sig_sqrt_dt"]),
                        float(jparams["r"]), 0.01, 1.0, -1.0, 0.0, 0.0,
                        100.0, 100.0]], dtype=F32)
    got, pieces = RS.rz_round_plain(z0, sc, levels=levels, block=block)
    assert got.xs.dtype == F32
    assert int(pieces.max()) <= capacity and int(got.m.max()) <= capacity
    live = np.arange(lanes) <= lvl0 - levels
    ysq = torch.linspace(-4.0, 4.0, 81, dtype=F32)
    for side in (0, 1):
        mine = got.map(lambda a: a[0, side])
        theirs = P.PWL(*(t(a)[side] for a in zj))
        vals = lambda f: P._eval1(f, ysq.expand(f.sl.shape + (81,))).numpy()
        np.testing.assert_allclose(vals(mine)[live], vals(theirs)[live],
                                   rtol=0, atol=RZ_TOL)


def test_rz_backward_float32_matches_jax():
    """At N=10 JAX's float32 walk and the port's (the plain walk and the
    kernel walk's plain rounds) fit K=48 and agree to 1e-4."""
    n, pay = 10, j_put(100.0)
    f = jax.jit(lambda *a: j_rz_backward(*a, n_steps=n, capacity=48,
                                          payoff=pay, dtype=jnp.float32))
    j_ask, j_bid, j_pieces = (float(x) for x in f(*(
        jnp.asarray(x, jnp.float32) for x in (100.0, 0.2, 0.1, 0.25, 0.01))))
    t = lambda x: torch.tensor([x], dtype=F32)
    args = [t(x) for x in (100.0, 0.2, 0.1, 0.25, 0.01)]
    pay = [t(x) for x in american_put(100.0).params]
    assert j_pieces <= 48
    for walk in (R.rz_backward, R.rz_backward_kernel):
        ask, bid, pieces = walk(*args, pay, n_steps=n, capacity=48,
                                dtype=F32)
        assert ask.dtype == F32 and int(pieces) <= 48
        assert float(ask) == pytest.approx(j_ask, abs=RZ_TOL)
        assert float(bid) == pytest.approx(j_bid, abs=RZ_TOL)


def test_rz_backward_float32_overflows_where_float64_fits():
    """At N=25 the float32 walk outgrows K=48 (JAX's float32 walk counts
    73 knots there, ROADMAP's reference caveats), the float64 walk needs
    4: float32 needs capacity headroom, as JAX's white-box test says."""
    for dt, fits in ((torch.float64, True), (F32, False)):
        t = lambda x: torch.tensor([x], dtype=dt)
        *_, pieces = R.rz_backward(
            *(t(x) for x in (100.0, 0.2, 0.1, 0.25, 0.01)),
            [t(x) for x in american_put(100.0).params], n_steps=25,
            capacity=48, dtype=dt)
        assert (int(pieces) <= 48) == fits


# --------------------------------------------------------------------- #
# the node-axis builders in float32
# --------------------------------------------------------------------- #
def _mesh(width):
    return D.DeviceMesh([[torch.device("cpu")] * width], ("data", "model"))


SPOTS = np.array([95.0, 100.0, 104.0])


@pytest.mark.parametrize("width", [2, 4])
def test_node_axis_float32_is_bit_equal_to_one_shard(width):
    col = lambda x: np.full(3, x)
    rz = lambda w: D.build_rz_sharded(
        _mesh(w), n_steps=12, payoff=american_put(100.0), capacity=48,
        round_depth=3, dtype=F32)(SPOTS, col(0.2), col(0.1), col(0.25),
                                  col(0.01))
    notc = lambda w: D.build_notc_sharded(
        _mesh(w), n_steps=40, strike=100.0, round_depth=5,
        dtype=F32)(SPOTS, col(0.3), col(0.06), col(1.0))
    ask1, bid1, _ = rz(1)
    ask, bid, _ = rz(width)
    assert ask.dtype == F32 and torch.equal(ask, ask1)
    assert torch.equal(bid, bid1)
    p1, p = notc(1), notc(width)
    assert p.dtype == F32 and torch.equal(p, p1)
    # float32 against the float64 builder: the float32 contract
    p64 = D.build_notc_sharded(_mesh(width), n_steps=40, strike=100.0,
                               round_depth=5)(SPOTS, col(0.3), col(0.06),
                                              col(1.0))
    np.testing.assert_allclose(p.double().numpy(), p64.numpy(), rtol=0,
                               atol=1e-4)
