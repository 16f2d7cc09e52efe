"""Port parity: the friction-free lattice kernel and its host loops.

The same numpy inputs go through the JAX package (Pallas kernels in
interpret mode on the CPU) and the port (the kernels' plain versions on
the CPU).  Tolerances: one round compares at a relative 1e-13 (a few ulps: the two
packages' ``exp`` differ in the last ulp, and node values reach 1e4 at
the far lanes) plus 1e-12 absolute, prices at the repo's 1e-9.  The card tests hold each CUDA kernel against its plain
version on the same card.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64)
from repro.core import LatticeModel as JLatticeModel
from repro.core import american_call as j_call
from repro.core import american_put as j_put
from repro.core.notc import price_notc_np as j_price_notc_np
from repro.kernels import binomial_step as JB
from repro.kernels.ops import price_notc_kernel as j_price_notc_kernel

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.core.lattice import LatticeModel
from repro_torch import api
from repro_torch.core.notc import price_notc_np
from repro_torch.core.payoff import american_call, american_put, bull_spread
from repro_torch.kernels import binomial_step as TB
from repro_torch.kernels.ops import price_notc_kernel

ROUND_TOL = 1e-12
ROUND_RTOL = 1e-13
PRICE_TOL = 1e-9




def _inputs(seed, rows, P, kind):
    rng = np.random.default_rng(seed)
    v = rng.uniform(0.0, 20.0, (rows, P))
    lvl0 = float(P - 20)
    base = [lvl0, 0.51, 0.998]
    if kind == "param":
        sc = [base + [rng.uniform(90, 110), 0.02,
                      *fam, 95.0 + r, 105.0 + r]
              for fam, r in zip([(1.0, -1.0, 0.0, 0.0), (0.0, 0.0, 1.0, -1.0),
                                 (-1.0, 1.0, 0.0, 0.0)][:rows],
                                rng.uniform(-3, 3, rows))]
    else:
        sc = [base + [100.0 + r, rng.uniform(90, 110), 0.02]
              for r in rng.uniform(-3, 3, rows)]
    return v, np.asarray(sc, np.float64)


@pytest.mark.parametrize("levels,block", [(6, 16), (16, 16), (3, 8)])
def test_lattice_round_param_matches_pallas(levels, block):
    v, sc = _inputs(1, 3, 4 * block, "param")
    want = np.stack([np.asarray(_jax_round(block, levels)(v[i], sc[i]))
                     for i in range(3)])
    got = TB.lattice_round_param(torch.tensor(v), torch.tensor(sc),
                                 levels=levels, block=block)
    np.testing.assert_allclose(got.numpy(), want, rtol=ROUND_RTOL, atol=ROUND_TOL)


@pytest.mark.parametrize("kind", ["put", "call"])
def test_lattice_round_matches_pallas(kind):
    block, levels = 32, 12
    v, sc = _inputs(2, 2, 3 * block, kind)
    want = np.stack([np.asarray(JB.lattice_round(
        v[i], sc[i], levels=levels, block=block, kind=kind))
        for i in range(2)])
    got = TB.lattice_round(torch.tensor(v), torch.tensor(sc), levels=levels,
                           block=block, kind=kind)
    np.testing.assert_allclose(got.numpy(), want, rtol=ROUND_RTOL, atol=ROUND_TOL)
    # the single-row form of the wrapper
    one = TB.lattice_round(torch.tensor(v[0]), torch.tensor(sc[0]),
                           levels=levels, block=block, kind=kind)
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())


def test_final_short_round_is_a_noop_below_level_zero():
    """Steps whose level is below 0 leave the lanes untouched."""
    v, sc = _inputs(3, 1, 128, "param")
    sc[0, 0] = 2.0                          # levels 1, 0, then no-ops
    a = TB.lattice_round_param(torch.tensor(v), torch.tensor(sc), levels=2,
                               block=64)
    b = TB.lattice_round_param(torch.tensor(v), torch.tensor(sc), levels=30,
                               block=64)
    np.testing.assert_array_equal(a.numpy()[:, :33], b.numpy()[:, :33])


@pytest.mark.parametrize("kind,n", [("put", 24), ("call", 19)])
def test_price_notc_kernel_matches_jax_and_oracles(kind, n):
    m = LatticeModel(s0=100.0, sigma=0.3, rate=0.06, maturity=1.0, n_steps=n)
    jm = JLatticeModel(s0=100.0, sigma=0.3, rate=0.06, maturity=1.0,
                       n_steps=n)
    got = price_notc_kernel(m, 100.0, kind=kind, levels=8, block=16,
                            device="cpu")
    want = j_price_notc_kernel(jm, 100.0, kind=kind, levels=8, block=16)
    jpay = (j_put if kind == "put" else j_call)(100.0)
    tpay = (american_put if kind == "put" else american_call)(100.0)
    assert got == pytest.approx(want, abs=PRICE_TOL)
    assert got == pytest.approx(j_price_notc_np(jm, jpay), abs=PRICE_TOL)
    assert got == pytest.approx(price_notc_np(m, tpay), abs=PRICE_TOL)
    plain = api.price_american(
        s0=100.0, sigma=0.3, rate=0.06, maturity=1.0, n_steps=n,
        payoff=kind, strike=100.0,
        execution=api.ExecutionConfig(backend="torch", device="cpu"))
    assert got == pytest.approx(plain.ask, abs=PRICE_TOL)


def test_numpy_oracle_matches_jax_oracle_on_every_family():
    jm = JLatticeModel(s0=98.0, sigma=0.25, rate=0.05, maturity=0.5,
                       n_steps=12)
    m = LatticeModel(s0=98.0, sigma=0.25, rate=0.05, maturity=0.5,
                     n_steps=12)
    from repro.core import bull_spread as j_bull
    for tp, jp in ((american_put(100.0), j_put(100.0)),
                   (american_call(95.0), j_call(95.0)),
                   (bull_spread(95.0, 105.0), j_bull(95.0, 105.0))):
        assert price_notc_np(m, tp) == pytest.approx(
            j_price_notc_np(jm, jp), abs=PRICE_TOL)


def test_lattice_model_matches_jax():
    kw = dict(s0=100.0, sigma=0.2, rate=0.1, maturity=0.25, n_steps=7,
              cost_rate=0.01)
    a, b = LatticeModel(**kw), JLatticeModel(**kw)
    for name in ("u", "d", "r"):
        assert getattr(a, name) == getattr(b, name)
    assert a.p == b.p_star and a.dt == b.maturity / b.n_steps
    np.testing.assert_array_equal(a.stock_level(7), b.stock_level(7))
    with pytest.raises(ValueError):
        LatticeModel(**{**kw, "cost_rate": 1.0})


def test_wrapper_contracts_and_no_launch_on_cpu():
    v = torch.zeros(1, 128, dtype=torch.float64)
    sc = torch.zeros(1, TB.PARAM_SCALARS, dtype=torch.float64)
    before = dict(TB.LAUNCHES)
    TB.lattice_round_param(v, sc, levels=4, block=64)
    assert TB.LAUNCHES == before            # the plain version is no launch
    with pytest.raises(ValueError, match="multiple of block"):
        TB.lattice_round_param(v, sc, levels=4, block=96)
    with pytest.raises(ValueError, match="levels <= block"):
        TB.lattice_round_param(v, sc, levels=65, block=64)
    with pytest.raises(ValueError, match="scalars"):
        TB.lattice_round_param(v, sc[:, :6], levels=4, block=64)
    # float32 builds too, but v and scalars must share one dtype
    with pytest.raises(TypeError, match="one dtype"):
        TB.lattice_round_param(v.float(), sc, levels=4, block=64)
    with pytest.raises(ValueError, match="kind"):
        TB.lattice_round(v, sc[:, :6], levels=4, block=64, kind="digital")


# ---------------------------------------------------------------------------
# The premises of the CUDA kernel's design (csrc/binomial_step.cu), checked
# here against the plain version and the JAX kernel in interpret mode.

PREMISE_CASES = [(8, 3), (16, 16), (64, 50)]


def _premise_inputs(block, levels, short):
    """Three rows of the 4-parameter family (put, bull spread, call) over
    256 lanes, each row at its own lvl0: the final short round puts the
    rows below ``levels`` (down to a round of no-ops)."""
    P = max(3 * block, 256)
    rng = np.random.default_rng(block + levels + short)
    v = rng.uniform(0.0, 30.0, (3, P))
    lvl0 = ([max(levels - 1, 1), 1.0, 0.0] if short
            else [float(P - 5), float(P + 40), float(2 * levels)])
    fams = [(1.0, -1.0, 0.0, 0.0), (0.0, 0.0, 1.0, -1.0), (-1.0, 1.0, 0.0, 0.0)]
    sc = np.array([[l0, 0.51, 0.998, 90.0 + 10 * i, 0.02, *fam, 95.0, 105.0]
                   for i, (l0, fam) in enumerate(zip(lvl0, fams))])
    return v, sc


@functools.lru_cache(maxsize=None)
def _jax_round(block, levels):
    """The JAX kernel (interpret mode) compiled once for a (block, levels):
    the premise inputs of one shape share it (eager, each call re-ran the
    interpreter, about 11 s at block 64 and 50 levels)."""
    return jax.jit(functools.partial(JB.lattice_round_param, levels=levels,
                                     block=block))


@functools.lru_cache(maxsize=None)
def _jax_row0(block, levels, short, perturbed):
    """The JAX kernel (interpret mode) on row 0 of the premise inputs,
    lanes [levels, block) of block 1 perturbed or not."""
    v, sc = _premise_inputs(block, levels, short)
    if perturbed:
        v = _perturb(v, 1, block, levels)
    return np.asarray(_jax_round(block, levels)(v[0], sc[0]))


def _perturb(v, nb, block, levels):
    out = v.copy()
    out[:, nb * block + levels:(nb + 1) * block] += 7.25
    return out


@pytest.mark.parametrize("short", [False, True], ids=["full", "short-round"])
@pytest.mark.parametrize("block,levels", PREMISE_CASES)
def test_owned_lanes_read_only_levels_lanes_of_the_halo(block, levels, short):
    """Perturbing lanes [levels, block) of block b+1 leaves block b's output
    unchanged: the halo the kernel loads is ``levels`` lanes wide."""
    v, sc = _premise_inputs(block, levels, short)
    nblk = v.shape[1] // block
    base = TB.lattice_round_plain(torch.tensor(v), torch.tensor(sc),
                                  levels=levels, block=block).numpy()
    for b in range(nblk - 1):
        got = TB.lattice_round_plain(torch.tensor(_perturb(v, b + 1, block,
                                                           levels)),
                                     torch.tensor(sc), levels=levels,
                                     block=block).numpy()
        own = slice(b * block, (b + 1) * block)
        np.testing.assert_array_equal(got[:, own], base[:, own])
    jax_base = _jax_row0(block, levels, short, False)
    jax_pert = _jax_row0(block, levels, short, True)
    np.testing.assert_array_equal(jax_pert[:block], jax_base[:block])
    np.testing.assert_allclose(base[0], jax_base, rtol=ROUND_RTOL,
                               atol=ROUND_TOL)


def _mirror_intrinsic(s, sc, kind):
    if kind == "put":
        return np.maximum(sc[3] - s, 0.0)
    if kind == "call":
        return np.maximum(s - sc[3], 0.0)
    alpha, zeta, w1, w2, k1, k2 = sc[5:11]
    pay = (alpha * k1 + w1 * np.maximum(s - k1, 0.0)
           + w2 * np.maximum(s - k2, 0.0) + zeta * s)
    return np.maximum(pay, 0.0)


def _mirror_round(v, sc, *, levels, block, kind="param", lanes=10, warps=4):
    """Numpy mirror of csrc/binomial_step.cu's schedule, for tests only.

    Each row is cut into tiles of ``warps * (W - min(levels, W/2))`` owned
    lanes (W = 32 * lanes, one warp window); a tile loads ``tile + levels``
    lanes of the virtual row (the last block's clamped halo beyond P),
    tabulates the intrinsic at j = 2 t0 - lvl0 + 1 + k (k = 2x + s - 1 for
    local lane x at step s), and runs its active steps in chunks of at most
    W/2 over warp windows that keep W - n lanes each.  Inside a window,
    thread t holds lanes [t*lanes, (t+1)*lanes) and two windows of table
    entries (odd and even steps) that rotate by one slot every two steps,
    refilled at the clamped table index as the kernel does.
    """
    rows, P = v.shape
    R, W = lanes, 32 * lanes
    keep = W - min(levels, W // 2)
    tile = warps * keep
    nsrc = tile + levels
    kmax = 2 * nsrc - 1
    out = np.empty_like(v)
    for row in range(rows):
        c = sc[row]
        lvl0, p_up, inv_r = c[0], c[1], c[2]
        q = 1.0 - p_up
        s0, sig = (c[3], c[4]) if kind == "param" else (c[4], c[5])
        active = levels if lvl0 >= levels else (int(lvl0) if lvl0 >= 1 else 0)

        def step(vals, w, u):
            last = np.append(vals[1:, 0], vals[31, 0])   # shfl_down
            up = np.concatenate([vals[:, 1:], last[:, None]], axis=1)
            cont = (p_up * up + q * vals) * inv_r
            return np.maximum(w[:, (np.arange(R) + u) % R], cont)

        for t0 in range(0, P, tile):
            p = t0 + np.arange(nsrc)
            src = np.where(p < P, v[row, np.minimum(p, P - 1)],
                           np.where(p < P + block,
                                    v[row, np.clip(p - block, 0, P - 1)], 0.0))
            dst = np.zeros(nsrc)
            j = 2 * t0 - int(lvl0) + 1 + np.arange(2 * nsrc)
            s = s0 * torch.exp(torch.tensor(j, dtype=torch.float64)
                               * sig).numpy()
            g = _mirror_intrinsic(s, c, kind)
            done = 0
            while done < active:
                n = min(active - done, W // 2)
                vout = nsrc - done - n
                # the kept ranges [start, start + W - n) tile [0, vout)
                # without overlap, so the warps' order does not matter
                for start in range(0, vout, W - n):
                    base = start + np.arange(32) * R
                    x = base[:, None] + np.arange(R)
                    vals = src[np.minimum(x, nsrc - 1)]
                    k = 2 * base + done
                    e = g[np.minimum(k[:, None] + 2 * np.arange(R), kmax)]
                    o = g[np.minimum(k[:, None] + 2 * np.arange(R) + 1, kmax)]
                    k = k + 2 * R
                    for i in range(0, n, 2 * R):
                        for u in range(R):
                            if i + 2 * u >= n:
                                break
                            vals = step(vals, e, u)
                            e[:, u] = g[np.minimum(k, kmax)]
                            if i + 2 * u + 1 >= n:
                                break
                            vals = step(vals, o, u)
                            o[:, u] = g[np.minimum(k + 1, kmax)]
                            k = k + 2
                    kept = (x - start < W - n) & (x < vout)
                    dst[x[kept]] = vals[kept]
                src, dst = dst, src
                done += n
            owned = t0 + np.arange(tile)
            out[row, owned[owned < P]] = src[:tile][owned < P]
    return out


@pytest.mark.parametrize("lanes,warps", [(1, 2), (3, 2), (10, 4)],
                         ids=["W32", "W96", "kernel-default"])
@pytest.mark.parametrize("short", [False, True], ids=["full", "short-round"])
@pytest.mark.parametrize("block,levels", PREMISE_CASES)
def test_kernel_schedule_mirror_is_bit_equal_to_plain(block, levels, short,
                                                      lanes, warps):
    """The kernel's trapezoid, chunking and intrinsic table (its jbase and
    clamped indices) give the plain version's owned lanes bit for bit,
    the clamped last block included; W32 and W96 cut rows into several
    tiles and (64, 50) into several chunks."""
    v, sc = _premise_inputs(block, levels, short)
    want = TB.lattice_round_plain(torch.tensor(v), torch.tensor(sc),
                                  levels=levels, block=block).numpy()
    got = _mirror_round(v, sc, levels=levels, block=block, lanes=lanes,
                        warps=warps)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got[0], _jax_row0(block, levels, short, False),
                               rtol=ROUND_RTOL, atol=ROUND_TOL)


@pytest.mark.parametrize("kind", ["put", "call"])
def test_kernel_schedule_mirror_kinds(kind):
    """The put/call entry (``lattice_round``) through the same schedule."""
    block, levels = 16, 12
    v, sc = _inputs(5, 2, 12 * block, kind)
    sc[1, 0] = 7.0                                   # a short round beside
    want = TB.lattice_round_plain(torch.tensor(v), torch.tensor(sc),
                                  levels=levels, block=block,
                                  kind=kind).numpy()
    got = _mirror_round(v, sc, levels=levels, block=block, kind=kind,
                        lanes=1, warps=2)
    np.testing.assert_array_equal(got, want)
