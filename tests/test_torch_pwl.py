"""Port parity: the PWL algebra (``core/pwl.py``) op by op.

Random valid PWL batches are made with numpy from a seed and fed through
``repro_torch.convert`` to the port and as arrays to the JAX package
(compiled with ``jax.jit``).  Knot counts and raw (pre-truncation) counts must be
equal; knot positions and values agree to 1e-12 relative (XLA may contract a multiply and an add into one
rounding, a few ulps at most).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64)
from repro.core import pwl as JP

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.convert import pwl_from_numpy, pwl_to_numpy
from repro_torch.core import pwl as TP

RTOL = ATOL = 1e-12


def _random_pwl(rng, batch, K, m_max):
    """A batch of valid PWLs: sorted distinct knots, BIG/0 padding."""
    m = rng.integers(1, m_max + 1, batch).astype(np.int32)
    xs = np.full((batch, K), JP.BIG)
    ys = np.zeros((batch, K))
    for b in range(batch):
        gaps = rng.uniform(0.2, 3.0, m[b])
        xs[b, :m[b]] = rng.uniform(-10, 0) + np.cumsum(gaps)
        ys[b, :m[b]] = rng.normal(0, 5, m[b])
    sl = rng.normal(0, 50, batch)
    sr = rng.normal(0, 50, batch)
    return xs, ys, sl, sr, m


def _jit(fn, *static):
    """``fn`` compiled by XLA with the trailing ``static`` arguments bound
    (op-by-op dispatch of the vmapped algebra takes tens of seconds)."""
    return jax.jit(lambda *a: fn(*a, *static))


def _jax(arrs):
    return JP.PWL(*(jnp.asarray(a) for a in arrs))


def _assert_pwl(got, want, raw_got=None, raw_want=None):
    g = pwl_to_numpy(got)
    w = [np.asarray(a) for a in want]
    np.testing.assert_array_equal(g[4], w[4])                    # m
    for a, b in zip(g[:4], w[:4]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    if raw_got is not None:
        np.testing.assert_array_equal(raw_got.numpy(), np.asarray(raw_want))


def test_convert_round_trip():
    arrs = _random_pwl(np.random.default_rng(0), 5, 8, 6)
    back = pwl_to_numpy(pwl_from_numpy(*arrs))
    for a, b in zip(arrs, back):
        np.testing.assert_array_equal(a, b)
    assert back[4].dtype == np.int32


def test_constructors_match():
    rng = np.random.default_rng(1)
    xi, ze, sa, sb = (rng.normal(size=4) for _ in range(4))
    t = lambda a: torch.tensor(a)
    _assert_pwl(TP.expense(t(xi), t(ze), t(sa), t(sb), 6),
                JP.expense(xi, ze, sa, sb, 6))
    _assert_pwl(TP.make_affine(t(sa), t(xi), 5), JP.make_affine(sa, xi, 5))


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_and_merge_match(side):
    rng = np.random.default_rng(2)
    a = np.sort(rng.integers(0, 6, (4, 7)).astype(np.float64), -1)
    b = np.sort(rng.integers(0, 6, (4, 5)).astype(np.float64), -1)
    got = TP._searchsorted(torch.tensor(a), torch.tensor(b), side).numpy()
    want = np.stack([np.asarray(JP._searchsorted(jnp.asarray(a[i]),
                                                 jnp.asarray(b[i]), side))
                     for i in range(4)])
    np.testing.assert_array_equal(got, want)
    pa, pb = rng.normal(size=a.shape), rng.normal(size=b.shape)
    merged, pay = TP._merge_take(torch.tensor(a), torch.tensor(b),
                                 (torch.tensor(pa), torch.tensor(pb)))
    for i in range(4):
        jm, jpay = JP._merge_take(jnp.asarray(a[i]), jnp.asarray(b[i]),
                                  (jnp.asarray(pa[i]), jnp.asarray(pb[i])))
        np.testing.assert_array_equal(merged[i].numpy(), np.asarray(jm))
        np.testing.assert_array_equal(pay[i].numpy(), np.asarray(jpay))


def test_compact_matches():
    rng = np.random.default_rng(3)
    xs = np.sort(rng.normal(size=(6, 9)), -1)
    ys = rng.normal(size=(6, 9))
    keep = rng.random((6, 9)) < 0.5
    got = TP._compact(torch.tensor(xs), torch.tensor(ys), torch.tensor(keep))
    for i in range(6):
        want = JP._compact(jnp.asarray(xs[i]), jnp.asarray(ys[i]),
                           jnp.asarray(keep[i]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


@pytest.mark.parametrize("take_max", [True, False, "per-lane"])
def test_envelope2_matches(take_max):
    rng = np.random.default_rng(4)
    f = _random_pwl(rng, 24, 10, 6)
    g = _random_pwl(rng, 24, 10, 6)
    if take_max == "per-lane":
        tm_np = rng.random(24) < 0.5
        tm_t, tm_j = torch.tensor(tm_np), jnp.asarray(tm_np)
    else:
        tm_t = tm_j = take_max
    got, raw = TP.envelope2(pwl_from_numpy(*f), pwl_from_numpy(*g), 10, tm_t)
    if take_max == "per-lane":
        want, raw_w = jax.jit(lambda a, b, t: JP.envelope2(a, b, 10, t))(
            _jax(f), _jax(g), tm_j)
    else:
        want, raw_w = _jit(JP.envelope2, 10, tm_j)(_jax(f), _jax(g))
    _assert_pwl(got, want, raw, raw_w)


def test_envelope2_reports_raw_count_beyond_capacity():
    rng = np.random.default_rng(5)
    f = _random_pwl(rng, 16, 8, 8)
    g = _random_pwl(rng, 16, 8, 8)
    got, raw = TP.envelope2(pwl_from_numpy(*f), pwl_from_numpy(*g), 3, True)
    want, raw_w = _jit(JP.envelope2, 3, True)(_jax(f), _jax(g))
    _assert_pwl(got, want, raw, raw_w)
    assert (raw.numpy() > 3).any()          # truncation happened and shows


def test_cone_infconv_matches():
    rng = np.random.default_rng(6)
    f = _random_pwl(rng, 24, 10, 7)
    s = rng.uniform(50, 150, 24)
    k = rng.uniform(0.0, 0.05, 24)
    a, b = (1 + k) * s, (1 - k) * s
    got, raw = TP.cone_infconv(pwl_from_numpy(*f), torch.tensor(a),
                               torch.tensor(b), 10)
    want, raw_w = _jit(JP.cone_infconv, 10)(_jax(f), jnp.asarray(a),
                                            jnp.asarray(b))
    _assert_pwl(got, want, raw, raw_w)


def test_eval_at_and_scale_match():
    rng = np.random.default_rng(7)
    f = _random_pwl(rng, 12, 8, 6)
    c = rng.uniform(-15, 25, 12)
    got = TP.eval_at(pwl_from_numpy(*f), torch.tensor(c)).numpy()
    want = np.asarray(jax.jit(JP.eval_at)(_jax(f), jnp.asarray(c)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    alpha = rng.uniform(0.5, 2.0, 12)
    _assert_pwl(TP.scale(pwl_from_numpy(*f), torch.tensor(alpha)),
                JP.scale(_jax(f), jnp.asarray(alpha)))


def test_algebra_is_sort_free():
    """The port, like the JAX package, never calls a sort."""
    import inspect
    src = inspect.getsource(TP)
    for banned in ("torch.sort", "argsort", ".sort("):
        assert banned not in src, banned
