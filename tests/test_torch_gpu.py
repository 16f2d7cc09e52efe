"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Marked ``gpu``: every test skips with a reason where
``torch.cuda.is_available()`` is False (decided inside a fixture, never
at import).  The module imports neither JAX nor the JAX package, so on a
machine without them it runs as

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerance: the pricing kernels repeat their plain versions' float64
arithmetic operation for operation (no fused multiply-add): the lattice
kernel agrees bit for bit, ``rz_round`` to 1e-9 with knot counts
exactly.  ``lru_scan`` rounds as its plain
version does and agrees bit for bit; ``flash_attention`` multiplies in
split TF32 on the tensor cores and sums in another order than its plain
version's matrix products, and is held to 2e-5, the bound JAX's own
flash attention is held to; against its arithmetic mirror
(``flash_attention_mirror``) it is held to the float32 contract's 2e-6.
The pricing kernels' float32 instances are held to their float32 plain
versions: the lattice kernels bit for bit (NaN for NaN), ``rz_round``
in function values within the registry's 1e-4 (``kernels/contracts.py``;
float32 knot counts are not required to match).  TF32 is off for the
comparisons (and restored after them).  The scan's backward kernel
rounds as ``lru_scan_backward_plain`` does and agrees bit for bit; a
train step on the card is held to the same step on the CPU (the loss
within 1e-5 relative, each gradient within 1e-4 of its leaf's largest
value).
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.rz import leaf_level, rz_level_step_lanes, rz_params
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import pwl as P
from repro_torch.kernels import binomial_step as TB
from repro_torch.kernels.contracts import CONTRACTS
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import lru_scan as TL
from repro_torch.kernels import rz_step as TR
from repro_torch.models import transformer as TT

TOL = 1e-9

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.fixture
def no_tf32(cuda):
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _lattice_inputs(kind, rows, P, device, lvl0=None):
    rng = np.random.default_rng(4)
    v = torch.tensor(rng.uniform(0.0, 30.0, (rows, P)), device=device)
    u = rng.uniform(0.0, 1.0, rows)
    lvl0 = [P - 100.0] * rows if lvl0 is None else lvl0
    if kind == "param":
        fam = [(1.0, -1.0, 0.0, 0.0), (-1.0, 1.0, 0.0, 0.0),
               (0.0, 0.0, 1.0, -1.0)]
        sc = [[lvl0[i], 0.5, 0.99998, 90 + 20 * x, 0.0026, *fam[i % 3],
               95.0 + x, 105.0 + x] for i, x in enumerate(u)]
    else:
        sc = [[lvl0[i], 0.5, 0.99998, 95 + 10 * x, 90 + 20 * x, 0.0026]
              for i, x in enumerate(u)]
    return v, torch.tensor(sc, dtype=torch.float64, device=device)


# (kind, rows, P, levels, block, lvl0 of each row or None for P - 100)
LATTICE_CASES = {
    "main-param": ("param", 4, 40192, 50, 256, None),
    "main-put": ("put", 4, 40192, 50, 256, None),
    "main-call": ("call", 4, 40192, 50, 256, None),
    "final-short-round": ("param", 4, 40192, 50, 256, [30.0, 1.0, 0.0, 49.0]),
    "mixed-lvl0": ("param", 4, 40192, 50, 256, [40000.0, 7.0, 50.0, 100.0]),
    "levels-eq-block": ("param", 8, 4096, 256, 256, None),
    "block32": ("param", 8, 4096, 32, 32, None),
    "block1024": ("param", 64, 4096, 1024, 1024, None),
    "single-block": ("put", 3, 256, 50, 256, [255.0, 40.0, 256.0]),
}


@pytest.mark.parametrize("case", list(LATTICE_CASES))
def test_lattice_kernel_matches_plain(cuda, case):
    """The kernel repeats the plain version's operations for every owned
    lane in the same order, so the two agree bit for bit."""
    kind, rows, P, levels, block, lvl0 = LATTICE_CASES[case]
    v, sc = _lattice_inputs(kind, rows, P, cuda, lvl0)
    fn = TB.lattice_round_param if kind == "param" else TB.lattice_round
    kw = {} if kind == "param" else {"kind": kind}
    n0 = sum(TB.LAUNCHES.values())
    got = fn(v, sc, levels=levels, block=block, **kw)
    torch.cuda.synchronize()
    assert sum(TB.LAUNCHES.values()) == n0 + 1
    want = TB.lattice_round_plain(v, sc, levels=levels, block=block, kind=kind)
    assert torch.equal(got, want)


PUT = (1.0, 0.0, -1.0, 0.0, 100.0, 100.0)
CALL = (-1.0, 1.0, 0.0, 0.0, 100.0, 110.0)
BULL = (0.0, 0.0, 1.0, -1.0, 95.0, 105.0)


def _rz_state(n_steps, capacity, lanes, walk, device, pay=BULL,
              dtype=torch.float64):
    t = lambda *x: torch.tensor(x, dtype=dtype, device=device)
    params = rz_params(t(100.0, 96.0), t(0.2, 0.25), t(0.1, 0.1),
                       t(0.25, 0.25), t(0.01, 0.005), n_steps=n_steps)
    z = leaf_level(n_steps, params, capacity, lanes).map(
        lambda a: a[:, None].expand((2, 2) + a.shape[1:]).contiguous())
    col = {k: v[:, None, None] for k, v in params.items()}
    payc = tuple(t(p) for p in pay)
    sides = torch.tensor([[True], [False]], device=device)
    for j in range(walk):
        z, _ = rz_level_step_lanes(z, float(n_steps - j), col, payc,
                                   capacity=capacity, seller=sides)
    sc = torch.stack([t(n_steps + 1.0 - walk, n_steps + 1.0 - walk),
                      params["s0"], params["sig_sqrt_dt"], params["r"],
                      params["k"], *(t(p, p) for p in pay)], dim=1)
    return z, sc


# (n_steps, capacity, lanes, block, levels, walk, payoff): the main
# path's round shapes, the tile schedule's edges, capacities 16 and 128,
# and calls whose lanes hold more knots than a record keeps inline
RZ_CASES = {
    "single-block": (300, 48, 302, 302, 64, 20, BULL),
    "halo": (300, 48, 384, 128, 64, 20, BULL),
    "lanes-not-a-multiple-of-tile": (300, 48, 301, 301, 8, 10, BULL),
    "lanes-below-tile": (40, 48, 42, 42, 8, 0, PUT),
    "levels-eq-lvl0": (40, 48, 42, 42, 41, 0, BULL),
    "levels-eq-lvl0-two-launches": (300, 48, 302, 302, 301, 0, PUT),
    "levels-1": (300, 48, 302, 302, 1, 20, BULL),
    "single-block-wrap": (40, 48, 24, 24, 10, 0, BULL),
    "halo-last-block": (40, 48, 48, 12, 8, 2, BULL),
    "halo-two-launches": (600, 16, 768, 256, 200, 0, PUT),
    "capacity-16": (300, 16, 302, 302, 64, 20, PUT),
    "capacity-128": (300, 128, 302, 302, 64, 20, BULL),
    "call-wide-lanes": (120, 48, 122, 122, 57, 64, CALL),
}


@pytest.mark.parametrize("case", list(RZ_CASES))
def test_rz_kernel_matches_plain(cuda, case):
    n, K, lanes, block, levels, walk, pay = RZ_CASES[case]
    z, sc = _rz_state(n, K, lanes, walk, cuda, pay)
    n0 = TR.LAUNCHES["rz_round"]
    got, pieces = TR.rz_round(z, sc, levels=levels, block=block)
    torch.cuda.synchronize()
    assert TR.LAUNCHES["rz_round"] == n0 + -(-levels // TR.LEVELS_PER_LAUNCH)
    want, wp = TR.rz_round_plain(z, sc, levels=levels, block=block)
    assert torch.equal(got.m, want.m)
    assert torch.equal(pieces, wp)
    for a, b in zip(got[:4], want[:4]):
        assert (a - b).abs().max().item() <= TOL
    if case == "call-wide-lanes":
        assert int(z.m.max()) > TR.INLINE_KNOTS


# (n_steps, capacity, lanes, levels, lane0, owned, walk, payoff): a
# node-axis shard's [S owned | H halo] buffer at tree column lane0, the
# last shard's (its halo beyond the tree), and two launches' worth of
# levels
RZ_LANE0_CASES = {
    "shard-1-of-4": (300, 48, 81, 5, 76, 76, 0, PUT),
    "last-shard": (300, 48, 81, 5, 228, 76, 20, BULL),
    "call-wide-lanes-two-launches": (120, 48, 100, 200, 20, 60, 64, CALL),
}


@pytest.mark.parametrize("case", list(RZ_LANE0_CASES))
def test_rz_kernel_with_lane0_and_owned_matches_plain(cuda, case):
    n, K, lanes, levels, lane0, owned, walk, pay = RZ_LANE0_CASES[case]
    z, sc = _rz_state(n, K, n + 2, walk, cuda, pay)
    z = z.map(lambda a: torch.cat([a, a], dim=2)[:, :, lane0:lane0 + lanes]
              .contiguous())
    kw = dict(levels=levels, block=lanes, lane0=lane0, owned=owned)
    got, pieces = TR.rz_round(z, sc, **kw)
    want, wp = TR.rz_round_plain(z, sc, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.m, want.m)
    assert torch.equal(pieces, wp)
    for a, b in zip(got[:4], want[:4]):
        assert (a - b).abs().max().item() <= TOL


@pytest.mark.parametrize("kind,lane0,P,block,levels", [
    ("put", 10001, 10240, 256, 50), ("call", 77, 512, 64, 40),
    ("param", 300, 1024, 256, 256)])
def test_lattice_kernel_with_lane0_matches_plain(cuda, kind, lane0, P, block,
                                                 levels):
    v, sc = _lattice_inputs(kind, 4, P, cuda, [P + lane0 - 10.0, 30.0,
                                                 lane0 + 5.0, 2.0 * P])
    fn = TB.lattice_round_param if kind == "param" else TB.lattice_round
    kw = {} if kind == "param" else {"kind": kind}
    got = fn(v, sc, levels=levels, block=block, lane0=lane0, **kw)
    want = TB.lattice_round_plain(v, sc, levels=levels, block=block,
                                  kind=kind, lane0=lane0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("sides", [(True,), (False, True, True)])
def test_rz_kernel_takes_any_number_of_sides(cuda, sides):
    """A CTA holds two sides; one side, or three in two launches, give
    the plain version's result."""
    z, sc = _rz_state(40, 16, 42, 0, cuda)
    z = z.map(lambda a: torch.cat([a, a[:, :1]], dim=1)[:, :len(sides)]
              .contiguous())
    n0 = TR.LAUNCHES["rz_round"]
    got, pieces = TR.rz_round(z, sc, levels=8, block=42, sellers=sides)
    torch.cuda.synchronize()
    assert TR.LAUNCHES["rz_round"] == n0 + -(-len(sides) // 2)
    want, wp = TR.rz_round_plain(z, sc, levels=8, block=42, sellers=sides)
    assert torch.equal(got.m, want.m)
    assert torch.equal(pieces, wp)
    for a, b in zip(got[:4], want[:4]):
        assert (a - b).abs().max().item() <= TOL


def test_grids_on_card_match_the_plain_walks(cuda):
    from repro_torch.kernels import binomial_step, rz_step
    g = api.ScenarioGrid.cartesian(
        s0=(95.0, 105.0), sigma=(0.15, 0.25), cost_rate=(0.0, 0.005, 0.01),
        payoff=("put", "call", "bull_spread"), strike=(95.0, 100.0, 105.0),
        n_steps=10)
    n_rz = rz_step.LAUNCHES["rz_round"]
    n_lat = binomial_step.LAUNCHES["lattice_round_param"]
    tc = api.price_grid(g, capacity=16)
    nt = api.price_grid(g, levels=4, block=16,
                        execution=api.ExecutionConfig(engine="notc"))
    assert rz_step.LAUNCHES["rz_round"] > n_rz
    assert binomial_step.LAUNCHES["lattice_round_param"] > n_lat
    plain = api.ExecutionConfig(backend="torch")
    tc_ref = api.price_grid(g, capacity=16, execution=plain)
    np.testing.assert_allclose(tc.ask, tc_ref.ask, rtol=0, atol=TOL)
    np.testing.assert_allclose(tc.bid, tc_ref.bid, rtol=0, atol=TOL)
    np.testing.assert_array_equal(tc.row_pieces, tc_ref.row_pieces)
    nt_ref = api.price_grid(g, execution=api.ExecutionConfig(
        engine="notc", backend="torch"))
    np.testing.assert_allclose(nt.ask, nt_ref.ask, rtol=0, atol=TOL)


@pytest.mark.parametrize("engine", ["rz", "notc", "lsmc"])
def test_layouts_bit_equal_on_card(cuda, engine):
    """Rows are independent on the card too: ``devices=4`` (simulated on
    fewer cards) and ``mesh=(cuda:0,) * 4`` (the real per-shard dispatch)
    give the single-device call's bits, the padded grid's first rows
    included; the LSMC standard errors are finite and positive."""
    kw = dict(s0=(90.0, 97.0, 103.0, 110.0), sigma=(0.2, 0.3),
              payoff=("put", "call"), strike=100.0, n_steps=12)
    if engine == "rz":
        kw["cost_rate"] = (0.005, 0.01)
    if engine == "lsmc":
        kw.update(n_assets=2, exercise_steps=(0, 4, 8, 12))
    grid = api.ScenarioGrid.cartesian(**kw)
    run = lambda g, **k: api.price_grid(
        g, capacity=16, levels=4 if engine == "notc" else None,
        block=16 if engine == "notc" else None, mesh=k.pop("mesh", None),
        execution=api.ExecutionConfig(engine=engine, n_paths=2048, **k))
    one = run(grid)
    fields = ("ask", "bid", "row_pieces") + (
        ("stderr",) if engine == "lsmc" else ())
    for label, got in (("devices=4", run(grid, devices=4)),
                       ("mesh", run(grid, mesh=(cuda,) * 4)),
                       ("pad_to", run(grid.pad_to(grid.n_scenarios + 5)))):
        for f in fields:
            a, b = getattr(one, f).ravel(), getattr(got, f).ravel()
            assert np.array_equal(a, b[:a.size]), (label, f)
    if engine == "lsmc":
        assert np.isfinite(one.stderr).all() and (one.stderr > 0).all()


@pytest.mark.parametrize("engine", ["rz", "notc"])
def test_node_axis_on_card_equals_one_shard(cuda, engine):
    """The node axis on (cuda:0,) * 4 and, where the machine has more
    than one card, on distinct cards (halos by peer copies) gives the
    bits of one shard, with halo rounds on every mesh."""
    from repro_torch.core.distributed import (DeviceMesh, build_notc_sharded,
                                              build_rz_sharded)
    from repro_torch.core.payoff import american_put
    s0 = np.linspace(90.0, 110.0, 8)
    col = lambda x: np.full(8, x)

    def run(devs):
        mesh = DeviceMesh([devs], ("data", "model"))
        if engine == "rz":
            f = build_rz_sharded(mesh, n_steps=300, payoff=american_put(100.0),
                                 round_depth=5, collapse_lanes=40)
            return f(s0, col(0.2), col(0.1), col(0.25), col(0.005))
        f = build_notc_sharded(mesh, n_steps=3000, strike=100.0,
                               round_depth=50, collapse_lanes=200)
        return (f(s0, col(0.3), col(0.06), col(3.0)),)

    one = run([cuda])
    meshes = [[cuda] * 4]
    n = torch.cuda.device_count()
    if n > 1:
        meshes.append([torch.device("cuda", i) for i in range(min(n, 4))])
    for devs in meshes:
        got = run(devs)
        for a, b in zip(one, got):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b), devs


@pytest.mark.parametrize("B,T,W", [(2, 77, 2560), (3, 256, 100),
                                   (1, 300, 2560), (2, 20, 77),
                                   (1, 1, 33)])
def test_lru_scan_kernel_matches_plain(cuda, B, T, W):
    """T = 77 and 300 leave a ragged last chunk of the kernel's 32-step
    ring; T = 20 and 1 are shorter than one chunk; W = 100, 77 and 33
    leave a ragged last warp of channels (77 and 33 rows that are not
    16-byte aligned); B = 1 is a single batch row."""
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.rand(B, T, W, generator=g, device=cuda)
    b = torch.randn(B, T, W, generator=g, device=cuda)
    h0 = torch.randn(B, W, generator=g, device=cuda)
    n0 = TL.LAUNCHES["lru_scan"]
    got_seq, got_last = TL.lru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert TL.LAUNCHES["lru_scan"] == n0 + 1
    want_seq, want_last = TL.lru_scan_plain(a, b, h0)
    assert torch.equal(got_seq, want_seq) and torch.equal(got_last, want_last)


def test_lru_scan_kernel_at_the_mamba_width(cuda):
    """falcon-mamba-7b's scan width, W = di * ds = 8192 * 16 = 131072
    channels (4096 one-warp blocks a batch row), at a short T with a
    ragged last ring chunk and slow decay, so the carry matters."""
    g = torch.Generator(device=cuda).manual_seed(6)
    B, T, W = 2, 45, 8192 * 16
    a = 0.9 + 0.1 * torch.rand(B, T, W, generator=g, device=cuda)
    b = torch.randn(B, T, W, generator=g, device=cuda)
    h0 = torch.randn(B, W, generator=g, device=cuda)
    got_seq, got_last = TL.lru_scan(a, b, h0)
    torch.cuda.synchronize()
    want_seq, want_last = TL.lru_scan_plain(a, b, h0)
    assert torch.equal(got_seq, want_seq) and torch.equal(got_last, want_last)
    assert (want_seq - b).abs().max().item() > 1.0


def test_flash_kernel_causal_gqa_at_hd128_ragged(no_tf32):
    """The dense archs' attention: causal, no window, head_dim 128, G = 4
    query heads a KV head (qwen3-4b's 32 / 8), T = 517, which leaves the
    kernel's last 64-row q tile and 32-key KV tile ragged and skips the
    KV tiles above the diagonal."""
    g = torch.Generator(device=no_tf32).manual_seed(128)
    B, T, KVH, G, hd = 1, 517, 8, 4, 128
    q = torch.randn(B, T, KVH * G, hd, generator=g, device=no_tf32)
    k = torch.randn(B, T, KVH, hd, generator=g, device=no_tf32)
    v = torch.randn(B, T, KVH, hd, generator=g, device=no_tf32)
    got = TF.flash_attention(q, k, v, causal=True, window=None)
    torch.cuda.synchronize()
    want = TF.flash_attention_plain(q, k, v, causal=True, window=None,
                                    q_chunk=100, kv_chunk=64)
    assert (got - want).abs().max().item() <= 2e-5


@pytest.mark.parametrize("hd,G", [(64, 1), (64, 4), (128, 2), (256, 10)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 100),
                                           (False, None), (False, 100)],
                         ids=["causal", "window", "bidirectional",
                              "bidirectional-window"])
def test_flash_kernel_matches_plain(no_tf32, hd, G, causal, window):
    """T = 200 and S = 200 leave the kernel's last 64-row and last KV
    tiles ragged; the split-TF32 products hold the float32 contract."""
    g = torch.Generator(device=no_tf32).manual_seed(hd + G)
    B, T, KVH = 2, 200, 2
    q = torch.randn(B, T, KVH * G, hd, generator=g, device=no_tf32)
    k = torch.randn(B, T, KVH, hd, generator=g, device=no_tf32)
    v = torch.randn(B, T, KVH, hd, generator=g, device=no_tf32)
    n0 = TF.LAUNCHES["flash_attention"]
    got = TF.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert TF.LAUNCHES["flash_attention"] == n0 + 1
    want = TF.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    q_chunk=64, kv_chunk=48)
    assert (got - want).abs().max().item() <= 2e-5


@pytest.mark.parametrize("B,T,W", [(2, 1024, 2560), (1, 300, 2560),
                                   (2, 20, 77), (1, 1, 33)])
def test_lru_scan_backward_kernel_matches_plain(cuda, B, T, W):
    """The reverse recurrence at the training shape (batch 2 x 1024,
    recurrentgemma-2b's 2560 channels) and the forward's edge cases: a
    ragged first (last in time) ring chunk, T below one chunk, W off the
    32-channel warps, one batch row.  Slow decay, nonzero h0 and
    dh_last: bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(8)
    a = 0.9 + 0.1 * torch.rand(B, T, W, generator=g, device=cuda)
    h0 = torch.randn(B, W, generator=g, device=cuda)
    h_seq = torch.randn(B, T, W, generator=g, device=cuda)
    dh_seq = torch.randn(B, T, W, generator=g, device=cuda)
    dh_last = torch.randn(B, W, generator=g, device=cuda)
    n0 = TL.LAUNCHES["lru_scan_backward"]
    got = TL.lru_scan_backward(a, h0, h_seq, dh_seq, dh_last)
    torch.cuda.synchronize()
    assert TL.LAUNCHES["lru_scan_backward"] == n0 + 1
    want = TL.lru_scan_backward_plain(a, h0, h_seq, dh_seq, dh_last)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_lru_scan_gradient_on_card_equals_plain_autograd(cuda):
    """Autograd through ``lru_scan`` on the card (forward and backward
    kernels) against autograd through ``lru_scan_plain`` on the card."""
    g = torch.Generator(device=cuda).manual_seed(9)
    B, T, W = 2, 200, 96
    xs = [0.9 + 0.1 * torch.rand(B, T, W, generator=g, device=cuda),
          torch.randn(B, T, W, generator=g, device=cuda),
          torch.randn(B, W, generator=g, device=cuda)]
    w = torch.randn(B, T, W, generator=g, device=cuda)
    grads = []
    for fn in (TL.lru_scan, TL.lru_scan_plain):
        leaves = [x.clone().requires_grad_(True) for x in xs]
        h_seq, h_last = fn(*leaves)
        ((h_seq * w).sum() + h_last.square().sum()).backward()
        grads.append([x.grad for x in leaves])
    for x, y in zip(*grads):
        assert (x - y).abs().max().item() <= 1e-6 * max(
            y.abs().max().item(), 1.0)


def test_kernels_without_backward_refuse_grad(cuda):
    """The pricing kernels have no backward and raise on inputs that
    require grad; ``flash_attention`` has one (an autograd Function whose
    backward is the backward kernel): its output carries a ``grad_fn`` and
    its gradient holds the float64 plain version's."""
    q = torch.randn(1, 64, 2, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 64, 1, 64, device=cuda)
    out = TF.flash_attention(q, k, k)
    assert out.grad_fn is not None
    n = TF.LAUNCHES["flash_attention_backward"]
    out.square().sum().backward()
    assert TF.LAUNCHES["flash_attention_backward"] == n + 1
    o, lse = TF.flash_attention_plain(q.detach(), k, k, return_lse=True)
    want = TF.flash_attention_backward_plain(
        *(x.double() for x in (q.detach(), k, k, o, lse, 2 * o)))[0]
    assert (q.grad.double() - want).abs().max().item() <= \
        TF.BWD_F32_TOL * want.abs().max().item()
    with torch.no_grad():
        assert TF.flash_attention(q, k, k).grad_fn is None
    v = torch.zeros(1, 8, dtype=torch.float64, device=cuda,
                    requires_grad=True)
    sc = torch.tensor([[7.0, 0.5, 0.99, 1.0, 1.0, 0.1]], dtype=torch.float64,
                      device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        TB.lattice_round(v, sc, levels=2, block=8)


def test_train_step_on_card_matches_cpu(no_tf32):
    """One ``make_train_step`` step of reduced recurrentgemma-2b (3
    layers: two RG-LRU through both scan kernels, one local attention)
    on the card and on the CPU from the same weights and batch: the loss
    within 1e-5 relative, every gradient within 1e-4 of its leaf's
    largest |g|."""
    from repro_torch.data.pipeline import SyntheticSource, to_device
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step, train_state
    cfg = reduced_config(get_config("recurrentgemma-2b"), n_layers=3,
                         d_model=256, n_heads=4)
    run = TT.RunCfg(dtype=torch.float32, impl="naive")
    batch = SyntheticSource(cfg.vocab, 4, 64, n_micro=2).batch(0)
    out = {}
    for dev in ("cpu", no_tf32):
        model = TT.init_lm(cfg, torch.Generator().manual_seed(1),
                           device="cpu").to(dev)
        step = make_train_step(cfg, run, AdamWConfig())
        n = dict(TL.LAUNCHES)
        _, m = step(train_state(model), to_device(batch, dev))
        out[str(dev)] = (float(m["loss"]), {
            k: p.grad.cpu() for k, p in model.named_parameters()})
        if dev != "cpu":
            torch.cuda.synchronize()
            assert TL.LAUNCHES["lru_scan"] == n["lru_scan"] + 4
            assert TL.LAUNCHES["lru_scan_backward"] == \
                n["lru_scan_backward"] + 4
    (want, gw), (got, gg) = out["cpu"], out[str(no_tf32)]
    assert abs(got - want) <= 1e-5 * abs(want)
    for name, w in gw.items():
        assert (gg[name] - w).abs().max().item() <= 1e-4 * max(
            w.abs().max().item(), 1e-12), name


def test_flash_kernel_refuses_what_it_cannot_run(cuda):
    """Head dims up to 256 run (padded to an instance); 288 does not."""
    q = torch.zeros(1, 8, 2, 288, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        TF.flash_attention(q, q[:, :, :1], q[:, :, :1])
    q = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="live key"):
        TF.flash_attention(q, q[:, :4, :1], q[:, :4, :1], window=2)
    with pytest.raises(ValueError, match="contiguous"):
        TF.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           q[:, :, :1], q[:, :, :1])


def test_reduced_lm_on_card_matches_cpu(no_tf32):
    """8-layer reduced recurrentgemma (head_dim 64) through the kernels on
    the card against the plain versions on the CPU, same weights:
    float32 sums in other orders on two devices, 1e-4 on the logits."""
    cfg = reduced_config(get_config("recurrentgemma-2b"), n_layers=8,
                         d_model=256, n_heads=4)
    make = lambda: TT.init_lm(cfg, torch.Generator().manual_seed(1),
                              device="cpu")
    cpu_model, card_model = make(), make().to(no_tf32)
    toks = torch.randint(0, cfg.vocab, (2, 130),
                         generator=torch.Generator().manual_seed(2))
    n_fa, n_ls = TF.LAUNCHES["flash_attention"], TL.LAUNCHES["lru_scan"]
    want, _ = TT.prefill(cpu_model, {"tokens": toks}, cfg,
                         TT.RunCfg(dtype=torch.float32))
    got, _ = TT.prefill(card_model, {"tokens": toks.to(no_tf32)}, cfg,
                        TT.RunCfg(dtype=torch.float32))
    assert TF.LAUNCHES["flash_attention"] == n_fa + 2
    assert TL.LAUNCHES["lru_scan"] == n_ls + 6
    assert (got.cpu() - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "qwen3-4b"])
def test_reduced_slice_archs_on_card_match_cpu(no_tf32, arch):
    """Reduced falcon-mamba-7b (two mamba layers, scan width 256 * 2 * 8)
    and qwen3-4b (two attention layers, head_dim 128) through the kernels
    on the card against the plain versions on the CPU, same weights:
    float32 sums in other orders on two devices, 1e-4 on the logits."""
    cfg = reduced_config(get_config(arch), d_model=256, n_heads=2)
    make = lambda: TT.init_lm(cfg, torch.Generator().manual_seed(1),
                              device="cpu")
    cpu_model, card_model = make(), make().to(no_tf32)
    toks = torch.randint(0, cfg.vocab, (2, 130),
                         generator=torch.Generator().manual_seed(2))
    n_fa, n_ls = TF.LAUNCHES["flash_attention"], TL.LAUNCHES["lru_scan"]
    want, _ = TT.prefill(cpu_model, {"tokens": toks}, cfg,
                         TT.RunCfg(dtype=torch.float32))
    got, _ = TT.prefill(card_model, {"tokens": toks.to(no_tf32)}, cfg,
                        TT.RunCfg(dtype=torch.float32))
    mamba = arch == "falcon-mamba-7b"
    assert TF.LAUNCHES["flash_attention"] == n_fa + (0 if mamba else 2)
    assert TL.LAUNCHES["lru_scan"] == n_ls + (2 if mamba else 0)
    assert (got.cpu() - want).abs().max().item() <= 1e-4


# --------------------------------------------------------------------- #
# the pricing service on the card
# --------------------------------------------------------------------- #
def _service_trace():
    from repro_torch.serve.engine import PriceRequest
    rng = np.random.default_rng(7)
    fams = ("put", "call", "bull_spread")
    reqs = [PriceRequest(s0=float(rng.uniform(90, 110)), sigma=0.2, rate=0.1,
                         maturity=0.25, cost_rate=0.0,
                         payoff=fams[i % 3], strike=100.0, n_steps=64)
            for i in range(37)]
    reqs += [PriceRequest(s0=float(rng.uniform(90, 110)), sigma=0.2,
                          rate=0.1, maturity=0.25,
                          cost_rate=(0.005, 0.01)[i % 2], payoff="put",
                          strike=100.0, n_steps=64) for i in range(11)]
    return reqs


def test_service_on_card_matches_price_flat(cuda):
    """Quotes through the service's buckets equal each bucket priced in
    one ``price_flat`` call on the card (rows are independent)."""
    from repro_torch.kernels import binomial_step, rz_step
    from repro_torch.serve.scheduler import PricingService
    reqs = _service_trace()
    n_rz = rz_step.LAUNCHES["rz_round"]
    n_lat = binomial_step.LAUNCHES["lattice_round_param"]
    svc = PricingService(max_batch=16, capacity=16, default_n_steps=64)
    ids = [svc.submit(r) for r in reqs]
    svc.flush()
    assert rz_step.LAUNCHES["rz_round"] > n_rz
    assert binomial_step.LAUNCHES["lattice_round_param"] > n_lat
    for tc in (False, True):
        sel = [i for i, r in enumerate(reqs) if (r.cost_rate > 0) == tc]
        col = lambda f: np.array([getattr(reqs[i], f) for i in sel])
        want = api.price_flat(
            s0=col("s0"), sigma=col("sigma"), rate=col("rate"),
            maturity=col("maturity"), cost_rate=col("cost_rate"),
            payoff=tuple(col("payoff")), strike=col("strike"), n_steps=64,
            capacity=16)
        got = [svc.result(ids[i]) for i in sel]
        assert np.abs(np.array([q.ask for q in got]) - want.ask).max() <= TOL
        assert np.abs(np.array([q.bid for q in got]) - want.bid).max() <= TOL
        assert [q.max_pieces for q in got] == want.row_pieces.tolist()


def test_two_thread_replicas_on_one_card_equal_one(cuda):
    """Two thread replicas on cuda:0, each on its own stream, give the
    quotes of one."""
    import asyncio
    from repro_torch.serve.gateway import PricingGateway
    from repro_torch.serve.replica import LocalReplica
    reqs = _service_trace()

    async def run(n):
        async with PricingGateway(
                replicas=[LocalReplica(f"r{i}", device="cuda:0")
                          for i in range(n)],
                max_batch=8, capacity=16, default_n_steps=64) as gw:
            rids = [await gw.submit(r) for r in reqs]
            return [await gw.result(r) for r in rids], gw.metrics()

    one, _ = asyncio.run(run(1))
    two, m = asyncio.run(run(2))
    assert m["completed"] == len(reqs) and m["failed"] == 0
    assert [(q.ask, q.bid, q.max_pieces) for q in one] == \
        [(q.ask, q.bid, q.max_pieces) for q in two]


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_process_replica_on_card_answers_jax_wire(cuda, backend):
    """A spawned worker on the card prices the JAX package's wire dicts
    (``tests/_jax_wire.py``); its quotes equal the same chunks on the
    host."""
    from _jax_wire import JAX_CHUNK_WIRES
    from repro_torch.serve.core import ChunkSpec, execute_chunk
    from repro_torch.serve.procpool import ProcessReplica, warmup_chunk
    rep = ProcessReplica("p0", device="cuda", warmup=warmup_chunk())
    try:
        for wire in JAX_CHUNK_WIRES.values():
            chunk = ChunkSpec.from_wire(dict(wire, backend=backend))
            got = rep.price_chunk(chunk)
            want = execute_chunk(chunk, device="cpu")
            assert np.abs(got.ask - want.ask).max() <= TOL
            assert np.abs(got.bid - want.bid).max() <= TOL
            np.testing.assert_array_equal(got.row_pieces, want.row_pieces)
            assert got.max_pieces == want.max_pieces
        assert rep.memory()["peak_allocated"] > 0
    finally:
        rep.close()


# ---------------------------------------------------------------------- #
# the float32 instances of the pricing kernels, and flash_attention
# against its arithmetic mirror
F32 = torch.float32


@pytest.mark.parametrize("case", ["main-param", "main-put", "main-call",
                                  "final-short-round", "block32"])
def test_lattice_kernel_float32_matches_plain(cuda, case):
    """Bit for bit, NaN for NaN: at P = 40192 the float32 spots overflow
    at the far lanes, and the 4-parameter payoff's 0 * inf is NaN in the
    plain version and the kernel alike."""
    kind, rows, P_, levels, block, lvl0 = LATTICE_CASES[case]
    v, sc = _lattice_inputs(kind, rows, P_, cuda, lvl0)
    v, sc = v.to(F32), sc.to(F32)
    fn = TB.lattice_round_param if kind == "param" else TB.lattice_round
    key = ("lattice_round_param" if kind == "param" else "lattice_round") \
        + ".float32"
    kw = {} if kind == "param" else {"kind": kind}
    n0 = TB.LAUNCHES[key]
    got = fn(v, sc, levels=levels, block=block, **kw)
    torch.cuda.synchronize()
    assert TB.LAUNCHES[key] == n0 + 1 and got.dtype == F32
    want = TB.lattice_round_plain(v, sc, levels=levels, block=block, kind=kind)
    assert bool(((got == want) | (got.isnan() & want.isnan())).all())


def _values(z, ys):
    return P._eval1(z, ys.expand(z.sl.shape + ys.shape))


@pytest.mark.parametrize("case", ["single-block", "halo",
                                  "levels-eq-lvl0-two-launches",
                                  "capacity-16", "call-wide-lanes"])
def test_rz_kernel_float32_matches_plain(cuda, case):
    n, K, lanes, block, levels, walk, pay = RZ_CASES[case]
    z, sc = _rz_state(n, K, lanes, walk, cuda, pay, dtype=F32)
    n0 = TR.LAUNCHES["rz_round.float32"]
    got, pieces = TR.rz_round(z, sc, levels=levels, block=block)
    torch.cuda.synchronize()
    assert TR.LAUNCHES["rz_round.float32"] > n0 and got.xs.dtype == F32
    want, _ = TR.rz_round_plain(z, sc, levels=levels, block=block)
    ys = torch.linspace(-4.0, 4.0, 81, dtype=F32, device=cuda)
    err = (_values(got, ys) - _values(want, ys)).abs().max().item()
    assert err <= CONTRACTS["rz_round"].tolerance(F32)


@pytest.mark.parametrize("engine", ["rz", "notc"])
def test_node_axis_float32_on_card_equals_one_shard(cuda, engine):
    from repro_torch.core.distributed import (DeviceMesh, build_notc_sharded,
                                              build_rz_sharded)
    from repro_torch.core.payoff import american_put
    s0 = np.linspace(90.0, 110.0, 8)
    col = lambda x: np.full(8, x)
    key = "rz_round.float32" if engine == "rz" else "lattice_round.float32"
    launches = (TR if engine == "rz" else TB).LAUNCHES

    def run(devs):
        mesh = DeviceMesh([devs], ("data", "model"))
        if engine == "rz":
            f = build_rz_sharded(mesh, n_steps=300, payoff=american_put(100.0),
                                 round_depth=5, collapse_lanes=40, dtype=F32)
            return f(s0, col(0.2), col(0.1), col(0.25), col(0.005))[:2]
        f = build_notc_sharded(mesh, n_steps=3000, strike=100.0,
                               round_depth=50, collapse_lanes=200, dtype=F32)
        return (f(s0, col(0.3), col(0.06), col(3.0)),)

    n0 = launches[key]
    one = run([cuda])
    got = run([cuda] * 4)
    assert launches[key] > n0
    assert all(a.dtype == F32 and torch.equal(a, b) for a, b in zip(one, got))


def test_price_notc_kernel_defaults_to_float32_on_card(cuda):
    from repro_torch.core.lattice import LatticeModel
    from repro_torch.kernels.ops import price_notc_kernel
    m = LatticeModel(s0=100.0, sigma=0.3, rate=0.06, maturity=1.0,
                     n_steps=300)
    n0 = dict(TB.LAUNCHES)
    p = price_notc_kernel(m, 100.0, levels=50)
    assert TB.LAUNCHES["lattice_round.float32"] == \
        n0["lattice_round.float32"] + 6
    assert TB.LAUNCHES["lattice_round"] == n0["lattice_round"]
    assert p == price_notc_kernel(m, 100.0, levels=50, dtype=F32)
    p64 = price_notc_kernel(m, 100.0, levels=50, dtype=torch.float64)
    assert p != p64 and abs(p - p64) < 1e-3


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)],
                         ids=["causal", "window", "bidirectional"])
def test_flash_kernel_matches_its_mirror_to_the_contract(no_tf32, hd, causal,
                                                         window):
    """The kernel's own arithmetic (split TF32, each MMA aligned and
    truncated as the tensor cores do it, its tile walk) at T = S = 150
    (ragged last tiles), four query heads over one KV head: within the
    float32 contract's 2e-6."""
    g = torch.Generator(device=no_tf32).manual_seed(hd + int(causal))
    q = torch.randn(1, 150, 4, hd, generator=g, device=no_tf32)
    k = torch.randn(1, 150, 1, hd, generator=g, device=no_tf32)
    v = torch.randn(1, 150, 1, hd, generator=g, device=no_tf32)
    got = TF.flash_attention(q, k, v, causal=causal, window=window)
    want = TF.flash_attention_mirror(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= \
        CONTRACTS["flash_attention"].tolerance(F32)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("T,S", [(100, 230), (230, 100)])
def test_flash_kernel_cross_attention_t_ne_s(no_tf32, hd, T, S):
    """Cross attention: bidirectional, T queries over S != T keys (both
    ways), neither a multiple of the 64-row tile, five query heads a KV
    head (llama4-scout's 40 / 8): within the contract's 2e-6 of the
    mirror and 2e-5 of the plain version."""
    g = torch.Generator(device=no_tf32).manual_seed(hd + T)
    q = torch.randn(2, T, 10, hd, generator=g, device=no_tf32)
    k = torch.randn(2, S, 2, hd, generator=g, device=no_tf32)
    v = torch.randn(2, S, 2, hd, generator=g, device=no_tf32)
    got = TF.flash_attention(q, k, v, causal=False)
    mirror = TF.flash_attention_mirror(q, k, v, causal=False)
    plain = TF.flash_attention_plain(q, k, v, causal=False, q_chunk=64,
                                     kv_chunk=48)
    torch.cuda.synchronize()
    assert got.shape == q.shape
    assert (got - mirror).abs().max().item() <= \
        CONTRACTS["flash_attention"].tolerance(F32)
    assert (got - plain).abs().max().item() <= 2e-5


def test_lsmc_keys_and_uniforms_on_card_equal_the_host(cuda):
    """The threefry sampler is integer arithmetic: the card's keys and
    uniforms are the host's bit for bit; the normals differ only by the
    two devices' ``erfinv``."""
    from repro_torch.core import lsmc as LS
    keys = LS.path_keys(2 ** 40 + 3, 5)
    shape = (1000, 7, 3)
    assert torch.equal(LS.path_keys(2 ** 40 + 3, 5).to(cuda).cpu(), keys)
    assert torch.equal(LS.uniforms(keys.to(cuda), shape).cpu(),
                       LS.uniforms(keys, shape))
    z = LS.normals(keys.to(cuda), shape).cpu()
    assert torch.allclose(z, LS.normals(keys, shape), rtol=1e-12, atol=0)


@pytest.mark.parametrize("arch,flash", [("dbrx-132b", 2),
                                        ("llama4-scout-17b-a16e", 2),
                                        ("seamless-m4t-medium", 6)])
def test_reduced_moe_and_encdec_archs_on_card_match_cpu(no_tf32, arch, flash):
    """Reduced MoE archs (top-2 of 4 experts; top-1 plus the shared
    expert) and the encoder-decoder arch (2 + 2 layers, 120 encoder
    frames against 130 decoder tokens: bidirectional and cross attention
    with T != S) through the kernels on the card against the plain
    versions on the CPU, same weights: 1e-4 on the logits and the cross
    cache."""
    cfg = reduced_config(get_config(arch), d_model=256, n_heads=4)
    make = lambda: TT.init_lm(cfg, torch.Generator().manual_seed(1),
                              device="cpu")
    cpu_model, card_model = make(), make().to(no_tf32)
    gen = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 130), generator=gen)}
    if cfg.n_encoder_layers:
        batch["enc_embeds"] = torch.randn(2, 120, cfg.d_model, generator=gen)
    n_fa = TF.LAUNCHES["flash_attention"]
    run = TT.RunCfg(dtype=torch.float32)
    want, wcache = TT.prefill(cpu_model, batch, cfg, run)
    got, gcache = TT.prefill(card_model, {k: v.to(no_tf32) for k, v in
                                          batch.items()}, cfg, run)
    assert TF.LAUNCHES["flash_attention"] == n_fa + flash
    assert (got.cpu() - want).abs().max().item() <= 1e-4
    for g, w in zip(gcache, wcache):
        assert sorted(g) == sorted(w)
        for name in w:
            assert (g[name].cpu() - w[name]).abs().max().item() <= 1e-4


# --------------------------------------------------------------------- #
# bfloat16: flash_attention's bfloat16 instance, reduced LMs in bfloat16
# --------------------------------------------------------------------- #
@pytest.fixture
def bf16_sums(no_tf32):
    """bfloat16 products summed in float32 (JAX's preferred_element_type),
    restored after."""
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    yield no_tf32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag


def _bf16_kernel_holds(dev, B, T, S, H, KVH, hd, causal, window, seed):
    """The bfloat16 instance on seeded inputs against its plain version at
    JAX's bfloat16 kernel-test bound (2e-2) and against its mirror
    elementwise within the mirror's bound (one bfloat16 ulp plus its
    slack): on every row up to T = 1024, beyond that on the first batch
    row's first 128 rows and its last q tiles from 128 rows before the end
    (those walk the most KV tiles); launches counted under
    ``flash_attention.bfloat16``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev).to(
        torch.bfloat16)
    q, k, v = mk(B, T, H, hd), mk(B, S, KVH, hd), mk(B, S, KVH, hd)
    kw = dict(causal=causal, window=window)
    n = TF.LAUNCHES["flash_attention.bfloat16"]
    got = TF.flash_attention(q, k, v, **kw)
    assert TF.LAUNCHES["flash_attention.bfloat16"] == n + 1
    assert got.dtype == torch.bfloat16
    plain = TF.flash_attention_plain(q, k, v, **kw)
    assert (got.float() - plain.float()).abs().max().item() <= \
        TF.BF16_PLAIN_TOL
    del plain
    if T <= 1024:
        spans, q, k, v = [None], q, k, v
    else:
        bq = TF.KERNEL_TILES_BF16[hd][0]
        spans = [(0, 128), ((T - 128) // bq * bq, T)]
        q, k, v, got = q[:1], k[:1], v[:1], got[:1]
    for rows in spans:
        mirror, slack = TF.flash_attention_mirror(
            q, k, v, with_slack=True, rows=rows, **kw)
        mine = got if rows is None else got[:, rows[0]:rows[1]]
        d = (mine.float() - mirror.float()).abs()
        assert (d <= TF.mirror_bound_bf16(mine, mirror, slack)).all(), rows


@pytest.mark.parametrize("hd,T,S,causal,window", [
    (hd, 150, 150, c, w) for hd in (64, 128, 256)
    for c, w in ((True, None), (True, 40), (False, None))] + [
    (hd, 300, 300, True, 160) for hd in (64, 128, 256)] + [
    (64, 100, 230, False, None), (128, 230, 100, False, None),
    (128, 517, 517, True, None), (256, 2200, 2200, True, 2048)] + [
    (hd, 700, 700, True, 300) for hd in (64, 128, 256)] + [
    (128, 2400, 2400, True, 2048), (64, 100, 90, False, None),
    (256, 200, 40, False, None)])
def test_flash_bf16_kernel_matches_plain_and_mirror(bf16_sums, hd, T, S,
                                                    causal, window):
    """Small shapes, two batch rows: every head_dim; causal,
    bidirectional, T != S both ways; T off the 128-row q tile; S shorter
    than one KV tile (90 of 128 keys, 40 of 64 at hd 256), so that TMA's
    zero fill holds within each batch row; a window of 40 keys (it cuts
    every tile it touches) and ones of 300 and 2048 keys at T > window +
    2 * 128, which leave KV tiles wholly inside the window for a consumer
    warpgroup's 64 rows (the kernel takes those without a mask; a window
    of 160 keys does so at hd 256 only)."""
    _bf16_kernel_holds(bf16_sums, 2, T, S, 4, 2, hd, causal, window, hd + T)


@pytest.mark.parametrize("shape", [
    ("recurrentgemma-2b local", 4, 4096, 4096, 10, 1, 256, True, 2048),
    ("qwen3-4b", 4, 4096, 4096, 32, 8, 128, True, None),
    ("qwen2.5-14b", 4, 4096, 4096, 40, 8, 128, True, None),
    ("chameleon-34b", 1, 4096, 4096, 64, 8, 128, True, None),
    ("seamless-m4t-medium encoder", 4, 4000, 4000, 16, 16, 64, False, None),
    ("seamless-m4t-medium self", 4, 1000, 1000, 16, 16, 64, True, None),
    ("seamless-m4t-medium cross", 4, 1000, 4000, 16, 16, 64, False, None)],
    ids=lambda sh: sh[0].replace(" ", "-"))
def test_flash_bf16_kernel_at_main_path_shapes(bf16_sums, shape):
    """The shapes a full-width bfloat16 prefill of these archs gives the
    kernel (recurrentgemma-2b's rows past position 2048 walk a full
    window; qwen2.5-14b's five query heads a KV head), on seeded
    inputs."""
    _bf16_kernel_holds(bf16_sums, *shape[1:], seed=shape[2] + shape[4])


def test_flash_bf16_kernel_refuses_what_it_cannot_run(cuda):
    bf = torch.bfloat16
    q = torch.zeros(1, 8, 2, 288, device=cuda, dtype=bf)
    with pytest.raises(ValueError, match="head_dim"):
        TF.flash_attention(q, q[:, :, :1], q[:, :, :1])
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=bf)
    with pytest.raises(ValueError, match="contiguous"):
        TF.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           q[:, :, :1], q[:, :, :1])
    with pytest.raises(TypeError, match="bfloat16"):
        TF.flash_attention(q, q[:, :, :1].float(), q[:, :, :1])
    # a gradient, not a refusal: the bfloat16 backward kernel's
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(1, 8, 2, 64, generator=g, device=cuda).to(bf)
    k = torch.randn(1, 8, 1, 64, generator=g, device=cuda).to(bf)
    leaf = q.clone().requires_grad_()
    n = TF.LAUNCHES["flash_attention_backward.bfloat16"]
    TF.flash_attention(leaf, k, k).float().sum().backward()
    assert TF.LAUNCHES["flash_attention_backward.bfloat16"] == n + 1
    assert leaf.grad.dtype == bf
    o, lse = TF.flash_attention_plain(q, k, k, return_lse=True)
    want = TF.flash_attention_backward_plain(
        *(x.double() for x in (q, k, k, o, lse, torch.ones_like(o))))[0]
    assert (leaf.grad.double() - want).abs().max().item() <= \
        TF.BWD_BF16_TOL * want.abs().max().item()


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen3-4b",
                                  "seamless-m4t-medium"])
def test_reduced_lm_bf16_on_card_matches_cpu(bf16_sums, arch):
    """Reduced archs with bfloat16 weights and compute (head_dim 64: the
    bfloat16 flash kernel, windowed, causal, bidirectional and cross)
    on the card against the same on the CPU (the plain versions): the
    logits within twice the CPU's own bfloat16 distance from float32 on
    the same weights, as tests/test_torch_bf16.py holds the CPU to JAX."""
    bf = torch.bfloat16
    cfg = reduced_config(get_config(arch), n_layers=3, d_model=256,
                         n_heads=4)
    make = lambda: TT.init_lm(cfg, torch.Generator().manual_seed(1),
                              device="cpu", dtype=bf)
    cpu_model, card_model = make(), make().to(bf16_sums)
    gen = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 130), generator=gen)}
    if cfg.n_encoder_layers:
        batch["enc_embeds"] = torch.randn(2, 120, cfg.d_model, generator=gen)
    n = TF.LAUNCHES["flash_attention.bfloat16"]
    run = TT.RunCfg(dtype=bf)
    want, _ = TT.prefill(cpu_model, batch, cfg, run)
    got, cache = TT.prefill(card_model, {k: v.to(bf16_sums) for k, v in
                                         batch.items()}, cfg, run)
    assert TF.LAUNCHES["flash_attention.bfloat16"] > n
    assert all(t.dtype == (torch.float32 if name == "h" else bf)
               for c in cache for name, t in c.items())
    ref, _ = TT.prefill(cpu_model.float(), batch, cfg,
                        TT.RunCfg(dtype=torch.float32))
    own = (want - ref).abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= 2.0 * own
    # the head rounds the logits to bfloat16, as JAX's (a float32 path's
    # logits would not be bfloat16 values).  Their bits are not counted
    # here: cuBLAS's bfloat16 products sum in other orders than the
    # CPU's, and at d_model 256 the card's logits differ from the CPU's
    # in 0.73-0.87 of their bits, as many as the float32 path's do
    assert torch.equal(got, got.to(bf).float())


# --------------------------------------------------------------------- #
# flash_attention's backward kernel; head dims below the instances'
# --------------------------------------------------------------------- #
def _bwd_holds(dev, dtype, B, T, S, H, KVH, hd, causal, window, seed):
    """The backward kernel on seeded inputs, from the forward kernel's own
    ``out`` and ``lse``, against ``flash_attention_backward_plain`` taken
    in float64 from the same tensors: each gradient's max abs gap within
    ``BWD_F32_TOL`` (float32) or ``BWD_BF16_TOL`` (bfloat16) of its max
    |g|, in the input's type; one backward launch counted."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
    q, k, v = mk(B, T, H, hd), mk(B, S, KVH, hd), mk(B, S, KVH, hd)
    dout = mk(B, T, H, hd)
    kw = dict(causal=causal, window=window)
    out, lse = TF.flash_attention_with_lse(q, k, v, **kw)
    key = "flash_attention_backward" + (
        ".bfloat16" if dtype == torch.bfloat16 else "")
    n = TF.LAUNCHES[key]
    got = TF.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert TF.LAUNCHES[key] == n + 1
    want = TF.flash_attention_backward_plain(
        *(x.double() for x in (q, k, v, out, lse, dout)), **kw)
    tol = TF.BWD_BF16_TOL if dtype == torch.bfloat16 else TF.BWD_F32_TOL
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == dtype and x.shape == w.shape, name
        gap = (x.double() - w).abs().max().item()
        assert gap <= tol * w.abs().max().item(), (name, gap)


# (B, T, S, H, KVH, hd, causal, window): GQA G = 2 and 5 with ragged
# tiles, windows of 40, 70 and 160 keys, bidirectional, cross T != S both
# ways, S under one tile, T = 1 (a row of one live key has dS = 0, so
# dQ is held where rows see several), and head dims 16, 24 and 32 through
# the padding; then the walks' tile edges (BWD_TILES): T and S one below
# and one above the dK/dV key tile (64) and the dQ q tile (64 in float32,
# 128 in bfloat16), a window edge that cuts a key tile, G = 8 (a dK/dV
# block walks all eight heads), cross attention with S off the key tile
BWD_CASES = [
    (2, 150, 150, 4, 2, 64, True, None), (1, 150, 150, 4, 2, 128, True, 40),
    (2, 100, 100, 10, 2, 256, True, 70), (1, 120, 120, 4, 4, 64, False, None),
    (2, 100, 230, 4, 2, 64, False, None), (1, 230, 100, 8, 2, 128, False, None),
    (1, 300, 300, 5, 1, 256, True, 160), (2, 129, 129, 2, 1, 128, True, None),
    (1, 1, 9, 2, 1, 64, False, None), (1, 70, 70, 2, 1, 16, True, None),
    (1, 70, 70, 4, 2, 24, True, 30), (2, 90, 40, 4, 4, 32, False, None),
    (2, 63, 63, 4, 2, 128, True, None), (1, 65, 65, 4, 1, 256, True, None),
    (1, 127, 127, 4, 2, 64, True, 50), (1, 129, 129, 2, 2, 256, False, None),
    (1, 300, 300, 4, 2, 128, True, 96), (1, 200, 200, 8, 1, 128, True, None),
    (2, 128, 200, 4, 2, 64, False, None), (1, 130, 70, 2, 1, 256, False, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_backward_kernel_matches_plain(no_tf32, dtype, case):
    _bwd_holds(no_tf32, dtype, *case, seed=sum(case[:6]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("hd,causal,window", [
    (64, True, None), (128, True, 40), (256, False, None), (16, True, None)])
def test_flash_out_is_bit_equal_with_and_without_lse(no_tf32, dtype, hd,
                                                     causal, window):
    """Asking the forward kernel for ``lse`` leaves ``out`` bit for bit as
    it was; ``lse`` holds the plain version's (float32 sums in another
    order: 1e-5 of max(1, |lse|))."""
    g = torch.Generator(device=no_tf32).manual_seed(hd)
    mk = lambda *s: torch.randn(*s, generator=g, device=no_tf32).to(dtype)
    q, k, v = mk(2, 200, 4, hd), mk(2, 200, 2, hd), mk(2, 200, 2, hd)
    kw = dict(causal=causal, window=window)
    plain = TF.flash_attention(q, k, v, **kw)
    out, lse = TF.flash_attention_with_lse(q, k, v, **kw)
    _, want = TF.flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    assert lse.shape == (2, 4, 200) and lse.dtype == F32
    assert (lse - want).abs().max().item() <= 1e-5 * max(
        1.0, want.abs().max().item())


@pytest.mark.parametrize("hd", [16, 24, 32])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)],
                         ids=["causal", "window", "bidirectional"])
def test_flash_kernel_small_head_dims_match_mirror(bf16_sums, hd, causal,
                                                   window):
    """Head dims of the reduced configs, zero-padded to the 64 instance:
    the float32 kernel within the contract's 2e-6 of its mirror (which
    pads alike) and 2e-5 of the plain version; the bfloat16 kernel within
    2e-2 of the plain version and its mirror's bound."""
    g = torch.Generator(device=bf16_sums).manual_seed(hd + int(causal))
    q = torch.randn(2, 150, 4, hd, generator=g, device=bf16_sums)
    k = torch.randn(2, 150, 2, hd, generator=g, device=bf16_sums)
    v = torch.randn(2, 150, 2, hd, generator=g, device=bf16_sums)
    kw = dict(causal=causal, window=window)
    got = TF.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.shape == q.shape
    assert (got - TF.flash_attention_mirror(q, k, v, **kw)).abs().max() \
        .item() <= CONTRACTS["flash_attention"].tolerance(F32)
    assert (got - TF.flash_attention_plain(q, k, v, **kw)).abs().max() \
        .item() <= 2e-5
    _bf16_kernel_holds(bf16_sums, 2, 150, 150, 4, 2, hd, causal, window,
                       hd + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("hd,causal,window", [
    (128, True, 100), (64, True, None), (128, False, None), (256, True, 300)])
def test_flash_gradient_on_card_is_deterministic(no_tf32, dtype, hd, causal,
                                                 window):
    """Autograd through ``flash_attention`` on the card equals the direct
    calls of the forward and backward kernels, and a second run, bit for
    bit: no atomics, so training is reproducible."""
    g = torch.Generator(device=no_tf32).manual_seed(4)
    mk = lambda *s: torch.randn(*s, generator=g, device=no_tf32).to(dtype)
    q, k, v = mk(2, 333, 8, hd), mk(2, 333, 2, hd), mk(2, 333, 2, hd)
    w = mk(2, 333, 8, hd)
    kw = dict(causal=causal, window=window)
    runs = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        (TF.flash_attention(*leaves, **kw) * w).float().sum().backward()
        runs.append([x.grad for x in leaves])
    out, lse = TF.flash_attention_with_lse(q, k, v, **kw)
    direct = TF.flash_attention_backward(q, k, v, out, lse, w, **kw)
    for a, b, c in zip(runs[0], runs[1], direct):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_train_step_flash_on_card_matches_cpu(no_tf32):
    """One ``make_train_step`` step of qwen3-0.6b reduced to 3 layers
    (head dim 16: the padded instances) with ``impl="flash"`` on the card
    (the forward and backward kernels) and on the CPU (the plain
    versions), same weights and batch: the loss within 1e-5 relative,
    every gradient within 1e-4 of its leaf's largest |g|."""
    from repro_torch.data.pipeline import SyntheticSource, to_device
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step, train_state
    cfg = reduced_config(get_config("qwen3-0.6b"), n_layers=3)
    assert cfg.resolved_head_dim == 16
    run = TT.RunCfg(dtype=torch.float32, impl="flash")
    batch = SyntheticSource(cfg.vocab, 2, 100, n_micro=1).batch(0)
    out = {}
    for dev in ("cpu", no_tf32):
        model = TT.init_lm(cfg, torch.Generator().manual_seed(1),
                           device="cpu").to(dev)
        step = make_train_step(cfg, run, AdamWConfig())
        n = dict(TF.LAUNCHES)
        _, m = step(train_state(model), to_device(batch, dev))
        out[str(dev)] = (float(m["loss"]), {
            k: p.grad.cpu() for k, p in model.named_parameters()})
        if dev != "cpu":
            torch.cuda.synchronize()
            assert TF.LAUNCHES["flash_attention"] == n["flash_attention"] + 3
            assert TF.LAUNCHES["flash_attention_backward"] == \
                n["flash_attention_backward"] + 3
    (want, gw), (got, gg) = out["cpu"], out[str(no_tf32)]
    assert abs(got - want) <= 1e-5 * abs(want)
    for name, w in gw.items():
        assert (gg[name] - w).abs().max().item() <= 1e-4 * max(
            w.abs().max().item(), 1e-12), name


# --------------------------------------------------------------------- #
# the mesh slice on one card: a world-1 process group (NCCL for the card's
# tensors, gloo for the host's) and a 1 x 1 rank mesh
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def rank_rules(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks, make_rank_mesh, mesh_rules
    store = tmp_path_factory.mktemp("ranks") / "store"
    init_ranks("cuda", rank=0, world_size=1, init_method=f"file://{store}")
    yield mesh_rules(make_rank_mesh((1, 1), ("data", "model"), "cuda"))
    dist.destroy_process_group()


def test_moe_dispatch_on_card_matches_dense_and_host(no_tf32, rank_rules):
    """``moe_dispatch`` on the 1 x 1 mesh (NCCL): at capacity factor 8,
    where nothing drops, within JAX's 3e-4 of ``moe_dense`` (its
    ``test_moe_dispatch_matches_dense_on_mesh``); at the config's 1.25,
    which drops tokens here (the tokens share a common component, as a
    model's hidden states do, so most choose the same experts), within
    1e-5 of max |out| of the same call on the host (gloo)."""
    import dataclasses
    from repro_torch.models import layers as L
    cfg = reduced_config(get_config("dbrx-132b"))
    cfg8 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    p = L.MoE(cfg, device="cpu")
    p.init_(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    x = 0.3 * torch.randn(2, 64, cfg.d_model, generator=gen) + torch.randn(
        cfg.d_model, generator=gen)
    pc, xc = p.to(no_tf32), x.to(no_tf32)
    want, _ = L.moe_dense(pc, xc, cfg, torch.float32)
    got, _ = L.moe_dispatch(pc, xc, cfg8, rank_rules, torch.float32)
    assert (got - want).abs().max().item() <= 3e-4
    card, _ = L.moe_dispatch(pc, xc, cfg, rank_rules, torch.float32)
    host, _ = L.moe_dispatch(p.cpu(), x, cfg, rank_rules, torch.float32)
    assert (card.cpu() - want.cpu()).abs().max().item() > 1e-3  # drops
    assert (card.cpu() - host).abs().max().item() <= \
        1e-5 * host.abs().max().item()


@pytest.mark.parametrize("arch,impl", [("qwen3-0.6b", "flash"),
                                       ("dbrx-132b", "naive")])
def test_mesh_train_step_on_card_bit_equals_unmeshed(no_tf32, rank_rules,
                                                     arch, impl):
    """One ``make_train_step`` step on the card with the 1 x 1 mesh's rules
    and without, same weights and batch: the loss, the gradient norm,
    every gradient and parameter bit-equal (a one-rank ``all_reduce``
    and a weight of one change no bit); qwen3-0.6b reduced (head dim 16)
    through both flash kernels, dbrx-132b reduced with its MoE's
    load-balancing term reduced over the data axis (dense MoE: dispatch
    with rules computes another function, at a capacity)."""
    from repro_torch.data.pipeline import SyntheticSource, to_device
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step, train_state
    cfg = reduced_config(get_config(arch), n_layers=3)
    run = TT.RunCfg(dtype=torch.float32, impl=impl)
    batch = to_device(SyntheticSource(cfg.vocab, 2, 100, n_micro=1).batch(0),
                      no_tf32)
    out = []
    for rules in (None, rank_rules):
        model = TT.init_lm(cfg, torch.Generator().manual_seed(1),
                           device="cpu").to(no_tf32)
        _, m = make_train_step(cfg, run, AdamWConfig(), rules)(
            train_state(model), batch)
        out.append((m, dict(model.named_parameters())))
    (m0, p0), (m1, p1) = out
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    for name, p in p0.items():
        assert torch.equal(p, p1[name]) and torch.equal(p.grad,
                                                        p1[name].grad), name


def test_compressed_psum_on_card_equals_host(cuda, rank_rules):
    """``compressed_psum`` over the world-1 group on the card's tensors
    and on host copies: two calls (the residual fed back), the reduced
    gradients and residuals bit for bit."""
    from repro_torch.optim.compression import compressed_psum
    g = torch.randn(300, 70, generator=torch.Generator().manual_seed(2))
    outs = []
    for dev in (cuda, "cpu"):
        red, ef = compressed_psum({"w": g.to(dev)}, None, rank_rules.mesh,
                                  rank_rules.dp)
        red2, ef2 = compressed_psum({"w": g.to(dev)}, ef, rank_rules.mesh,
                                    rank_rules.dp)
        outs.append([t["w"].cpu() for t in (red, ef.residual, red2,
                                            ef2.residual)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_train_launcher_refuses_too_few_cards(cuda, tmp_path):
    """``launch.train`` with more ranks than the host has cards raises,
    naming both counts, rather than share a card or fall back."""
    from repro_torch.launch import train as launch_train
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"{n} ranks on device 'cuda' need "
                       f"{n} cards, one a rank; this process sees {n - 1}"):
        launch_train.main(["--arch", "qwen3-0.6b", "--reduced", "--steps",
                           "1", "--data", str(n), "--device", "cuda",
                           "--ckpt", str(tmp_path)])
