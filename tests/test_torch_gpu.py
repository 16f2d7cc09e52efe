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
flash attention is held to.  TF32 is off for the
comparisons (and restored after them).
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.rz import leaf_level, rz_level_step_lanes, rz_params
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import binomial_step as TB
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


def _rz_state(n_steps, capacity, lanes, walk, device, pay=BULL):
    t = lambda *x: torch.tensor(x, dtype=torch.float64, device=device)
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


def test_flash_kernel_refuses_what_it_cannot_run(cuda):
    q = torch.zeros(1, 8, 2, 16, device=cuda)
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
    want, _ = TT.prefill(cpu_model, {"tokens": toks}, cfg, TT.RunCfg())
    got, _ = TT.prefill(card_model, {"tokens": toks.to(no_tf32)}, cfg,
                        TT.RunCfg())
    assert TF.LAUNCHES["flash_attention"] == n_fa + 2
    assert TL.LAUNCHES["lru_scan"] == n_ls + 6
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
