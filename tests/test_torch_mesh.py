"""Port parity: the mesh slice's logic that needs no ranks, against the
JAX package.

* ``launch/elastic.py``: the topology catalogue, ``pick_topology`` for
  every count from 0 to 600, ``rescale_batch`` (and its rejection: JAX
  asserts, the port raises ``ValueError`` with the same message), the
  straggler policy's verdicts and evictions on one series of step
  times; ``pick_mesh`` raises, naming both counts, without the picked
  world size.
* ``MeshRules.spec`` for every parameter of all ten archs at their
  published sizes on meshes (1, 1), (2, 2), (16, 16) and (2, 16, 16)
  (shape-only meshes: ``MeshShape``; JAX's rules on an object with the
  same ``shape``), the divisibility fallbacks included; the port's
  ``lm_specs`` equal to JAX's ``init_lm(...)[1]`` (taken while
  ``jax.eval_shape`` traces it at full size) and ``state_specs`` equal
  to JAX's.
* ``split_stages``' shapes and its rejection of an uneven split (JAX's
  ``test_pipeline.py`` configs).
* ``logical`` returns its tensor and checks the axes; the rank-only
  parts refuse a ``MeshShape`` and a missing process group; ring
  attention refuses grad mode; ``make_test_mesh`` (the node axis) is
  unchanged.
"""
import dataclasses
import types

import jax
import pytest
import torch

import repro.core  # noqa: F401
from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.configs import reduced_config as j_reduced_config
from repro.launch import elastic as JE
from repro.models.sharding import MeshRules as JMeshRules
from repro.models.transformer import init_lm as j_init_lm
from repro.train.pipeline import split_stages as j_split_stages
from repro.train.step import state_specs as j_state_specs

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.convert import lm_named_to_jax
from repro_torch.launch import elastic as E
from repro_torch.launch.mesh import (make_production_mesh, make_test_mesh,
                                     mesh_rules, production_shape)
from repro_torch.models.context_parallel import ring_attention_local
from repro_torch.models.sharding import MeshShape, logical
from repro_torch.models.transformer import LM
from repro_torch.train.pipeline import split_stages
from repro_torch.train.step import lm_specs, state_specs

MESHES = (((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))


def test_topology_catalogue_and_pick_match_jax():
    assert E.TOPOLOGY_CATALOGUE == JE.TOPOLOGY_CATALOGUE
    for n in range(1, 601):
        assert E.pick_topology(n) == JE.pick_topology(n), n
    for mod in (E, JE):
        with pytest.raises(RuntimeError, match="no catalogued topology"):
            mod.pick_topology(0)


def test_rescale_batch_matches_jax():
    for args in ((8, 128, 1), (256, 4096, 16), (512, 8192, 4),
                 (64, 1 << 17, 2), (4, 1 << 20, 1)):
        assert E.rescale_batch(*args) == JE.rescale_batch(*args), args
    with pytest.raises(AssertionError) as want:
        JE.rescale_batch(10, 128, 4)
    with pytest.raises(ValueError) as got:
        E.rescale_batch(10, 128, 4)
    assert str(got.value) == str(want.value)


def test_straggler_policy_matches_jax():
    times = [1, 1, 5, 5, 1, 5, 5, 5, 5, 5, 5, 1, 4, 9, 9, 9, 2]
    seen = {}
    verdicts = {}
    for name, mod in (("jax", JE), ("port", E)):
        evicted = seen.setdefault(name, [])
        pol = mod.StragglerPolicy(on_evict=evicted.append)
        verdicts[name] = [pol.observe(i, dt, 1.0) for i, dt in
                          enumerate(times)]
    assert verdicts["port"] == verdicts["jax"]
    assert seen["port"] == seen["jax"] and seen["port"]
    assert "tolerate" in verdicts["port"]


def test_pick_mesh_refuses_another_world_size():
    with pytest.raises(RuntimeError, match=r"pick the \(2, 2\) mesh of 4 "
                       r"ranks, but the process group has 0"):
        E.pick_mesh(5, device="cpu")
    with pytest.raises(RuntimeError, match=r"needs 256 ranks; the process "
                       r"group has 0"):
        make_production_mesh(device="cpu")


@pytest.fixture(scope="module")
def arch_specs():
    """For each arch at its published size: JAX's spec tree and leaf
    shapes (``init_lm`` traced by ``jax.eval_shape``), and the port's
    (``lm_specs``, the shapes of a model on the meta device)."""
    out = {}
    key = jax.random.PRNGKey(0)
    for arch in list_archs():
        box = {}

        def init(k, arch=arch):
            params, box["specs"] = j_init_lm(k, j_get_config(arch))
            return params
        shapes = jax.eval_shape(init, key)
        cfg = get_config(arch)
        meta = {k: p for k, p in LM(cfg, device="meta").named_parameters()}
        out[arch] = dict(
            jax_specs=box["specs"],
            jax_shapes=jax.tree.map(lambda s: tuple(s.shape), shapes),
            specs=lm_specs(cfg),
            shapes=lm_named_to_jax({k: tuple(p.shape) for k, p in
                                    meta.items()}, cfg,
                                   stack=lambda s: (len(s),) + s[0]))
    return out


def _leaves(tree, prefix=""):
    for key, val in sorted(tree.items()):
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}/")
        else:
            yield prefix + key, val


def test_lm_specs_and_shapes_match_jax(arch_specs):
    assert list(list_archs()) == list(j_list_archs())
    for arch, d in arch_specs.items():
        assert d["specs"] == d["jax_specs"], arch
        assert d["shapes"] == d["jax_shapes"], arch


@pytest.mark.parametrize("sizes,axes", MESHES)
def test_mesh_rules_spec_matches_jax_for_every_parameter(arch_specs, sizes,
                                                         axes):
    shape = MeshShape(sizes, axes)
    rules = mesh_rules(shape)
    fake = types.SimpleNamespace(shape=dict(zip(axes, sizes)))
    jrules = JMeshRules(mesh=fake, fsdp=rules.fsdp, tp=rules.tp)
    for arch, d in arch_specs.items():
        shapes = dict(_leaves(d["shapes"]))
        for path, spec in _leaves(d["specs"]):
            shp = shapes[path]
            assert rules.spec(*spec, shape=shp) == tuple(
                jrules.spec(*spec, shape=shp)), (arch, path)
            assert rules.spec(*spec) == tuple(jrules.spec(*spec))
        # activations: (batch, seq, heads, head dim) of the queries and
        # the KV heads, where the head counts may not divide tp
        cfg = get_config(arch)
        for heads in (cfg.n_heads, cfg.n_kv_heads):
            act = (32, 4096, heads, cfg.resolved_head_dim)
            got = rules.spec("dp", None, "tp", None, shape=act)
            assert got == tuple(jrules.spec("dp", None, "tp", None,
                                            shape=act)), (arch, heads)
            assert (got[2] is None) == (heads % sizes[-1] != 0)
    assert rules.dp == jrules.dp and \
        rules.axis_size(rules.tp) == jrules.axis_size(jrules.tp)
    if sizes[-1] == 16:
        # recurrentgemma's 10 query heads fall back to replication
        rg = get_config("recurrentgemma-2b")
        assert rules.spec("dp", None, "tp", None,
                          shape=(32, 4096, rg.n_heads, 256))[2] is None


def test_state_specs_match_jax(arch_specs):
    d = arch_specs["dbrx-132b"]
    for master in (False, True):
        got = state_specs(d["specs"], master_fp32=master)
        want = j_state_specs(d["jax_specs"], master_fp32=master)
        assert got.params == want.params
        assert tuple(got.opt) == tuple(want.opt)


def test_split_stages_matches_jax():
    key = jax.random.PRNGKey(0)

    def j_split(jcfg, stages):
        return jax.eval_shape(lambda k: j_split_stages(
            j_init_lm(k, jcfg)[0], jcfg, stages), key)
    for n_layers, stages in ((4, 2), (4, 4), (4, 1)):
        jcfg = dataclasses.replace(
            j_reduced_config(j_get_config("qwen3-0.6b")), n_layers=n_layers)
        cfg = dataclasses.replace(reduced_config(get_config("qwen3-0.6b")),
                                  n_layers=n_layers)
        leaf = jax.tree.leaves(j_split(jcfg, stages)["stages"])[0]
        model = LM(cfg, device="meta")
        got = split_stages(model, cfg, stages)
        pat = len(cfg.block_pattern)
        assert (len(got), len(got[0]) // pat) == leaf.shape[:2]
        assert [b for grp in got for b in grp] == list(model.blocks)
    for arch, n_layers in (("qwen3-0.6b", 3), ("seamless-m4t-medium", 2)):
        jcfg = dataclasses.replace(j_reduced_config(j_get_config(arch)),
                                   n_layers=n_layers)
        cfg = dataclasses.replace(reduced_config(get_config(arch)),
                                  n_layers=n_layers)
        with pytest.raises(ValueError) as want:
            j_split(jcfg, 2)
        with pytest.raises(ValueError) as got:
            split_stages(LM(cfg, device="meta"), cfg, 2)
        assert str(got.value) == str(want.value)


def test_logical_checks_and_returns_its_tensor():
    rules = mesh_rules(MeshShape((2, 2), ("data", "model")))
    x = torch.zeros(4, 3, 8)
    assert logical(x, rules, "dp", None, "tp") is x
    with pytest.raises(ValueError, match="do not fit"):
        logical(x, rules, "dp", None)
    with pytest.raises(ValueError, match="do not fit"):
        logical(x, rules, "dp", None, "pod")


def test_rank_parts_refuse_a_shape_only_mesh():
    rules = mesh_rules(MeshShape((2, 2), ("data", "model")))
    with pytest.raises(TypeError, match="no ranks"):
        rules.expert_slice(4)
    with pytest.raises(TypeError, match="no ranks"):
        rules.dp_slice(8)
    # one tp rank, or experts that do not divide: every rank holds all
    assert mesh_rules(MeshShape((2, 1), ("data", "model"))
                      ).expert_slice(4) is None
    assert rules.expert_slice(3) is None
    with pytest.raises(ValueError, match="must divide"):
        rules.dp_slice(3)
    assert production_shape() == ((16, 16), ("data", "model"))
    assert production_shape(multi_pod=True) == ((2, 16, 16),
                                                ("pod", "data", "model"))
    assert mesh_rules(MeshShape(*production_shape(multi_pod=True))).fsdp == \
        ("pod", "data")


def test_ring_attention_refuses_grad_mode():
    q = torch.zeros(1, 4, 1, 1, 8, requires_grad=True)
    k = torch.zeros(1, 4, 1, 8)
    with pytest.raises(NotImplementedError, match="no backward"):
        ring_attention_local(q, k, k, None, "model")


def test_node_axis_test_mesh_is_unchanged():
    mesh = make_test_mesh(1, 2, kind="cpu", repeat=True)
    assert mesh.shape == {"data": 1, "model": 2}
    assert all(d == torch.device("cpu") for d in mesh.devices.ravel())
