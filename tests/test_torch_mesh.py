"""The port's mesh layer against the JAX package's, with no process group:
every family's ``param_specs`` / ``cache_logical_specs`` equal the
reference's flattened specs, key for key; under ``train_rules`` and
``serve_rules`` on the (16, 16) and (2, 16, 16) production meshes the
port's ``resolve`` and ``spec_to_sharding`` give the reference's
``PartitionSpec`` for every parameter and cache entry (placements turned
back into axis entries by ``shardctx.axes_spec``); ``input_specs``,
``shape_applicable``, ``replan_mesh`` and ``degraded_batch``; and the
models keep the reference's 15 constraint sites.

Neither side needs 256 devices to resolve a spec: both take a stand-in
mesh with the reference's ``axis_names`` / ``devices`` and the port's
``mesh_dim_names`` / ``shape``, and the reference's ``NamedSharding`` is
patched to hand back its ``PartitionSpec``.
"""
import os
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import arch_ids
from repro.configs import get_config as jget_config
from repro.launch import elastic as jelastic
from repro.launch import sharding as jsharding
from repro.models import SHAPES as JSHAPES
from repro.models import build_model as jbuild_model
from repro.models import input_specs as jinput_specs
from repro.models import shape_applicable as jshape_applicable
from repro.models import shardctx as jshardctx
from repro_torch.configs import get_config
from repro_torch.launch import elastic, sharding
from repro_torch.models import (
    SHAPES,
    build_model,
    input_specs,
    shape_applicable,
    shardctx,
)

ROOT = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class StandIn:
    """A mesh as both packages' resolvers read it."""

    def __init__(self, shape, names):
        self.axis_names = self.mesh_dim_names = names
        self.devices = np.empty(shape)
        self.shape = shape


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's spec_to_sharding returning its PartitionSpec."""
    monkeypatch.setattr(jsharding, "NamedSharding", lambda mesh, spec: spec)
    yield
    jshardctx.set_context(None, None)
    shardctx.set_context(None, None)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _port_params(arch):
    model = build_model(get_config(arch), device="meta")
    return model, {n.replace(".", "/"): tuple(p.shape)
                   for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", arch_ids())
def test_param_and_cache_specs_equal_reference(arch):
    jmodel = jbuild_model(jget_config(arch))
    want = {k: tuple(v) for k, v in _flat(jmodel.param_specs()).items()}
    jshapes = {k: tuple(v.shape) for k, v in _flat(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0))).items()}
    model, shapes = _port_params(arch)
    assert model.param_specs() == want
    assert shapes == jshapes
    assert model.cache_logical_specs() == {
        k: tuple(v) for k, v in jmodel.cache_logical_specs().items()}


def _cache_shapes(arch):
    """Each decode shape's cache entries: name -> (logical, shape)."""
    model = build_model(get_config(arch), device="meta")
    logical = model.cache_logical_specs()
    out = []
    for shape, sh in SHAPES.items():
        if sh["kind"] == "decode":
            cache = model.cache_specs(sh["batch"], sh["seq"])
            out += [(f"{shape}:{n}", logical[n], s) for n, (s, _) in
                    cache.items()]
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", arch_ids())
def test_resolution_equals_reference(ref_specs, arch, mesh_name):
    mesh = StandIn(*MESHES[mesh_name])
    multi_pod = mesh_name == "2x16x16"
    model, shapes = _port_params(arch)
    specs = model.param_specs()
    tensors = [(n, specs[n], s) for n, s in shapes.items()]
    tensors += _cache_shapes(arch)
    for rules_of in ("train_rules", "serve_rules"):
        jrules = getattr(jshardctx, rules_of)(multi_pod)
        rules = getattr(shardctx, rules_of)(multi_pod)
        assert rules == jrules
        jshardctx.set_context(mesh, jrules)
        shardctx.set_context(mesh, rules)
        for name, logical, shape in tensors:
            want = tuple(jsharding.spec_to_sharding(mesh, jrules, logical,
                                                    shape))
            placements = sharding.spec_to_sharding(mesh, rules, logical,
                                                   shape)
            assert len(placements) == len(mesh.shape)
            got = tuple(shardctx.axes_spec(mesh, placements, len(shape)))
            assert got == want, (rules_of, name)
            want = tuple(jshardctx.resolve(logical, shape))
            assert tuple(shardctx.resolve_axes(logical, shape)) == want, (
                rules_of, name)
            if name in specs:  # a parameter: no axis taken twice
                got = shardctx.axes_spec(
                    mesh, shardctx.resolve(logical, shape), len(shape))
                assert tuple(got) == want, (rules_of, name)
        assert tuple(sharding.batch_sharding(mesh, rules, (256, 4096))) == (
            shardctx.to_placements(mesh, [tuple(jrules["batch"]) if multi_pod
                                          else "data", None]))


def test_batch_over_two_axes_is_pod_major(ref_specs):
    """("pod", "data") on one dim: Shard(0) on both mesh dims, in mesh
    order; axes out of the mesh's order have no placement."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = StandIn(*MESHES["2x16x16"])
    assert shardctx.to_placements(mesh, [("pod", "data"), "model"]) == (
        Shard(0), Shard(0), Shard(1))
    assert shardctx.axes_spec(mesh, (Shard(0), Shard(0), Replicate()), 2) == [
        ("pod", "data"), None]
    with pytest.raises(ValueError, match="mesh's order"):
        shardctx.to_placements(mesh, [("data", "pod")])


@pytest.mark.parametrize("arch", arch_ids())
def test_input_specs_equal_reference(arch):
    """Meta tensors of the reference's shapes; int64 tokens and labels
    where the reference's are int32, the other dtypes equal."""
    dtypes = {"int32": torch.int32, "bfloat16": torch.bfloat16,
              "float32": torch.float32}
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in SHAPES:
        want = _flat(jinput_specs(jcfg, shape))
        got = _flat(input_specs(cfg, shape))
        assert got.keys() == want.keys(), shape
        for name, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[name].shape), (shape, name)
            is_token = name.split("/")[-1] in ("tokens", "labels")
            dtype = (torch.int64 if is_token
                     else dtypes[str(want[name].dtype)])
            assert t.dtype == dtype, (shape, name)


def test_shapes_and_applicability_equal_reference():
    assert SHAPES == JSHAPES
    for arch in arch_ids():
        for shape in SHAPES:
            assert shape_applicable(get_config(arch), shape) == \
                jshape_applicable(jget_config(arch), shape)


def test_replan_mesh_and_degraded_batch():
    """The shape and axis names ``replan_mesh`` builds, the reference's on
    the one device JAX has here, and the arithmetic elsewhere."""
    jmesh = jelastic.replan_mesh(1, model_parallel=1)
    assert elastic.replan_shape(1, model_parallel=1) == (
        tuple(jmesh.devices.shape), tuple(jmesh.axis_names))
    assert elastic.replan_shape(240) == ((15, 16), ("data", "model"))
    assert elastic.replan_shape(512, want_pods=2) == (
        (2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        elastic.replan_shape(250)
    with pytest.raises(ValueError, match="not divisible by 3 pods"):
        elastic.replan_shape(256, want_pods=3)
    for b, lost in ((256, 0.0), (256, 0.5), (3, 0.9), (1, 0.99)):
        assert elastic.degraded_batch(b, lost) == jelastic.degraded_batch(
            b, lost)


def _constrain_sites(package):
    sites = {}
    models = os.path.join(ROOT, "src", package, "models")
    for name in sorted(os.listdir(models)):
        if name.endswith(".py") and name != "shardctx.py":
            with open(os.path.join(models, name)) as f:
                n = len(re.findall(r"\bconstrain\(", f.read()))
            if n:
                sites[name] = n
    return sites


def test_models_keep_the_reference_constraint_sites():
    """attention's q / k / v, the MLP, the embedding and the logits, one a
    layer in each family's forward, and the MoE's four."""
    assert _constrain_sites("repro_torch") == _constrain_sites("repro")
    assert sum(_constrain_sites("repro_torch").values()) == 15
