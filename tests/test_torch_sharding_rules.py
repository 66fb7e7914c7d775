"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``): the same spec on every leaf of the
abstract parameter tree of all eleven reference configs and of the
abstract cache tree of the ten LM configs, on the production meshes and
on the test mesh; the reference's own rule cases; and ``placements``.

The rules read only path names, shapes and named axis sizes, so both
packages get shape-only mesh stand-ins and the reference's abstract trees
(``jax.eval_shape``): no device is touched.  Specs compare exactly (a
``PartitionSpec`` as its tuple of entries)."""
import functools

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro import models as jmodels
from repro.configs import ARCH_IDS, get_config
from repro.launch import sharding as jsharding

from repro_torch.configs.base import InputShape
from repro_torch.launch import sharding
from repro_torch.launch.mesh import axis_sizes, data_axes


class FakeMesh:
    """Shape-only mesh (the reference test's stand-in)."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "pod2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
          "4x2": FakeMesh({"data": 4, "model": 2})}
MESH = MESHES["16x16"]
MESH_POD = MESHES["pod2x16x16"]
CONFIGS = ARCH_IDS + ("cifar-resnet18",)
# cache geometries: a batch that shards over the data axes, and batch 1
# (long context: the sequence dim shards instead)
CACHE_SHAPES = {"b32": (32, 1024), "b1": (1, 4096)}


@functools.lru_cache(maxsize=None)
def _abstract_params(arch):
    cfg = get_config(arch)
    return jax.eval_shape(lambda: jmodels.init_params(
        cfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _abstract_cache(arch, batch, max_seq):
    cfg = get_config(arch)
    return jax.eval_shape(lambda: jmodels.init_cache(cfg, batch, max_seq))


def _ref_leaves(specs):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))]


def _paths(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", CONFIGS)
def test_param_specs_equal_reference(arch, mesh):
    tree = _abstract_params(arch)
    ref = _ref_leaves(jsharding.param_specs(tree, MESHES[mesh]))
    got = sharding.spec_leaves(tree, sharding.param_specs(tree,
                                                          MESHES[mesh]))
    assert len(got) == len(ref) == len(jax.tree_util.tree_leaves(tree))
    bad = [(path, r, g) for path, r, g in zip(_paths(tree), ref, got)
           if r != g]
    assert not bad, bad[:5]
    # the rules shard something on every LM (not a vacuous agreement)
    if arch != "cifar-resnet18":
        assert any(any(e is not None for e in s) for s in got)


@pytest.mark.parametrize("shape", CACHE_SHAPES, ids=str)
@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, mesh, shape):
    batch, max_seq = CACHE_SHAPES[shape]
    tree = _abstract_cache(arch, batch, max_seq)
    ref = _ref_leaves(jsharding.cache_specs(tree, MESHES[mesh], batch=batch))
    got = sharding.spec_leaves(tree, sharding.cache_specs(
        tree, MESHES[mesh], batch=batch))
    assert len(got) == len(ref) == len(jax.tree_util.tree_leaves(tree))
    bad = [(path, r, g) for path, r, g in zip(_paths(tree), ref, got)
           if r != g]
    assert not bad, bad[:5]


@pytest.mark.parametrize("arch", CONFIGS)
def test_specs_of_the_ports_meta_trees_equal_reference(arch):
    """``param_specs`` and ``cache_specs`` on the port's own abstract
    trees (``launch.specs``: meta tensors) equal the reference's on its
    ``jax.eval_shape`` trees, leaf for leaf, on every mesh and cache
    geometry."""
    from repro_torch.configs import get_config as tget_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import specs
    cfg = tget_config(arch)
    trees = [(specs.abstract_params(cfg), _abstract_params(arch), None)]
    if arch != "cifar-resnet18":
        trees += [(specs.input_specs(cfg, InputShape(
            "decode", max_seq, batch, "decode"))["cache"],
            _abstract_cache(arch, batch, max_seq), batch)
            for batch, max_seq in CACHE_SHAPES.values()]
    for tree, jtree, batch in trees:
        assert all(t.is_meta for t in tree_leaves(tree))
        for mesh in MESHES.values():
            if batch is None:
                ref = jsharding.param_specs(jtree, mesh)
                got = sharding.param_specs(tree, mesh)
            else:
                ref = jsharding.cache_specs(jtree, mesh, batch=batch)
                got = sharding.cache_specs(tree, mesh, batch=batch)
            assert sharding.spec_leaves(tree, got) == _ref_leaves(ref)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("shape", [(256, 4096), (32, 128), (8, 16), (1, 1),
                                   (6, 7), (16,)], ids=str)
def test_batch_spec_equals_reference(shape, mesh):
    assert sharding.batch_spec(shape, MESHES[mesh]) == tuple(
        jsharding.batch_spec(shape, MESHES[mesh]))


# ------------------------------------------------ the reference's rule cases
def test_col_row_parallel_orientation():
    assert sharding.spec_for(("segments", "attn", "wq"), (64, 4096, 4096),
                             MESH) == tuple(P(None, "data", "model"))
    assert sharding.spec_for(("segments", "attn", "wo"), (64, 4096, 4096),
                             MESH) == tuple(P(None, "model", "data"))
    assert sharding.spec_for(("segments", "mlp", "wi"), (32, 4096, 14336),
                             MESH) == tuple(P(None, "data", "model"))


def test_vocab_major_embeddings():
    assert sharding.spec_for(("embed",), (128256, 16384), MESH) \
        == tuple(P("model", "data"))
    # non-divisible vocab falls back (granite 49155, seamless 256206)
    assert sharding.spec_for(("lm_head",), (49155, 1536), MESH) \
        == tuple(P(None, "data"))


def test_moe_expert_parallel_or_ff_fallback():
    # arctic: 128 experts divide 16 -> expert-parallel
    assert sharding.spec_for(("segments", "moe", "wi"), (35, 128, 7168, 4864),
                             MESH) == tuple(P(None, "model", "data", None))
    # granite: 40 experts don't divide -> shard d_ff instead
    assert sharding.spec_for(("segments", "moe", "wi"), (32, 40, 1536, 512),
                             MESH) == tuple(P(None, None, "data", "model"))
    assert sharding.spec_for(("segments", "moe", "wo"), (32, 40, 512, 1536),
                             MESH) == tuple(P(None, None, "model", "data"))


def test_non_divisible_dims_drop_to_none():
    assert sharding.spec_for(("segments", "attn", "wq"), (34, 2560, 2048),
                             MESH) == tuple(P(None, "data", "model"))
    assert sharding.spec_for(("segments", "attn", "wq"), (2, 30, 50),
                             MESH) == tuple(P(None, None, None))


def test_norms_and_small_params_replicated():
    assert sharding.spec_for(("segments", "ln1"), (32, 4096), MESH) \
        == tuple(P(None, None))
    assert sharding.spec_for(("final_norm",), (4096,), MESH) == tuple(P(None))
    assert sharding.spec_for(("segments", "moe", "router"), (32, 4096, 128),
                             MESH) == tuple(P(None, None, None))


def test_batch_spec_pod_axes():
    assert sharding.batch_spec((256, 4096), MESH) == tuple(P(("data",), None))
    assert sharding.batch_spec((256, 4096), MESH_POD) \
        == tuple(P(("pod", "data"), None))
    assert sharding.batch_spec((1, 1), MESH) == tuple(P(None, None))
    assert sharding.batch_spec((32, 128), MESH_POD) \
        == tuple(P(("pod", "data"), None))


def test_mesh_stand_in_axes():
    assert axis_sizes(MESH_POD) == {"pod": 2, "data": 16, "model": 16}
    assert data_axes(MESH_POD) == ("pod", "data")
    assert data_axes(MESH) == ("data",)


# -------------------------------------------------------------- placements
class _NamedMesh:
    """The two attributes ``placements`` reads of a ``DeviceMesh``: its
    axis names and (here as a dict) their sizes."""

    def __init__(self, names, sizes=None):
        self.mesh_dim_names = names
        self.shape = dict(zip(names, sizes or (2,) * len(names)))


@pytest.mark.parametrize("spec,names,want", [
    (("data", "model"), ("data", "model"), ("S0", "S1")),
    (("model", "data"), ("data", "model"), ("S1", "S0")),
    ((None, "data", "model"), ("data", "model"), ("S1", "S2")),
    ((None, None), ("data", "model"), ("R", "R")),
    ((), ("data", "model"), ("R", "R")),
    ((("pod", "data"), None), ("pod", "data", "model"), ("S0", "S0", "R")),
    (("data", None), ("pod", "data", "model"), ("R", "S0", "R")),
    ((None, None, "data", "model"), ("pod", "data", "model"),
     ("R", "S2", "S3")),
], ids=["col", "row", "stacked", "replicated", "scalar", "pod_batch",
        "pod_replicated", "moe_ff"])
def test_placements_of_each_spec_kind(spec, names, want):
    from torch.distributed.tensor import Replicate, Shard
    got = sharding.placements(spec, _NamedMesh(names))
    exp = tuple(Replicate() if w == "R" else Shard(int(w[1:])) for w in want)
    assert got == exp


@pytest.mark.parametrize("sizes,want", [((1, 1), ("R", "R")),
                                        ((4, 1), ("S0", "R")),
                                        ((1, 2), ("R", "S1"))],
                         ids=["one_rank", "data_only", "model_only"])
def test_one_rank_axes_replicate(sizes, want):
    """An axis of one rank replicates: the shard is the whole dim."""
    from torch.distributed.tensor import Replicate, Shard
    got = sharding.placements(("data", "model"),
                              _NamedMesh(("data", "model"), sizes))
    assert got == tuple(Replicate() if w == "R" else Shard(int(w[1:]))
                        for w in want)


def test_spec_leaves_follow_the_tree_order():
    tree = {"b": [{"w": _Shape((2, 4))}, {}], "a": _Shape((8,))}
    specs = {"b": [{"w": ("x", None)}, {}], "a": (None,)}
    assert sharding.spec_leaves(tree, specs) == [(None,), ("x", None)]


class _Shape:
    def __init__(self, shape):
        self.shape = shape
