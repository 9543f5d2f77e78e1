"""Port vs reference, the dry run's tables and specs: ``launch/shapes`` (input
shapes, ``serve_cfg``, ``long_context_cfg``, the three ``*_input_specs`` as
``meta`` tensors against the reference's ``ShapeDtypeStruct``s, the decode
state included) and ``launch/sharding`` (``build_param_specs`` against the
reference's ``PartitionSpec`` tree and against the port's own parameter tree,
``decode_state_specs`` in both KV regimes, ``prepend_axes``, ``placements``
on a 4-rank ``fake`` group). Shapes and axis names are compared exactly; no
tensor is allocated.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jax_get_config
from repro.launch import shapes as jshapes
from repro.launch import sharding as jsharding
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shapes, sharding, steps
from repro_torch.launch.sharding import P
from repro_torch.models import transformer

ARCHS = sorted(ARCHITECTURES)
SHAPES = sorted(shapes.INPUT_SHAPES)


def _walk(tree, path=""):
    """(path, leaf) of a tree of dicts and (named) tuples, None kept."""
    if isinstance(tree, dict):
        for name in sorted(tree):
            yield from _walk(tree[name], f"{path}/{name}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, x in zip(tree._fields, tree):
            yield from _walk(x, f"{path}.{name}")
    else:
        yield path, tree


def _same_structs(got, want):
    """Every meta tensor of ``got`` has the shape and dtype of the reference's
    struct at the same path."""
    got, want = dict(_walk(got)), dict(_walk(want))
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        w = want[path]
        if w is None:
            assert x is None, path
            continue
        assert x.device.type == "meta", path
        assert tuple(x.shape) == tuple(w.shape), path
        assert str(x.dtype).replace("torch.", "") == str(np.dtype(w.dtype)), path


def _serve(cfg, shape_name, mod):
    c = mod.serve_cfg(cfg)
    return mod.long_context_cfg(c) if shape_name == "long_500k" else c


def test_tables_equal_the_references():
    assert shapes.INPUT_SHAPES == {k: shapes.InputShape(**dataclasses.asdict(v))
                                   for k, v in jshapes.INPUT_SHAPES.items()}
    assert shapes.FED_LAYOUT == jshapes.FED_LAYOUT
    assert shapes.LONG_CONTEXT_WINDOW == jshapes.LONG_CONTEXT_WINDOW
    assert shapes.arch_ids() == jshapes.arch_ids()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shards", [16, 8])
def test_serve_and_long_context_cfg_match_reference(arch, shards):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(shapes.serve_cfg(cfg, shards)) == dataclasses.asdict(
        jshapes.serve_cfg(jcfg, shards))
    assert dataclasses.asdict(shapes.long_context_cfg(cfg)) == dataclasses.asdict(
        jshapes.long_context_cfg(jcfg))
    assert shapes.is_subquadratic(cfg) == jshapes.is_subquadratic(jcfg)


@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape_name):
    shape, jshape = shapes.INPUT_SHAPES[shape_name], jshapes.INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        cfg, jcfg = get_config(arch).pad_for_mesh(16), jax_get_config(arch).pad_for_mesh(16)
        v = shapes.FED_LAYOUT[arch][0]
        got = shapes.train_input_specs(cfg, shape, v)
        want = jshapes.train_input_specs(jcfg, jshape, v)
        assert "rng" not in got and "rng" in want        # the port's step takes none
        del want["rng"]
        assert shapes.text_seq_len(cfg, shape) == jshapes.text_seq_len(jcfg, jshape)
    else:
        cfg = _serve(get_config(arch), shape_name, shapes)
        jcfg = _serve(jax_get_config(arch), shape_name, jshapes)
        fn = shapes.prefill_input_specs if shape.kind == "prefill" else shapes.decode_input_specs
        jfn = (jshapes.prefill_input_specs if shape.kind == "prefill"
               else jshapes.decode_input_specs)
        got, want = fn(cfg, shape), jfn(jcfg, jshape)
    _same_structs(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference_and_the_parameter_tree(arch):
    cfg, jcfg = get_config(arch).pad_for_mesh(16), jax_get_config(arch).pad_for_mesh(16)
    for fsdp in (None, "fsdp"):
        got = dict(_walk(sharding.build_param_specs(cfg, fsdp=fsdp)))
        want = dict(_walk(jsharding.build_param_specs(jcfg, fsdp=fsdp)))
        assert sorted(got) == sorted(want)
        for path, spec in got.items():
            assert isinstance(spec, P) and tuple(spec) == tuple(want[path]), path
    # the port's own parameter tree, on meta: the same paths, one entry per
    # dim at most, every dim sharded over "model" divisible by 16
    params = dict(_walk(transformer.init_params(torch.Generator(), cfg, device="meta")))
    specs = dict(_walk(sharding.build_param_specs(cfg)))
    assert sorted(params) == sorted(specs)
    for path, leaf in params.items():
        spec = specs[path]
        assert len(spec) <= leaf.dim(), (path, spec, leaf.shape)
        for dim, axis in enumerate(spec):
            if axis == "model":
                assert leaf.shape[dim] % 16 == 0, (path, dim, leaf.shape)
    # the reference's parameter shapes are the port's
    jparams = jax.eval_shape(lambda r: jtf.init_params(r, jcfg), jax.random.PRNGKey(0))
    _same_structs(transformer.init_params(torch.Generator(), cfg, device="meta"), jparams)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2.5-3b", "granite-34b", "rwkv6-3b",
                                  "hymba-1.5b"])
def test_decode_state_specs_match_reference(arch):
    """Both KV regimes: a serving kv count that divides 16 (qwen3's 8 and
    hymba's 5, padded to 16) shards the cache over its heads; qwen2.5's 2 and
    granite-34b's 1 over its sequence dim."""
    cfg, jcfg = shapes.serve_cfg(get_config(arch)), jshapes.serve_cfg(jax_get_config(arch))
    for batch in ("data", ("pod", "data"), None):
        got = dict(_walk(sharding.decode_state_specs(cfg, batch)))
        want = dict(_walk(jsharding.decode_state_specs(jcfg, batch)))
        assert sorted(got) == sorted(want)
        for path, spec in got.items():
            if want[path] is None:
                assert spec is None, path
            else:
                assert tuple(spec) == tuple(want[path]), path
    kv = sharding.decode_state_specs(cfg, "data").kv
    if arch in ("qwen3-1.7b", "hymba-1.5b"):
        assert cfg.num_kv_heads == 16 and kv.k == P(None, "data", None, "model", None)
    elif arch != "rwkv6-3b":
        assert cfg.num_kv_heads < 16 and kv.k == P(None, "data", "model", None, None)
    else:
        assert kv is None


def test_prepend_axes_and_spec_type():
    tree = {"a": P(None, "model"), "b": {"c": P()}}
    out = sharding.prepend_axes(tree, (("pod", "vehicle"),))
    assert out == {"a": P(("pod", "vehicle"), None, "model"), "b": {"c": P(("pod", "vehicle"))}}
    assert isinstance(out["b"]["c"], P) and repr(P("model")) == "P('model')"
    assert sharding.drop_leading(P("vehicle", None, "model")) == P(None, "model")
    with pytest.raises(AttributeError):
        P("model").append(None)                       # immutable


@pytest.fixture
def fake4():
    """A 4-rank ``fake`` group in this process; torn down with its meshes."""
    from repro_torch.launch import dryrun
    dryrun._fake_group(4)
    yield
    mesh_lib.shutdown()


def test_placements_on_a_mesh(fake4):
    mesh = mesh_lib.make_federation_mesh(vehicle=2, fsdp=1, model=2, explicit=True)
    assert sharding.placements(P("vehicle", None, "model"), mesh) == (
        Shard(0), Replicate(), Shard(2))
    assert sharding.placements(P(None, "model", "fsdp"), mesh) == (
        Replicate(), Shard(2), Shard(1))
    assert sharding.placements(P(("vehicle", "fsdp"), None), mesh) == (
        Shard(0), Shard(0), Replicate())
    assert sharding.placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="not a dim of the mesh"):
        sharding.placements(P("data"), mesh)
    with pytest.raises(ValueError, match="twice"):
        sharding.placements(P("model", "model"), mesh)
    # the tree form, and the step's own specs through ``named``
    cfg = get_config("qwen3-1.7b").reduced().pad_for_mesh(16)
    ts = steps.build_dds_train_step(cfg, mesh=mesh)
    named = steps.named(mesh, ts.param_specs)
    assert named["blocks"]["attn"]["wq"] == (Shard(0), Replicate(), Shard(3))   # [V, L, d, w]
    assert named["embed"] == (Shard(0), Replicate(), Shard(1))
    # placing a meta tree cuts each leaf to this rank's shard, no allocation
    params, _, _ = steps.train_state_specs(cfg, 2)
    placed = sharding.place_tree(params, mesh, ts.param_specs)
    wq = placed["blocks"]["attn"]["wq"]
    assert tuple(wq.shape) == tuple(params["blocks"]["attn"]["wq"].shape)
    assert tuple(wq.to_local().shape) == (1,) + tuple(wq.shape[1:3]) + (wq.shape[3] // 2,)
    assert wq.to_local().device.type == "meta"
