"""The port's partition rules (``repro_torch.sharding.partition``) held
against the reference's (``repro.sharding.partition``) on the CPU, with no
device: both sides are abstract.

For every config in ``configs/`` (all ten), the train state (parameters
and both moments), the parameters in the serving layout (``fsdp=False``),
every applicable cell's inputs, its exact cache and (dense, moe, vlm) its
PQ caches with exact and coded values: the port's spec of every leaf
equals the reference's ``PartitionSpec`` at the same field path, entry
for entry, on the 16 x 16, 2 x 16 x 16, 1 x 1 and 2 x 2 meshes.  The
reference's specs come from a ``jax.sharding.AbstractMesh``; the port's
per-layer leaves are padded with ``None`` for the reference's stack axes
(``specs.reference_layout``).  The per-device argument bytes summed from
the port's local shapes equal those summed from the reference's specs.
"""

import functools
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import registry as jreg
from repro.launch import specs as jspecs
from repro.serve.pqkv import PQKVConfig as JPQ
from repro.sharding import partition as jpart
from repro_torch import _tree
from repro_torch.configs import registry as treg
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.launch.cells import state_specs
from repro_torch.serve.pqkv import PQKVConfig as TPQ
from repro_torch.sharding import partition as tpart

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


def _meshes(name):
    dims, axes = MESHES[name]
    return AbstractMesh(dims, axes), tmesh.MeshDesc(dims, axes)


def _name(k):
    for a in ("name", "key", "idx"):
        if hasattr(k, a):
            return str(getattr(k, a))
    raise TypeError(k)


def _jax_specs(specs):
    """``{path: (entries...)}`` of a tree of reference specs."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {"/".join(_name(k) for k in path): tuple(s) for path, s in flat}


def _ref_key(path):
    """A port leaf's reference path: the layer index after ``blocks`` /
    ``enc_blocks`` / ``dec_blocks`` dropped (``specs.reference_layout``'s
    keys)."""
    names = [str(k) for k in path]
    for i, k in enumerate(path):
        if k in ("blocks", "enc_blocks", "dec_blocks") and i + 1 < len(path):
            del names[i + 1]
            break
    return "/".join(names)


def _port_specs(tree, specs, cfg):
    """``{reference path: entries}`` of the port's specs: the port's
    per-layer leaves padded with ``None`` for the reference's stack
    axes (a rule-less leaf's ``()`` stays ``()``, as ``P()``); every
    layer of a stacked leaf must have the same spec."""
    got = []
    _tree.tree_map_with_path(lambda p, x, s: got.append((p, s)), tree, specs)
    layout = tspecs.reference_layout(tree, cfg)
    out = {}
    for path, spec in got:
        key = _ref_key(path)
        ndim = len(layout[key][0])
        entry = (tuple(spec) if not spec
                 else (None,) * (ndim - len(spec)) + tuple(spec))
        assert out.setdefault(key, entry) == entry, key
    return out


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """``[(what, reference tree, port tree, kind)]`` of one config: kind
    ``param`` (``fsdp`` applies), ``state``, ``cache`` or ``batch``."""
    jc, tc = jreg.get_config(arch), treg.get_config(arch)
    out = [("train state", jspecs.abstract_train_state(jc),
            tspecs.abstract_train_state(tc), "state"),
           ("params", jspecs.abstract_params(jc), tspecs.abstract_params(tc),
            "param")]
    for name, jshape in jreg.SHAPES.items():
        if not jreg.shape_applicable(jc, jshape)[0]:
            continue
        tshape = treg.SHAPES[name]
        out.append((f"{name} inputs", jspecs.input_specs(jc, jshape),
                    tspecs.input_specs(tc, tshape), "batch"))
        if jshape.kind != "decode":
            continue
        out.append((f"{name} cache", jspecs.abstract_cache(jc, jshape),
                    tspecs.abstract_cache(tc, tshape), "cache"))
        if jc.family in ("dense", "moe", "vlm"):
            for qv in (False, True):
                out.append((f"{name} pq cache qv={qv}",
                            jspecs.abstract_pq_cache(jc, jshape,
                                                     JPQ(quantize_v=qv)),
                            tspecs.abstract_pq_cache(tc, tshape,
                                                     TPQ(quantize_v=qv)),
                            "cache"))
    return out


def _both(kind, jtree, ttree, jmesh, tmesh_, fsdp=True):
    if kind == "state":
        # the reference's _state_shardings: moments by the params' specs,
        # the step and the count replicated
        js = _jax_specs(jpart.param_specs(jtree.params, jmesh))
        want = {"step": (), "opt/count": ()}
        for prefix in ("params/", "opt/mu/", "opt/nu/"):
            want |= {prefix + k: v for k, v in js.items()}
        return want, None, state_specs(ttree, tmesh_)
    if kind == "param":
        return (_jax_specs(jpart.param_specs(jtree, jmesh, fsdp=fsdp)), None,
                tpart.param_specs(ttree, tmesh_, fsdp=fsdp))
    if kind == "cache":
        return (_jax_specs(jpart.cache_specs(jtree, jmesh)), None,
                tpart.cache_specs(ttree, tmesh_))
    return (_jax_specs(jpart.batch_specs(jtree, jmesh)), None,
            tpart.batch_specs(ttree, tmesh_))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_specs_equal_the_reference(arch, mesh):
    jmesh, desc = _meshes(mesh)
    tc = treg.get_config(arch)
    for what, jtree, ttree, kind in _trees(arch):
        for fsdp in ((True, False) if kind == "param" else (True,)):
            want, _, tspec = _both(kind, jtree, ttree, jmesh, desc, fsdp)
            assert _port_specs(ttree, tspec, tc) == want, (what, fsdp)


def _jax_local_bytes(tree, specs, mesh):
    sizes = dict(mesh.shape)
    n = 0
    for (_, leaf), (_, spec) in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]):
        shape = list(leaf.shape)
        for d, e in enumerate(spec):
            for a in (() if e is None else (e,) if isinstance(e, str)
                      else e):
                shape[d] //= sizes[a]
        n += math.prod(shape) * np.dtype(leaf.dtype).itemsize
    return n


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2-72b",
                                  "deepseek-moe-16b", "mamba2-780m",
                                  "zamba2-2.7b", "seamless-m4t-large-v2"])
def test_per_device_bytes_equal_the_reference(arch, mesh):
    jmesh, desc = _meshes(mesh)
    for what, jtree, ttree, kind in _trees(arch):
        if kind == "state":
            jt, tt = jtree.params, ttree.params
            js, ts = (jpart.param_specs(jt, jmesh),
                      tpart.param_specs(tt, desc))
        else:
            jt, tt = jtree, ttree
            _, _, ts = _both(kind, jtree, ttree, jmesh, desc)
            js = {"param": lambda: jpart.param_specs(jt, jmesh),
                  "cache": lambda: jpart.cache_specs(jt, jmesh),
                  "batch": lambda: jpart.batch_specs(jt, jmesh)}[kind]()
        assert tpart.local_bytes(tt, ts, desc) == \
            _jax_local_bytes(jt, js, jmesh), what


def test_an_axis_that_does_not_divide_replicates_the_dim():
    jmesh, desc = _meshes("16x16")
    shapes = {"wq": (30, 48), "w_down": (48, 17), "embed": (92, 64),
              "bq": (8,), "we_gate": (4, 64, 32), "unknown": (16, 16)}
    jtree = {k: jax.ShapeDtypeStruct(s, np.float32)
             for k, s in shapes.items()}
    ttree = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    want = _jax_specs(jpart.param_specs(jtree, jmesh))
    got = tpart.param_specs(ttree, desc)
    assert {k: tuple(v) for k, v in got.items()} == want
    assert got["wq"] == (None, "model") and got["w_down"] == ("model", None)
    # a batch of 1 (long-context decode) is replicated over DP
    b = {"token": torch.empty(1, 1, device="meta")}
    jb = {"token": jax.ShapeDtypeStruct((1, 1), np.int32)}
    assert tpart.batch_specs(b, desc)["token"] == \
        tuple(jpart.batch_specs(jb, jmesh)["token"]) == (None, None)


def test_placements_split_a_dim_over_pod_and_data():
    from torch.distributed.tensor import Replicate, Shard
    desc = tmesh.make_production_mesh(multi_pod=True)
    assert tpart.placements((("pod", "data"), "model"), desc) == \
        [Shard(0), Shard(0), Shard(1)]
    assert tpart.placements((None, "model"), desc) == \
        [Replicate(), Replicate(), Shard(1)]
    assert tpart.local_shape((64, 32), (("pod", "data"), "model"), desc) \
        == (2, 2)


def test_constraints_are_the_identity_off_a_mesh():
    x = torch.randn(4, 3)
    assert tpart.constrain_batch(x) is x
    with tpart.activation_sharding(("data",), 16):
        assert tpart.constrain_batch(x) is x
        assert tpart.constrain_dims(x, {0: "dp"}) is x
        assert tpart.gather_fsdp({"w": x})["w"] is x
        assert tpart.current_model_size() == 16
    assert tpart.current_act_axes() is None
