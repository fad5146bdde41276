"""The port's partition specs (``repro_torch.launch.shardings``) against
the JAX package's (``repro.launch.shardings``), leaf by leaf.

Both sides are computed at full size with no devices and no weights: the
reference over ``jax.eval_shape`` of its ``init`` (and ``cache_init``)
and a stand-in mesh that has only ``axis_names`` and a ``shape`` dict,
the port over a model built on the ``meta`` device and a
``launch.mesh.MeshShape``. The reference's stacked leaves are cut into
the port's per-layer leaves by ``convert._model_state`` (its spec without
the leading None of the stack). Meshes: the production (16, 16) and
(2, 16, 16), and (3, 3), where the divisibility fallback replicates the
dims 3 does not divide.
"""
import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS, get_config as jget_config
from repro.launch import shardings as jshard
from repro.models import build_model as jbuild_model
from repro.train.step import init_state as jinit_state

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import shardings
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.step import TrainState

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "3x3": (("data", "model"), (3, 3))}
STACKS = ("blocks", "enc_blocks", "dec_blocks")


class _JMesh:
    """The part of a ``jax.sharding.Mesh`` the reference's rules read."""

    def __init__(self, names, shape):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


def _meshes(key):
    names, shape = MESHES[key]
    return _JMesh(names, shape), MeshShape(names, shape)


_REF = {}


def _ref(arch):
    """(model, parameter shapes) of the reference at full size."""
    if arch not in _REF:
        model = jbuild_model(jget_config(arch))
        _REF[arch] = (model, jax.eval_shape(model.init,
                                            jax.random.PRNGKey(0)))
    return _REF[arch]


_PORT = {}


def _port(arch):
    if arch not in _PORT:
        _PORT[arch] = build_model(get_config(arch), device="meta")
    return _PORT[arch]


def _spec(s):
    return tuple(s) if isinstance(s, P) else s


def _unstacked(tree, stacked=False):
    """The reference's spec tree with each stacked leaf as an object array
    of its per-layer spec (``convert`` indexes it by layer)."""
    if isinstance(tree, dict):
        return {k: _unstacked(v, stacked or k in STACKS)
                for k, v in tree.items()}
    spec = _spec(tree)
    if not stacked:
        return spec
    assert spec[0] is None, spec
    arr = np.empty(4096, dtype=object)
    for i in range(arr.shape[0]):
        arr[i] = spec[1:]
    return arr


def _ref_param_specs(arch, jmesh):
    _, sds = _ref(arch)
    tree = jshard.param_specs(sds, jmesh, jget_config(arch))
    return convert._model_state(_unstacked(tree), get_config(arch))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh):
    jmesh, pmesh = _meshes(mesh)
    want = _ref_param_specs(arch, jmesh)
    got = shardings.param_specs(_port(arch), pmesh, get_config(arch))
    assert set(got) == set(want)
    bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    assert not bad, list(bad.items())[:5]


def test_divisibility_fallback_replicates():
    """On (3, 3) a dim 3 does not divide is replicated, one it divides is
    sharded (Qwen3-8B: d_model 4096 is not a multiple of 3, its 36 layers'
    d_ff 12288 is)."""
    _, pmesh = _meshes("3x3")
    specs = shardings.param_specs(_port("qwen3-8b"), pmesh)
    assert specs["layers.0.mlp.w_up"] == (None, "model")      # (4096, 12288)
    assert specs["layers.0.mlp.w_down"] == ("model", None)    # (12288, 4096)
    _, full = _meshes("16x16")
    assert shardings.param_specs(_port("qwen3-8b"), full)[
        "layers.0.mlp.w_up"] == ("data", "model")
    assert shardings.leaf_spec("x.moe_up", (64, 2048, 1408), pmesh) == (
        None, None, None)


_REF_CACHE = {}


def _ref_cache_specs(arch, jmesh, B, S, seq_axes):
    model, _ = _ref(arch)
    cfg = jget_config(arch)
    if (arch, B, S) not in _REF_CACHE:
        args = (B, S, 64) if cfg.is_encoder_decoder else (B, S)
        _REF_CACHE[arch, B, S] = jax.eval_shape(
            lambda: model.cache_init(*args))
    return jshard.cache_specs(_REF_CACHE[arch, B, S], jmesh, cfg,
                              seq_axes=seq_axes)


def _port_cache(arch, B, S):
    model = _port(arch)
    if get_config(arch).is_encoder_decoder:
        return model.cache_init(B, S, 64)
    return model.cache_init(B, S)


def _ref_layer_specs(ref, cfg):
    """The reference's cache specs per port layer (``layers[l]``)."""
    if cfg.is_encoder_decoder:
        one = {k: _spec(ref[k])[1:] for k in ("k", "v", "xk", "xv")}
        return [one] * cfg.num_layers
    off = 1 if cfg.first_layer_dense else 0
    out = [] if not off else [{k: _spec(v)
                               for k, v in ref["first"].items()}]
    for layer in range(off, off + cfg.num_repeats * cfg.pattern_len):
        blk = ref["blocks"][f"pos{(layer - off) % cfg.pattern_len}"]
        out.append({k: _spec(v)[1:] for k, v in blk.items()})
    return out


@pytest.mark.parametrize("seq", [None, ("data",)], ids=["batch", "seq"])
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh, seq):
    jmesh, pmesh = _meshes(mesh)
    cfg = get_config(arch)
    # a batch the batch axes divide on (16, 16) and not on (2, 16, 16)
    B, S = 16, 1024
    ref = _ref_cache_specs(arch, jmesh, B, S, seq)
    got = shardings.cache_specs(_port_cache(arch, B, S), pmesh, cfg,
                                seq_axes=seq)
    assert got["slot_pos"] == _spec(ref["slot_pos"])
    assert got["pos"] == _spec(ref["pos"]) == ()
    assert got["layers"] == _ref_layer_specs(ref, cfg)


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b"])
def test_state_specs_match_reference(arch):
    jmesh, pmesh = _meshes("16x16")
    model, _ = _ref(arch)
    cfg = get_config(arch)
    jstate = jax.eval_shape(lambda k: jinit_state(model, k),
                            jax.random.PRNGKey(0))
    ref = jshard.state_specs(jstate, jmesh, jget_config(arch))
    names = dict(_port(arch).named_parameters())
    state = TrainState(params=names, opt=AdamWState(step=None, m=names,
                                                    v=names))
    got = shardings.state_specs(state, pmesh, cfg)
    assert got.opt.step == _spec(ref.opt.step) == ()
    for mine, theirs in ((got.params, ref.params), (got.opt.m, ref.opt.m),
                         (got.opt.v, ref.opt.v)):
        assert mine == convert._model_state(_unstacked(theirs), cfg)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_batch_specs_match_reference(mesh):
    jmesh, pmesh = _meshes(mesh)
    assert shardings.batch_specs(pmesh) == _spec(jshard.batch_specs(jmesh))
    got = shardings.batch_specs(pmesh, with_extra=True, extra_rank=3)
    want = jshard.batch_specs(jmesh, with_extra=True, extra_rank=3)
    assert got == tuple(_spec(s) for s in want)


def test_named_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MeshShape(("pod", "data", "model"), (2, 2, 2))
    assert shardings.placements(mesh, ("data", "model")) == (
        Replicate(), Shard(0), Shard(1))
    assert shardings.placements(mesh, ("model", None, "data")) == (
        Replicate(), Shard(2), Shard(0))
    assert shardings.placements(mesh, (("pod", "data"), None)) == (
        Shard(0), Shard(0), Replicate())
    assert shardings.placements(mesh, ()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        shardings.placements(mesh, (("data", "pod"),))
    tree = shardings.named(mesh, {"a": [(None, "model")], "b": (("data",),)})
    assert tree == {"a": [(Replicate(), Replicate(), Shard(1))],
                    "b": (Replicate(), Shard(0), Replicate())}


class _RankedMesh(MeshShape):
    """A mesh shape seen from one rank (its coordinate on each axis)."""

    def __new__(cls, names, shape, coords):
        self = super().__new__(cls)
        object.__setattr__(self, "coords", dict(zip(names, coords)))
        return self

    def __init__(self, names, shape, coords):
        super().__init__(names, shape)

    def get_local_rank(self, axis):
        return self.coords[axis]


@pytest.mark.parametrize("coords,rows", [((0, 0), (0, 2)), ((0, 1), (2, 4)),
                                         ((1, 0), (4, 6)), ((1, 1), (6, 8))])
def test_local_shard_blocks(coords, rows):
    """A rank's block of a dim split over two axes takes the first as the
    major one, as JAX's PartitionSpec does; a dim over one axis takes that
    axis's rank."""
    import torch
    t = torch.arange(8 * 4).reshape(8, 4)
    mesh = _RankedMesh(("data", "model"), (2, 2), coords)
    got = shardings.local_shard(t, mesh, (("data", "model"), None))
    assert torch.equal(got, t[rows[0]:rows[1]])
    got = shardings.local_shard(t, mesh, (None, "model"))
    assert torch.equal(got, t[:, 2 * coords[1]:2 * coords[1] + 2])
    assert shardings.local_shard(t, _RankedMesh(("data", "model"), (1, 1),
                                                (0, 0)),
                                 (("data", "model"), None)) is t
