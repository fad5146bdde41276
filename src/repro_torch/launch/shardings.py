"""Partition specs of the port's parameters, optimizer state, decode caches
and batches (the JAX package's ``launch/shardings.py``), and their DTensor
placements.

The rules are the reference's, leaf by leaf:

* TP over "model": attention heads, FFN hidden, vocab, MoE experts (EP),
  SSD heads; output projections are row-sharded.
* FSDP over "data": every weight matrix is also sharded on a non-TP dim.
* "pod": pure DP (weights replicated).
* An axis that does not divide its dim falls back to replication
  (:func:`_div`).

The rules read the last part of a parameter's name (``layers.3.mixer.wq``
reads ``wq``: the JAX package's leaf names) and its shape. The port's
layers are per-layer submodules, so no leaf is stacked over the repeats:
``convert._lm_state`` pairs a port leaf with the reference's repeat slice,
whose spec is the reference's without its leading None.

A spec is a tuple with one entry per tensor dim: None, an axis name, or a
tuple of two or more axis names (the dim split over all of them, the
first major; one axis is written as its name, as JAX writes it). The
spec functions read only a mesh's axis names and sizes, so they take any
``launch.mesh`` kind (``DeviceMesh``, ``LocalMesh``, ``MeshShape``).

:func:`named` turns specs into DTensor placements, one per mesh dim
(``Shard(dim)`` or ``Replicate()``). On a ``DeviceMesh``,
:func:`distribute`, :func:`place_module` and :func:`place_cache` put full
tensors at those placements, each rank keeping only its own shard (a view
where the shard is the whole tensor: no second copy). :func:`gather`
brings a DTensor back to a plain tensor, all-gathering each dim that a
mesh axis of size > 1 shards unless the caller keeps that axis on it, and
:func:`write_back` copies the rank's part of such a tensor into the
DTensor's shard. An axis of size 1 issues no collective.

Under a gradient the gathers go through ``launch/collectives.py``: the
caller names the axes whose ranks compute different rows after the gather
(``rows``), and the adjoint on such an axis is a reduce-scatter of the
gradient (a replicated dim there all-reduces it); on any other axis the
rank's own slice.

A block that runs on its TP rank (``models/tp.py``: its heads, FFN
columns or vocab) takes its weights through :func:`gather_local`: every
dim is gathered but the one the TP axis shards, which stays the rank's
(:func:`tp_keep`), so the weights are gathered over FSDP only and the
gradient of a kept dim is the rank's own shard. The TP axis counts among
the block's ``rows``: its ranks compute different heads, so a weight the
block holds whole (a per-head norm scale, Mamba2's ``w_bc``, MLA's
latent projection) has a partial gradient on each rank, which the
adjoint all-reduces, and one the block gathers over TP to slice (the KV
heads its queries read) reduce-scatters its gradient.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from . import collectives
from .mesh import axis_group, axis_rank, axis_size, batch_axes

__all__ = ["param_specs", "state_specs", "cache_specs", "batch_specs",
           "leaf_spec", "named", "placements", "local_shard", "distribute",
           "place_module", "place_cache", "gather", "gather_dim",
           "write_back", "is_device_mesh", "spec_axes", "local", "like",
           "sharded_axes", "tp_keep", "gather_local"]

Spec = Tuple[Any, ...]

# the rank of a leaf's own shape, by name (the reference's table; others:
# 1 for a norm scale, else 2)
_BASE_RANK = {"embedding": 2, "head": 2, "router": 2, "conv": 2,
              "A_log": 1, "D": 1, "dt_bias": 1, "ssm_norm": 1,
              "moe_up": 3, "moe_gate": 3, "moe_down": 3}


def _entry(axes):
    """The spec entry of a dim split over ``axes``: None, the name of one
    axis, or the tuple of several."""
    axes = tuple(axes or ())
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _div(n: int, mesh, axis: Optional[str]):
    """axis if it is in the mesh and divides n, else None (replicate)."""
    if axis is None or axis not in tuple(mesh.mesh_dim_names):
        return None
    return axis if n % axis_size(mesh, axis) == 0 else None


def _leaf_spec(name: str, shape, mesh, tp: str, fsdp: str) -> Spec:
    """The spec of one leaf of its own rank (no stacking dim)."""
    nd = len(shape)

    def col2(rows, cols):  # (rows sharded fsdp, cols sharded tp)
        return (_div(rows, mesh, fsdp), _div(cols, mesh, tp))

    def row2(rows, cols):  # (rows sharded tp, cols sharded fsdp)
        return (_div(rows, mesh, tp), _div(cols, mesh, fsdp))

    if name == "embedding":      # (V, d): shard vocab
        return (_div(shape[0], mesh, tp), _div(shape[1], mesh, fsdp))
    if name in ("head", "wq", "wk", "wv", "w_up", "w_gate", "shared_up",
                "shared_gate", "w_in_x", "w_in_z", "w_dt", "w_uk", "w_uv"):
        return col2(*shape[-2:])
    if name in ("wo", "w_down", "shared_down", "w_out"):
        return row2(*shape[-2:])
    if name in ("w_dkv", "w_bc"):   # small, column dims stay whole
        return (_div(shape[-2], mesh, fsdp), None)
    if name in ("moe_up", "moe_gate"):   # (E, d, ff): EP on E, FSDP on d
        return (_div(shape[0], mesh, tp), _div(shape[1], mesh, fsdp), None)
    if name == "moe_down":               # (E, ff, d): FSDP on d
        return (_div(shape[0], mesh, tp), None, _div(shape[2], mesh, fsdp))
    if name == "router":
        return (None, None)
    if name == "conv":                   # (width, d_inner)
        return (None, _div(shape[1], mesh, tp))
    if name in ("A_log", "D", "dt_bias", "ssm_norm"):
        return (_div(shape[0], mesh, tp),)
    return (None,) * nd                  # norm scales; conservative default


def leaf_spec(name: str, shape, mesh, *, tp: str = "model",
              fsdp: str = "data") -> Spec:
    """The spec of the parameter ``name`` (a dotted path) of ``shape``.
    As in the reference, a leaf one rank above its name's own rank is
    taken as stacked and gets a leading None."""
    leaf = name.rsplit(".", 1)[-1]
    base = _BASE_RANK.get(leaf)
    if base is None:
        base = 1 if (leaf.startswith("ln") or "norm" in leaf) else 2
    shape = tuple(shape)
    if len(shape) == base + 1:
        return (None, *_leaf_spec(leaf, shape[1:], mesh, tp, fsdp))
    return _leaf_spec(leaf, shape, mesh, tp, fsdp)


def _named_shapes(params) -> dict:
    if isinstance(params, nn.Module):
        return {k: tuple(p.shape) for k, p in params.named_parameters()}
    return {k: tuple(getattr(v, "shape", v)) for k, v in params.items()}


def param_specs(params, mesh, cfg=None, *, tp: str = "model",
                fsdp: str = "data") -> dict:
    """``{name: spec}`` for a module's parameters, or for a mapping of
    names to tensors or shapes (``cfg`` is unused, as in the reference)."""
    return {k: leaf_spec(k, s, mesh, tp=tp, fsdp=fsdp)
            for k, s in _named_shapes(params).items()}


def state_specs(state, mesh, cfg=None):
    """Specs of a ``train.step.TrainState``: AdamW's moments follow the
    parameters, its step is replicated."""
    return type(state)(
        params=param_specs(state.params, mesh, cfg),
        opt=type(state.opt)(step=(),
                            m=param_specs(state.opt.m, mesh, cfg),
                            v=param_specs(state.opt.v, mesh, cfg)))


def cache_specs(cache, mesh, cfg=None, *, seq_axes=None,
                tp: str = "model"):
    """Specs of a decode cache (``LM.cache_init`` / ``prefill``'s dict).

    ``seq_axes`` shards each attention entry's and MLA latent's sequence
    dim over those axes (long-context decode, a batch too small to shard);
    otherwise the batch dim is sharded over the mesh's batch axes where
    they divide it. Mamba states are never sequence-sharded."""
    seq = _entry(seq_axes)
    ba_all = batch_axes(mesh)
    prod = 1
    for a in ba_all:
        prod *= axis_size(mesh, a)

    def ba_for(b: int):
        return _entry(ba_all) if b % prod == 0 else None

    def one(name: str, t):
        if name == "slot_pos":
            return (seq,)
        if name == "pos":
            return ()
        shape = tuple(t.shape)
        if name in ("k", "v", "xk", "xv"):   # (B, Hkv, S, hd)
            if seq:
                return (None, _div(shape[1], mesh, tp), seq, None)
            return (ba_for(shape[0]), _div(shape[1], mesh, tp), None, None)
        if name in ("c", "rope"):            # (B, S, dim): MLA latent
            return (None, seq, None) if seq else (ba_for(shape[0]), None,
                                                  None)
        if name == "ssm":                    # (B, H, P, N)
            return (None if seq else ba_for(shape[0]),
                    _div(shape[1], mesh, tp), None, None)
        if name == "conv":                   # (B, w - 1, d_inner)
            return (None if seq else ba_for(shape[0]), None,
                    _div(shape[2], mesh, tp))
        return (None,) * len(shape)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        return one(name, node)

    return walk(cache, "")


def batch_specs(mesh, *, with_extra: bool = False, extra_rank: int = 3):
    """The spec of a (B, S) token batch, and with ``with_extra`` of a
    (B, ...) extra input of rank ``extra_rank``."""
    ba = _entry(batch_axes(mesh))
    toks = (ba, None)
    if with_extra:
        return toks, (ba, *([None] * (extra_rank - 1)))
    return toks


# ------------------------------------------------------------ placements
def spec_axes(entry) -> Tuple[str, ...]:
    """The axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _is_spec(x) -> bool:
    return type(x) is tuple and all(
        e is None or isinstance(e, str)
        or (type(e) is tuple and all(isinstance(a, str) for a in e))
        for e in x)


def placements(mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec``: for each mesh dim, ``Shard(d)`` if
    the spec splits tensor dim d over it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in spec_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: a dim split over several axes "
                             f"takes them in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def named(mesh, spec_tree):
    """The tree of specs (dicts, lists, ``NamedTuple``s) with each spec
    replaced by its :func:`placements`."""
    if _is_spec(spec_tree):
        return placements(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(named(mesh, v) for v in spec_tree))
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(named(mesh, v) for v in spec_tree)
    raise TypeError(f"not a spec tree: {spec_tree!r}")


def is_device_mesh(mesh) -> bool:
    if mesh is None:
        return False
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def _is_dtensor(t) -> bool:
    if not isinstance(t, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local(t):
    """The tensor a DTensor holds on this rank (a plain tensor as it
    is)."""
    return t.to_local() if _is_dtensor(t) else t


def like(t, loc: torch.Tensor):
    """``loc``, this rank's part of a tensor at ``t``'s placements, as a
    DTensor like ``t`` (``loc`` itself where ``t`` is plain)."""
    if not _is_dtensor(t):
        return loc
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(loc, t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=_contiguous_stride(t.shape))


def sharded_axes(t) -> Tuple[str, ...]:
    """The mesh axes of size > 1 that shard a DTensor (() for a plain
    tensor): the axes over which its ranks' parts add up to the whole."""
    if not _is_dtensor(t):
        return ()
    mesh = t.device_mesh
    return tuple(n for i, (n, pl) in enumerate(zip(mesh.mesh_dim_names,
                                                   t.placements))
                 if pl.is_shard() and mesh.size(i) > 1)


def _block(mesh, axes) -> Tuple[int, int]:
    """(rank, count) of this process's block of a dim split over ``axes``."""
    rank, count = 0, 1
    for a in axes:
        n = axis_size(mesh, a)
        rank, count = rank * n + axis_rank(mesh, a), count * n
    return rank, count


def local_shard(t: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec`` (a
    view)."""
    for d, entry in enumerate(spec):
        rank, count = _block(mesh, spec_axes(entry))
        if count > 1:
            if t.shape[d] % count:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not "
                                 f"split over {spec_axes(entry)}")
            size = t.shape[d] // count
            t = t.narrow(d, rank * size, size)
    return t


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def distribute(t: torch.Tensor, mesh, spec: Spec, have: Optional[Spec] = None):
    """``t`` as a DTensor at ``spec``'s placements holding this rank's
    shard. ``t`` is the full tensor (the same on every rank) or, with
    ``have``, already this rank's block over the axes ``have`` names on
    each dim (they must be among ``spec``'s there). The shard is a copy
    only where it is smaller than ``t``. Off a ``DeviceMesh`` (a
    ``LocalMesh``: one device) ``t`` comes back as it is."""
    if not is_device_mesh(mesh):
        return t
    from torch.distributed.tensor import DTensor
    loc, shape = t, list(t.shape)
    for d, entry in enumerate(spec):
        kept = _kept(have, d)
        if not set(kept) <= set(spec_axes(entry)):
            raise ValueError(f"dim {d} is split over {kept}, not among "
                             f"the spec's {spec_axes(entry)}")
        for a in kept:
            shape[d] *= axis_size(mesh, a)
        rank, count = _block(mesh, [a for a in spec_axes(entry)
                                    if a not in kept])
        if count > 1:
            if loc.shape[d] % count:
                raise ValueError(f"dim {d} of {tuple(loc.shape)} does not "
                                 f"split over {spec_axes(entry)}")
            size = loc.shape[d] // count
            loc = loc.narrow(d, rank * size, size)
    if loc.numel() != t.numel():
        loc = loc.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(loc, mesh, placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def place_module(module: nn.Module, mesh, specs: dict) -> nn.Module:
    """Put ``module``'s parameters at ``specs``' placements, one at a time
    (each full tensor is dropped as its shard takes its place)."""
    if not is_device_mesh(mesh):
        return module
    for name, spec in specs.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        old = getattr(owner, leaf)
        new = nn.Parameter(distribute(old.detach(), mesh, spec),
                           requires_grad=old.requires_grad)
        if isinstance(owner, nn.ParameterDict):
            owner[leaf] = new
        else:
            setattr(owner, leaf, new)
    return module


def place_cache(cache, mesh, specs):
    """A cache (dicts and lists of tensors; ints stay) at ``specs``'
    placements."""
    if isinstance(cache, dict):
        return {k: place_cache(v, mesh, specs[k]) for k, v in cache.items()}
    if isinstance(cache, list):
        return [place_cache(v, mesh, s) for v, s in zip(cache, specs)]
    if isinstance(cache, torch.Tensor):
        return distribute(cache, mesh, specs)
    return cache


def gather_dim(t: torch.Tensor, dim: int, mesh, axes, *,
               partial_grads: bool = False) -> torch.Tensor:
    """The blocks of dim ``dim`` split over ``axes`` (major first),
    all-gathered from every rank; axes of size 1 are skipped. The adjoint
    is the rank's slice, or with ``partial_grads`` a reduce-scatter
    (``collectives.all_gather``)."""
    for a in reversed(spec_axes(axes)):   # the minor axis first
        t = collectives.all_gather(t, dim, axis_group(mesh, a),
                                   partial_grads=partial_grads)
    return t


def _kept(keep, d: int) -> Tuple[str, ...]:
    return spec_axes(keep[d]) if keep is not None and d < len(keep) else ()


def gather(t, keep: Optional[Spec] = None, rows=()) -> torch.Tensor:
    """A plain tensor of ``t``: a DTensor all-gathered along every dim
    that a mesh axis of size > 1 shards, except where ``keep`` (a spec:
    the layout the caller computes in) names that axis on that dim. A
    plain tensor comes back as it is. ``rows``: the axes whose ranks
    compute different rows with the result; under a gradient a gather
    over one of them reduce-scatters the gradient, and a dim replicated
    over one of them all-reduces it (the module says why)."""
    if not _is_dtensor(t):
        return t
    mesh = t.device_mesh
    names = tuple(mesh.mesh_dim_names)
    out = t.to_local()
    wide = [i for i in reversed(range(len(names))) if mesh.size(i) > 1]
    # the replicated axes first: their gradient sums run on the shard
    # (the pods' join of a weight FSDP-sharded over "data")
    for i in wide:
        if not t.placements[i].is_shard() and names[i] in rows:
            out = collectives.reduce_grad(out, mesh.get_group(names[i]))
    for i in wide:   # the minor axis of a dim first
        pl = t.placements[i]
        if not pl.is_shard() or names[i] in _kept(keep, pl.dim):
            continue
        out = collectives.all_gather(out, pl.dim, mesh.get_group(names[i]),
                                     partial_grads=names[i] in rows)
    return out


def tp_keep(t, axis: Optional[str]) -> Optional[Spec]:
    """The spec that keeps ``axis`` on the dim that it shards a DTensor
    ``t`` over, for :func:`gather`'s ``keep`` (None where it shards none
    or ``t`` is plain)."""
    if axis is None or not _is_dtensor(t):
        return None
    names = tuple(t.device_mesh.mesh_dim_names)
    if axis not in names:
        return None
    pl = t.placements[names.index(axis)]
    if not pl.is_shard():
        return None
    keep = [None] * t.ndim
    keep[pl.dim] = axis
    return tuple(keep)


def gather_local(t, axis: Optional[str], rows=()) -> torch.Tensor:
    """``t`` as a block computed on its rank of ``axis`` takes it: gathered
    over every other axis that shards it, this rank's block of the dim
    ``axis`` shards, ``axis`` among the ``rows`` (the module says why)."""
    return gather(t, keep=tp_keep(t, axis),
                  rows=(*rows, axis) if axis is not None else rows)


def write_back(t, value: torch.Tensor, keep: Optional[Spec] = None) -> None:
    """Store ``value`` (``t`` in the layout ``keep``, as :func:`gather`
    returned it and the caller then updated) into ``t``: a DTensor keeps
    this rank's part of it. Nothing is copied where ``value`` is the
    tensor ``t`` holds."""
    if not _is_dtensor(t):
        if value.data_ptr() != t.data_ptr():
            t.copy_(value)
        return
    mesh = t.device_mesh
    names = tuple(mesh.mesh_dim_names)
    part = value
    for i, pl in enumerate(t.placements):   # the major axis of a dim first
        if (not pl.is_shard() or mesh.size(i) == 1
                or names[i] in _kept(keep, pl.dim)):
            continue
        n, r = mesh.size(i), mesh.get_local_rank(names[i])
        size = part.shape[pl.dim] // n
        part = part.narrow(pl.dim, r * size, size)
    loc = t.to_local()
    if part.data_ptr() != loc.data_ptr() or part.shape != loc.shape:
        loc.copy_(part)
