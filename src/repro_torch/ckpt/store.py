"""Checkpointing: npz arrays + JSON metadata, an atomic pointer, an async
writer.

Layout (the JAX package's ``ckpt/store.py``, file for file):

    <dir>/step_000123/arrays.npz      the tree's leaves (key = "/"-joined path)
    <dir>/step_000123/meta.json       step, pipeline manifest, caller's meta
    <dir>/LATEST                      atomic pointer file (rename-committed)

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or numbers; dict keys walk in sorted order, as a JAX pytree's do,
and a ``None`` is an empty subtree (a NamedTuple, such as a
``TrainState``, walks as a tuple and comes back as its own type). Restore rebuilds the structure of a
template and gives every leaf its template's dtype (a tensor leaf comes
back as a tensor on its template's device; bf16 tensors travel as their
16-bit patterns), so a restored tree is the saved one bit for bit.

Whole-pipeline checkpoints (:func:`save_pipeline` /
:func:`restore_pipeline`) bundle what a partitioning loop owns into one
manifest in ``meta.json``: the decider's ``state_dict`` (a balancer, a
workflow balancer or a serving engine, by kind), any in-flight progress,
and ``kernels.autotune.cache_state()``. The splits in that snapshot fix
each launch's blocks and so the order of every float sum.

Kill/restore tick parity: a replica killed after its step-t checkpoint and
restored from it makes a bitwise-identical step t+1 (the same splits,
family selection and posterior update), because every input of the next
tick is in the manifest or is deterministic code. ``sim/chaos.py`` holds
it continuously. A pipeline save and a restore are ``audit.ckpt_save`` and
``audit.ckpt_restore`` events (``obs``); no trace state goes into any
manifest, so a restored replica starts a fresh trace whose first record is
its restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..obs import events as obs_events

__all__ = ["save", "restore", "latest_step", "save_pipeline",
           "restore_pipeline", "CheckpointManager"]

_SEP = "/"


def _pipeline_kind(decider) -> str:
    """Manifest kind, by the decider's type: ``engine`` (a
    ``WorkflowEngine``, restored against code-side templates),
    ``workflow`` (a ``WorkflowBalancer``, against its DAG) or ``balancer``
    (any decider with an ``UncertaintyAwareBalancer``-shaped state)."""
    name = type(decider).__name__
    if name == "WorkflowEngine":
        return "engine"
    return "workflow" if name == "WorkflowBalancer" else "balancer"


def _children(node):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _walk(tree, path=()):
    """(path, leaf) pairs in pytree order; None is an empty subtree."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield path, tree
        return
    for k, child in kids:
        yield from _walk(child, path + (str(k),))


def _host(leaf) -> np.ndarray:
    """A leaf as a host array (a bf16 tensor as its 16-bit patterns)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    return {_SEP.join(path): _host(leaf) for path, leaf in _walk(tree)}


def _like(arr: np.ndarray, leaf):
    """``arr`` in the type, dtype and device of the template's ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            t = torch.from_numpy(arr.astype(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr.astype(_host(leaf).dtype))
        return t.to(leaf.device)
    return arr.astype(np.asarray(leaf).dtype)


def _remake(template, items):
    """A tuple or list like ``template`` (a NamedTuple by its fields)."""
    if hasattr(template, "_fields"):
        return type(template)(*items)
    return type(template)(items)


def _rebuild(template, flat: dict, path=()):
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        key = _SEP.join(path)
        if key not in flat:
            raise ValueError(
                f"checkpoint restore: leaf {key!r} missing from the saved "
                f"arrays (template and checkpoint structures diverged; "
                f"saved keys: {sorted(flat)[:8]}...)")
        arr = flat[key]
        want = tuple(np.shape(template))
        if tuple(arr.shape) != want:
            raise ValueError(
                f"checkpoint restore: leaf {key!r} shape mismatch — "
                f"expected {want} (template), found {tuple(arr.shape)} "
                f"(checkpoint); the run being restored was saved with a "
                f"different fleet/model shape")
        return _like(arr, template)
    out = {k: _rebuild(c, flat, path + (str(k),)) for k, c in kids}
    if isinstance(template, dict):
        return {k: out[k] for k in template}
    return _remake(template, [out[i] for i in range(len(template))])


def _to_host(tree):
    """The tree with every tensor leaf copied to a host array (before a
    write on another thread: the caller may go on changing its tensors)."""
    kids = _children(tree)
    if kids is None:
        return _host(tree) if isinstance(tree, torch.Tensor) else tree
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return _remake(tree, [_to_host(v) for v in tree])


def save(directory: str, step: int, tree, meta: Optional[dict] = None) -> str:
    """Write the checkpoint of ``step``; commit by an atomic LATEST
    rename."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(directory, f".tmp_{name}")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **_flatten(tree))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, **(meta or {})}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    ptr_tmp = os.path.join(directory, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(name)
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> Optional[int]:
    """Step of the LATEST pointer, or None when there is no usable one.

    A corrupt or empty pointer falls back to the newest complete step
    directory on disk instead of raising: restore after a crash is when
    this runs, and a damaged pointer must not make a good checkpoint
    unreachable. A step directory is complete once its ``meta.json``
    exists (it is written last).
    """
    ptr = os.path.join(directory, "LATEST")
    if os.path.exists(ptr):
        try:
            with open(ptr) as f:
                text = f.read().strip()
            if text:
                return int(text.split("_")[-1])
        except (OSError, ValueError):
            pass
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and os.path.exists(
                os.path.join(directory, d, "meta.json")):
            try:
                steps.append(int(d.split("_")[-1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore(directory: str, template,
            step: Optional[int] = None) -> Tuple[Any, dict]:
    """Load ``(tree, meta)``; ``template`` gives the structure, dtypes,
    shapes and devices."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return _rebuild(template, flat), meta


def _manifest(decider, inflight, autotune: bool) -> dict:
    from ..kernels import autotune as _autotune  # lazy: layering
    return {
        "kind": _pipeline_kind(decider),
        "balancer": decider.state_dict(),
        "inflight": inflight,
        "autotune": _autotune.cache_state() if autotune else None,
    }


def save_pipeline(directory: str, step: int, balancer, *,
                  inflight: Optional[dict] = None, autotune: bool = True,
                  tree=None, meta: Optional[dict] = None) -> str:
    """One crash-consistent manifest for a whole partitioning pipeline, in
    one atomically committed step directory: ``balancer.state_dict()`` (a
    balancer, a ``WorkflowBalancer`` or a ``WorkflowEngine``), ``inflight``
    (any JSON-serializable progress, such as a simulator's state), the
    autotune cache (so the restored replica launches the same splits) and
    optionally an array ``tree`` beside it. Restore with
    :func:`restore_pipeline`."""
    manifest = _manifest(balancer, inflight, autotune)
    path = save(directory, step, tree if tree is not None else {},
                meta={**(meta or {}), "pipeline": manifest})
    obs_events.ckpt_save(step, manifest["kind"], path)
    return path


def restore_pipeline(directory: str, *, dag=None, template=None,
                     templates=None, step: Optional[int] = None,
                     autotune: bool = True, device="cuda"):
    """Restore a :func:`save_pipeline` manifest, solving on ``device``.

    Returns ``(decider, inflight, meta)`` (with the restored ``tree`` in
    ``meta["tree"]`` when a ``template`` is given). ``dag`` is required for
    a workflow-kind checkpoint and ``templates`` (name -> StageDAG) for an
    engine-kind one: the graphs are code-side configuration. With
    ``autotune`` the saved cache is loaded into the process, so the next
    tick launches the same splits.
    """
    from ..sched.balancer import (UncertaintyAwareBalancer,
                                  WorkflowBalancer)  # lazy: layering
    tree, meta = restore(directory, template if template is not None else {},
                         step=step)
    manifest = meta.get("pipeline")
    if manifest is None:
        raise ValueError(
            f"checkpoint in {directory} has no 'pipeline' manifest — it was "
            f"written by save(), not save_pipeline()")
    if manifest["kind"] == "engine":
        from ..serve.engine import WorkflowEngine  # lazy: layering
        if templates is None:
            raise ValueError("engine-kind checkpoint needs the templates= "
                             "mapping the engine was built against")
        decider = WorkflowEngine.from_state_dict(manifest["balancer"],
                                                 templates, device=device)
    elif manifest["kind"] == "workflow":
        if dag is None:
            raise ValueError("workflow-kind checkpoint needs the dag= the "
                             "balancer was built against")
        decider = WorkflowBalancer.from_state_dict(manifest["balancer"], dag,
                                                   device=device)
    else:
        decider = UncertaintyAwareBalancer.from_state_dict(
            manifest["balancer"], device=device)
    if autotune and manifest.get("autotune"):
        from ..kernels import autotune as _autotune  # lazy: layering
        _autotune.load_cache_state(manifest["autotune"])
    obs_events.ckpt_restore(int(meta.get("step", -1)), manifest["kind"],
                             directory)
    if template is not None:
        meta = dict(meta)
        meta["tree"] = tree
    return decider, manifest.get("inflight"), meta


class CheckpointManager:
    """Interval-gated asynchronous checkpoints with bounded retention: one
    writer thread at a time; tensors are copied to the host on the
    caller's thread before it starts."""

    def __init__(self, directory: str, interval: int = 100, keep: int = 3):
        self.dir = directory
        self.interval = interval
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def _write(self, step: int, host_tree, meta: Optional[dict],
               blocking: bool) -> None:
        if self._thread is not None:
            self._thread.join()

        def work():
            save(self.dir, step, host_tree, meta)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def maybe_save(self, step: int, tree, meta: Optional[dict] = None,
                   blocking: bool = False) -> bool:
        if step % self.interval != 0:
            return False
        self._write(step, _to_host(tree), meta, blocking)
        return True

    def maybe_save_pipeline(self, step: int, balancer, *,
                            inflight: Optional[dict] = None, tree=None,
                            meta: Optional[dict] = None,
                            blocking: bool = False) -> bool:
        """Interval-gated :func:`save_pipeline` through the async writer.
        The manifest is taken on the caller's thread, so it is this tick
        boundary's even if the decider moves on while the write runs."""
        if step % self.interval != 0:
            return False
        manifest = _manifest(balancer, inflight, True)
        self._write(step, _to_host(tree) if tree is not None else {},
                    {**(meta or {}), "pipeline": manifest}, blocking)
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(int(d.split("_")[-1]) for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
