"""Wrapper of the CUDA flash-decode kernels (``csrc/attention.cu``).

:func:`flash_decode` attends one query group per kv head over a KV cache
with an ``(S,)`` validity mask, with online softmax and the probabilities
in float32. It replaces the Pallas TPU kernel of the JAX package's
``kernels/flash_decode.py``; unlike that wrapper it takes any cache length
S (the kernel masks the ragged tail itself), such as the
``prompt + max_new`` caches of ``serve.ServeEngine``.

The cache is split along S across blocks (:func:`decode_splits` picks the
count from the shape and the card's SM count): each block streams its
slots and writes a float32 partial (m, l, acc), and a second small kernel
merges the splits in split order. A short cache takes one split, whose
block writes the output directly. ``ref.decode_attention_split_ref`` is
the same arithmetic in plain PyTorch.

On a CUDA tensor it launches the kernels or raises; on a CPU tensor it
runs the plain version, ``kernels/ref.decode_attention_ref``. The kernels
take contiguous q, k, v and valid with 16-byte aligned rows (D times the
element size a multiple of 16), G <= ``MAX_GROUP`` and D <= ``MAX_HEAD_DIM``,
and live in the library of ``kernels/flash_attention.py``. ``LAUNCHES``
counts calls of the wrapper that launched (one per call, whether it ran
one kernel or the split kernel and its combine), so a decode step counts
one launch per layer; :func:`flash_decode_partial`, the partial mode of
a sequence-sharded decode, counts under its own key. The kernels have no
backward: on a CUDA tensor
that needs a gradient (grad mode on) the call raises rather than return an
output with no autograd node.

On a ``meta`` tensor (the dry run's decode cells) either call launches
nothing: after the card's checks it returns empty outputs of the kernels'
shapes and dtypes and records their work (``launch.roofline.decode_work``,
``decode_partial_work``) in the active count. Only a meta tensor takes it.
"""
from __future__ import annotations

import torch

from . import _cuda
from . import flash_attention as _fa
from . import ref
from ..launch import roofline

__all__ = ["flash_decode", "flash_decode_partial", "decode_splits",
           "LAUNCHES", "reset_launches",
           "MAX_GROUP", "MAX_HEAD_DIM", "MAX_GROUP_WIDTH", "MIN_SPLIT"]

MAX_GROUP = 16           # query rows per kv head (the kernel's registers)
MAX_HEAD_DIM = 256
MAX_GROUP_WIDTH = MAX_GROUP * MAX_HEAD_DIM   # G * D
MIN_SPLIT = 256          # the fewest cache slots worth a split of its own

# kernel launches since the last reset_launches()
LAUNCHES = {"flash_decode": 0, "flash_decode_partial": 0}
# SM count per CUDA device index, read once: decode_splits needs it on
# every call, and the property lookup costs more host time than the launch
_SM_COUNT: dict = {}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check_args(q, k, v, valid):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_decode takes q (B, Hkv, G, D) and k, v "
                         f"(B, Hkv, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if (q.shape[0], q.shape[1], q.shape[3]) != (k.shape[0], k.shape[1],
                                                k.shape[3]):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} need "
                         f"one B, Hkv and D")
    if valid.dtype != torch.bool or tuple(valid.shape) != (k.shape[2],):
        raise ValueError(f"valid must be a bool ({k.shape[2]},) mask, got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if q.dtype not in _cuda.DTYPES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k and v must share one dtype in "
                        f"{list(_cuda.DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if any(t.device != q.device for t in (k, v, valid)):
        raise ValueError("q, k, v and valid must lie on one device")


def decode_splits(B: int, Hkv: int, S: int, sm_count: int):
    """(splits, split_len): enough blocks for about four per SM, each split
    at least ``MIN_SPLIT`` slots; split s covers slots
    ``[s * split_len, min(S, (s + 1) * split_len))``, none of them empty."""
    want = -(-4 * sm_count // (B * Hkv))
    splits = max(1, min(want, S // MIN_SPLIT))
    split_len = -(-S // splits)
    return -(-S // split_len), split_len


def _check_kernel(q, k, v, partial: bool):
    """The kernels' terms that need no storage."""
    _cuda.forbid_grad("flash_decode_partial" if partial else "flash_decode",
                      q, k, v, why="training never decodes; ROADMAP.md "
                                   "section 3, item 27")
    G, D = q.shape[2], q.shape[3]
    if G > MAX_GROUP or D > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes G <= {MAX_GROUP} and D <= "
                         f"{MAX_HEAD_DIM} (G * D <= {MAX_GROUP_WIDTH}), got "
                         f"G={G}, D={D}")
    if (D * q.element_size()) % 16:
        raise ValueError(f"the kernel reads 16-byte rows: D * "
                         f"{q.element_size()} bytes must be a multiple of 16,"
                         f" got D={D}")


def _outputs(q, partial: bool):
    """The output, or the (m, l, acc) float32 partial, uninitialised."""
    B, Hkv, G, D = q.shape
    if partial:
        acc = torch.empty((B, Hkv, G, D), dtype=torch.float32,
                          device=q.device)
        ml = torch.empty((B, Hkv, G, 2), dtype=torch.float32,
                         device=q.device)
        return (ml[..., :1], ml[..., 1:], acc), acc, ml
    return torch.empty_like(q), None, None


def _meta(q, k, v, partial: bool):
    """The kernels' outputs on meta tensors, their work recorded."""
    _check_kernel(q, k, v, partial)
    B, Hkv, G, D = q.shape
    work = roofline.decode_partial_work if partial else roofline.decode_work
    roofline.record_kernel(
        "flash_decode_partial" if partial else "flash_decode",
        *work(B, Hkv, G, k.shape[2], D, q.element_size()))
    return _outputs(q, partial)[0]


def _launch(q, k, v, valid, sm_scale, partial: bool):
    """Checks the kernels' terms and launches them on CUDA tensors: the
    output, or with ``partial`` the (m, l, acc) float32 partial."""
    _check_kernel(q, k, v, partial)
    B, Hkv, G, D = q.shape
    S = k.shape[2]
    if not all(t.is_contiguous() for t in (q, k, v, valid)):
        raise ValueError("the kernel takes contiguous q, k, v and valid")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the kernel takes q, k and v at 16-byte aligned "
                         "addresses")
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    out, acc, ml = _outputs(q, partial)
    if q.numel() == 0:
        return out
    dev = q.device.index
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    splits, split_len = decode_splits(B, Hkv, S, _SM_COUNT[dev])
    # the splits' float32 partials: acc (G x D) and (m, l) per row
    part = (torch.empty(B * Hkv * splits * G * (D + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _fa.build()
    ptrs = (_cuda.DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            valid.data_ptr())
    tail = (part.data_ptr() if part is not None else None, B, Hkv, G, S, D,
            splits, split_len, float(scale), stream)
    if partial:
        err = lib.flash_decode_partial_launch(*ptrs, acc.data_ptr(),
                                              ml.data_ptr(), *tail)
        _cuda.check(err, "flash_decode_partial")
        LAUNCHES["flash_decode_partial"] += 1
    else:
        err = lib.flash_decode_launch(*ptrs, out.data_ptr(), *tail)
        _cuda.check(err, "flash_decode")
        LAUNCHES["flash_decode"] += 1
    return out


def flash_decode(q, k, v, valid, *, sm_scale=None):
    """q: (B, Hkv, G, D); k, v: (B, Hkv, S, D); valid: (S,) bool ->
    (B, Hkv, G, D) in q's dtype. A group with no valid slot gives 0."""
    _check_args(q, k, v, valid)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, valid, sm_scale=sm_scale)
    if q.device.type == "meta":
        return _meta(q, k, v, partial=False)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, valid, sm_scale, partial=False)


def flash_decode_partial(q, k, v, valid, *, sm_scale=None):
    """The partial mode: a sequence shard's part of a sharded decode.

    Arguments as in :func:`flash_decode` (the shard's cache slots and
    their mask) -> ``(m, l, acc)`` float32, m and l (B, Hkv, G, 1), acc
    (B, Hkv, G, D): m the max of the valid logits in natural-log units
    (-1e30 where no slot is valid), l the sum of exp(s - m) and acc the
    sum of exp(s - m) v (0 and 0 where none is valid). The split kernel
    runs over the shard's slots as in :func:`flash_decode`, and the
    combine kernel merges its splits in split order and writes (m, l, acc)
    instead of acc / l; the raw split partials are never returned. Its
    plain version (a CPU tensor) is ``ref.decode_attention_partial_ref``.
    ``LAUNCHES["flash_decode_partial"]`` counts it."""
    _check_args(q, k, v, valid)
    if q.device.type == "cpu":
        return ref.decode_attention_partial_ref(q, k, v, valid,
                                                sm_scale=sm_scale)
    if q.device.type == "meta":
        return _meta(q, k, v, partial=True)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, valid, sm_scale, partial=True)
