"""The dedup-history merge: a CUDA kernel for Hopper + its plain version.

Counterpart of `uptune_tpu/ops/dedup.py`.  `History.insert` keeps the
device-resident dedup history as an h0-sorted table; its hot inner
operation is the STABLE TWO-RUN MERGE of the sorted [cap] history with a
freshly sorted [b] batch, the new rows landing at the strictly increasing
output positions `pos_new`, truncated at cap.  Every function here takes
columns with leading instance dims ([..., cap], [..., b]) as well: the
batched engine merges all instances' histories in one call.

* `merge_rows` — the plain PyTorch version, step for step the JAX
  package's `merge_rows_xla` (an `is_new` lane, a cumsum, clipped
  gathers).  The CPU tests use it and `chip_smoke.py` holds the kernel
  against it on the card.
* `merge_rows_cuda` — the wrapper of the kernel in `csrc/merge.cu`,
  which replaces the Pallas TPU kernel `_merge_kernel`: one launch over
  all instances, counted once.
* `merge_rows_kernel` — the merge as the engine calls it: the custom op
  `uptune_tpu_torch::merge_rows`, which routes by the tensors' device,
  with no mode knob (CPU tensors take `merge_rows`, CUDA tensors launch
  the kernel or raise), and whose vmap rule stacks the instances and
  calls the op once more, so `torch.func.vmap` over an engine's commit
  merges every instance in one launch.  (A `ctypes` launch on
  `data_ptr()` cannot run on vmap's batched tensors itself.)
* `merge_history` — computes `pos_new` (one searchsorted) and merges.

Rows are (h0 int64 holding a u32, h1 int64 holding a u32, qor f32,
age i32).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .. import native

Rows = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

_ROW_DTYPES = (torch.int64, torch.int64, torch.float32, torch.int32)

MERGE_KERNEL = native.MERGE


def merge_rows(hist: Rows, new: Rows, pos_new: torch.Tensor) -> Rows:
    """The plain version: stable two-run merge as gathers off one b-row
    scatter — mark the new rows' positions in a [cap+b] lane, and let
    every output slot pull its row through cumsum-derived, clipped
    indices.  Output truncates at cap.  Leading dims are instances."""
    cap = hist[0].shape[-1]
    b = new[0].shape[-1]
    if b == 0:
        return tuple(h.clone() for h in hist)
    dev = hist[0].device
    lead = pos_new.shape[:-1]
    is_new = torch.zeros(lead + (cap + b,), dtype=torch.bool,
                         device=dev).scatter(-1, pos_new.to(torch.int64),
                                             True)
    idx_new = torch.cumsum(is_new.to(torch.int64), -1) - 1
    idx_hist = torch.arange(cap + b, device=dev) - idx_new - 1
    idx_new = torch.clamp(idx_new, 0, b - 1)
    idx_hist = torch.clamp(idx_hist, 0, cap - 1)
    return tuple(torch.where(is_new, n.gather(-1, idx_new),
                             h.gather(-1, idx_hist))[..., :cap]
                 for h, n in zip(hist, new))


def _check_rows(rows: Rows, what: str, shape: tuple, device: torch.device):
    if len(rows) != 4:
        raise ValueError(f"{what}: expected 4 columns, got {len(rows)}")
    for col, dt, t in zip(("h0", "h1", "qor", "age"), _ROW_DTYPES, rows):
        if t.device != device:
            raise ValueError(f"{what}.{col} on {t.device}, expected {device}")
        if t.dtype != dt:
            raise TypeError(f"{what}.{col} is {t.dtype}, expected {dt}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}.{col} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what}.{col} is not contiguous")


def merge_rows_cuda(hist: Rows, new: Rows, pos_new: torch.Tensor) -> Rows:
    """Launch the merge kernel (`csrc/merge.cu`) on CUDA tensors, on the
    current stream: one launch for all n instances (the product of the
    leading dims; none for one history).  `pos_new` is [..., b] int32,
    strictly increasing along its last dim; any b is taken.  Checks
    device, dtype, shape and contiguity, allocates the outputs, and
    raises if the launch fails."""
    dev = hist[0].device
    if dev.type != "cuda":
        raise ValueError(f"merge_rows_cuda needs CUDA tensors, got {dev}")
    lead = tuple(hist[0].shape[:-1])
    cap = hist[0].shape[-1]
    b = new[0].shape[-1]
    _check_rows(hist, "hist", lead + (cap,), dev)
    _check_rows(new, "new", lead + (b,), dev)
    if (pos_new.device != dev or pos_new.dtype != torch.int32
            or tuple(pos_new.shape) != lead + (b,)
            or not pos_new.is_contiguous()):
        raise ValueError(f"pos_new must be a contiguous {lead + (b,)} "
                         f"int32 tensor on {dev}")
    fn = MERGE_KERNEL.function()
    out = tuple(torch.empty_like(h) for h in hist)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in hist), *(t.data_ptr() for t in new),
                 pos_new.data_ptr(), *(t.data_ptr() for t in out),
                 math.prod(lead), cap, b, stream)
    native.check(err, MERGE_KERNEL)
    MERGE_KERNEL.launches += 1
    return out


def _merge_impl(h0, h1, q, age, n0, n1, nq, nage, pos_new):
    hist, new = (h0, h1, q, age), (n0, n1, nq, nage)
    if h0.device.type == "cpu":
        return merge_rows(hist, new, pos_new)
    return merge_rows_cuda(hist, new, pos_new)


_merge_op = torch.library.custom_op(
    "uptune_tpu_torch::merge_rows", _merge_impl, mutates_args=(),
    schema="(Tensor h0, Tensor h1, Tensor q, Tensor age, Tensor n0, "
           "Tensor n1, Tensor nq, Tensor nage, Tensor pos_new) "
           "-> (Tensor, Tensor, Tensor, Tensor)")


def _merge_vmap(info, in_dims, *cols):
    """vmap over the merge: every column gets the instance axis in front
    (a column without one is broadcast) and the op runs once on the
    stack."""
    n = info.batch_size
    cols = [(c.movedim(d, 0) if d is not None
             else c.expand((n,) + tuple(c.shape))).contiguous()
            for c, d in zip(cols, in_dims)]
    return _merge_op(*cols), (0, 0, 0, 0)


_merge_op.register_vmap(_merge_vmap)


def merge_rows_kernel(hist: Rows, new: Rows, pos_new: torch.Tensor) -> Rows:
    """Route one merge by device: CPU tensors take the plain version
    (there is no kernel to run there); CUDA tensors launch the kernel or
    raise — never a fallback, inside `torch.func.vmap` too, where all
    instances merge in one launch."""
    return tuple(_merge_op(*hist, *new, pos_new))


def merge_history(hist: Rows, new: Rows) -> Rows:
    """Merge the h0-sorted batch `new` into the h0-sorted history: old rows
    come before new rows on equal h0 (the History invariant).  h0 holds
    u32 values in int64, so `searchsorted` orders them as unsigned.
    Leading dims are instances."""
    b = new[0].shape[-1]
    pos_new = (torch.arange(b, device=new[0].device)
               + torch.searchsorted(hist[0], new[0], right=True)
               ).to(torch.int32)
    return merge_rows_kernel(hist, new, pos_new)
