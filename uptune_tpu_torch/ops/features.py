"""The GP's query features in one kernel (`csrc/features.cu`).

`Space.surrogate_features(cands)` is `surrogate_transform(features(
cands))`: on the CPU that chain of torch ops, on a CUDA batch one launch
of `native.FEATURES`, which computes the same float32 features bitwise
(the arithmetic and its rounding are in the kernel's source).  The
kernel reads the Space's `feature_tables` besides the batch, so a call
allocates its output alone and copies nothing to the device.

* `features_cuda` — the wrapper: checks the operands, allocates the
  output and launches once for all rows (none for an empty batch),
  counting the rows as the kernel's `elements`.
* `surrogate_features` — the entry: any leading dims, the perm blocks
  side by side in one tensor, through the custom op
  `uptune_tpu_torch::surrogate_features`, whose vmap rule stacks the
  instances' rows into one launch (a `ctypes` launch on `data_ptr()`
  cannot see vmap's batched tensors), as `acquire_topk`'s op does.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from .. import native


def features_cuda(u: torch.Tensor, perm: torch.Tensor, kind: torch.Tensor,
                  lanes: torch.Tensor, cols: torch.Tensor,
                  items_of: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream over [B, D] unit lanes
    and the [B, P] perm blocks side by side, with the Space's feature
    tables -> [B, F] float32 features."""
    dev = u.device
    if dev.type != "cuda":
        raise ValueError(f"the features kernel needs a CUDA batch, got {dev}")
    if u.dtype != torch.float32 or u.dim() != 2:
        raise ValueError(f"u is [B, D] float32, got {u.dtype} "
                         f"{tuple(u.shape)}")
    b, d = u.shape
    p, f = items_of.shape[0], cols.shape[0]
    if (perm.dtype != torch.int64 or perm.shape != (b, p)
            or perm.device != dev):
        raise ValueError(f"perm is [B, P] = [{b}, {p}] int64 on the batch's "
                         f"device, got {perm.dtype} {tuple(perm.shape)} on "
                         f"{perm.device}")
    if kind.shape != (d,):
        raise ValueError("the batch does not match the feature tables")
    if u.stride(-1) != 1:
        u = u.contiguous()
    if perm.stride(-1) != 1:
        perm = perm.contiguous()
    out = torch.empty(b, f, dtype=torch.float32, device=dev)
    if b and f:
        native.FEATURES.launch(dev, u, u.stride(0), perm, perm.stride(0),
                               kind, lanes, cols, items_of, out, b, d, p, f,
                               elements=b)
    return out


def _impl(u, perm, kind, lanes, cols, items_of):
    # the wrapper looked up at each call, so that a CPU test can stand in
    # for the launch
    return features_cuda(u, perm, kind, lanes, cols, items_of)


_op = torch.library.custom_op(
    "uptune_tpu_torch::surrogate_features", _impl, mutates_args=(),
    schema="(Tensor u, Tensor perm, Tensor kind, Tensor lanes, "
           "Tensor cols, Tensor items_of) -> Tensor")


def _vmap(info, in_dims, u, perm, *tables):
    """vmap over the op: the instances' rows stack into one launch; the
    tables are the Space's, shared by every instance."""
    if any(d is not None for d in in_dims[2:]):
        raise ValueError("surrogate_features under vmap takes the instance "
                         "axis on the batch only: the tables are shared")
    n = info.batch_size

    def rows(t, dim):
        t = t.movedim(dim, 0) if dim is not None else t.expand(
            (n,) + tuple(t.shape))
        return t.reshape(n * t.shape[1], t.shape[2])
    out = _op(rows(u, in_dims[0]), rows(perm, in_dims[1]), *tables)
    return out.reshape(n, out.shape[0] // n, out.shape[-1]), 0


_op.register_vmap(_vmap)


def surrogate_features(u: torch.Tensor, perms: Sequence[torch.Tensor],
                       tables) -> torch.Tensor:
    """[..., D] unit lanes and [..., s_k] perm blocks on the card, with
    `Space.feature_tables` -> [..., F] features, one launch.  The blocks
    go to the kernel side by side: a space with one block passes it as
    it is."""
    lead = tuple(u.shape[:-1])
    if len(perms) == 1:
        perm = perms[0]
    elif perms:
        perm = torch.cat(tuple(perms), dim=-1)
    else:
        perm = u.new_empty(lead + (0,), dtype=torch.int64)
    b = math.prod(lead)
    out = _op(u.reshape(b, u.shape[-1]), perm.reshape(b, perm.shape[-1]),
              *tables)
    return out.reshape(lead + (out.shape[-1],))
