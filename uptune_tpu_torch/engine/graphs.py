"""Replaying the fused engine's phases as captured CUDA graphs.

On the card a fused step is about a thousand small launches, and the
host's launch of each one sets the step's pace.  A `Phase` captures one
phase of `FusedEngine` (the whole step, the proposal or the commit) as
a `torch.cuda.CUDAGraph` over static input tensors, so that a call is a
few copies and one graph launch.  The kernels are the same ones, in the
same order, on the same values, so a replay's results are bitwise those
of the eager code.

Trees.  A state is a tree of tuples (NamedTuples included), tensors and
None.  `flatten` gives its tensors and a hashable spec (the tree, each
tensor's shape and dtype), under which the engine keeps its captures;
anything else in a tree (a Python number, a list, a tensor on another
device) gives no spec, and the engine runs that call eagerly.

Buffers.  A phase's inputs and its outputs each live in one byte buffer
(`Layout`), every tensor a contiguous slice of it at an offset aligned
to 512 bytes, as the caching allocator aligns a fresh tensor, so that a
kernel takes the same vectorized path on a slice as on a fresh tensor.
A call copies the incoming tree into the input buffer with one
`_foreach_copy_` a dtype; the graph packs its outputs into the output
buffer; the caller gets a clone of that buffer (one copy) with the
leaves as views, so a returned state is a value that no later replay
overwrites.

Launch counters.  Capture runs no kernel, so what the hand-written
kernels counted while capturing (`native.counts()`, every counter) is
taken back out; each replay adds the counts its capture recorded.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .. import native

# the distance between the starts of two tensors in a buffer, in bytes
# (the caching allocator's rounding of a block)
ALIGN = 512


class _NoSpec(Exception):
    """A tree the graphs cannot hold."""


def flatten(tree, device: torch.device
            ) -> Optional[Tuple[List[torch.Tensor], tuple]]:
    """(the tensors of `tree` in order, its spec), or None where the tree
    holds something other than tuples, None and tensors on `device`."""
    leaves: List[torch.Tensor] = []
    try:
        spec = _flatten(tree, leaves, device)
    except _NoSpec:
        return None
    return leaves, spec


def _flatten(x, leaves: list, device: torch.device):
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise _NoSpec
        leaves.append(x)
        return (x.shape, x.dtype)
    if isinstance(x, tuple):
        return (type(x), tuple([_flatten(c, leaves, device) for c in x]))
    if x is None:
        return None
    raise _NoSpec


def unflatten(spec: tuple, leaves: Sequence[torch.Tensor]):
    """The tree of `spec` with `leaves` in place of its tensors."""
    return _build(spec, iter(leaves))


def _build(spec, it):
    if spec is None:
        return None
    head, kids = spec
    if not isinstance(head, type):              # a tensor: (shape, dtype)
        return next(it)
    parts = [_build(k, it) for k in kids]
    return head(*parts) if hasattr(head, "_fields") else head(parts)


class Layout:
    """Tensors of given shapes and dtypes laid in one byte buffer: each a
    contiguous slice starting at a multiple of `ALIGN` bytes."""

    def __init__(self, metas: Sequence[Tuple[torch.Size, torch.dtype]],
                 device: torch.device):
        self.device = device
        self.slots = []                 # (dtype, shape, strides, offset)
        end = 0
        for shape, dt in metas:
            strides = [1] * len(shape)
            for i in range(len(shape) - 2, -1, -1):
                strides[i] = strides[i + 1] * shape[i + 1]
            self.slots.append((dt, shape, tuple(strides),
                               end // dt.itemsize))
            end += -(-math.prod(shape) * dt.itemsize // ALIGN) * ALIGN
        self.nbytes = max(end, ALIGN)
        self.dtypes = list(dict.fromkeys(dt for _, dt in metas))
        # the slots of each dtype, for one foreach copy a dtype
        self.groups = [[i for i, m in enumerate(metas) if m[1] == dt]
                       for dt in self.dtypes]

    def alloc(self) -> torch.Tensor:
        return torch.empty(self.nbytes, dtype=torch.uint8,
                           device=self.device)

    def views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """The tensors over `buf` (a buffer of this layout)."""
        typed = {dt: buf.view(dt) for dt in self.dtypes}
        return [typed[dt].as_strided(shape, strides, off)
                for dt, shape, strides, off in self.slots]

    def copy(self, views: Sequence[torch.Tensor],
             leaves: Sequence[torch.Tensor]) -> None:
        """views[i] <- leaves[i], one foreach copy a dtype."""
        for idx in self.groups:
            torch._foreach_copy_([views[i] for i in idx],
                                 [leaves[i] for i in idx])


class Phase:
    """One phase captured as a CUDA graph: `fn(*args)`, where `args` are
    trees over static input tensors that the caller fills before each
    `replay`.  Its output tree lies in one buffer: `static` is the tree
    over it, overwritten by the next replay; `fresh()` a copy.

    Before capture `fn` runs once eagerly on a side stream over the
    same inputs (lazy set-up: the kernels' libraries, the codec tables,
    the draw streams' block sizes), as the CUDA graph documentation asks.
    Raises where `fn` cannot be captured (a host read, a synchronising
    copy) or its output is not a tree of tensors on `device`; the launch
    counters are restored either way."""

    def __init__(self, fn: Callable, args: tuple, device: torch.device):
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn(*args)
        cur.wait_stream(side)
        before = native.counts()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                flat = flatten(fn(*args), device)
                if flat is None:
                    raise TypeError("a phase's output must be a tree of "
                                    f"tuples and tensors on {device}")
                leaves, self.spec = flat
                self.layout = Layout([(t.shape, t.dtype) for t in leaves],
                                     device)
                self.buf = self.layout.alloc()
                views = self.layout.views(self.buf)
                self.layout.copy(views, leaves)
        finally:
            # a capture that fails leaves the capture stream current
            torch.cuda.set_stream(cur)
            self.counts = native.counts() - before
            native.restore(before)
        self.static = unflatten(self.spec, views)

    def replay(self) -> None:
        self.graph.replay()
        native.add(self.counts)

    def fresh(self):
        """The output tree of the last replay, in a buffer of its own."""
        return unflatten(self.spec, self.layout.views(self.buf.clone()))


class Captures:
    """The phases captured for one state structure: the state's static
    copy (`state`, filled by `load`) and the phases over it, by key
    (`phases`; None for one that cannot be captured), with the static
    inputs a phase takes besides the state (`inputs`)."""

    def __init__(self, leaves: Sequence[torch.Tensor], spec: tuple,
                 device: torch.device):
        self.device = device
        self.layout = Layout([(t.shape, t.dtype) for t in leaves], device)
        self.views = self.layout.views(self.layout.alloc())
        self.state = unflatten(spec, self.views)
        self.phases = {}
        self.inputs = {}

    def load(self, leaves: Sequence[torch.Tensor]) -> None:
        self.layout.copy(self.views, leaves)
