"""Spans: named profiler ranges inside the port, on the device trace's
clock.

A span is a ``torch.profiler.record_function`` range, so it lands in the
same Kineto trace as the CUDA kernels, and each kernel is tagged with the
spans open on the thread that launched it. Spans are on exactly while a
profiler records: profile a few steps to see them. With no profiler a span
costs one flag check, and the autograd graph is node for node the one
without spans.

    span(name)            a forward range around a block of code
    region(name, fn, *a)  ``fn(*a)`` under ``span(name)``, and ``<name>.bwd``
                          around its backward, on whatever thread autograd
                          runs it (the device thread for CUDA tensors)
    step_bwd(loss)        ``step.bwd``: from the start of the loss's
                          backward to the end of its graph task
    layer_span()          ``layer.recompute`` when a layer runs inside a
                          backward (checkpoint's recompute), else
                          ``layer.fwd``

``region`` puts an identity ``torch.autograd.Function`` (``_Mark``) on
each side of the block: at its inputs, whose backward closes the range,
and at its outputs, whose backward opens it. Both pass every gradient
through unchanged (None stays None) and launch nothing. The range holds every
node of the block's backward: autograd runs a ready node with a higher
sequence number first, and the block's nodes were made after its input
marker and before its output marker.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.autograd import Function
from torch.autograd.profiler import record_function
from torch.autograd.variable import Variable

_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str, args: Optional[str] = None):
    """A profiler range `name` (`args`: record_function's string argument)
    while a profiler records, else a shared no-op context."""
    if not _enabled():
        return _OFF
    return record_function(name, args)


def layer_span():
    """``layer.recompute`` inside a backward (checkpoint's recompute), else
    ``layer.fwd``, while a profiler records."""
    if not _enabled():
        return _OFF
    in_backward = torch._C._current_graph_task_id() != -1
    return record_function("layer.recompute" if in_backward else "layer.fwd")


class _Range:
    """A range opened and closed from backward nodes."""

    def __init__(self, name: str):
        self.rec = record_function(name)

    def open(self) -> None:
        self.rec.__enter__()

    def close(self) -> None:
        self.rec.__exit__(None, None, None)

    def open_to_end(self) -> None:
        """Open now; close when the running graph task ends."""
        self.open()
        Variable._execution_engine.queue_callback(self.close)


class _Mark(Function):
    """Identity on its tensors; its backward calls `edge` (a range's
    ``open``, ``close`` or ``open_to_end``) and passes every gradient on
    as it came."""

    @staticmethod
    def forward(ctx, edge, *xs):
        ctx.edge = edge
        ctx.set_materialize_grads(False)
        return xs

    @staticmethod
    def backward(ctx, *gs):
        ctx.edge()
        return (None,) + gs


def _mark(edge, values: tuple) -> tuple:
    """`values` with the tensors that require grad passed through one
    :class:`_Mark` calling `edge`."""
    idx = [i for i, v in enumerate(values)
           if isinstance(v, torch.Tensor) and v.requires_grad]
    if not idx:
        return values
    out = list(values)
    for i, v in zip(idx, _Mark.apply(edge, *(values[i] for i in idx))):
        out[i] = v
    return tuple(out)


def _needs_grad(values) -> bool:
    return any(isinstance(v, torch.Tensor) and v.requires_grad
               for v in values)


def region(name: str, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` under ``span(name)``; while a profiler
    records and gradients flow through the tensors among `args` to a tensor
    among its outputs (one tensor or a tuple), ``<name>.bwd`` spans their
    backward."""
    if not _enabled():
        return fn(*args, **kwargs)
    if not (torch.is_grad_enabled() and _needs_grad(args)):
        with record_function(name):
            return fn(*args, **kwargs)
    rng = _Range(name + ".bwd")
    args = _mark(rng.close, args)
    with record_function(name):
        out = fn(*args, **kwargs)
    single = isinstance(out, torch.Tensor)
    outs = _mark(rng.open, (out,) if single else tuple(out))
    return outs[0] if single else outs


def step_bwd(loss: torch.Tensor) -> torch.Tensor:
    """`loss`, marked so that its backward is spanned by ``step.bwd`` while
    a profiler records."""
    if not (_enabled() and loss.requires_grad):
        return loss
    return _Mark.apply(_Range("step.bwd").open_to_end, loss)[0]
