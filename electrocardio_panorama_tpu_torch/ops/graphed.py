"""A train-phase function replayed from two CUDA graphs, forward and
backward, behind one autograd Function: the host issues one graph launch
where it issued every kernel of the function and of its gradient.

`GraphedTrain(fn)` wraps `fn(params, *tensors) -> tuple of tensors`, a pure
function of its parameters and inputs (no state it updates, no collective,
no host synchronization; no parameter read that it does not differentiate,
since only those are held as static inputs). Its first CUDA call runs `fn` eagerly: the
warm-up, in which cuDNN measures every key of `conv1d_measured` as the
eager step does, with the memory that step holds (the cap of the find's
trials rests on it: ops/convs.py::_find_headroom). The second call captures
the forward and the backward into one private memory pool, where no key is
new, and every call from then on replays them. The static buffers are the
capturing call's own tensors: the parameters (aliased, never copied: the
optimizer updates them in place) and the inputs; a later call copies its
inputs into them where they live elsewhere. One graph pair is kept, for the
shapes, dtypes and device of the first call's tensors; a call with others
runs `fn` eagerly. The graphs die with the object.

The gradients a replay returns alias the backward graph's buffers until its
next replay: autograd may take them as `.grad`, so the caller sets `.grad` to
None before each step (`Solver.train_step`'s `zero_grad(set_to_none=True)`).
"""

from __future__ import annotations

import collections

import torch

# "warmups" (first calls, eager) and "captures"; "replays_fwd" /
# "replays_bwd"; "eager.<reason>": other CUDA calls that ran without a graph
# ("mesh": the owner runs under a device mesh; "new_shape": tensors of other
# shapes, dtypes or device than the first call's)
GRAPHED: collections.Counter = collections.Counter()


class _Graphs:
    """The captured pair: static inputs (the parameters `fn` differentiates,
    then the tensors), outputs, gradient inputs and parameter gradients."""

    def __init__(self, fn, params: dict, tensors: tuple):
        static = {k: v.detach().requires_grad_(v.requires_grad) for k, v in params.items()}
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        with torch.cuda.graph(self.fwd, pool=pool):
            outs = fn(static, *tensors)
        self.grad_outputs = [torch.empty_like(o) for o in outs]
        with torch.cuda.graph(self.bwd, pool=pool):
            grads = torch.autograd.grad(outs, list(static.values()), self.grad_outputs, allow_unused=True)
        self.names = [k for k, g in zip(static, grads) if g is not None]
        self.grads = [g for g in grads if g is not None]
        self.inputs = [*(static[k] for k in self.names), *tensors]
        self.outputs = [o.detach() for o in outs]
        GRAPHED["captures"] += 1


def _copy_in(static, given) -> None:
    for s, t in zip(static, given):
        if s.data_ptr() != t.data_ptr():
            s.copy_(t)


class _Replay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, graphs, *inputs):
        ctx.graphs = graphs
        _copy_in(graphs.inputs, inputs)
        graphs.fwd.replay()
        GRAPHED["replays_fwd"] += 1
        return tuple(o.detach() for o in graphs.outputs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grad_outputs):
        g = ctx.graphs
        _copy_in(g.grad_outputs, grad_outputs)
        g.bwd.replay()
        GRAPHED["replays_bwd"] += 1
        return (None, *(d.detach() for d in g.grads), *[None] * (len(g.inputs) - len(g.grads)))


class GraphedTrain:
    """`fn(params, *tensors)` replayed from CUDA graphs on CUDA tensors (see
    the module's docstring), eagerly on the CPU, and eagerly on CUDA where
    `eager` names why every call must be (counted as `eager.<reason>`)."""

    def __init__(self, fn, *, eager: str | None = None):
        self.fn = fn
        self.eager = eager
        self._key = None
        self._graphs = None

    def __call__(self, params: dict, *tensors):
        if not tensors[0].is_cuda:
            return self.fn(params, *tensors)
        key = tuple((t.shape, t.dtype, t.device) for t in tensors)
        reason = self.eager or (None if self._key in (None, key) else "new_shape")
        if reason is not None:
            GRAPHED[f"eager.{reason}"] += 1
            return self.fn(params, *tensors)
        if self._key is None:
            self._key = key
            GRAPHED["warmups"] += 1
            return self.fn(params, *tensors)
        if self._graphs is None:
            self._graphs = _Graphs(self.fn, params, tensors)
        g = self._graphs
        return _Replay.apply(g, *(params[k] for k in g.names), *tensors)
