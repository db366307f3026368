"""A step function replayed as CUDA graphs, one capture per branch.

The estimator's steady-state step runs thousands of small kernels; on
the card it is captured once per branch (keyframe, non-keyframe) and
replayed each frame, so a frame's backend costs no Python per op.

    graph = StepGraph(step_fn, device)
    outputs = graph(key, inputs)

`step_fn(key, inputs)` maps a pytree of tensors to a pytree of tensors
and must not synchronize with the host: no `.item()`, no tensor made
from host data, no data-dependent shape. The one exception is a call
made through `host_synced(fn, *tensors)`: a library call that checks its
result on the host (`torch.linalg.eigh`, `torch.linalg.svd`). Capture
ends the current graph before such a call and starts the next one after
it, so a branch is a chain of graph segments with the host-synced calls
run eagerly between them, on static buffers.

On the card `inputs` are copied into static tensors that the graphs
read (host tensors in pinned memory upload asynchronously), and the
returned outputs are static tensors that the next call overwrites. On
the CPU the step runs eagerly on `inputs` and `host_synced` calls
through. A capture or a replay that fails raises; nothing falls back to
eager execution on the card.
"""

from __future__ import annotations

import contextvars

import torch
from torch.utils import _pytree as pytree

_CAPTURE = contextvars.ContextVar("step_graph_capture", default=None)


def host_synced(fn, *args):
    """fn(*args) for a call that synchronizes with the host. Inside a
    capture it runs between two graph segments (see module docstring);
    returns a tuple of fn's outputs."""
    chain = _CAPTURE.get()
    if chain is None:
        return tuple(fn(*args))
    return chain.split(fn, args)


class _Chain:
    """The graph segments of one branch and the eager calls between."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = []
        self.calls = []       # (fn, static inputs, static outputs)
        self._graph = None

    def begin(self):
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool)

    def end(self):
        self._graph.capture_end()
        self.graphs.append(self._graph)
        self._graph = None

    def split(self, fn, args):
        ins = tuple(a.clone() for a in args)    # in the graph's pool
        self.end()
        # run once, outside capture, for the outputs' shapes; the
        # inputs hold nothing yet, so feed zeros
        outs = tuple(fn(*(torch.zeros_like(a) for a in ins)))
        self.calls.append((fn, ins, outs))
        self.begin()
        return outs

    def abort(self):
        if self._graph is not None:
            try:
                self._graph.capture_end()
            except RuntimeError:
                pass
            self._graph = None

    def replay(self, mark=None):
        """Run the segments in order with the calls between them; calls
        `mark()`, if given, after each segment and each call. A segment
        reads pool memory that the segments before it in the same replay
        wrote, so it cannot be replayed on its own."""
        for i, g in enumerate(self.graphs):
            g.replay()
            if mark is not None:
                mark()
            if i < len(self.calls):
                fn, ins, outs = self.calls[i]
                for o, r in zip(outs, fn(*ins)):
                    o.copy_(r)
                if mark is not None:
                    mark()


class StepGraph:
    """step_fn on the card as one graph chain per key (see module
    docstring); the chains of all `keys` are captured at the first call.
    `replays` counts the chains replayed, per key."""

    def __init__(self, step_fn, device, keys=()):
        self.fn = step_fn
        self.device = torch.device(device)
        self.keys = tuple(keys)
        self.inputs = None        # static, on the card
        self.outputs = None       # static, shared by every key
        self.chains = {}
        self.replays = {}

    @property
    def on_card(self):
        return self.device.type == "cuda"

    def segments(self, key):
        return len(self.chains[key].graphs)

    def host_syncs(self, key):
        """Host synchronizations inside one replay of key's chain."""
        return len(self.chains[key].calls)

    def __call__(self, key, inputs):
        if not self.on_card:
            return self.fn(key, inputs)
        self.load(inputs)
        return self.replay(key)

    def load(self, inputs):
        """Copy inputs into the static tensors (allocated at first use)."""
        if self.inputs is None:
            self.inputs = pytree.tree_map(
                lambda t: t.to(self.device, copy=True), inputs)
        else:
            pytree.tree_map(lambda d, s: d.copy_(s, non_blocking=True),
                            self.inputs, inputs)

    def replay(self, key):
        """Replay key's chain on the static inputs (capture at first use)."""
        for k in (key,) + self.keys:
            if k not in self.chains:
                self.capture(k)
        self.chains[key].replay()
        self.replays[key] = self.replays.get(key, 0) + 1
        return self.outputs

    def capture(self, key):
        """Warm up on a side stream, then capture key's chain."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            out = self.fn(key, self.inputs)
            if self.outputs is None:
                self.outputs = pytree.tree_map(torch.empty_like, out)
            del out
        torch.cuda.synchronize(self.device)
        chain = _Chain()
        token = _CAPTURE.set(chain)
        try:
            with torch.cuda.stream(side):
                chain.begin()
                out = self.fn(key, self.inputs)
                pytree.tree_map(lambda d, s: d.copy_(s), self.outputs, out)
                del out
                chain.end()
        except BaseException:
            chain.abort()
            raise
        finally:
            _CAPTURE.reset(token)
        torch.cuda.synchronize(self.device)
        self.chains[key] = chain
        self.replays.setdefault(key, 0)
