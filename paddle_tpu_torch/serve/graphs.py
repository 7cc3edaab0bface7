"""Compile-once serving programs: the port's counterpart of the JAX
engine's two ``jax.jit`` programs.

A :class:`Program` is a function of static buffers. Its per-call values
(token ids, lengths, counters, masks) are int32 entries of a
:class:`StagedInts`: the host writes them into a pinned stage and one
non-blocking ``copy_`` moves the stage to a device buffer at a fixed
address. On the card the program is captured as a CUDA graph on first use
(the counterpart of a trace and compile) and replayed on every later
call; on the CPU (the tests' path) the same body runs eagerly on the same
buffers. The body's output is one int32 tensor, copied back to a pinned
host buffer without blocking; :meth:`Program.fetch` waits for that copy,
so host work placed between :meth:`Program.launch` and
:meth:`Program.fetch` runs while the device works.

A captured graph keeps the dtypes of its capture: the dtype policy (and
the 1x1-conv lowering) current at capture is the one every replay runs,
whatever the policy at the replay, as a jitted JAX function keeps what it
was traced under.

There is no eager path on the card: a capture or replay that fails
raises. The kernel wrappers count launches in Python, which a replay does
not run, so a capture records the launches it saw
(:func:`~paddle_tpu_torch.nn.cuda_attention.capturing_launches`) and
every replay adds them to the counters.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..nn import cuda_attention

__all__ = ["StagedInts", "Program", "GraphPool"]


class StagedInts:
    """Named int32 arrays in one device buffer at a fixed address, filled
    from a host stage by one copy. On the card the stage is pinned and the
    copy does not block; an event recorded after it guards the stage, so
    the host never rewrites it under a copy still in flight. On the CPU
    the stage is the buffer itself."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]], device):
        self.device = torch.device(device)
        sizes = {k: int(np.prod(s, dtype=np.int64)) for k, s in
                 shapes.items()}
        total = max(1, sum(sizes.values()))
        cuda = self.device.type == "cuda"
        self._host = torch.zeros(total, dtype=torch.int32, pin_memory=cuda)
        self._dev = torch.zeros(total, dtype=torch.int32,
                                device=self.device) if cuda else self._host
        self._copied = torch.cuda.Event() if cuda else None
        self.host: Dict[str, np.ndarray] = {}
        self.dev: Dict[str, torch.Tensor] = {}
        host_np = self._host.numpy()
        at = 0
        for k, shape in shapes.items():
            n = sizes[k]
            self.host[k] = host_np[at:at + n].reshape(shape)
            self.dev[k] = self._dev[at:at + n].view(shape)
            at += n

    def stage(self, **values) -> None:
        """Write ``values`` (arrays or scalars, by name) into the stage and
        copy the whole stage to the device buffer. Names left out keep
        their last values."""
        if self._copied is not None:
            self._copied.synchronize()       # the previous copy has read it
        for k, v in values.items():
            self.host[k][...] = v
        if self._dev is not self._host:
            self._dev.copy_(self._host, non_blocking=True)
            self._copied.record()


class GraphPool:
    """The memory pool the programs of one engine capture into, shared so
    that the largest program's activations (the one-shot prefill at the
    full width) are the pool's size, not a sum. The programs replay on one
    stream, one at a time, and each keeps its output alive."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.handle = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None
        self.stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None


@contextlib.contextmanager
def _no_gc() -> Iterator[None]:
    """Python's cyclic garbage collection held off inside the block (a
    CUDA graph capture). A collection there can run a finalizer that
    frees a CUDA resource of an earlier call, which invalidates the
    capture (seen on the card: a capture in a test process failed with
    cudaErrorStreamCaptureInvalidated whenever a collection fell inside
    it, and passed with the collector off); ``torch.cuda.graph``
    collects just before the capture begins."""
    was_on = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_on:
            gc.enable()


class Program:
    """A compile-once entry point: ``body()`` reads :attr:`inputs` (and
    whatever other static buffers it closes over) and returns one int32
    tensor. :meth:`launch` stages the inputs and runs the body (the card:
    captured on first use, replayed after), then starts the copy of the
    output to the host; :meth:`fetch` waits for it. ``builds`` counts
    captures (the CPU: first uses), ``replays`` the replays."""

    def __init__(self, name: str, body: Callable[[], torch.Tensor],
                 shapes: Dict[str, Tuple[int, ...]], pool: GraphPool):
        self.name = name
        self.body = body
        self.inputs = StagedInts(shapes, pool.device)
        self.pool = pool
        self.builds = 0
        self.replays = 0
        self.captured: Dict[str, int] = {}
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[torch.Tensor] = None
        self._host_out: Optional[torch.Tensor] = None
        self._fetched: Optional[torch.cuda.Event] = None

    @property
    def on_card(self) -> bool:
        return self.pool.device.type == "cuda"

    def _capture(self) -> None:
        """One eager run of the body on the capture stream (kernels built
        and loaded, library workspaces made, shared-memory limits set:
        nothing of that may happen inside a capture), then the capture,
        with Python's cyclic garbage collection held off
        (:func:`_no_gc`). The eager run computes what the replay will, so
        it changes no state the replay does not set again; its launches
        count as launches."""
        stream = self.pool.stream
        stream.wait_stream(torch.cuda.current_stream(self.pool.device))
        with torch.cuda.stream(stream), torch.no_grad():
            self.body()
        torch.cuda.current_stream(self.pool.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with _no_gc(), cuda_attention.capturing_launches() as captured, \
                torch.no_grad(), \
                torch.cuda.graph(graph, pool=self.pool.handle,
                                 stream=stream):
            out = self.body()
        self._graph, self._out, self.captured = graph, out, captured
        self._host_out = torch.empty(out.shape, dtype=out.dtype,
                                     pin_memory=True)
        self._fetched = torch.cuda.Event()
        self.builds += 1

    def launch(self, **values) -> None:
        """Stage ``values`` and run the program; the output's copy to the
        host is under way when this returns."""
        self.inputs.stage(**values)
        if not self.on_card:
            if self._out is None:
                self.builds += 1
            with torch.no_grad():
                self._out = self.body()
            return
        if self._graph is None:
            self._capture()
        self._graph.replay()
        self.replays += 1
        cuda_attention.count_replay(self.captured)
        self._host_out.copy_(self._out, non_blocking=True)
        self._fetched.record()

    def fetch(self) -> np.ndarray:
        """The last launch's output on the host (waits for its copy)."""
        if not self.on_card:
            return self._out.numpy().copy()
        self._fetched.synchronize()
        return self._host_out.numpy().copy()

    def run_eager(self) -> torch.Tensor:
        """The body run once, eagerly, on the inputs last staged: the
        function the graph captured, as a yardstick for it."""
        with torch.no_grad():
            return self.body()
