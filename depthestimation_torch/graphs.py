"""One callable captured as a CUDA graph and replayed.

The counterpart of the JAX package's compiled-program caches (jax.jit per
(config, shape) in depthestimation_tpu/pipeline.py, api.py,
models/mono.py, models/train.py and parallel/shard.py): a jitted function
there runs a frame or a train step as one dispatch, and a CapturedCall
here runs it as one graph launch instead of the thousands of kernel
launches the eager PyTorch code makes. The caches that hold one
CapturedCall per key live with their callers (StereoPipeline.
_graph_cache, StereoDepthEstimatorVideo._stats_cache, MonoDepthModel.
_graph_cache, and the graph_cache of the functions that
models/train.make_train_step, make_sharded_predict and
parallel/shard.batch_pipeline return); `cached` makes their entries.

The first call warms up and captures:
- it copies the tensor arguments into static input tensors;
- it runs the callable once, eagerly, on a side stream (as
  torch.cuda.graphs asks): that builds the kernel library, uploads
  anything a function caches on the device and loads every kernel, none
  of which a capture allows;
- it captures a second run under torch.cuda.graph, on that side stream,
  into a memory pool of the graph's own;
- it returns the warm-up's outputs.
Every later call copies its arguments into the static inputs, replays the
graph on the current stream and returns fresh copies of the graph's
outputs (one device-to-device copy each): a caller that holds one call's
result never sees the next call overwrite it. Calls are ordered on the
caller's current stream; one CapturedCall is not replayed from two
streams at once.

A capture that fails (a host synchronisation, a pageable host-to-device
copy, an allocation the capture refuses) raises RuntimeError; so does a
replay. Nothing here runs the callable eagerly in place of a replay.

A graph that captured NCCL collectives (the train step's, the sharded
predict's, a tiled batch_pipeline's: made with collectives=True) holds
that work of its communicators, and NCCL's teardown of a communicator
waits until no graph holds its work: torch.distributed.
destroy_process_group() with such a graph alive never returns.
release_collective_graphs() drops every such graph that is still alive
(a later call captures again); parallel/mesh.destroy_process_group()
calls it before it ends the group, and so does the interpreter's exit.

Launch counts: the kernel wrappers count while a graph is captured, though
nothing runs then. The capture takes that change of cuda_build.LAUNCHES
and CALLS back and adds it again on every replay, so the counts are the
launches the card ran.
"""

from __future__ import annotations

import atexit
import contextlib
import gc
import time
import weakref

import torch

from .ops import cuda_build

__all__ = ["CapturedCall", "cached", "release_collective_graphs", "tf32_flags"]

# The CapturedCalls made with collectives=True that are still alive.
_COLLECTIVE = weakref.WeakSet()


@contextlib.contextmanager
def _cudnn_fixed():
    """cuDNN's benchmark mode off, every other flag as it is: a warm-up
    and a capture pick the convolution algorithms that an eager call with
    the default flags picks."""
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = prev


def tf32_flags():
    """cuDNN's and cuBLAS's TF32 switches, part of a key wherever a graph
    holds convolutions or matrix products: a graph keeps the kernels its
    capture chose."""
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def cached(cache: dict, key, fn, name: str, device, collectives: bool = False):
    """cache[key], made from fn on first use: a CapturedCall of fn on a
    CUDA device, fn itself on any other (the CPU runs eagerly).
    collectives: fn runs NCCL collectives (see release_collective_graphs)."""
    entry = cache.get(key)
    if entry is None:
        entry = (CapturedCall(fn, name, collectives) if torch.device(device).type == "cuda"
                 else fn)
        cache[key] = entry
    return entry


def release_collective_graphs():
    """Drop the graph of every live CapturedCall that captured NCCL
    collectives (CapturedCall.release): NCCL's teardown of a communicator
    (torch.distributed.destroy_process_group) waits until no graph holds
    its work. Each call captures again if called again."""
    for call in list(_COLLECTIVE):
        call.release()


atexit.register(release_collective_graphs)


def _signature(tensors):
    return [(tuple(t.shape), t.dtype, t.device) for t in tensors]


class CapturedCall:
    """fn(*tensors) -> a tensor or a tuple of tensors and Nones, captured
    as a CUDA graph on its first call and replayed on every later one.

    After the first call: `warmup_ms`, `capture_ms` (the capture, its
    synchronisation and clean-up included), `instantiate_ms` and
    `pool_bytes` (device memory the graph's pool holds: its intermediates
    and static outputs); `replays` counts the replays.
    """

    def __init__(self, fn, name: str, collectives: bool = False):
        self.fn = fn
        self.name = name
        self.graph = None
        if collectives:
            _COLLECTIVE.add(self)
        self.replays = 0
        self.warmup_ms = self.capture_ms = self.instantiate_ms = None
        self.pool_bytes = None
        self._inputs = self._outputs = self._counts = None
        self._tuple = False

    def __call__(self, *args):
        if self.graph is None:
            return self._capture(args)
        if _signature(args) != self._signature:
            raise ValueError(f"{self.name}: arguments {_signature(args)} differ from the "
                             f"captured {self._signature}")
        try:
            for static, a in zip(self._inputs, args):
                if a is not static:
                    static.copy_(a)
            self.graph.replay()
        except Exception as exc:
            raise RuntimeError(f"replay of the CUDA graph of {self.name} failed: {exc}") from exc
        cuda_build.add_counts(self._counts)
        self.replays += 1
        return self._result([None if t is None else t.clone() for t in self._outputs])

    def release(self):
        """Drop the graph, its pool and its static tensors once the card
        has run what was enqueued; the next call captures again."""
        if self.graph is not None:
            torch.cuda.synchronize(self._inputs[0].device)
            self.graph.reset()
        self.graph = None
        self._inputs = self._outputs = None

    def _result(self, outs):
        return tuple(outs) if self._tuple else outs[0]

    def _capture(self, args):
        device = args[0].device
        cur = torch.cuda.current_stream(device)
        self._signature = _signature(args)
        self._inputs = [a.clone() for a in args]
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        t0 = time.perf_counter()
        with torch.cuda.stream(side), _cudnn_fixed():
            out = self.fn(*self._inputs)
        cur.wait_stream(side)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        self._tuple = isinstance(out, tuple)
        # An output that is a static input would be overwritten by the
        # next call's arguments.
        inputs = {t.untyped_storage().data_ptr() for t in self._inputs}
        warm = [t.clone() if t is not None and t.untyped_storage().data_ptr() in inputs else t
                for t in (out if self._tuple else [out])]
        for t in warm:
            if t is not None:
                t.record_stream(cur)

        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        before = cuda_build.counts()
        graph = torch.cuda.CUDAGraph()
        t2 = time.perf_counter()
        # The outer stream context puts the current stream back when a
        # failed capture leaves torch.cuda.graph without restoring it.
        # thread_local: an input thread may stage the next pair on its own
        # stream meanwhile; only this thread's calls must be capturable.
        try:
            with torch.cuda.stream(cur), torch.cuda.graph(
                    graph, stream=side, capture_error_mode="thread_local"):
                with _cudnn_fixed():
                    out = self.fn(*self._inputs)
                t3 = time.perf_counter()
        except Exception as exc:
            cuda_build.set_counts(before)
            first = "" if exc.__context__ is None else f" (after {exc.__context__!r})"
            raise RuntimeError(
                f"capture of {self.name} as a CUDA graph failed: {exc!r}{first}. A host "
                "synchronisation (.item(), .cpu(), a synchronize), a pageable "
                "host-to-device copy or an allocation the capture refuses breaks it"
            ) from exc
        t4 = time.perf_counter()
        after = cuda_build.counts()
        cuda_build.set_counts(before)
        self._counts = tuple({k: a[k] - b[k] for k in a if a[k] != b[k]}
                             for a, b in zip(after, before))
        self._outputs = list(out) if self._tuple else [out]
        self.graph = graph
        self.warmup_ms = (t1 - t0) * 1e3
        self.capture_ms = (t3 - t2) * 1e3
        self.instantiate_ms = (t4 - t3) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        return self._result(warm)
