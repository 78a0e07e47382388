"""Host <-> device copies of the batched and streaming encode/decode.

On a CUDA device a host array goes up through a pinned staging tensor with
a non-blocking copy, and results come back with non-blocking copies into
pinned tensors on a side stream, ordered after an event that marks the end
of the work that produced them.  The caller waits on the readback's own
event only when it needs the bytes, so in the streaming API a batch's
readback and host tail overlap the next batch's device work.

Two allocators make this safe without a ring of buffers: PyTorch's caching
host allocator does not hand a pinned block out again until the copies
recorded on it have completed, so a staging buffer is never overwritten
while its copy is in flight; and record_stream keeps the caching device
allocator from reusing a result's memory while the side stream still
reads it.  On the CPU both directions are plain conversions.

The staging copy, the readback's issue and its wait are the spans
`transfer.stage`, `transfer.issue` and `transfer.wait` (utils/trace.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device` (non-blocking from pinned
    memory on CUDA).  The span `transfer.stage` covers the host's part: the
    copy into pinned memory (on the CPU, the conversion)."""
    with trace.span("transfer.stage"):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if torch.device(device).type != "cuda":
            return t.to(device)
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def start_readback(tensors):
    """Start copying `tensors` (all on one device) to the host; returns the
    handle that finish_readback takes.  The span `transfer.issue`."""
    dev = tensors[0].device
    with trace.span("transfer.issue"):
        if dev.type != "cuda":
            return tuple(tensors), None
        produced = torch.cuda.Event()
        produced.record(torch.cuda.current_stream(dev))
        side = torch.cuda.Stream(dev)
        side.wait_event(produced)
        host = []
        with torch.cuda.stream(side):
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(side)
                host.append(h)
            copied = torch.cuda.Event()
            copied.record(side)
    return tuple(host), copied


def finish_readback(handle) -> tuple[np.ndarray, ...]:
    """Wait for a start_readback's copies; the results as numpy arrays.
    The span `transfer.wait`."""
    host, copied = handle
    with trace.span("transfer.wait"):
        if copied is not None:
            copied.synchronize()
        return tuple(h.numpy() for h in host)
