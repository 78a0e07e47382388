"""Spans, counters and the card clock of fpng_tpu_torch's own stages.

The switch.  Each public call - decode_batch, encode_batch, a batch of
decode_batch_stream or encode_batch_stream, the mesh's sharded decode -
asks begin(op) whether it is traced.  It is while a torch.profiler session
is enabled (FPNG_TPU_PROFILE's `tools/profile_kernels.profiled`, or any
other session), or where the caller forces it (models/decoder.py does
while decode_batch.spans is a dict).  torch tells no Python caller whether
a session records the host's operations or the card's alone, so a
card-only session turns tracing on too: its ranges then record nothing,
and nothing here launches, copies, sets or allocates anything on the card.

While a call is traced:

- span(name) opens a torch.profiler.record_function range `name`
  (`<layer>.<stage>`, e.g. `decoder.parse`) with args "call=<n>", n the
  call's number from begin(), so every span of one call carries the same
  number and nesting gives each span its parent.  It adds the block's host
  seconds, total and self (total less what the spans nested in it cover),
  and one to its count, to the registry;
- count(name, n) adds n to a counter;
- card_clock(name, device) times the card's work of a block with CUDA event
  pairs on the current stream: host_wait() inside it closes the open pair
  before a host wait and opens a new one after it, so the host's time there
  is not counted.  settle(), once the call has waited for its results,
  reads the pairs (so reading them waits for nothing) and adds their
  seconds to the counter `name`.  On the CPU, where the plain versions run
  synchronously, the pairs are host-clock readings.

snapshot() returns the registry as a plain dict: `calls` (traced calls by
op), `spans` (name -> count, total_s, self_s) and `counters`.

Off, span() returns a shared null context after one flag read: no clock is
read and no range entered.  Nothing here synchronises the card.
"""

from __future__ import annotations

import contextlib
import time

import torch

_NULL = contextlib.nullcontext()

_calls: dict = {}  # op -> traced calls
_spans: dict = {}  # name -> [count, total_s, self_s]
_counters: dict = {}  # name -> sum
_pairs: dict = {}  # traced call -> [(counter, start mark, end mark)]
_open: list = []  # the spans open now, innermost last
_clocks: list = []  # the card clocks open now, innermost last
_seq = 0
_current = None  # the traced call whose work runs now, or None


def begin(op: str, force: bool = False):
    """A public call of `op` starts: its number when it is traced (and
    counted under `op`), else None.  Its work runs inside within(number)."""
    global _seq
    if not (force or torch.autograd.profiler._is_profiler_enabled):
        return None
    _seq += 1
    _calls[op] = _calls.get(op, 0) + 1
    return _seq


@contextlib.contextmanager
def within(call):
    """Run the block as work of `call`, begin()'s number (None: untraced)."""
    global _current
    outer, _current = _current, call
    try:
        yield
    finally:
        _current = outer


class _Span:
    """One open span: its range, its start and its children's seconds."""

    __slots__ = ("name", "range", "start", "child", "seconds")

    def __init__(self, name: str, args: str):
        self.name = name
        self.range = torch.profiler.record_function(
            name, f"call={_current}{args}")
        self.child = self.seconds = 0.0

    def __enter__(self):
        self.range.__enter__()
        _open.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.start
        _open.pop()
        if _open:
            _open[-1].child += self.seconds
        s = _spans.setdefault(self.name, [0, 0.0, 0.0])
        s[0] += 1
        s[1] += self.seconds
        s[2] += self.seconds - self.child
        self.range.__exit__(*exc)
        return False


def span(name: str, args: str = ""):
    """A span over the block (args is added to the range's "call=<n>");
    yields the open span, whose `seconds` hold its total after the block,
    or None when the call is not traced."""
    return _NULL if _current is None else _Span(name, args)


def count(name: str, n=1) -> None:
    """Add n to the counter `name` when the call is traced."""
    if _current is not None:
        _counters[name] = _counters.get(name, 0) + n


class _Clock:
    def __init__(self, name: str, device: torch.device):
        self.name, self.device, self.call = name, device, _current
        self.start = None

    def _mark(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def open(self) -> None:
        self.start = self._mark()

    def close(self) -> None:
        _pairs.setdefault(self.call, []).append(
            (self.name, self.start, self._mark()))


@contextlib.contextmanager
def card_clock(name: str, device):
    """Time the card's work of the block into the counter `name` (read by
    settle()); nothing when the call is not traced."""
    if _current is None:
        yield
        return
    clock = _Clock(name, torch.device(device))
    clock.open()
    _clocks.append(clock)
    try:
        yield
    finally:
        _clocks.pop()
        clock.close()


@contextlib.contextmanager
def host_wait():
    """A host wait inside a card clock: the clock's pair is closed before
    the block and a new one opened after it."""
    clock = _clocks[-1] if _clocks and _current is not None else None
    if clock is not None:
        clock.close()
    try:
        yield
    finally:
        if clock is not None:
            clock.open()


def settle() -> None:
    """Add the current call's card-clock pairs to their counters.  Call it
    after the call's own wait for the results of the work they bracket."""
    for name, a, b in _pairs.pop(_current, ()):
        count(name, b - a if isinstance(a, float) else
              a.elapsed_time(b) / 1e3)


def snapshot() -> dict:
    """The registry as a plain dict (a copy)."""
    return {"calls": dict(_calls),
            "spans": {k: {"count": c, "total_s": t, "self_s": s}
                      for k, (c, t, s) in _spans.items()},
            "counters": dict(_counters)}


def reset() -> None:
    """Empty the registry."""
    for d in (_calls, _spans, _counters, _pairs):
        d.clear()
