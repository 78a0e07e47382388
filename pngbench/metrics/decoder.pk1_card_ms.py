"""decoder.pk1_card_ms (ms): the card's time in the PK=1 tier of the
decode chain a traced decode call - B8's walk, the epilogue, B9, B5 and
B6 after a walk8 overflow, bracketed by CUDA events between the host's
waits - from the port's counter `decoder.pk1_card_s`
(models/decoder._walk_chain), over the decode_batch calls the port's
registry counts (fpng_tpu_torch/utils/trace.py; the set-up's
profiler-start call is traced too, and counted).  0 where no call
overflowed walk8; None where the port has no registry."""


def _snapshot():
    try:
        from fpng_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def read(ctx):
    snap = _snapshot() if ctx["op"] == "decode" else None
    calls = snap["calls"].get("decode_batch", 0) if snap else 0
    if not calls:
        return None
    return snap["counters"].get("decoder.pk1_card_s", 0.0) * 1e3 / calls
