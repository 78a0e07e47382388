"""decoder.walk8_card_ms (ms): the card's time in the walk8 tier of the
decode chain a traced decode call - B3's walk, the epilogue and, where it
fits, B4, B5 and B6 - bracketed by CUDA events between the host's waits,
from the port's counter `decoder.walk8_card_s` (models/decoder._walk_chain),
over the decode_batch calls the port's registry counts
(fpng_tpu_torch/utils/trace.py; the set-up's profiler-start call is traced
too, and counted).  None where the port has no such counter."""


def _snapshot():
    try:
        from fpng_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def read(ctx):
    snap = _snapshot() if ctx["op"] == "decode" else None
    calls = snap["calls"].get("decode_batch", 0) if snap else 0
    card_s = snap["counters"].get("decoder.walk8_card_s") if snap else None
    if not calls or card_s is None:
        return None
    return card_s * 1e3 / calls
