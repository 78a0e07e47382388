"""decoder.walk8_passes (passes): the fixpoint passes of a walk8 walk (B3)
- the port's counter `decoder.walk8_passes` over `decoder.walk8_walks`,
both added where ops/walk8.decode_kernel8 reads its passes back
(fpng_tpu_torch/utils/trace.py registry, traced calls only).  Since B3
walks every lane to an exact exit, an overflowing batch's walk8 runs the
whole PK=1 fixpoint, one lane a pass, here.  None where no walk8 walk ran
or the port has no such counter."""


def _snapshot():
    try:
        from fpng_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def read(ctx):
    snap = _snapshot() if ctx["op"] == "decode" else None
    walks = snap["counters"].get("decoder.walk8_walks", 0) if snap else 0
    if not walks:
        return None
    return snap["counters"].get("decoder.walk8_passes", 0) / walks
