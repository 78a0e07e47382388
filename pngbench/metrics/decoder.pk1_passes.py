"""decoder.pk1_passes (passes): the fixpoint passes of a PK=1 walk - the
port's counter `decoder.pk1_passes` over `decoder.pk1_walks`, both added
where ops/specdec_tpu.decode_kernel_pk1 reads its passes back
(fpng_tpu_torch/utils/trace.py registry, traced calls only).  None where
no PK=1 walk ran or the port has no registry."""


def _snapshot():
    try:
        from fpng_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def read(ctx):
    snap = _snapshot() if ctx["op"] == "decode" else None
    walks = snap["counters"].get("decoder.pk1_walks", 0) if snap else 0
    if not walks:
        return None
    return snap["counters"].get("decoder.pk1_passes", 0) / walks
