"""encoder.host_ms (ms): the encoder driver's host stages a traced encode
call - the table set-up, the IDAT CRC's host prologue, the container
splice and the stored-block fallback - as the self seconds of the port's
own spans `encoder.tables`, `.crc`, `.container` and `.stored`, over the
encode_batch calls the port's registry counts
(fpng_tpu_torch/utils/trace.py; the set-up's profiler-start call is
traced too, and counted).  None where the port has no registry."""

STAGES = ("encoder.tables", "encoder.crc", "encoder.container",
          "encoder.stored")


def _snapshot():
    try:
        from fpng_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def read(ctx):
    snap = _snapshot() if ctx["op"] == "encode" else None
    calls = snap["calls"].get("encode_batch", 0) if snap else 0
    if not calls:
        return None
    spans = snap["spans"]
    return sum(spans[s]["self_s"] for s in STAGES if s in spans) * 1e3 / calls
