"""transfer.stage_ms (ms): the host's copy of a traced call's inputs into
pinned memory before their upload, from the port's own span
`transfer.stage` (models/transfer.to_device), over the calls of the op
(decode_batch or encode_batch) that the port's registry counts
(fpng_tpu_torch/utils/trace.py; the set-up's profiler-start call is
traced too, and counted).  None where the port has no registry."""

API = {"decode": "decode_batch", "encode": "encode_batch"}


def _snapshot():
    try:
        from fpng_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def read(ctx):
    op = API.get(ctx["op"])
    snap = _snapshot() if op else None
    calls = snap["calls"].get(op, 0) if snap else 0
    if not calls:
        return None
    stage = snap["spans"].get("transfer.stage")
    return (stage["total_s"] if stage else 0.0) * 1e3 / calls
