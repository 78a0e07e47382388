"""decoder.host_ms (ms): the decoder driver's host stages a call - the
container parse, the stored files' host decode, the stream pack and the
finish - from the port's own stage spans (decode_batch.spans,
models/decoder.py), which the traced run turns on."""

HOST_STAGES = ("parse", "host_stored", "pack", "finish")


def read(ctx):
    spans = ctx["spans"]
    if ctx["op"] != "decode" or not spans or not ctx["calls"]:
        return None
    return sum(spans.get(s, 0.0) for s in HOST_STAGES) * 1e3 / ctx["calls"]
