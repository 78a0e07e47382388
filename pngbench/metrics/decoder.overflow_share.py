"""decoder.overflow_share (%): the share of the window's walked decodes
(decode_batch.sub_batches) whose walk8 attempt overflowed and was decoded
again on PK=1 (decode_batch.walk8_overflows), from the port's counters."""


def read(ctx):
    c = ctx["counters"]
    if ctx["op"] != "decode" or c.get("sub_batches", 0) <= 0:
        return None
    return 100.0 * c["walk8_overflows"] / c["sub_batches"]
