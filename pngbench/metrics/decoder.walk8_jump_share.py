"""decoder.walk8_jump_share (%): the share of the images walked by walk8
(B3) whose fixpoint was still moving after its pass 16 and was replayed on
maps - the port's counter `decoder.walk8_jump_images` over
`decoder.walk8_images`, both added where ops/walk8.decode_kernel8 reads its
passes back (fpng_tpu_torch/utils/trace.py registry, traced calls only).
0 where no walk crawled; None where no walk8 walk ran or the port has no
such counter."""


def _snapshot():
    try:
        from fpng_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def read(ctx):
    snap = _snapshot() if ctx["op"] == "decode" else None
    images = snap["counters"].get("decoder.walk8_images", 0) if snap else 0
    if not images:
        return None
    return 100.0 * snap["counters"].get("decoder.walk8_jump_images", 0) / \
        images
