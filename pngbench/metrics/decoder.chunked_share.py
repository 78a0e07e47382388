"""decoder.chunked_share (%): the share of the images the decode chain
planned that took the chunked decode - counter `decoder.chunked_images`
over `decoder.images`, both added by models/decoder.dispatch_kernel's
memory plan (fpng_tpu_torch/utils/trace.py registry, traced calls only),
past the walk path's raster limit or where the image's walk cannot fit
the card.  0 where every image walked; None where the port counts no
planned image (a port without these counters)."""


def _snapshot():
    try:
        from fpng_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def read(ctx):
    snap = _snapshot() if ctx["op"] == "decode" else None
    images = snap["counters"].get("decoder.images", 0) if snap else 0
    if not images:
        return None
    return 100.0 * snap["counters"].get("decoder.chunked_images", 0) / images
