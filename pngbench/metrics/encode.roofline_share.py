"""encode.roofline_share (%): the least time the card's memory needs for
the window's encodes - each raster read once and each zlib stream written
once (pngbench/roofline.py) at the HBM rate - over the card's busy time
outside host<->device copies."""


def read(ctx):
    if ctx["op"] != "encode":
        return None
    R = ctx["roofline"]
    return R.share(R.encode_bytes(ctx["files"]), ctx["stage_s"], ctx["card"])
