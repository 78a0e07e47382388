"""decode.roofline_share (%): the least time the card's memory needs for
the window's device decodes - each zlib stream read once and each raster
written once (pngbench/roofline.py) at the HBM rate - over the card's busy
time outside host<->device copies."""


def read(ctx):
    if ctx["op"] != "decode":
        return None
    R = ctx["roofline"]
    return R.share(R.decode_bytes(ctx["files"]), ctx["stage_s"], ctx["card"])
