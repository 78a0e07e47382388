"""transfer.copy_ms_per_mpix (ms/MPix): the card's time in host<->device
copies (the union of its HtoD and DtoH memcpy records; models/transfer.py
issues them) over the megapixels the window completed."""


def read(ctx):
    if ctx["copy_s"] <= 0 or ctx["mpix"] <= 0:
        return None
    return ctx["copy_s"] * 1e3 / ctx["mpix"]
