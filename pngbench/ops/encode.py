"""An encode call: `fpng_tpu_torch.encode_batch(images, flags)` on one
same-shape batch of rasters.

Every call counts its missing files.  The check reads every sampled file
back with the plain reference (chunk CRCs, zlib and its Adler-32, the
row filters) and compares it with its raster, counts the files it cannot
read, and holds the sampled files' zlib bytes against the reference's
own: `idat_excess` is the share by which their total exceeds the total
of pngref.write's (filter Up, zlib level 1) for the same rasters.  A
file written as stored blocks, or compressed less, reads back whole; the
excess is what tells it.  Its limit is the traffic's
`idat_excess_limit`.
"""

import contextlib

from pngbench import pngref, roofline


class Op:
    def __init__(self, traffic: dict, device):
        self.device = device
        self.flags = traffic.get("flags", 0)
        self.excess_limit = traffic["idat_excess_limit"]
        self.unreadable = 0
        self.spans = {}

    def prepare(self, units, batch: int, encoder) -> None:
        pass

    def request(self, units, idx):
        return units[idx]

    def call(self, api, req):
        return api.encode_batch(req, self.flags, device=self.device)

    def tally(self, out, n: int) -> dict:
        return {"missing": max(n - len(out), 0) + sum(
            not isinstance(p, bytes) or not p for p in out)}

    def answers(self, out) -> list:
        images = []
        for p in out:
            try:
                images.append(pngref.read(p))
            except (pngref.BadPNG, TypeError):
                self.unreadable += 1
                images.append(None)
        return images

    def want(self, unit):
        return unit

    def checks(self, units, kept, calls) -> dict:
        ours = ref = 0
        ref_of = {}
        for k, out in kept:
            for i, p in zip(calls[k], out):
                if i not in ref_of:
                    ref_of[i] = pngref.idat_bytes(pngref.write(units[i]))
                ref += ref_of[i]
                ours += roofline.file_info(p, units[i].shape)[0]
        return {"bad_files": (self.unreadable, 0),
                "idat_excess": (ours / ref - 1 if ref else float("inf"),
                                self.excess_limit)}

    def file_info(self, units, kept, calls) -> list:
        """The roofline's view of each unit: its file as a sampled call
        wrote it (a unit no sampled call sent counts nothing)."""
        info = [(0, *units[0].shape, False)] * len(units)
        for k, out in kept:
            for i, p in zip(calls[k], out):
                info[i] = roofline.file_info(p, units[i].shape)
        return info

    def counters(self) -> dict:
        return {}

    @contextlib.contextmanager
    def traced_layers(self):
        """--trace 1: a record_function range, named after the stage,
        around each of the encoder's stage functions (the encoder has no
        spans of its own); a name the port no longer has is left alone."""
        import torch
        from fpng_tpu_torch.models import encoder as E

        saved = []
        for attr, label in (("to_device", "encoder.upload"),
                            ("_prepare_tables", "encoder.tables"),
                            ("encode_kernel", "encoder.kernel"),
                            ("launch_assemble", "encoder.crc"),
                            ("finish_readback", "encoder.readback"),
                            ("_finish_batch_devcrc", "encoder.container")):
            fn = getattr(E, attr, None)
            if fn is None:
                continue
            saved.append((attr, fn))

            def ranged(*a, _fn=fn, _label=label, **kw):
                with torch.profiler.record_function(_label):
                    return _fn(*a, **kw)
            setattr(E, attr, ranged)
        try:
            yield
        finally:
            for attr, fn in saved:
                setattr(E, attr, fn)
