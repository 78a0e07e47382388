"""A decode call: `fpng_tpu_torch.decode_batch(files, desired_channels)`
on one same-shape batch of files.

Set-up makes each unit's file once, `batch` a call, with the port's
`encode_batch` and the traffic's flags.  Every call counts its statuses
other than success and its missing images; the check compares every
sampled answer with its raster (converted to the channels asked for) and
reads every input file back to its raster with the plain reference.
"""

import contextlib

import numpy as np

from pngbench import pngref, roofline

COUNTERS = ("sub_batches", "walk8_overflows")


class Op:
    def __init__(self, traffic: dict, device):
        self.device = device
        self.flags = traffic.get("flags", 0)
        self.out_chans = traffic.get("desired_channels", traffic["channels"])
        self.files = None
        self.spans = {}

    def prepare(self, units, batch: int, encoder) -> None:
        self.files = []
        for s in range(0, len(units), batch):
            self.files += encoder(units[s:s + batch], self.flags,
                                  device=self.device)

    def request(self, units, idx):
        return [self.files[i] for i in idx]

    def call(self, api, req):
        return api.decode_batch(req, desired_channels=self.out_chans,
                                device=self.device)

    def tally(self, out, n: int) -> dict:
        statuses, images = out
        return {"bad_status": sum(s != 0 for s in statuses),
                "missing": max(n - len(images), 0)
                + sum(im is None for im in images)}

    def answers(self, out) -> list:
        return list(out[1])

    def want(self, unit):
        return pngref.convert(unit, self.out_chans)

    def checks(self, units, kept, calls) -> dict:
        bad = 0
        for p, r in zip(self.files, units):
            try:
                bad += not np.array_equal(pngref.read(p), r)
            except pngref.BadPNG:
                bad += 1
        return {"bad_files": (bad, 0)}

    def file_info(self, units, kept, calls) -> list:
        """The roofline's view of each unit: its input file."""
        return [roofline.file_info(p, u.shape)
                for p, u in zip(self.files, units)]

    def counters(self) -> dict:
        from fpng_tpu_torch.models.decoder import decode_batch as D

        return {c: getattr(D, c) for c in COUNTERS}

    @contextlib.contextmanager
    def traced_layers(self):
        """--trace 1: the decoder's stage spans on, each wrapped in a
        record_function range of its name (`decoder.parse`, ...), so the
        trace's idle gaps go to the stage the host was in."""
        import torch
        from fpng_tpu_torch.models import decoder as D

        span = D._span

        @contextlib.contextmanager
        def ranged(name, device):
            with torch.profiler.record_function(f"decoder.{name}"), \
                    span(name, device):
                yield

        D._span, D.decode_batch.spans = ranged, {}
        try:
            yield
        finally:
            self.spans = dict(D.decode_batch.spans or {})
            D._span, D.decode_batch.spans = span, None
