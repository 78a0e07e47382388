"""The control and the faults that the check must catch.

    python3 -m pngbench.control --workload <cell> --seeds 1,2,3 [--seconds s] [--stand-in control|stale|half|altered|stored]

The control is the plain reference (pngbench/pngref.py) put in the
program's place at the next precision down from the configuration's: 7
bits a sample where the configuration states 8 and lossless.  A decode
returns the reference's raster with each sample's low bit cleared; an
encode writes valid PNGs of the raster with each low bit cleared.  The
faults break the port's own path underneath a run: `stale` returns the
first call's answer for every later call (a step that leaves its state
unchanged), `half` returns the first half of the batch's answers only,
`altered` changes one byte of one answer where it is produced, and
`stored` (an encode's) switches on the port's own stored-block path
(FPNG_FORCE_UNCOMPRESSED), valid files that skip the compression.  A
cell on one card has no exchange between cards to leave out.

On the card this runs a cell's set-up as a run does (the files by the
port's encode_batch), then the window with the stand-in in the
program's place and no measurement, and prints each seed's checks; the
benchmark's own runs never run it.  The tests (pngbench/tests/) drive
the same stand-ins on the CPU at a small size.
"""

from __future__ import annotations

import argparse
import json

from pngbench import pngref

FAULTS = ("stale", "half", "altered", "stored")
FORCE_UNCOMPRESSED = 2  # fpng's FPNG_FORCE_UNCOMPRESSED flag


class Reference7:
    """The reference in the program's place, 7 bits a sample."""

    def decode_batch(self, pngs, desired_channels=4, device=None):
        imgs = [pngref.convert(pngref.read(p), desired_channels) & 0xFE
                for p in pngs]
        return [0] * len(pngs), imgs

    def encode_batch(self, images, flags=0, device=None):
        return [pngref.write(img & 0xFE) for img in images]


class Fault:
    """The port with one fault planted where its answers are produced."""

    def __init__(self, api, kind: str):
        if kind not in FAULTS:
            raise ValueError(f"unknown fault {kind!r}")
        self.api, self.kind, self.first = api, kind, None

    def _break(self, out, decode: bool):
        if self.kind == "stale":
            if self.first is None:
                self.first = out
            return self.first
        if decode:
            statuses, images = out
            if self.kind == "half":
                n = len(images) // 2
                return statuses[:n], images[:n]
            images = list(images)
            bad = images[0].copy()
            bad.reshape(-1)[0] ^= 1
            images[0] = bad
            return statuses, images
        if self.kind == "half":
            return out[:len(out) // 2]
        files = list(out)
        b = bytearray(files[0])
        b[-20] ^= 1  # inside the last IDAT (the IEND chunk is 12 bytes)
        files[0] = bytes(b)
        return files

    def decode_batch(self, pngs, desired_channels=4, device="cuda"):
        if self.kind == "stored":
            raise ValueError("stored is a fault of an encode")
        return self._break(self.api.decode_batch(
            pngs, desired_channels=desired_channels, device=device), True)

    def encode_batch(self, images, flags=0, device="cuda"):
        if self.kind == "stored":
            return self.api.encode_batch(images, flags | FORCE_UNCOMPRESSED,
                                         device=device)
        return self._break(self.api.encode_batch(images, flags,
                                                 device=device), False)


def stand_in(kind: str):
    if kind == "control":
        return Reference7()
    import fpng_tpu_torch

    return Fault(fpng_tpu_torch, kind)


def main(argv=None) -> int:
    from pngbench import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--stand-in", default="control",
                    choices=("control",) + FAULTS)
    a = ap.parse_args(argv)
    for seed in (int(s) for s in a.seeds.split(",")):
        out = run.run(a.workload, seed, a.seconds, False,
                      api=stand_in(a.stand_in), measure=False)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "stand_in": a.stand_in, "correct": out["correct"],
                          "calls": out["served"]["calls"],
                          "checks": {n: c["value"] for n, c in
                                     out["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
