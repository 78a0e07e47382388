"""End-to-end verification drive (counterpart of fpng_tpu's
tools/verify_drive.py).

    python -m fpng_tpu_torch.tools.verify_drive [--tiles 8] [--size 256] [--rounds 10] [--device cuda|cpu]

Encodes synthetic content - train.synthetic_corpus tiles and tiles of
flat bands, a gradient and noise, in 3 channels and in 4 (alpha
correlated with green) - in 1-pass, 2-pass and stored mode through
encode_batch, and checks every file: zlib with a per-row defilter (code
that shares nothing with the codec), the port's pngcheck, the port's
golden decoder, and a round trip through fpng_decode_memory; then
decode_batch on each batch.  Then corrupted containers (must not
decode), a checkerboard whose 2-pass streams overflow the walk8 lanes,
and a sweep of corrupted deflate streams through the decode dispatch,
each held against golden.decode_zlib on the same bytes: the device must
agree on acceptance, and an accepted stream must give the golden pixels.

fpng_tpu's drive also decodes every file with the compiled reference
fpng, lodepng and wuffs, and compares sizes with the reference encoder;
those codecs' sources are not in this repository, so those checks are
left out (as the bench's size gate is).  It prints a line a mode and
"FAILURES: n" last, and exits non-zero when n > 0.
"""

from __future__ import annotations

import argparse
import time
import zlib

import numpy as np

import fpng_tpu_torch as T
from fpng_tpu_torch import constants as C


def defilter_check(png: bytes, img: np.ndarray) -> bool:
    """Fully independent reconstruction: zlib + per-row Up defilter."""
    h, w, c = img.shape
    ofs = 8
    idat = b""
    while ofs + 8 <= len(png):
        ln = int.from_bytes(png[ofs:ofs + 4], "big")
        if png[ofs + 4:ofs + 8] == b"IDAT":
            idat += png[ofs + 8:ofs + 8 + ln]
        ofs += 12 + ln
    raw = zlib.decompress(idat)
    stride = 1 + w * c
    if len(raw) != h * stride:
        return False
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride)
    filt = rows[:, 0]
    if filt[0] != 0 or (filt[1:] > 2).any():
        return False
    out = np.zeros((h, w * c), np.uint8)
    prev = np.zeros(w * c, np.uint8)
    for y in range(h):
        cur = rows[y, 1:].copy()
        if filt[y] == 2:
            cur = cur + prev
        elif filt[y] != 0:
            return False
        out[y] = cur
        prev = cur
    return bool(np.array_equal(out.reshape(h, w, c), img))


def structured_tile(rng, h: int, w: int) -> np.ndarray:
    """Noise with a flat band, a flat column strip and a gradient below
    (tests/conftest.make_test_image's "mixed" kind, 3 channels)."""
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img[h // 4:h // 2, :] = rng.integers(0, 256, 3, dtype=np.uint8)
    img[:, w // 4:w // 3] = rng.integers(0, 256, 3, dtype=np.uint8)
    grad = np.arange(w, dtype=np.int32)[None, :, None] % 256
    img[3 * h // 4:] = (grad + img[3 * h // 4:, :1, :1]).astype(np.uint8)
    return img


def make_tiles(B: int, size: int):
    """(tiles3 (B, size, size, 3), tiles4 (B, size, size, 4)): the first
    half synthetic_corpus tiles, the rest structured tiles."""
    from fpng_tpu_torch.train import synthetic_corpus

    corpus = list(synthetic_corpus(3, size=size))
    n = B - B // 2
    rng = np.random.default_rng(0x7E57)
    tiles3 = np.stack([corpus[(i * 7) % len(corpus)] for i in range(n)] +
                      [structured_tile(rng, size, size)
                       for _ in range(B - n)])
    tiles4 = np.concatenate([tiles3, tiles3[..., 1:2]], axis=-1)
    return tiles3, tiles4


def check_mode(name, tiles, flags, device) -> int:
    """Encode one batch in one mode and check every file; the failures."""
    from fpng_tpu_torch import golden
    from fpng_tpu_torch.utils.pngcheck import check as png_check

    B, TH, TW, c = tiles.shape
    t0 = time.perf_counter()
    pngs = T.encode_batch(tiles, flags, device)
    t1 = time.perf_counter()
    pngs = T.encode_batch(tiles, flags, device)
    t2 = time.perf_counter()
    failures = 0
    for i, (png, img) in enumerate(zip(pngs, tiles)):
        ok_z = defilter_check(png, img)
        violations = png_check(png)
        gs, gi, *_ = golden.decode_memory(png, c)
        ok_g = gs == C.FPNG_DECODE_SUCCESS and np.array_equal(gi, img)
        st, out, w, h, ch = T.fpng_decode_memory(png, c, device)
        ok_rt = (st == C.FPNG_DECODE_SUCCESS and (w, h, ch) == (TW, TH, c)
                 and np.array_equal(out, img))
        if not (ok_z and ok_g and ok_rt and not violations):
            print(f"FAIL {name}[{i}]: zlib={ok_z} golden={ok_g} "
                  f"fpng_decode_memory={ok_rt} "
                  f"pngcheck={violations or 'ok'}")
            failures += 1
    t3 = time.perf_counter()
    sts, outs = T.decode_batch(pngs, c, device)
    t4 = time.perf_counter()
    sts, outs = T.decode_batch(pngs, c, device)
    t5 = time.perf_counter()
    for i in range(B):
        if sts[i] != C.FPNG_DECODE_SUCCESS or \
                not np.array_equal(outs[i], tiles[i]):
            print(f"FAIL {name}[{i}]: decode_batch status={sts[i]}")
            failures += 1
    mpix = B * TH * TW / 1e6
    print(f"{name}: enc {t1 - t0:.3f}s first / {mpix / (t2 - t1):.1f} "
          f"MPix/s second; dec {t4 - t3:.3f}s first / "
          f"{mpix / (t5 - t4):.1f} MPix/s second; {sum(map(len, pngs))} "
          f"bytes")
    return failures


def corrupted_stream_sweep(tiles3: np.ndarray, rounds: int = 10,
                           device="cuda") -> int:
    """Corrupted deflate streams through the decode dispatch
    (models/decoder.dispatch_kernel), each held against the golden
    decoder on the same bytes: the device must agree on acceptance, and
    an accepted stream must decode to the golden pixels.  Corruption stays
    past each image's header, so the LUT parsed from the pristine file
    stays right for both sides.  Returns the failures."""
    from fpng_tpu_torch.golden import decode_zlib
    from fpng_tpu_torch.models.decoder import (_parse_one, dispatch_kernel,
                                               pack_streams)
    from fpng_tpu_torch.models.transfer import to_device

    TH = TW = min(64, tiles3.shape[1])
    tiles = np.ascontiguousarray(tiles3[:8, :TH, :TW])
    tiles = np.concatenate([tiles, 255 - tiles])
    pngs = T.encode_batch(tiles, 0, device)
    metas = [_parse_one(p) for p in pngs]
    keep = [j for j, m in enumerate(metas) if m[7] is not None]
    base, luts, p0, zl = pack_streams([metas[j] for j in keep])
    B = len(keep)
    lj, pj = to_device(luts.astype(np.int64), device), to_device(p0, device)
    hdr_end = (p0 + 7) // 8
    rng = np.random.default_rng(0xC0DE)
    fails = total = agree_rej = agree_ok = 0
    for rnd in range(rounds):
        bad = base.copy()
        zr = zl.copy()
        for j in range(B):
            lo, hi = int(hdr_end[j]), int(zl[j])
            cls = (rnd + j) % 5
            if cls == 0:    # single bit flips
                for pos in rng.integers(lo, hi, 3):
                    bad[j, pos] ^= 1 << int(rng.integers(0, 8))
            elif cls == 1:  # byte xor burst
                pos = int(rng.integers(lo, hi - 4))
                bad[j, pos:pos + 4] ^= rng.integers(
                    1, 256, 4).astype(np.uint8)
            elif cls == 2:  # zero-fill run (kills the code stream)
                pos = int(rng.integers(lo, hi - 8))
                bad[j, pos:pos + 8] = 0
            elif cls == 3:  # truncation via a shortened zlib length
                zr[j] = int(rng.integers(lo + 5, hi))
                bad[j, zr[j]:] = 0
            else:           # tail corruption near EOB/adler
                pos = int(rng.integers(max(lo, hi - 9), hi))
                bad[j, pos] ^= 0xFF
        di, ok, _, _ = dispatch_kernel(
            to_device(bad, device), lj, pj, to_device(zr, device),
            h=TH, w=TW, c=3, zmax=int(zr.max()))
        di, ok = di.cpu().numpy(), ok.cpu().numpy()
        for j in range(B):
            total += 1
            oracle = decode_zlib(bad[j].tobytes(), int(zr[j]), TW, TH, 3)
            if bool(ok[j]) != (oracle is not None):
                print(f"SWEEP FAIL r{rnd}[{j}]: device ok={bool(ok[j])} "
                      f"golden={'ok' if oracle is not None else 'reject'}")
                fails += 1
            elif ok[j]:
                agree_ok += 1
                if not np.array_equal(di[j], oracle):
                    print(f"SWEEP FAIL r{rnd}[{j}]: accepted pixels "
                          f"differ from golden")
                    fails += 1
            else:
                agree_rej += 1
    print(f"corrupted-stream sweep: {total} streams, {agree_rej} rejected, "
          f"{agree_ok} accepted-and-equal, {fails} failures")
    return fails


def drive(B: int = 8, size: int = 256, rounds: int = 10,
          device="cuda") -> int:
    """Run every check; returns the number of failures."""
    tiles3, tiles4 = make_tiles(B, size)
    failures = 0
    for name, tiles, flags in [
            ("1pass-3ch", tiles3, 0),
            ("1pass-4ch", tiles4, 0),
            ("2pass-3ch", tiles3, C.FPNG_ENCODE_SLOWER),
            ("2pass-4ch", tiles4, C.FPNG_ENCODE_SLOWER),
            ("stored-3ch", tiles3, C.FPNG_FORCE_UNCOMPRESSED)]:
        failures += check_mode(name, tiles, flags, device)

    # negative probes: a corrupted IHDR must not decode
    bad = bytearray(T.encode_batch(tiles3[:1], 0, device)[0])
    bad[30] ^= 0xFF
    st = T.fpng_decode_memory(bytes(bad), 3, device)[0]
    sts, _ = T.decode_batch([bytes(bad)], 3, device)
    if st == C.FPNG_DECODE_SUCCESS or sts[0] == C.FPNG_DECODE_SUCCESS:
        print("FAIL negative probe: a corrupted container decoded")
        failures += 1
    else:
        print("negative probes ok")

    # deep-chunk probe: a checkerboard defeats matching while 2-pass tables
    # give its two delta symbols 1-2 bit codes, so a 512-bit lane holds
    # ~170 steps: the walk8 lanes overflow and the batch decodes on PK=1
    y, x = np.mgrid[0:64, 0:64]
    cb = (((x + y) % 2)[..., None] * np.full(3, 17)).astype(np.uint8)
    cb = np.stack([cb] * 4)
    csts, couts = T.decode_batch(
        T.encode_batch(cb, C.FPNG_ENCODE_SLOWER, device), 3, device)
    deep = sum(s != C.FPNG_DECODE_SUCCESS or not np.array_equal(o, i)
               for s, o, i in zip(csts, couts, cb))
    print("deep-chunk probe ok" if not deep else
          f"FAIL deep-chunk probe: {deep} images")
    failures += deep

    failures += corrupted_stream_sweep(tiles3, rounds, device)
    print("FAILURES:", failures, flush=True)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="end-to-end verification drive")
    ap.add_argument("--tiles", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    return 1 if drive(a.tiles, a.size, a.rounds, a.device) else 0


if __name__ == "__main__":
    raise SystemExit(main())
