"""The check that decides `correct`, on the CPU at a small size: a sound
run passes, and the control (the reference at 7 bits a sample) and each
fault planted under the timed path fail it.  The encode's `idat_excess`
limit is set for the card's size in its traffic file; at this size (eight
tiles of 32 x 32, half of them gradients, which fpng compresses less than
zlib does) sound runs read ~1.1 and the stored-block path ~3.8, so the
tests give it SMALL_EXCESS_LIMIT."""

import numpy as np
import pytest

import fpng_tpu_torch
from pngbench import control, manifest, pngref, run
from pngbench.tests.conftest import FRAME, TILE, small

CELLS = [("tile_rgb.decode", "tile256", TILE),
         ("frame4k_rgb.decode", "frame4k", FRAME),
         ("tile_rgba.decode", "tile256", TILE),
         ("tile_rgb.encode", "tile256", TILE)]


SMALL_EXCESS_LIMIT = 2.0


def _run(workload, config, api=None, seed=2**31 + 11):
    traffic = dict(manifest.cell(manifest.load(), workload)["traffic"])
    if "idat_excess_limit" in traffic:
        traffic["idat_excess_limit"] = SMALL_EXCESS_LIMIT
    return run.run(workload, seed, 0.05, False, device="cpu", api=api,
                   config=small(config, **config_sizes(config)),
                   traffic=traffic)


def config_sizes(config):
    return FRAME if config == "frame4k" else TILE


@pytest.mark.parametrize("workload,config,_", CELLS)
def test_sound_run_is_correct(workload, config, _):
    out = _run(workload, config)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 and c["limit"] == 0
               for n, c in out["checks"].items() if n != "idat_excess")
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("workload,config,_", CELLS)
def test_control_fails(workload, config, _):
    out = _run(workload, config, api=control.Reference7())
    assert not out["correct"]
    assert out["checks"]["wrong_bytes"]["value"] > 0


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
@pytest.mark.parametrize("workload,config,_", CELLS)
def test_fault_fails(workload, config, _, kind):
    out = _run(workload, config, api=control.Fault(fpng_tpu_torch, kind))
    assert not out["correct"], (kind, out["checks"])


def test_stored_blocks_fail_the_encode_on_their_bytes_alone():
    """Valid files that skip the compression read back whole: only the
    zlib bytes against the reference's catch them."""
    sound = _run("tile_rgb.encode", "tile256")["checks"]["idat_excess"]
    out = _run("tile_rgb.encode", "tile256",
               api=control.Fault(fpng_tpu_torch, "stored"))
    checks = out["checks"]
    assert not out["correct"]
    assert checks["wrong_bytes"]["value"] == 0
    assert checks["bad_files"]["value"] == 0
    assert sound["value"] < SMALL_EXCESS_LIMIT < \
        checks["idat_excess"]["value"]
    with pytest.raises(ValueError):
        control.Fault(fpng_tpu_torch, "stored").decode_batch([b""])


def test_reference_reads_what_it_writes_and_rejects_damage():
    rng = np.random.default_rng(1)
    for c in (3, 4):
        img = rng.integers(0, 256, (9, 7, c), dtype=np.uint8)
        png = pngref.write(img)
        assert np.array_equal(pngref.read(png), img)
        for pos in (3, 20, len(png) - 20, len(png) - 5):
            bad = bytearray(png)
            bad[pos] ^= 0x10
            with pytest.raises(pngref.BadPNG):
                pngref.read(bytes(bad))


def test_reference_reads_the_ports_files():
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 4, (3, 16, 24, 4), dtype=np.uint8) * 60
    for png, img in zip(fpng_tpu_torch.encode_batch(imgs, device="cpu"),
                        imgs):
        assert np.array_equal(pngref.read(png), img)
