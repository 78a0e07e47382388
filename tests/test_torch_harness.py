"""The port's harness on the CPU at a tiny size: fpng_tpu_torch.bench (its
JSON line, with bench.py's keys) and fpng_tpu_torch.cli (-E, -f, -t, the
CSV and the summary benchmark)."""

import json

import numpy as np
import pytest

import fpng_tpu_torch as T
from fpng_tpu_torch import bench, cli

MODE_KEYS = {
    "encode_mps", "encode_with_assembly_mps", "decode_mps", "decode_path",
    "encode_serving_mps", "decode_serving_mps", "aggregate_mps",
    "hbm_util_encode", "hbm_util_decode", "bytes", "bytes_ref",
    "vs_ref_bytes", "stored_fallbacks", "vs_ref_singlecore", "device_s",
    "host_tail_s", "d2h_s"}


def test_bench_prints_one_json_line(monkeypatch, capsys):
    """B = 4 tiles of 32 x 32, 3- and 4-channel 1-pass (the selection
    matches substrings, as bench.py's)."""
    monkeypatch.setenv("FPNG_TPU_BENCH_ONLY", "real3_1pass,real4_1pass")
    monkeypatch.setenv("FPNG_TPU_BENCH_4K", "0")
    spot = []
    check = bench._spot_check
    monkeypatch.setattr(bench, "_spot_check",
                        lambda *a: spot.append(check(*a)))
    assert bench.main(device="cpu", B=4, size=32) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    res = json.loads(out[0])
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "detail"}
    d = res["detail"]
    assert set(d) == {"corpus", "methodology", "card", "real3_1pass",
                      "real4_1pass"}
    assert d["card"] == "cpu" and len(spot) == 2
    for name in ("real3_1pass", "real4_1pass"):
        assert set(d[name]) == MODE_KEYS
        assert d[name]["decode_path"] in ("walk8", "pk1")
        assert d[name]["vs_ref_bytes"] is None  # no compiled reference here
        assert d[name]["encode_mps"] > 0 and d[name]["decode_serving_mps"] > 0
    assert res["value"] == d["real3_1pass"]["aggregate_mps"]


def test_bench_size_gate_classes():
    classes = bench._heldout_classes(4)
    assert set(classes) == {"photo_noise", "texture_octaves",
                            "radial_gradients"}
    assert all(v.shape == (8, 192, 192, 4) for v in classes.values())
    assert bench._ref_bytes(classes["photo_noise"][:1], 0) == 0


@pytest.fixture
def two_pngs(tmp_path):
    rng = np.random.default_rng(12)
    paths = []
    for k, (h, w, c) in enumerate(((24, 31, 3), (20, 18, 4))):
        img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
        img[h // 3:h // 2] = 90 + k
        if c == 4:
            img[..., 3] = np.where(img[..., 3] > 128, 255, img[..., 3])
        p = str(tmp_path / f"f{k}.png")
        assert T.fpng_encode_image_to_file(p, img, w, h, c, device="cpu")
        paths.append(p)
    return paths


def test_cli_fuzz_modes(two_pngs, tmp_path, capsys):
    assert cli.main(["-E", "-n", "5", "-d", "48"], device="cpu") == 0
    data = bytearray(open(two_pngs[0], "rb").read())
    data[70] ^= 0x5A
    bad = tmp_path / "bad.png"
    bad.write_bytes(bytes(data))
    assert cli.main(["-f", str(bad)], device="cpu") == 0
    assert cli.main(["-t", *two_pngs], device="cpu") == 0
    out = capsys.readouterr().out
    assert "random-dims fuzz: 5 trials OK" in out
    assert "status=" in out and "trained on 1 opaque / 1 alpha" in out


def test_cli_bench_csv_and_summary(two_pngs, capsys):
    assert cli.main(["-c", *two_pngs], device="cpu") == 0
    rows = [r.split(", ") for r in capsys.readouterr().out.splitlines()]
    assert [r[0] for r in rows] == two_pngs
    assert all(len(r) == 28 for r in rows)
    assert [r[1:4] for r in rows] == [["31", "24", "3"], ["18", "20", "4"]]
    assert all(float(r[9]) > 0 and r[4] == "" for r in rows)  # fpng; no qoi
    assert cli.main([*two_pngs, "-b", "2"], device="cpu") == 0
    assert "** Batched (B=2)" in capsys.readouterr().out
