"""The port's harness on the CPU at a tiny size: fpng_tpu_torch.bench (its
JSON line, with bench.py's keys), fpng_tpu_torch.cli (-E, -f, -t, the
CSV and the summary benchmark) and the tools (verify_drive,
profile_kernels, prof_walk8, bench_mesh, bench_large)."""

import json

import numpy as np
import pytest

import fpng_tpu_torch as T
from fpng_tpu_torch import bench, cli
from fpng_tpu_torch.tools import (bench_large, bench_mesh, prof_walk8,
                                  profile_kernels, verify_drive)

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


def test_verify_drive(capsys):
    assert verify_drive.main(["--tiles", "4", "--size", "32", "--rounds",
                              "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [o.split(":")[0] for o in out[:5]] == [
        "1pass-3ch", "1pass-4ch", "2pass-3ch", "2pass-4ch", "stored-3ch"]
    assert "negative probes ok" in out and "deep-chunk probe ok" in out
    assert out[-2].startswith("corrupted-stream sweep: 16 streams")
    assert out[-1] == "FAILURES: 0"


def test_verify_drive_checks_catch_damage():
    tiles3, tiles4 = verify_drive.make_tiles(4, 16)
    assert tiles3.shape == (4, 16, 16, 3) and tiles4.shape == (4, 16, 16, 4)
    assert np.array_equal(tiles4[..., 3], tiles3[..., 1])
    png = T.encode_batch(tiles3[:1], 0, device="cpu")[0]
    assert verify_drive.defilter_check(png, tiles3[0])
    assert not verify_drive.defilter_check(png, tiles3[1])


def test_profile_kernels_main(capsys):
    assert profile_kernels.main(["32", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "corpus 4x32x32x3 = 0.0 MPix"
    assert [o.split(":")[0].strip() for o in out[1:]] == [
        "enc_desc", "enc_fuse", "enc_full", "dec_all", "dec_walk", "dec_fin",
        "dec_fz", "dec_dep", "dec_exp"]
    assert profile_kernels.corpus(40, 2).shape == (2, 40, 40, 3)


def test_prof_walk8_main(capsys):
    t = prof_walk8.stages(32, 4, device="cpu")
    assert t["images"] >= 1 and t["pk1_passes"] > 0 and t["walk8_passes"] > 0
    assert all(t[k] > 0 for k in ("pk1_all", "pk1_walk", "walk8_all",
                                  "walk8_walk", "walk8_fin"))
    assert prof_walk8.main(["32", "4", "--device", "cpu"]) == 0
    assert "walk8 fin" in capsys.readouterr().out


def test_bench_mesh_cpu(capsys):
    assert bench_mesh.main(["4", "32", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    res = json.loads(out[0])
    assert res["mode"] == "cpu" and res["card"] == "cpu"
    assert res["corpus"] == "8x32x32x3"
    assert list(res["mesh_sizes"]) == ["1", "2", "4"]
    for n, row in res["mesh_sizes"].items():
        assert row["decoded_images"] % int(n) == 0
        assert row["encode_mps"] > 0 and row["decode_mps"] > 0
    assert res["mesh_sizes"]["1"]["scaling_eff"] == 1.0


def test_bench_mesh_refuses_missing_cards(monkeypatch):
    monkeypatch.setattr(bench_mesh.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench_mesh.torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="asked for 2 CUDA devices"):
        bench_mesh.bench(2, 32, 2, device="cuda")


def test_bench_large_shrunken_frame(capsys):
    assert bench_large.main(["2", "48", "80", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("corpus: 2x48x80x3") and len(out) == 3
    r = bench_large.measure(1, 40, 64, device="cpu")
    assert r["shape"] == [1, 40, 64, 3] and r["decode_path"] == "walk8"
    assert r["encode_mps"] > 0 and r["stored_fallbacks"] == 0
