"""fpng_tpu_torch's spans, counters and card clock (utils/trace.py) on the
CPU.

Untraced, a decode and an encode read no clock, enter no profiler range
and never synchronise.  Under a CPU torch.profiler session each public
call opens its ranges with the documented names and nesting, all with the
call's number as args; the registry's totals, self times and counts add
up; the outputs are byte-identical to the untraced ones; the PK=1 tier's
passes and card time are counted.  The benchmark's four readers of the
registry (pngbench/metrics/) are held on made-up snapshots, and the
sharded decode's mesh spans on the two-device dry run.
"""

import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fpng_tpu_torch as T
from fpng_tpu_torch import golden, graft_entry
from fpng_tpu_torch.models import decoder as TD
from fpng_tpu_torch.ops import specdec_tpu as TS
from fpng_tpu_torch.ops import walk8 as TW
from fpng_tpu_torch.parallel import mesh as TM
from fpng_tpu_torch.train import synthetic_corpus
from fpng_tpu_torch.utils import trace
from pngbench import manifest

LAYERS = ("decoder.", "encoder.", "transfer.", "mesh.")

# (range, innermost enclosing range of the port) of one call
DECODE_TREE = {
    ("decoder.parse", None), ("decoder.host_stored", None),
    ("decoder.pack", None), ("decoder.h2d", None),
    ("transfer.stage", "decoder.h2d"), ("decoder.device", None),
    ("decoder.plan", "decoder.device"), ("decoder.walk8", "decoder.device"),
    ("decoder.d2h", None), ("transfer.issue", "decoder.d2h"),
    ("transfer.wait", None), ("decoder.finish", None)}
ENCODE_TREE = {
    ("encoder.upload", None), ("transfer.stage", "encoder.upload"),
    ("encoder.tables", None), ("transfer.stage", "encoder.tables"),
    ("encoder.kernel", None), ("encoder.crc", None),
    ("transfer.issue", None), ("encoder.readback", None),
    ("transfer.wait", "encoder.readback"), ("encoder.container", None)}


@pytest.fixture
def fresh():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def tiles():
    return np.stack(list(synthetic_corpus(3, size=32))[:4])


@pytest.fixture(scope="module")
def pngs(tiles):
    """Four dynamic-block files and one of stored blocks."""
    return T.encode_batch(tiles, 0, device="cpu") + T.encode_batch(
        tiles[:1], T.FPNG_FORCE_UNCOMPRESSED, device="cpu")


@pytest.fixture(scope="module")
def pk1_pngs():
    """tests/test_torch_pk1.py's input: two 32 x 32 x 4 2-pass tiles whose
    first overflows walk8, so the decode re-walks the batch on PK=1."""
    tiles = list(synthetic_corpus(4, size=32))
    imgs = np.stack([tiles[6], tiles[9]])
    return imgs, [golden.encode_image_to_memory(i, 32, 32, 4,
                                                T.FPNG_ENCODE_SLOWER)
                  for i in imgs]


def _session(monkeypatch):
    """A CPU profiler session, and the (name, args) of every range the
    port opens in it (record_function wrapped by a stand-in that notes its
    arguments and opens the real range)."""
    seen = []
    real = torch.profiler.record_function

    def noting(name, args=None):
        seen.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", noting)
    return profile(activities=[ProfilerActivity.CPU]), seen


def _tree(prof):
    """{(range, innermost enclosing range of the port)} of the session."""
    out = set()
    for e in prof.events():
        if e.name.startswith(LAYERS):
            p = e.cpu_parent
            while p is not None and not p.name.startswith(LAYERS):
                p = p.cpu_parent
            out.add((e.name, p.name if p else None))
    return out


def test_untraced_calls_read_no_clock_open_no_range_and_never_sync(
        monkeypatch, fresh, tiles, pngs, pk1_pngs):
    imgs4, pk1 = pk1_pngs
    want = (T.decode_batch(pngs, 3, device="cpu"),
            T.decode_batch(pk1, 4, device="cpu"),
            T.encode_batch(tiles, 0, device="cpu"),
            T.encode_batch(tiles, T.FPNG_ENCODE_SLOWER, device="cpu"))

    def refuse(*a, **k):
        raise AssertionError("called while tracing is off")

    with monkeypatch.context() as m:
        for mod, name in ((time, "perf_counter"),
                          (torch.profiler, "record_function"),
                          (torch.autograd.profiler, "record_function"),
                          (torch.cuda, "synchronize"), (torch.cuda, "Event")):
            m.setattr(mod, name, refuse)
        got = (T.decode_batch(pngs, 3, device="cpu"),
               T.decode_batch(pk1, 4, device="cpu"),
               T.encode_batch(tiles, 0, device="cpu"),
               T.encode_batch(tiles, T.FPNG_ENCODE_SLOWER, device="cpu"))
        streamed = (list(T.decode_batch_stream([pngs, pk1], 4, device="cpu")),
                    list(T.encode_batch_stream([tiles, tiles], 0,
                                               device="cpu")))
    for (ws, wi), (gs, gi) in zip(want[:2], got[:2]):
        assert ws == gs
        assert all(np.array_equal(a, b) for a, b in zip(wi, gi))
    assert got[2:] == want[2:]
    assert streamed[1] == [want[2], want[2]]
    assert [s for s, _ in streamed[0]] == [[0] * 5, [0, 0]]
    assert trace.snapshot() == {"calls": {}, "spans": {}, "counters": {}}


def test_decode_ranges_nest_and_share_the_call(monkeypatch, fresh, pngs):
    want = T.decode_batch(pngs, 3, device="cpu")
    prof, seen = _session(monkeypatch)
    with prof:
        got = T.decode_batch(pngs, 3, device="cpu")
        T.decode_batch(pngs[:1], 3, device="cpu")
    assert got[0] == want[0] == [0] * 5
    assert all(np.array_equal(a, b) for a, b in zip(got[1], want[1]))
    assert _tree(prof) == DECODE_TREE
    n = {a for _, a in seen}
    assert len(n) == 2 and all(a.startswith("call=") for a in n)
    first = seen[0][1]
    assert {nm for nm, a in seen if a == first} == {r for r, _ in
                                                     DECODE_TREE}
    assert trace.snapshot()["calls"] == {"decode_batch": 2}


def test_encode_ranges_nest_and_share_the_call(monkeypatch, fresh, tiles):
    # two tiles of noise, which the budget rule sends to the stored fallback
    noisy = tiles.copy()
    noisy[1:3] = np.random.default_rng(5).integers(0, 256, noisy[1:3].shape)
    want = [T.encode_batch(x, 0, device="cpu") for x in (tiles, noisy)]
    stored = T.encode_batch(tiles, T.FPNG_FORCE_UNCOMPRESSED, device="cpu")
    prof, seen = _session(monkeypatch)
    with prof:
        got = [T.encode_batch(x, 0, device="cpu") for x in (tiles, noisy)]
        got_stored = T.encode_batch(tiles, T.FPNG_FORCE_UNCOMPRESSED,
                                    device="cpu")
    assert got == want and got_stored == stored
    assert [golden.decode_memory(p, 3)[0] for p in got[1]] == [0] * 4
    assert _tree(prof) == ENCODE_TREE | {("encoder.stored", None),
                                         ("encoder.stored",
                                          "encoder.container")}
    calls = [a for _, a in seen]
    assert len(set(calls)) == 3
    # the fallback is one span a call, whatever the number of its images
    assert [nm for nm, a in seen if a == calls[-1]] == ["encoder.stored"]
    assert [nm for nm, _ in seen].count("encoder.stored") == 2
    assert trace.snapshot()["calls"] == {"encode_batch": 3}


def _add_up(snap, tree, calls, more):
    """The registry against one op's tree: every span of the tree, self
    times that add up to the outermost spans' totals (a span's self time is
    its total less its children's totals), and the counts: `calls` a span,
    or as `more` says."""
    sp = snap["spans"]
    assert set(sp) == {r for r, _ in tree}
    assert all(s["total_s"] >= s["self_s"] > 0 for s in sp.values())
    roots = {r for r, p in tree if p is None}
    assert sum(s["self_s"] for s in sp.values()) == pytest.approx(
        sum(sp[r]["total_s"] for r in roots), rel=1e-9)
    assert {r: s["count"] for r, s in sp.items()} == {
        **{r: calls for r, _ in tree}, **more}
    return sp


def test_registry_totals_self_and_counts_add_up(monkeypatch, fresh, pngs,
                                                tiles):
    monkeypatch.setattr(TD.decode_batch, "spans", {})
    passes8 = TW.walk_fix8.passes
    T.decode_batch(pngs, 3, device="cpu")  # traced: spans is a dict
    snap = trace.snapshot()
    assert snap["calls"] == {"decode_batch": 1}
    counters = dict(snap["counters"])
    # the walk8 tier's card clock: on the CPU, host-clock readings
    assert 0 < counters.pop("decoder.walk8_card_s") <= \
        snap["spans"]["decoder.walk8"]["total_s"]
    walked = 4  # the dynamic-block files, planned on walk8 -> PK=1
    assert counters == {  # one walk8 walk, no PK=1, no jump
        "decoder.walk8_walks": 1, "decoder.walk8_images": walked,
        "decoder.walk8_passes": TW.walk_fix8.passes - passes8,
        "decoder.walk8_jump_images": 0,
        "decoder.images": walked, "decoder.tier.walk8_pk1": walked}
    sp = _add_up(snap, DECODE_TREE, 1, {"transfer.stage": 4})
    dev = sp["decoder.device"]
    assert dev["total_s"] - dev["self_s"] == pytest.approx(
        sp["decoder.plan"]["total_s"] + sp["decoder.walk8"]["total_s"],
        rel=1e-9)
    # the decoder's stage dict receives exactly its seven stages' totals
    stages = TD.decode_batch.spans
    assert set(stages) == {"parse", "host_stored", "pack", "h2d", "device",
                           "d2h", "finish"}
    assert all(v == sp["decoder." + k]["total_s"] for k, v in stages.items())

    trace.reset()
    monkeypatch.setattr(TD.decode_batch, "spans", None)
    with profile(activities=[ProfilerActivity.CPU]):
        T.encode_batch(tiles, 0, device="cpu")
        T.encode_batch(tiles, 0, device="cpu")
    snap = trace.snapshot()
    assert snap["calls"] == {"encode_batch": 2} and snap["counters"] == {}
    # a call uploads its pixels, two table columns and three desc columns
    _add_up(snap, ENCODE_TREE, 2, {"transfer.stage": 2 * (1 + 2 + 3),
                                   "encoder.upload": 2 * 2})


def test_pk1_tier_counts_its_passes_and_its_card_time(monkeypatch, fresh,
                                                      pk1_pngs):
    imgs, pk1 = pk1_pngs
    want = T.decode_batch(pk1, 4, device="cpu")
    passes, passes8 = TS.walk_fix.passes, TW.walk_fix8.passes
    prof, seen = _session(monkeypatch)
    with prof:
        got = T.decode_batch(pk1, 4, device="cpu")
    assert got[0] == want[0] == [0, 0]
    assert all(np.array_equal(a, b) for a, b in zip(got[1], imgs))
    assert ("decoder.pk1", "decoder.device") in _tree(prof)
    snap = trace.snapshot()
    sp, cnt = snap["spans"], snap["counters"]
    assert sp["decoder.walk8"]["count"] == sp["decoder.pk1"]["count"] == 1
    assert cnt["decoder.pk1_walks"] == 1
    assert cnt["decoder.pk1_passes"] == TS.walk_fix.passes - passes > 0
    assert cnt["decoder.walk8_walks"] == 1
    assert cnt["decoder.walk8_passes"] == TW.walk_fix8.passes - passes8 > 0
    # the card clock's pairs leave out the host's wait for the passes, so
    # they cover less than the tier's span, but most of it
    assert 0.5 * sp["decoder.pk1"]["total_s"] < cnt["decoder.pk1_card_s"] \
        <= sp["decoder.pk1"]["total_s"]
    # the walk8 tier's clock likewise, and the plan's counts: two images
    # planned on walk8 -> PK=1, none on the chunked decode
    assert 0 < cnt["decoder.walk8_card_s"] <= sp["decoder.walk8"]["total_s"]
    assert cnt["decoder.images"] == cnt["decoder.tier.walk8_pk1"] == 2
    assert "decoder.chunked_images" not in cnt


@pytest.mark.parametrize("why", ["past_limit", "no_room"])
def test_plan_counts_the_chunked_images_and_why(monkeypatch, fresh,
                                                pk1_pngs, why):
    """The chunked decode's images, counted in the plan with the reason:
    past the walk path's raster limit (ops/walk8.fits refuses), or with no
    room for the image's walk on the card (a budget under one walk8
    decode, and the chunked decode's model patched to fit it); the readers
    decoder.chunked_share and decoder.walk8_card_ms read 100% and
    nothing."""
    imgs, pk1 = pk1_pngs
    if why == "past_limit":
        monkeypatch.setattr(TD, "fits", lambda h, bpl: False)
    else:
        monkeypatch.setattr(TD, "_free_bytes", lambda device: 1)
        monkeypatch.setattr(TD, "chunked_bytes", lambda *a: 0)
    prof, _ = _session(monkeypatch)
    with prof:
        sts, got = T.decode_batch(pk1, 4, device="cpu")
    assert sts == [0, 0]
    assert all(np.array_equal(a, b) for a, b in zip(got, imgs))
    cnt = trace.snapshot()["counters"]
    assert cnt["decoder.images"] == cnt["decoder.chunked_images"] == 2
    assert cnt["decoder.chunked_" + why] == 2
    other = "no_room" if why == "past_limit" else "past_limit"
    assert "decoder.chunked_" + other not in cnt
    assert "decoder.walk8_card_s" not in cnt
    assert _reader("decoder.chunked_share")({"op": "decode"}) == 100.0
    assert _reader("decoder.walk8_card_ms")({"op": "decode"}) is None


def test_stream_batches_are_calls_of_their_own(monkeypatch, fresh, pngs,
                                              tiles):
    prof, seen = _session(monkeypatch)
    with prof:
        dec = list(T.decode_batch_stream([pngs, pngs[:2]], 3, device="cpu"))
        enc = list(T.encode_batch_stream([tiles, tiles[:2]], 0,
                                         device="cpu"))
    assert [s for s, _ in dec] == [[0] * 5, [0, 0]]
    assert enc == [T.encode_batch(tiles, 0, device="cpu"),
                   T.encode_batch(tiles[:2], 0, device="cpu")]
    assert trace.snapshot()["calls"] == {"decode_batch_stream": 2,
                                         "encode_batch_stream": 2}
    # batch 1 is launched before batch 0 finishes: batch 0's finish still
    # carries its own number
    calls = [a for _, a in seen]
    order = [nm for nm, _ in seen]
    first, second = calls[0], calls[order.index("decoder.parse", 1)]
    assert first != second
    assert calls[order.index("decoder.finish")] == first


def _reader(name):
    return manifest.reader(name)


SNAP = {"calls": {"decode_batch": 4, "encode_batch": 5},
        "spans": {"encoder.tables": {"count": 5, "total_s": 0.02,
                                     "self_s": 0.01},
                  "encoder.crc": {"count": 5, "total_s": 0.01,
                                  "self_s": 0.01},
                  "encoder.container": {"count": 5, "total_s": 0.04,
                                        "self_s": 0.03},
                  "encoder.kernel": {"count": 5, "total_s": 1.0,
                                     "self_s": 1.0},
                  "transfer.stage": {"count": 30, "total_s": 0.09,
                                     "self_s": 0.09}},
        "counters": {"decoder.pk1_card_s": 0.4, "decoder.pk1_walks": 4,
                     "decoder.pk1_passes": 3844, "decoder.walk8_walks": 8,
                     "decoder.walk8_passes": 7688,
                     "decoder.walk8_card_s": 0.3, "decoder.images": 8,
                     "decoder.chunked_images": 2,
                     "decoder.walk8_images": 8,
                     "decoder.walk8_jump_images": 1}}


@pytest.mark.parametrize("metric,op,want", [
    ("encoder.host_ms", "encode", 10.0),
    ("encoder.host_ms", "decode", None),
    ("transfer.stage_ms", "decode", 22.5),
    ("transfer.stage_ms", "encode", 18.0),
    ("decoder.pk1_card_ms", "decode", 100.0),
    ("decoder.pk1_card_ms", "encode", None),
    ("decoder.pk1_passes", "decode", 961.0),
    ("decoder.pk1_passes", "encode", None),
    ("decoder.walk8_passes", "decode", 961.0),
    ("decoder.walk8_passes", "encode", None),
    ("decoder.walk8_card_ms", "decode", 75.0),
    ("decoder.walk8_card_ms", "encode", None),
    ("decoder.chunked_share", "decode", 25.0),
    ("decoder.chunked_share", "encode", None),
    ("decoder.walk8_jump_share", "decode", 12.5),
    ("decoder.walk8_jump_share", "encode", None)])
def test_readers_of_the_registry(monkeypatch, metric, op, want):
    monkeypatch.setattr(trace, "snapshot", lambda: SNAP)
    got = _reader(metric)({"op": op})
    assert got == (pytest.approx(want) if want is not None else None)


@pytest.mark.parametrize("metric", ["encoder.host_ms", "transfer.stage_ms",
                                    "decoder.pk1_card_ms",
                                    "decoder.pk1_passes",
                                    "decoder.walk8_passes",
                                    "decoder.walk8_card_ms",
                                    "decoder.chunked_share",
                                    "decoder.walk8_jump_share"])
def test_readers_find_nothing_without_calls_or_a_registry(monkeypatch,
                                                          metric):
    read = _reader(metric)
    monkeypatch.setattr(trace, "snapshot", lambda: {
        "calls": {}, "spans": {}, "counters": {}})
    assert read({"op": "decode"}) is None and read({"op": "encode"}) is None
    # traced decode calls with no PK=1 walk: 0 card time, and no passes
    monkeypatch.setattr(trace, "snapshot", lambda: {
        "calls": {"decode_batch": 3}, "spans": {}, "counters": {}})
    assert read({"op": "decode"}) == (
        0.0 if metric in ("decoder.pk1_card_ms", "transfer.stage_ms")
        else None)
    # a port without utils/trace.py: nothing, and no exception
    import fpng_tpu_torch.utils as U

    monkeypatch.delattr(U, "trace")
    monkeypatch.setitem(sys.modules, "fpng_tpu_torch.utils.trace", None)
    assert read({"op": "decode"}) is None and read({"op": "encode"}) is None


def test_mesh_spans_on_the_two_device_dry_run(monkeypatch, fresh, tiles):
    mesh = TM.make_mesh(["cpu", "cpu"])
    files = T.encode_batch(tiles, 0, device="cpu")
    want = TM.decode_batch_sharded(mesh, files, 32, 32, 3)
    prof, seen = _session(monkeypatch)
    with prof:
        graft_entry.dryrun_multichip(2, device="cpu")  # raises on a fault
        got = TM.decode_batch_sharded(mesh, files, 32, 32, 3)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert np.array_equal(got[0], tiles) and got[1].all()
    assert {("mesh.shard", None), ("mesh.readback", None),
            ("mesh.join", None), ("transfer.stage", "mesh.shard"),
            ("decoder.plan", "mesh.shard"), ("decoder.walk8", "mesh.shard"),
            ("transfer.issue", "mesh.shard"),
            ("transfer.wait", "mesh.readback")} <= _tree(prof)
    last = seen[-1][1].split()[0]
    mesh_args = [(nm, a) for nm, a in seen
                 if nm.startswith("mesh.") and a.startswith(last + " ")]
    assert mesh_args == [("mesh.shard", f"{last} shard=0"),
                         ("mesh.shard", f"{last} shard=1"),
                         ("mesh.readback", f"{last} shard=0"),
                         ("mesh.readback", f"{last} shard=1")]
    assert ("mesh.join", last) in seen
    assert trace.snapshot()["calls"] == {"decode_batch_sharded": 2,
                                         "encode_batch": 1}
