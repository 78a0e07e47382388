"""One run of one cell of fpng_tpu_torch's benchmark.

    python3 -m pngbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json's `workloads`) names a configuration (the shape,
batch, content and pool of a deployment, `pngbench/configs/`) and a
traffic mix (the operation, channels and flags, `pngbench/traffic/`).
Set-up makes the pool (make_pool: the configuration's content,
`pngbench/content/<content>.py`, and each call's order from the seed)
and the operation's inputs (`pngbench/ops/<op>.py`: a decode's files,
made with the port's own `encode_batch`), then warms the calls until
every unit has been sent.  The window is a closed loop with one client:
it calls the public synchronous entry that the op names
(`fpng_tpu_torch.decode_batch` or `encode_batch`) on one same-shape
batch, waits for the result and sends the next, cycling over the pool,
for `--seconds` and then to the end of the cycle of content calls.

--trace 0 prints the cell's end-to-end metrics, taken by the card's own
activity records over the whole window (pngbench/activity.py, CUDA
activity alone) and by the caching allocator's peak; --trace 1 records
the host's operations too, turns on the decoder's stage spans and prints
the per-layer metrics (pngbench/metrics/), the card's busy and window
seconds and the breakdown.  The host-paced served rate and the calls'
wall-clock tail go on an earlier line: on these machines the host paces
every call, and a host-paced number does not repeat within a bound.

After the window the answers are checked against the plain reference
(pngbench/pngref.py): every call's statuses and count, and every answer
of SAMPLE calls drawn from the seed, byte for byte against the rasters,
with the op's own numbers (a decode's input files read back; an encode's
files read back, and their zlib bytes against the reference's).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the set-up clock starts before any import

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".build", "pngbench")


def _pin_environment() -> None:
    """Few host threads, and every build and kernel cache at a fixed path
    inside the checkout (the port builds its kernels into .build/ itself)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")


_pin_environment()

import numpy as np  # noqa: E402

from pngbench import activity, guard, manifest, roofline  # noqa: E402


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), *stream])


SAMPLE = 8  # calls whose every answer is compared with the reference
LEAD_S = 0.05  # seconds of the capture before the window's first call and after its last


def make_pool(config: dict, traffic: dict, seed: int):
    """(units, calls, cycle).  units: the distinct rasters the run sends,
    (N, H, W, C) uint8, made by the configuration's content
    (pngbench/content/<content>.py) without the seed: `bank_calls` content
    calls of `batch` units each, in the content's order.  calls:
    config["pool_calls"] index arrays, one a call, in groups of
    `bank_calls` (the cycle), each group every content call once, in an
    order drawn from the seed.  Every seed sends the same calls in another
    order, so every run does the same work: a call's time follows its
    content and the order of its units (a walk runs until its batch's last
    lane converges), and content or orders drawn from the seed made the
    card's time move with the seed."""
    content = manifest.plugin("content", config["content"])
    units = content.units(config, traffic["channels"])
    B, P, n = config["batch"], config["bank_calls"], config["pool_calls"]
    if len(units) != B * P or n % P:
        raise ValueError("pngbench: a pool is bank_calls x batch units, "
                         "and pool_calls a multiple of bank_calls")
    rng = _rng(seed, 0)
    calls = [np.arange(c * B, (c + 1) * B)
             for _ in range(n // P) for c in rng.permutation(P)]
    return units, calls, P


class Driver:
    """The calls of one cell: set-up, one call of the window, and the
    check of what the window returned.  `api` is the system under test
    (the module fpng_tpu_torch, or a stand-in with the same entries); the
    traffic's `op` (pngbench/ops/<op>.py) says which entry a call makes
    and what the check compares."""

    def __init__(self, config, traffic, seed, api, device):
        self.op_name = traffic["op"]
        self.op = manifest.plugin("ops", self.op_name).Op(traffic, device)
        self.api, self.device = api, device
        self.batch = config["batch"]
        self.units, self.calls, self.cycle = make_pool(config, traffic, seed)
        h, w = self.units[0].shape[:2]
        self.mpix_call = self.batch * h * w / 1e6
        self.sample_rng = _rng(seed, 1)
        self.n_noted = 0
        self.counts = {}  # the op's tally, summed over the window's calls
        self.kept = []  # (pool call, its output), a sample of SAMPLE calls

    def prepare(self, encoder) -> None:
        """The op's inputs made from the units (a decode's files, by
        `encoder`, the port's encode_batch)."""
        self.op.prepare(self.units, self.batch, encoder)

    def warm_calls(self) -> list:
        """Pool calls that send every unit at least once, and one more:
        every shape and every file the window sends has then been sent."""
        seen, out = set(), []
        for k, idx in enumerate(self.calls):
            if len(seen) == len(self.units):
                break
            seen.update(idx.tolist())
            out.append(k)
        return out + [len(out) % len(self.calls)]

    def request(self, k: int):
        """Pool call k's input, made before the call is sent."""
        return self.op.request(self.units, self.calls[k])

    def call(self, req):
        return self.op.call(self.api, req)

    @property
    def failed(self) -> int:
        return sum(self.counts.values())

    def note(self, k: int, out) -> None:
        """Inside the window: add the call's tally (failed and missing
        answers), and keep its output if the seed's draw picks it (a
        uniform sample of SAMPLE calls over the window)."""
        for name, v in self.op.tally(out, self.batch).items():
            self.counts[name] = self.counts.get(name, 0) + v
        self.n_noted += 1
        if len(self.kept) < SAMPLE:
            self.kept.append((k, out))
        else:
            j = self.sample_rng.integers(self.n_noted)
            if j < SAMPLE:
                self.kept[j] = (k, out)

    def unit_info(self) -> list:
        return self.op.file_info(self.units, self.kept, self.calls)

    def check(self) -> dict:
        """{name: (value, limit)} of the numbers compared: the tally's
        counts and the bytes unlike the rasters, each with the limit 0,
        then the op's own numbers."""
        wrong = 0
        for k, out in self.kept:
            images = self.op.answers(out)
            for j, i in enumerate(self.calls[k]):
                w = self.op.want(self.units[i])
                got = images[j] if j < len(images) else None
                if got is None or got.shape != w.shape:
                    wrong += w.size
                else:
                    wrong += int(np.count_nonzero(got != w))
        nums = {n: (v, 0) for n, v in self.counts.items()}
        nums["wrong_bytes"] = (wrong, 0)
        nums["calls_unchecked"] = (int(not self.kept), 0)
        nums.update(self.op.checks(self.units, self.kept, self.calls))
        return nums


def window(drv: Driver, seconds: float, measure: bool, trace: bool):
    """The measured window: calls until `seconds` have passed, at least
    SAMPLE calls, and a whole number of cycles (every content call as
    often as the others).  Returns a dict of what it saw; with measure,
    the card's activity (Capture), peak memory and the op's counters."""
    calls, walls = [], []
    res = {"spans": {}, "counters": {}}
    P = len(drv.calls)
    stack = contextlib.ExitStack()
    call_range = contextlib.nullcontext()
    mark = lambda: None  # noqa: E731
    if measure:
        import torch

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = drv.op.counters()
        if trace:
            stack.enter_context(drv.op.traced_layers())
            call_range = torch.profiler.record_function(
                f"harness.{drv.op_name}")
        cap = stack.enter_context(activity.Capture(trace))

        def mark():  # two, so that one lost record loses no call start
            torch.cuda._sleep(0)
            torch.cuda._sleep(0)
    with stack:
        if measure:
            # the profiler can drop the records of its first moments (the
            # window's first call start was lost so): a lead-in of markers,
            # with no work between them, which all count as the first call's
            # start; and a lead-out after the last call
            t = time.perf_counter()
            while time.perf_counter() - t < LEAD_S:
                mark()
                torch.cuda.synchronize()
                time.sleep(0.002)
        start = time.perf_counter()
        k = 0
        while True:
            if time.perf_counter() - start >= seconds and \
                    len(calls) >= SAMPLE and len(calls) % drv.cycle == 0:
                break
            req = drv.request(k)
            t = time.perf_counter()
            mark()
            with call_range:
                out = drv.call(req)
            walls.append(time.perf_counter() - t)
            drv.note(k, out)
            calls.append(k)
            k = (k + 1) % P
        if measure:
            torch.cuda.synchronize()
        res["window_s"] = time.perf_counter() - start
        if measure:
            time.sleep(LEAD_S)
    res["calls"], res["walls"] = calls, walls
    if measure:
        res["spans"] = drv.op.spans
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        res["counters"] = {c: v - before[c]
                           for c, v in drv.op.counters().items()}
        card, host = cap.records()
        res["activity"] = activity.summarize(card, host)
    return res


def _ctx(drv: Driver, res: dict, card_name: str) -> dict:
    """What the per-layer readers read (pngbench/metrics/)."""
    act = res["activity"]
    info = drv.unit_info()
    files = [info[i] for k in res["calls"] for i in drv.calls[k]]
    return {"op": drv.op_name, "card": card_name, "calls": len(res["calls"]),
            "mpix": drv.mpix_call * len(res["calls"]),
            "window_s": res["window_s"], "busy_s": act["busy"] / 1e9,
            "copy_s": act["copy"] / 1e9, "stage_s": act["stage"] / 1e9,
            "spans": res["spans"], "counters": res["counters"],
            "files": files, "roofline": roofline}


def end_to_end(drv: Driver, res: dict, setup_s: float) -> dict:
    act = res["activity"]
    mpix = drv.mpix_call * len(res["calls"])
    per_call_ms = np.asarray(act["calls"], np.float64) / 1e6
    if act["busy"] <= 0 or not len(per_call_ms):
        raise RuntimeError("pngbench: the card's activity records hold no "
                           "work or no call start")
    if len(per_call_ms) != len(res["calls"]):
        raise RuntimeError(f"pngbench: the activity records hold "
                           f"{len(per_call_ms)} call starts for "
                           f"{len(res['calls'])} calls")
    return {
        "card_ms_per_mpix": act["busy"] / 1e6 / mpix,
        "batch_card_p95_ms": float(np.percentile(per_call_ms, 95)),
        "peak_device_gb": res["peak_bytes"] / 1e9,
        "setup_s": setup_s,
    }


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", api=None, config=None, traffic=None,
        measure=None) -> dict:
    """One run; returns the result object.  The tests call it on the CPU
    with `device="cpu"` (no card metrics, only the checks), a small
    `config` (and a `traffic` with the limits of that size), and an `api`
    that breaks the timed path; pngbench/control.py calls it on the card
    with measure=False and the reference in the program's place."""
    cell = manifest.cell(manifest.load(), workload)
    config = config or cell["config"]
    traffic = traffic or cell["traffic"]
    if measure is None:
        measure = device == "cuda"
    chips = cell["workload"]["chips"]
    phases = {}
    clock = [T0]

    def lap(name):
        t = time.perf_counter()
        phases[name] = t - clock[0]
        clock[0] = t

    import torch
    if device == "cuda":
        torch.set_num_threads(1)
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise SystemExit(f"pngbench: the cell needs {chips} CUDA "
                             "device(s); none or too few here")
        torch.zeros(1, device=device)
    import fpng_tpu_torch

    if api is None:
        api = fpng_tpu_torch
    lap("import_s")
    drv = Driver(config, traffic, seed, api, device)
    lap("pool_s")
    drv.prepare(fpng_tpu_torch.encode_batch)
    lap("files_s")
    for k in drv.warm_calls():
        drv.call(drv.request(k))
    lap("warm_s")
    if measure:
        with activity.Capture(trace):  # the profiler's own first start
            drv.call(drv.request(0))
        torch.cuda.synchronize()
        lap("profiler_s")
    setup_s = time.perf_counter() - T0
    res = window(drv, seconds, measure, trace)
    lap("window_and_records_s")
    nums = drv.check()
    lap("check_s")
    correct = all(v <= lim for v, lim in nums.values())
    B = drv.batch
    walls = np.asarray(res["walls"]) * 1e3
    served = {"mpix_s": drv.mpix_call * len(res["calls"]) / res["window_s"],
              "batch_wall_p50_ms": float(np.percentile(walls, 50)),
              "batch_wall_p95_ms": float(np.percentile(walls, 95)),
              "calls": len(res["calls"]), "window_s": res["window_s"],
              "phases": phases}
    out = {"correct": correct, "attempted": B * len(res["calls"]),
           "failed": drv.failed, "metrics": {},
           "device": {}, "served": served}
    if measure:
        act = res["activity"]
        card_ms = np.asarray(act["calls"], np.float64) / 1e6
        served["card_copy_ms_per_mpix"] = act["copy"] / 1e6 / (
            drv.mpix_call * len(res["calls"]))
        served["card_call_ms"] = {
            q: float(np.percentile(card_ms, p)) if len(card_ms) else None
            for q, p in (("min", 0), ("p50", 50), ("p95", 95), ("max", 100))}
        card_name = torch.cuda.get_device_name(0)
        out["device"] = {"platform": "gpu", "kind": card_name, "count": chips,
                         "memory_peak_bytes": res["peak_bytes"]}
        if trace:
            ctx = _ctx(drv, res, card_name)
            for m in cell["per_layer"]:
                v = manifest.reader(m["name"])(ctx)
                if v is not None:
                    out["metrics"][m["name"]] = {"value": v,
                                                 "unit": m["unit"]}
            out["device"].update(busy_s=act["busy"] / 1e9,
                                 window_s=res["window_s"])
            out["breakdown"] = {
                "device_ops": [[n, t / 1e9] for n, t in act["device_ops"]],
                "idle_gaps": [[n, t / 1e9]
                              for n, t in act.get("idle_gaps", [])]}
        else:
            vals = end_to_end(drv, res, setup_s)
            for m in cell["end_to_end"]:
                out["metrics"][m["name"]] = {"value": vals[m["name"]],
                                             "unit": m["unit"]}
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, (v, lim) in nums.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    out = run(a.workload, a.seed, a.seconds, bool(a.trace))
    bad = guard.forbidden()
    if bad:
        print(f"pngbench: the run loaded {bad}: no JAX and nothing of "
              "fpng_tpu may load", file=sys.stderr)
        return 3
    served = out.pop("served")
    print(json.dumps({"served": served}), flush=True)
    for n, c in out["checks"].items():
        print(f"check {n} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
