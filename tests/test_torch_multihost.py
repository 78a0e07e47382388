"""The port's multi-process dry run on the CPU: two processes join one
torch.distributed group over gloo, each holds half of the seeded corpus
as 4 local shards, and the training histogram's all-reduce crosses the
process boundary (fpng_tpu_torch/tools/dryrun_multihost.py; the model is
tests/test_multihost.py)."""

import os
import subprocess
import sys

from fpng_tpu_torch.tools import dryrun_multihost as MH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_multihost_dryrun_gloo():
    env = dict(os.environ, FPNG_TPU_TORCH_MH_PORT=str(MH.free_port()))
    r = subprocess.run(
        [sys.executable, "-m", "fpng_tpu_torch.tools.dryrun_multihost",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-2000:]
    assert "MULTIHOST DRYRUN: OK" in r.stdout
    assert r.stdout.count("global hist ok") == 2
    assert "world 2, gloo" in r.stdout
