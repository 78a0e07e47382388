"""Driver entry points (counterpart of __graft_entry__.py).

entry():            the single-device forward step - the batched 1-pass
                    encode kernel with its fused token histogram - and
                    example inputs for it.
dryrun_multichip(): one full data-parallel step over an n-entry mesh
                    (parallel/mesh.py): the sharded encode kernel with the
                    mesh-wide histogram reduction, then a sharded decode
                    round trip that must be pixel-exact.

With device="cuda" the mesh takes the first n cards and raises when there
are fewer; nothing falls back to the CPU.  device="cpu" builds n CPU
shards in this process.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _example_inputs(B=2, H=32, W=48, Cc=3, device="cuda"):
    """(args, num_words, Cc): encode_kernel's inputs for B random H x W x
    Cc images with some runs, and the 1-pass tables, on `device`."""
    from .models.encoder import _budget
    from .tables import one_pass_state

    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (B, H, W, Cc), dtype=np.uint8)
    imgs[:, 8:16] = 7  # some RLE structure
    st = one_pass_state(Cc, device)

    def col(v):
        return torch.full((B,), v, dtype=torch.int32, device=device)

    args = (torch.from_numpy(imgs).to(device), st.codes.expand(B, -1),
            st.sizes.expand(B, -1), col(len(st.prefix) * 8), col(st.acc),
            col(st.nacc))
    return args, max(_budget(H, W, Cc) // 4 + 4, 8), Cc


def entry(device="cuda"):
    """(fn, example_args): the batched 1-pass encode step."""
    from .models.encoder import encode_kernel

    args, num_words, Cc = _example_inputs(device=device)
    fn = functools.partial(encode_kernel, num_chans=Cc, cost_check=False,
                           want_hist=True, num_words=num_words)
    return fn, args


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run one full data-parallel step on an n-entry mesh of `device`
    ("cuda": the first n cards; "cpu": n CPU shards); raises on a
    failed check or, for "cuda", with fewer than n cards."""
    import fpng_tpu_torch as T
    from .parallel.mesh import (decode_batch_sharded, full_step_sharded,
                                make_mesh)

    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip: need {n_devices} CUDA "
                               f"devices, have {have}")
        devices = [f"cuda:{i}" for i in range(n_devices)]
    else:
        devices = [device] * n_devices
    mesh = make_mesh(devices)
    B, H, W, Cc = 2 * n_devices, 16, 24, 3
    rng = np.random.default_rng(1)
    # compressible content (flat runs + small-alphabet noise), so every
    # file takes the dynamic-block path, not the stored fallback
    imgs = rng.integers(0, 8, (B, H, W, Cc), dtype=np.uint8)
    imgs[:, 4:8] = 3

    words, total_bits, adler, ghist = full_step_sharded(mesh, imgs, Cc)
    if tuple(ghist.shape) != (288,) or int(total_bits.min()) <= 0 or \
            words.shape[0] != B:
        raise RuntimeError("dryrun_multichip: sharded encode step")

    pngs = T.encode_batch(imgs, device=mesh.devices[0])
    dec, ok = decode_batch_sharded(mesh, pngs, H, W, Cc)
    if not ok.all():
        raise RuntimeError("dryrun_multichip: sharded decode rejected "
                           "valid files")
    if not np.array_equal(dec, imgs):
        raise RuntimeError("dryrun_multichip: sharded round trip mismatch")
