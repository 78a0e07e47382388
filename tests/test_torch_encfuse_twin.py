"""Numpy twins of kernels B1 (csrc/encfuse.cu) and B7 (csrc/demote.cu),
held against their plain versions on the CPU, tolerance zero.

A CUDA kernel cannot run here, so each twin replays its kernel's plan in
numpy: for B1 the tiles of kTile units, each tile's words built from its
own first bit, the decoupled look-back over (bit count, last 32 bits, last
token start) runs with the tiles publishing and looking back in a random
order, every output word stored once by the tile that holds its last bit
(or by the zeroing blocks), and the lanes' fold in the kernel's order; for
B7 the 16-pixel groups with a byte-wise head and tail per image.  The
kernels themselves are held against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from fpng_tpu_torch.models.encoder import _budget, _num_words, build_desc
from fpng_tpu_torch.models.encoder import tokens
from fpng_tpu_torch.ops.encfuse import (DESC_EXTRA_N_SHIFT,
                                        DESC_EXTRA_VAL_SHIFT, DESC_TOK_START,
                                        demote_mask_plain, encode_bits_plain,
                                        pack_table)
from fpng_tpu_torch.tables import one_pass_state

TILE = 4096             # kEncTile in csrc/encfuse.cu
THREADS = 256           # kEncThreads: a tile's threads, and the tiles a
                        # look-back round reads
LOCAL_WORDS = TILE + 2  # kLocalWords
ZERO_WORDS = 8192       # kZeroWords
GROUP = 16              # kGroup in csrc/demote.cu
M32 = 0xFFFFFFFF
INT32_MAX = 2 ** 31 - 1
AGG, INCL = 1, 2


def combine(l, r):
    """csrc/encfuse.cu:combine on (n, lt, tail) runs."""
    n, lt = l[0] + r[0], (l[0] + r[1] if r[1] >= 0 else l[1])
    if r[0] >= 32:
        tail = r[2]
    elif r[0] == 0:
        tail = l[2]
    else:
        kl = min(l[0], 32)
        from_l = min(n, 32) - r[0]
        tail = ((l[2] >> (kl - from_l)) if from_l else 0) | \
            ((r[2] << from_l) & M32)
    return (n, lt, tail)


IDENTITY = (0, -1, 0)


def decode_units(d, tbl_row):
    """csrc/encfuse.cu:decode_unit over an int64 array of desc."""
    sym, use_t = d & 511, (d >> 9) & 1
    en, ev = (d >> 10) & 7, (d >> 13) & 0x1FFF
    e = np.where(use_t == 1, tbl_row[sym], 0)
    sz = e >> 16
    return ((e & 0xFFFF) | (ev << sz)) & M32, sz + en, (d >> 26) & 1


class B1Twin:
    """One launch of B1 on (B, N) desc, replayed step by step."""

    def __init__(self, desc, tbl, base, num_words, rng, threads=THREADS):
        self.desc = desc.astype(np.int64)
        self.tbl = tbl.reshape(tbl.shape[0], -1).astype(np.int64)
        self.base = base.astype(np.int64)
        self.nw = num_words
        self.rng = rng
        self.threads = threads  # tiles a look-back round reads
        B, N = desc.shape
        self.nblk = max(1, -(-N // TILE))
        self.tiles = B * self.nblk
        self.flags = [0] * self.tiles
        self.agg = [None] * self.tiles
        self.incl = [None] * self.tiles
        self.words = np.full((B, num_words), 0xDEADBEEF, np.int64)
        self.writes = np.zeros((B, num_words), np.int64)
        self.total = np.full(B, 0x7EEEEEEE, np.int64)
        self.last_tok = np.full(B, 0x7EEEEEEE, np.int64)
        self.zero_width_tiles = 0
        self.base_folds = 0  # look-backs that folded down to base_bits

    def tile_words(self, t):
        """Steps 1-3: the tile's units and its words from its first bit,
        built thread by thread as the kernel's deposit builds them: a
        thread's bits gather in a 64-bit register from the start of its
        first word; each full word goes out, stored plainly when it lies
        strictly inside the thread's bit range (it must then be untouched)
        and ORed in otherwise."""
        b, j = divmod(t, self.nblk)
        d = np.zeros(TILE, np.int64)
        part = self.desc[b, j * TILE:(j + 1) * TILE]
        d[:len(part)] = part
        val, n, ts = decode_units(d, self.tbl[b])
        units = TILE // THREADS
        s = n.reshape(THREADS, units).sum(axis=1)
        offs = np.cumsum(s) - s
        w_s = np.zeros(LOCAL_WORDS, np.int64)
        lt = -1
        for th in range(THREADS):
            o = int(offs[th])
            w_first = cw = o >> 5
            acc, lt_rel = 0, -1
            for k in range(th * units, (th + 1) * units):
                if ts[k]:
                    lt_rel = o - int(offs[th])
                acc |= int(val[k]) << (o - 32 * cw)
                o += int(n[k])
                if o - 32 * cw >= 32:
                    if cw < LOCAL_WORDS:
                        if cw == w_first:
                            w_s[cw] |= acc & M32
                        else:
                            assert w_s[cw] == 0, "a plain store clobbers"
                            w_s[cw] = acc & M32
                    acc >>= 32
                    cw += 1
            if acc & M32 and cw < LOCAL_WORDS:
                w_s[cw] |= acc & M32
            if lt_rel >= 0:
                lt = max(lt, int(offs[th]) + lt_rel)
        # the kernel's run, from the units before the words exist: the
        # last token start from each thread's own (above), the tail from
        # the units that reach into the tile's last min(n, 32) bits
        n_tile = int(n.sum())
        win = n_tile - min(n_tile, 32)
        off = np.cumsum(n) - n
        tail = 0
        for k in np.nonzero((n > 0) & (off + n > win))[0]:
            o = int(off[k])
            tail |= (int(val[k]) << (o - win)) & M32 if o >= win \
                else int(val[k]) >> (win - o)
        return n_tile, lt, w_s, tail

    def publish(self, t):
        """Step 2: the tile's run, as an aggregate or (tile 0) inclusive."""
        n, lt, w_s, tail = self.tile_words(t)
        q = n - min(n, 32)
        wi, r = q >> 5, q & 31
        from_words = int(w_s[wi]) >> r
        if r:
            from_words |= (int(w_s[wi + 1]) << (32 - r)) & M32
        assert tail == from_words, "the run's tail differs from its words"
        mine = (n, lt, tail)
        self.zero_width_tiles += n == 0
        b, j = divmod(t, self.nblk)
        self.agg[t] = mine  # every tile writes its aggregate
        if j == 0:
            pre = (int(self.base[b]), -1, 0)
            self.incl[t] = combine(pre, mine)
            self.flags[t] = INCL
            return (mine, w_s, pre)
        self.flags[t] = AGG
        return (mine, w_s, None)

    def look_back(self, t):
        """Step 4 as a generator that yields while a thread would spin:
        thread d reads tile q - d's flag once; the nearest inclusive run
        (lowest d) in that snapshot ends the round, and the threads before
        it wait for aggregates.  Without one, the aggregates fold down to
        tile 0 and then base_bits (tile 0 may publish between the read and
        the wait)."""
        b, j = divmod(t, self.nblk)
        run = IDENTITY
        nt = self.threads
        lanes = min(32, nt)
        for q in range(j - 1, -1, -nt):
            ps = [q - d for d in range(nt)]
            fs = [self.flags[b * self.nblk + p] if p >= 0 else 0 for p in ps]
            inc = [d for d, f in enumerate(fs) if f == INCL]
            m = inc[0] if inc else nt
            while any(self.flags[b * self.nblk + ps[d]] == 0
                      for d in range(min(m, nt)) if ps[d] >= 0):
                yield None
            x = [IDENTITY] * nt
            for d in range(min(m + 1, nt)):
                if ps[d] >= 0:
                    tp = b * self.nblk + ps[d]
                    x[d] = self.incl[tp] if d == m else self.agg[tp]
            warps = []
            for w in range(nt // lanes):
                xs = x[lanes * w:lanes * w + lanes]
                o = 1
                while o < lanes:  # the shfl_down fold, older lanes left
                    xs = [combine(xs[i + o], xs[i]) if i + o < lanes
                          else xs[i] for i in range(lanes)]
                    o <<= 1
                warps.append(xs[0])
            r = warps[-1]
            for wr in reversed(warps[:-1]):
                r = combine(r, wr)
            run = combine(r, run)
            if inc:
                return run
        self.base_folds += 1
        return combine((int(self.base[b]), -1, 0), run)

    def store(self, t, mine, w_s, pre):
        """Step 5: the words whose last bit lies in [s, e), shifted."""
        b, j = divmod(t, self.nblk)
        s0 = pre[0]
        e0 = s0 + mine[0]
        sh = s0 & 31
        pb = (pre[2] >> (min(s0, 32) - sh)) if sh else 0
        last = j == self.nblk - 1
        w0 = s0 >> 5
        kmax = (e0 >> 5) - w0 + (1 if last and e0 & 31 else 0)
        for k in range(kmax):
            if w0 + k >= self.nw:
                break
            cur = int(w_s[k]) if k < LOCAL_WORDS else 0
            v = cur
            if sh:
                prev = pb if k == 0 else \
                    (int(w_s[k - 1]) if k - 1 < LOCAL_WORDS else 0) >> \
                    (32 - sh)
                v = ((cur << sh) & M32) | prev
            self.words[b, w0 + k] = v
            self.writes[b, w0 + k] += 1
        if last:
            self.total[b] = e0
            l = s0 + mine[1] if mine[1] >= 0 else pre[1]
            self.last_tok[b] = -1 if l < 0 else l

    def zero_block(self, z):
        """Words of one image below base_bits or past the stream's end."""
        zblk = -(-self.nw // ZERO_WORDS)
        b = z // zblk
        lo = (z - b * zblk) * ZERO_WORDS
        hi = min(lo + ZERO_WORDS, self.nw)
        head = int(self.base[b]) >> 5
        tail = (self.incl[b * self.nblk + self.nblk - 1][0] + 31) >> 5
        for q in range(lo, hi):
            if q < head or q >= tail:
                self.words[b, q] = 0
                self.writes[b, q] += 1

    def run(self, resident=48):
        """Tickets in order, up to `resident` tiles in flight; each step
        moves a random tile that can move (publish, or finish its
        look-back and store), then the zeroing blocks in a random order
        once their image's last tile is inclusive."""
        pending, state, looks, nxt = {}, {}, {}, 0
        while nxt < self.tiles or pending:
            while nxt < self.tiles and len(pending) < resident:
                pending[nxt] = "start"
                nxt += 1
            order = list(pending)
            self.rng.shuffle(order)
            for t in order:
                if pending[t] == "start":
                    state[t] = self.publish(t)
                    pending[t] = "lookback"
                    break
                mine, w_s, pre = state[t]
                if pre is None:
                    look = looks.setdefault(t, self.look_back(t))
                    try:
                        next(look)
                        continue  # a thread spins
                    except StopIteration as done:
                        pre = done.value
                    self.incl[t] = combine(pre, mine)
                    self.flags[t] = INCL
                self.store(t, mine, w_s, pre)
                del pending[t]
                break
            else:
                raise AssertionError("no tile can move: the look-back "
                                     "would deadlock")
        zblk = -(-self.nw // ZERO_WORDS)
        for z in self.rng.permutation(self.desc.shape[0] * zblk):
            self.zero_block(int(z))
        return self


def twin_b1(desc, tbl, base, num_words, seed=0, threads=THREADS):
    tw = B1Twin(desc.numpy(), tbl.numpy(), base.numpy(), num_words,
                np.random.default_rng(seed), threads).run()
    assert (tw.writes == 1).all(), "a word is stored twice or never"
    return tw


def tiles_per_word(desc, tbl, base):
    """For each image, the largest number of tiles whose bits reach one
    word (from the plain offsets)."""
    from fpng_tpu_torch.ops.bitpack import exclusive_offsets
    from fpng_tpu_torch.ops.encfuse import materialize_units

    B = desc.shape[0]
    t = tbl.reshape(B, -1).to(torch.int64)
    _, nbits, _ = materialize_units(desc, t & 0xFFFF, t >> 16)
    off = exclusive_offsets(nbits, base)
    best = 0
    for b in range(B):
        nz = nbits[b] > 0
        first = (off[b][nz] >> 5).numpy()
        last = ((off[b][nz] + nbits[b][nz] - 1) >> 5).numpy()
        tile = np.nonzero(nz.numpy())[0] // TILE
        per = {}
        for f, l, tl in zip(first, last, tile):
            for w in range(f, l + 1):
                per.setdefault(int(w), set()).add(int(tl))
        best = max([best] + [len(s) for s in per.values()])
    return best


def make_image(rng, h, w, c, kind):
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    if kind == "flat":
        img[:] = img[:1, :1]
    elif kind == "mixed":
        img[h // 4:h // 2, :] = rng.integers(0, 256, c, dtype=np.uint8)
        img[:, w // 4:w // 3] = rng.integers(0, 256, c, dtype=np.uint8)
    return img


def corpus_desc(imgs, base_bits=None):
    B, H, W, Cc = imgs.shape
    st = one_pass_state(Cc, "cpu")
    desc, tbl, *_ = build_desc(
        torch.from_numpy(imgs), st.codes.expand(B, -1),
        st.sizes.expand(B, -1), torch.full((B,), st.acc, dtype=torch.int32),
        torch.full((B,), st.nacc, dtype=torch.int32), num_chans=Cc,
        cost_check=False)
    base = torch.full((B,), len(st.prefix) * 8 if base_bits is None
                      else base_bits, dtype=torch.int32)
    return desc, tbl, base, _num_words(_budget(H, W, Cc))


def raw_desc(widths, vals=None, tok=None):
    """A (1, N) stream of raw units (no table) of the given widths."""
    widths = np.asarray(widths, np.int64)
    vals = np.zeros_like(widths) if vals is None else np.asarray(vals)
    d = (widths << DESC_EXTRA_N_SHIFT) | (vals << DESC_EXTRA_VAL_SHIFT)
    if tok is not None:
        d |= np.where(np.asarray(tok), DESC_TOK_START, 0)
    return torch.from_numpy(d.astype(np.int32)[None])


def three_tile_word():
    """Tile 0 ends 5 bits into a word, tile 1 adds 3 bits to it, tile 2 is
    empty, tile 3 adds 7 more: bits of three tiles share that word."""
    rng = np.random.default_rng(3)
    N = 4 * TILE + 300
    w = np.zeros(N, np.int64)
    w[:TILE - 5] = rng.integers(0, 8, TILE - 5)
    x = (5 - (19 + int(w.sum()))) % 32  # up to 31 bits over 5 units
    w[TILE - 5:TILE] = [min(7, max(0, x - 7 * i)) for i in range(5)]
    w[TILE + 100] = 3
    w[3 * TILE + 7] = 7
    w[3 * TILE + 8:] = rng.integers(0, 8, N - 3 * TILE - 8)
    vals = rng.integers(0, 1 << 13, N) & ((1 << w) - 1)
    tok = rng.random(N) < 0.3
    return raw_desc(w, vals, tok)


def b1_case(name):
    """(desc, tbl, base, num_words) of each twin case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "zero_width_tiles":
        # a flat image's stream (a match start every 258 bytes) with the
        # match starts of two whole tiles dropped: tiles of zero-width units
        desc, tbl, base, nw = corpus_desc(
            np.stack([make_image(rng, 5, 1400, 3, "flat")]))
        desc[:, TILE:3 * TILE] = 0
        return desc, tbl, base, nw
    if name == "mixed_kinds_b3":
        return corpus_desc(np.stack([make_image(rng, 37, 61, 3, k)
                                     for k in ("mixed", "flat", "noise")]))
    if name == "ragged_n":  # N = 1 + 29 * 286 + 1, not a multiple of 2048
        return corpus_desc(np.stack([make_image(rng, 29, 95, 3, k)
                                     for k in ("noise", "mixed")]))
    if name == "num_words_cut":
        desc, tbl, base, nw = corpus_desc(
            np.stack([make_image(rng, 40, 64, 3, "noise")]))
        return desc, tbl, base, 300
    if name == "many_rounds":  # 40 tiles of raw units, 2 to 7 bits
        N = 40 * TILE - 77
        w = rng.integers(0, 8, N)
        vals = rng.integers(0, 1 << 13, N) & ((1 << w) - 1)
        desc = raw_desc(w, vals, rng.random(N) < 0.1)
        tbl = torch.zeros((1, 8, 128), dtype=torch.int32)
        return desc, tbl, torch.tensor([45], dtype=torch.int32), \
            _num_words(_budget(N // 400, 100, 4))
    if name == "three_tile_word":
        desc = three_tile_word()
        tbl = torch.zeros((1, 8, 128), dtype=torch.int32)
        return desc, tbl, torch.tensor([19], dtype=torch.int32), 2048
    base = {"base_word_aligned": 64, "base_off_by_one": 63,
            "base_one_over": 65, "base_near_2_31": 2 ** 31 - 300}[name]
    desc, tbl, _, nw = corpus_desc(
        np.stack([make_image(rng, 24, 100, 3, k)
                  for k in ("mixed", "noise")]), base_bits=base)
    return desc, tbl, _, 1024 if base > 2 ** 30 else nw


B1_CASES = ["zero_width_tiles", "mixed_kinds_b3", "ragged_n", "num_words_cut",
            "three_tile_word", "base_word_aligned", "base_off_by_one",
            "base_one_over", "base_near_2_31", "many_rounds"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", B1_CASES)
def test_b1_twin_matches_plain(name, seed):
    """many_rounds reads 8 tiles a look-back round instead of 256, so that
    40 tiles take several rounds."""
    desc, tbl, base, nw = b1_case(name)
    tw = twin_b1(desc, tbl, base, nw, seed,
                 8 if name == "many_rounds" else THREADS)
    words, total, last_tok = encode_bits_plain(desc, tbl, base, nw)
    got = torch.from_numpy(((tw.words + 2 ** 31) % 2 ** 32 - 2 ** 31)
                           .astype(np.int32))
    assert torch.equal(got, words)
    assert torch.equal(torch.from_numpy(tw.total), total)
    assert torch.equal(torch.from_numpy(tw.last_tok), last_tok)
    if name == "zero_width_tiles":
        assert tw.zero_width_tiles >= 2 and tw.base_folds >= 1
    if name == "three_tile_word":
        assert tiles_per_word(desc, tbl, base) >= 3
    if name == "base_near_2_31":
        assert (total > INT32_MAX).all() and not words.any()
    if name == "num_words_cut":
        assert int(total[0]) > 32 * nw  # the stream runs past the words


def test_b1_twin_run_combine_is_concatenation():
    """combine() keeps the last 32 bits and the last token start of the
    concatenated runs, for every split of a random bit string."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, 200)
    toks = rng.random(200) < 0.05

    def run(lo, hi):
        n = hi - lo
        k = min(n, 32)
        tail = sum(int(bits[hi - k + i]) << i for i in range(k))
        lt = max([i - lo for i in range(lo, hi) if toks[i]], default=-1)
        return (n, lt, tail)

    for lo, mid, hi in [(0, 0, 0), (0, 0, 40), (0, 40, 40), (3, 9, 20),
                        (0, 31, 33), (10, 60, 61), (0, 100, 200),
                        (5, 6, 7), (0, 32, 64)]:
        assert combine(run(lo, mid), run(mid, hi)) == run(lo, hi)


def twin_b7(deltas, len_sym, len_extra, cand, tbl, align=0):
    """csrc/demote.cu's plan: per image, byte-wise head up to the first
    16-byte boundary of cand (whose buffer starts `align` bytes past one),
    16-pixel groups, byte-wise tail."""
    B, H, W, _ = deltas.shape
    HW = H * W
    sizes = tbl.reshape(B, -1).numpy().astype(np.int64) >> 16
    d = deltas.reshape(B * HW, 4).numpy().astype(np.int64)
    ls, le = len_sym.reshape(-1).numpy(), len_extra.reshape(-1).numpy()
    c = cand.reshape(-1).numpy()
    out = np.full(B * HW, 7, np.uint8)  # every byte must be written
    for b in range(B):
        p0 = b * HW

        def px(q):
            lit = sizes[b][d[q]].sum()
            return int(sizes[b][ls[q]] + le[q] + 1 > lit)

        head = min(HW, (16 - (align + p0) % 16) % 16)
        groups = (HW - head) // GROUP
        rest = HW - head - GROUP * groups
        for i in range(head + rest):
            q = p0 + (i if i < head else i + GROUP * groups)
            out[q] = int(c[q]) and px(q)
        for g in range(groups):
            q0 = p0 + head + GROUP * g
            assert (align + q0) % 16 == 0 and q0 + GROUP <= p0 + HW
            out[q0:q0 + GROUP] = [px(q) if c[q] else 0
                                  for q in range(q0, q0 + GROUP)]
    return torch.from_numpy(out.astype(bool).reshape(B, H, W))


@pytest.mark.parametrize("align", [0, 5])
@pytest.mark.parametrize("shape", [(3, 21, 13), (2, 16, 16), (4, 7, 9),
                                   (1, 1, 1)])
def test_b7_twin_matches_plain(shape, align):
    """B7's 16-pixel groups with HW % 16 != 0 and B > 1 (image starts off
    the 16-byte grid), on a 2-value alphabet (many 1-pixel match starts),
    the 1-pass sizes for image 0 and random sizes for the others."""
    B, H, W = shape
    rng = np.random.default_rng(H * W + align)
    imgs = (rng.integers(0, 2, (B, H, W, 4)) * 37).astype(np.uint8)
    st = one_pass_state(4, "cpu")
    codes = st.codes.expand(B, -1)
    sizes = st.sizes.expand(B, -1).clone()
    for b in range(1, B):
        sizes[b] = torch.from_numpy(rng.integers(1, 13, 288))
    deltas, _, mstart, mlen, _, ls, le = tokens(torch.from_numpy(imgs), 4)
    args = (deltas, ls, le, mstart & (mlen == 1), pack_table(codes, sizes))
    want = demote_mask_plain(*args)
    assert torch.equal(twin_b7(*args, align=align), want)
    if B > 1 and H * W > 4:
        assert bool(args[3].any())
