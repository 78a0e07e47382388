// fpng_tpu_torch native host runtime (a copy of fpng_tpu's).
//
// The reference library's host-side layers are C++ (portability/checksum
// kernels fpng.cpp:195-487, container framing :1662-1829, chunk walk
// :2903-3083, dynamic-header parse + LUT build :1954-2105).  This is the
// rebuild's native equivalent: everything O(pixels) runs on the device, and
// the O(1)-per-image host work that sits on the batch critical path runs
// here instead of Python -- CRC-32/Adler-32, batched PNG container
// assembly around device-produced deflate payloads, the decode-side chunk
// walk, and the dynamic-block header parse that builds the packed 12-bit
// decode LUT consumed by ops/specdec.py.
//
// Build: g++ -O3 -shared -fPIC (driven by fpng_tpu_torch/runtime/__init__.py);
// binding is plain ctypes -- no external dependencies.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

// ---------------------------------------------------------------------------
// CRC-32 (slice-by-8; semantics of fpng.cpp:199-249's slice-by-4, widened)
// ---------------------------------------------------------------------------

uint32_t g_crc_tab[8][256];
bool g_crc_init = false;

void crc_init() {
    if (g_crc_init) return;
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        g_crc_tab[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
        for (int s = 1; s < 8; s++)
            g_crc_tab[s][i] =
                g_crc_tab[0][g_crc_tab[s - 1][i] & 0xFF] ^
                (g_crc_tab[s - 1][i] >> 8);
    g_crc_init = true;
}

uint32_t crc32_impl(const uint8_t* p, size_t n, uint32_t prev) {
    crc_init();
    uint32_t c = ~prev;
    while (n >= 8) {
        uint32_t lo, hi;
        memcpy(&lo, p, 4);
        memcpy(&hi, p + 4, 4);
        lo ^= c;
        c = g_crc_tab[7][lo & 0xFF] ^ g_crc_tab[6][(lo >> 8) & 0xFF] ^
            g_crc_tab[5][(lo >> 16) & 0xFF] ^ g_crc_tab[4][lo >> 24] ^
            g_crc_tab[3][hi & 0xFF] ^ g_crc_tab[2][(hi >> 8) & 0xFF] ^
            g_crc_tab[1][(hi >> 16) & 0xFF] ^ g_crc_tab[0][hi >> 24];
        p += 8; n -= 8;
    }
    while (n--) c = g_crc_tab[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
    return ~c;
}

// ---------------------------------------------------------------------------
// Adler-32 (mod-65521 deferral, fpng.cpp:465-487)
// ---------------------------------------------------------------------------

uint32_t adler32_impl(const uint8_t* p, size_t n, uint32_t prev) {
    uint32_t a = prev & 0xFFFF, b = prev >> 16;
    while (n) {
        size_t blk = n < 5552 ? n : 5552;
        n -= blk;
        while (blk--) { a += *p++; b += a; }
        a %= 65521; b %= 65521;
    }
    return (b << 16) | a;
}

// ---------------------------------------------------------------------------
// Shared format constants (constants.py parity)
// ---------------------------------------------------------------------------

const uint8_t PNG_SIG[8] = {137, 80, 78, 71, 13, 10, 26, 10};
const uint8_t FDEC_SIG[4] = {82, 36, 147, 227};
enum {
    DEC_SUCCESS = 0, DEC_NOT_FPNG = 1, DEC_INVALID_ARG = 2,
    DEC_NOT_PNG = 3, DEC_HDR_CRC = 4, DEC_BAD_DIMS = 5,
    DEC_CHUNK = 7, DEC_BAD_IDAT = 8,
};
const uint32_t MAX_DIM = 1u << 24;
const uint64_t MAX_PIXELS = 1ull << 30;

uint32_t rd_be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | p[3];
}
void wr_be32(uint8_t* p, uint32_t v) {
    p[0] = uint8_t(v >> 24); p[1] = uint8_t(v >> 16);
    p[2] = uint8_t(v >> 8); p[3] = uint8_t(v);
}

// ---------------------------------------------------------------------------
// Chunk walk (container.get_info_internal / fpng.cpp:2930-3077 parity)
// ---------------------------------------------------------------------------

int get_info_walk(const uint8_t* d, size_t len, int check_crcs,
                  uint32_t* w, uint32_t* h, uint32_t* ch,
                  uint32_t* idat_ofs, uint32_t* idat_len) {
    if (len < 8 + 25 + 12 + 1 + 12) return DEC_NOT_PNG;
    if (memcmp(d, PNG_SIG, 8)) return DEC_NOT_PNG;
    if (rd_be32(d + 8) != 13) return DEC_NOT_PNG;
    if (check_crcs && crc32_impl(d + 12, 17, 0) != rd_be32(d + 29))
        return DEC_HDR_CRC;
    uint32_t W = rd_be32(d + 16), H = rd_be32(d + 20);
    uint8_t bitdepth = d[24], color = d[25], comp = d[26], filt = d[27],
            inter = d[28];
    if (!W || !H || W > MAX_DIM || H > MAX_DIM) return DEC_BAD_DIMS;
    if ((uint64_t)W * H > MAX_PIXELS) return DEC_BAD_DIMS;
    *w = W; *h = H;
    if (comp || filt || inter || bitdepth != 8) return DEC_NOT_FPNG;
    if (color == 2) *ch = 3;
    else if (color == 6) *ch = 4;
    else return DEC_NOT_FPNG;

    size_t ofs = 33;
    bool found_fdec = false;
    for (;;) {
        if (ofs >= len || len - ofs < 12) return DEC_CHUNK;
        uint32_t clen = rd_be32(d + ofs);
        if (ofs + 12 + (uint64_t)clen > len) return DEC_CHUNK;
        const uint8_t* ct = d + ofs + 4;
        for (int i = 0; i < 4; i++) {
            uint8_t c = ct[i];
            if (!((c >= 65 && c <= 90) || (c >= 97 && c <= 122)))
                return DEC_CHUNK;
        }
        bool is_idat = !memcmp(ct, "IDAT", 4);
        if (check_crcs && !is_idat &&
            crc32_impl(d + ofs + 4, 4 + clen, 0) !=
                rd_be32(d + ofs + 8 + clen))
            return DEC_HDR_CRC;
        if (!memcmp(ct, "IEND", 4)) break;
        if (is_idat) {
            if (*idat_ofs || !found_fdec) return DEC_NOT_FPNG;
            *idat_ofs = (uint32_t)ofs;
            *idat_len = clen;
            if (clen < 7) return DEC_BAD_IDAT;
        } else if (!memcmp(ct, "fdEC", 4)) {
            if (found_fdec || clen != 5) return DEC_NOT_FPNG;
            if (memcmp(d + ofs + 8, FDEC_SIG, 4) || d[ofs + 12] != 0)
                return DEC_NOT_FPNG;
            found_fdec = true;
        } else if ((ct[0] & 32) == 0) {
            return DEC_NOT_FPNG;  // unknown critical chunk
        }
        ofs += 12 + clen;
    }
    if (!found_fdec || !*idat_ofs) return DEC_NOT_FPNG;
    return DEC_SUCCESS;
}

// get_info_internal parity: failure paths report idat_ofs/idat_len as 0
int get_info_impl(const uint8_t* d, size_t len, int check_crcs,
                  uint32_t* w, uint32_t* h, uint32_t* ch,
                  uint32_t* idat_ofs, uint32_t* idat_len) {
    *w = *h = *ch = *idat_ofs = *idat_len = 0;
    int st = get_info_walk(d, len, check_crcs, w, h, ch, idat_ofs, idat_len);
    if (st != DEC_SUCCESS) *idat_ofs = *idat_len = 0;
    return st;
}

// ---------------------------------------------------------------------------
// Dynamic-block header parse + packed 12-bit LUT (fpng.cpp:1954-2105 and
// ops/specdec.pack_lut parity)
// ---------------------------------------------------------------------------

struct BitRd {
    const uint8_t* p; size_t len; size_t pos;  // pos in bits
    uint32_t peek(int n) const {
        uint64_t w = 0;
        size_t byte = pos >> 3;
        for (int i = 0; i < 8; i++)
            if (byte + i < len) w |= uint64_t(p[byte + i]) << (8 * i);
        return uint32_t((w >> (pos & 7)) & ((1u << n) - 1));
    }
    uint32_t get(int n) { uint32_t v = peek(n); pos += n; return v; }
};

const int CLEN_ORDER[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4,
                            12, 3, 13, 2, 14, 1, 15};

// build_decoder_table parity (huffman.py:314): entry = sym | len<<9
bool build_table(int num_syms, const uint8_t* sizes, uint32_t* table,
                 int table_bits) {
    int64_t num_codes[17] = {0};
    for (int i = 0; i < num_syms; i++) {
        if (sizes[i] > 15) return false;
        num_codes[sizes[i]]++;
    }
    int64_t next_code[18] = {0};
    int64_t total = 0, nonzero = 0;
    for (int i = 1; i <= 15; i++) {
        nonzero += num_codes[i];
        total = (total + num_codes[i]) << 1;
        next_code[i + 1] = total;
    }
    if (total != 0x10000 && nonzero != 1) return false;
    size_t tsize = size_t(1) << table_bits;
    memset(table, 0, tsize * 4);
    for (int i = 0; i < num_syms; i++) {
        int size = sizes[i];
        if (!size) continue;
        int64_t code = next_code[size]++;
        // bit-reverse
        uint32_t rev = 0;
        for (int b = 0; b < size; b++) rev |= ((code >> b) & 1) << (size - 1 - b);
        if (size > table_bits) continue;  // callers reject >12 lit codes
        uint32_t entry = uint32_t(i) | (uint32_t(size) << 9);
        for (size_t j = rev; j < tsize; j += size_t(1) << size)
            table[j] = entry;
    }
    return true;
}

// deflate length-symbol geometry (constants.py LEN_BASE/EXTRA_BY_SYM)
void len_sym_geometry(int idx, int* base, int* nextra) {
    static int BASE[29], EXTRA[29];
    static bool init = false;
    if (!init) {
        static const int eb[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2,
                                   2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
        int length = 3;
        for (int s = 0; s < 28; s++) {
            BASE[s] = length; EXTRA[s] = eb[s];
            length += 1 << eb[s];
        }
        BASE[28] = 258; EXTRA[28] = 0;
        init = true;
    }
    *base = BASE[idx]; *nextra = EXTRA[idx];
}

// Returns DEC_SUCCESS and fills lut (4096 packed entries) + p0 (bit pos of
// the first token) or DEC_NOT_FPNG.
int parse_dyn_header_impl(const uint8_t* src, size_t src_len, int num_chans,
                          uint32_t* lut, int32_t* p0) {
    BitRd r{src, src_len, 0};
    if (src_len < 3 || src[0] != 0x78 || src[1] != 0x01) return DEC_NOT_FPNG;
    r.pos = 16;
    if (r.get(1) != 1 || r.get(2) != 2) return DEC_NOT_FPNG;

    int num_lit = int(r.get(5)) + 257;
    int num_dist = int(r.get(5)) + 1;
    int total = num_lit + num_dist;
    if (total > 288 + 32) return DEC_NOT_FPNG;
    int num_clen = int(r.get(4)) + 4;
    uint8_t clen_sizes[19] = {0};
    for (int i = 0; i < num_clen; i++)
        clen_sizes[CLEN_ORDER[i]] = uint8_t(r.get(3));
    static thread_local uint32_t clen_table[1 << 12];
    if (!build_table(19, clen_sizes, clen_table, 12)) return DEC_NOT_FPNG;

    uint8_t code_sizes[288 + 32] = {0};
    int cur = 0;
    while (cur < total) {
        uint32_t e = clen_table[r.peek(12)];
        int sym_len = (e >> 9) & 15;
        if (!sym_len) return DEC_NOT_FPNG;
        r.pos += sym_len;
        int sym = e & 511;
        if (sym <= 15) {
            if (sym > 12) return DEC_NOT_FPNG;  // fpng code limit
            code_sizes[cur++] = uint8_t(sym);
            continue;
        }
        int rep, val = 0;
        if (sym == 16) {
            if (cur == 0) return DEC_NOT_FPNG;
            rep = int(r.get(2)) + 3;
            val = code_sizes[cur - 1];
        } else if (sym == 17) {
            rep = int(r.get(3)) + 3;
        } else {
            rep = int(r.get(7)) + 11;
        }
        if (cur + rep > total) return DEC_NOT_FPNG;
        memset(code_sizes + cur, val, rep);
        cur += rep;
    }

    // fpng distance-code constraints (fpng.cpp:2058-2074)
    const uint8_t* dist_sizes = code_sizes + num_lit;
    int valid = 0;
    for (int i = 0; i < num_dist; i++) valid += dist_sizes[i] == 1;
    if (valid < 1 || valid > 2) return DEC_NOT_FPNG;
    if (num_chans - 1 >= num_dist || dist_sizes[num_chans - 1] != 1)
        return DEC_NOT_FPNG;
    if (valid == 2 && dist_sizes[num_chans] != 1) return DEC_NOT_FPNG;

    uint8_t lit_sizes[288] = {0};
    memcpy(lit_sizes, code_sizes, num_lit < 288 ? num_lit : 288);
    if (!build_table(288, lit_sizes, lut, 12)) return DEC_NOT_FPNG;

    // pack run geometry + speculative second literal (specdec.pack_lut
    // parity; the reference's second-symbol trick, fpng.cpp:2080-2102).
    // Reserved syms 286/287 keep their sym|clen with zero geometry:
    // walks must keep advancing so a spurious lane never freezes the
    // entry fixpoint (specdec.py); the record pass rejects them on the
    // true chain.
    uint32_t raw[4096];
    memcpy(raw, lut, sizeof raw);
    for (size_t i = 0; i < 4096; i++) {
        uint32_t e = raw[i];
        int sym = e & 511;
        int cl = int((e >> 9) & 15);
        if (sym > 285) { lut[i] = e & 0x1FFF; continue; }
        if (sym > 256 && e) {
            int base, nextra;
            len_sym_geometry(sym - 257, &base, &nextra);
            lut[i] = (e & 0x1FFF) | (uint32_t(nextra) << 13) |
                     (uint32_t(base) << 16);
        } else if (sym < 256 && cl > 0) {
            uint32_t e2 = raw[(i >> cl) & 0xFFF];
            int s2 = e2 & 511;
            int l2 = int((e2 >> 9) & 15);
            uint32_t out = e & 0x1FFF;
            if (l2 > 0 && s2 < 256 && l2 + cl <= 12)
                out |= (uint32_t(s2) << 16) | (uint32_t(l2) << 25);
            lut[i] = out;
        }
    }
    *p0 = int32_t(r.pos);
    return DEC_SUCCESS;
}

// ---------------------------------------------------------------------------
// Batched container assembly (fpng.cpp:1662-1829 driver work, batched)
// ---------------------------------------------------------------------------

void build_header(uint8_t* hdr, uint32_t zlib_size, uint32_t w, uint32_t h,
                  int num_chans) {
    memcpy(hdr, PNG_SIG, 8);
    wr_be32(hdr + 8, 13);
    memcpy(hdr + 12, "IHDR", 4);
    wr_be32(hdr + 16, w);
    wr_be32(hdr + 20, h);
    hdr[24] = 8;
    hdr[25] = num_chans == 3 ? 2 : 6;
    hdr[26] = hdr[27] = hdr[28] = 0;
    wr_be32(hdr + 29, crc32_impl(hdr + 12, 17, 0));
    wr_be32(hdr + 33, 5);
    memcpy(hdr + 37, "fdEC", 4);
    memcpy(hdr + 41, FDEC_SIG, 4);
    hdr[45] = 0;
    wr_be32(hdr + 46, crc32_impl(hdr + 37, 9, 0));
    wr_be32(hdr + 50, zlib_size);
    memcpy(hdr + 54, "IDAT", 4);
}

}  // namespace

// ---------------------------------------------------------------------------
// 2-pass Huffman table construction + dynamic block header emit.
// Byte-exact twin of huffman.py (itself reproducing the
// reference's table pipeline, fpng.cpp:607-816): stable frequency sort,
// Moffat/Katajainen minimum-redundancy lengths in uint16 arithmetic,
// Kraft max-code-size fixup, canonical bit-reversed codes, RLE-compressed
// header.  Batched: the per-image Python loop was the 2-pass bottleneck.
// ---------------------------------------------------------------------------

namespace {

constexpr int NUM_LIT = 288;
constexpr int NUM_DIST = 32;
constexpr int NUM_CLEN = 19;
constexpr int LIT_LIMIT = 12;
constexpr int CLEN_LIMIT = 7;
// (code-length transmit order CLEN_ORDER is shared with the decode side)

void min_redundancy(uint16_t* A, int n) {
    if (n == 0) return;
    if (n == 1) { A[0] = 1; return; }
    A[0] = uint16_t(A[0] + A[1]);
    int root = 0, leaf = 2;
    for (int nxt = 1; nxt < n - 1; nxt++) {
        if (leaf >= n || A[root] < A[leaf]) {
            A[nxt] = A[root];
            A[root] = uint16_t(nxt);
            root++;
        } else {
            A[nxt] = A[leaf];
            leaf++;
        }
        if (leaf >= n || (root < nxt && A[root] < A[leaf])) {
            A[nxt] = uint16_t(A[nxt] + A[root]);
            A[root] = uint16_t(nxt);
            root++;
        } else {
            A[nxt] = uint16_t(A[nxt] + A[leaf]);
            leaf++;
        }
    }
    A[n - 2] = 0;
    for (int nxt = n - 3; nxt >= 0; nxt--)
        A[nxt] = uint16_t(A[A[nxt]] + 1);
    int avbl = 1, used = 0, dpth = 0;
    int r2 = n - 2, nxt = n - 1;
    while (avbl > 0) {
        while (r2 >= 0 && A[r2] == dpth) { used++; r2--; }
        while (avbl > used) { A[nxt] = uint16_t(dpth); nxt--; avbl--; }
        avbl = 2 * used;
        dpth++;
        used = 0;
    }
}

void enforce_max_size(int* num_codes, int code_list_len, int max_size) {
    if (code_list_len <= 1) return;
    for (int i = max_size + 1; i <= 32; i++) {
        num_codes[max_size] += num_codes[i];
        num_codes[i] = 0;
    }
    int64_t total = 0;
    for (int i = max_size; i > 0; i--)
        total += int64_t(num_codes[i]) << (max_size - i);
    while (total != (int64_t(1) << max_size)) {
        num_codes[max_size]--;
        for (int i = max_size - 1; i > 0; i--) {
            if (num_codes[i]) {
                num_codes[i]--;
                num_codes[i + 1] += 2;
                break;
            }
        }
        total--;
    }
}

uint32_t bitrev(uint32_t code, int nbits) {
    uint32_t r = 0;
    for (int i = 0; i < nbits; i++) { r = (r << 1) | (code & 1); code >>= 1; }
    return r;
}

// sizes (0 = unused) from uint16 freqs; stable ascending sort, shortest
// lengths assigned walking the sorted array from its high end
void build_sizes(const uint16_t* freqs, int n, int limit,
                 uint8_t* sizes, int* num_codes /* [33] */) {
    int idx[NUM_LIT];
    uint16_t key[NUM_LIT];
    int m = 0;
    for (int i = 0; i < n; i++)
        if (freqs[i]) { idx[m] = i; key[m] = freqs[i]; m++; }
    // stable sort by frequency (ties keep symbol-index order, matching
    // the reference's radix sort); <= 288 elements so comparison sort wins
    int order[NUM_LIT];
    for (int i = 0; i < m; i++) order[i] = i;
    std::stable_sort(order, order + m,
                     [&](int a, int b) { return key[a] < key[b]; });
    uint16_t A[NUM_LIT];
    for (int i = 0; i < m; i++) A[i] = key[order[i]];
    min_redundancy(A, m);
    memset(num_codes, 0, 33 * sizeof(int));
    for (int i = 0; i < m; i++) num_codes[A[i]]++;
    enforce_max_size(num_codes, m, limit);
    memset(sizes, 0, n);
    int j = m;
    for (int i = 1; i <= limit; i++)
        for (int k = 0; k < num_codes[i]; k++)
            sizes[idx[order[--j]]] = uint8_t(i);
}

void canonical(const uint8_t* sizes, int n, const int* num_codes, int limit,
               uint16_t* codes) {
    int next_code[34];
    memset(next_code, 0, sizeof(next_code));
    int j = 0;
    for (int i = 2; i <= limit; i++) {
        j = (j + num_codes[i - 1]) << 1;
        next_code[i] = j;
    }
    for (int i = 0; i < n; i++) {
        int s = sizes[i];
        if (!s) { codes[i] = 0; continue; }
        codes[i] = uint16_t(bitrev(uint32_t(next_code[s]++), s));
    }
}

struct BitWr {
    uint8_t* buf;
    int nbytes = 0;
    uint64_t acc = 0;
    int nacc = 0;
    void put(uint32_t v, int nbits) {
        acc |= uint64_t(v) << nacc;
        nacc += nbits;
        while (nacc >= 8) {
            buf[nbytes++] = uint8_t(acc);
            acc >>= 8;
            nacc -= 8;
        }
    }
};

void emit_header(BitWr& w, const uint8_t* lit_sizes,
                 const uint8_t* dist_sizes) {
    int num_lit = 286;
    while (num_lit > 257 && lit_sizes[num_lit - 1] == 0) num_lit--;
    int num_dist = 30;
    while (num_dist > 1 && dist_sizes[num_dist - 1] == 0) num_dist--;

    uint8_t concat[NUM_LIT + NUM_DIST];
    memcpy(concat, lit_sizes, num_lit);
    memcpy(concat + num_lit, dist_sizes, num_dist);
    int total = num_lit + num_dist;

    // RLE pack (RFC 1951 3.2.7 syms 16/17/18), mirroring
    // huffman._pack_code_sizes
    uint8_t psym[NUM_LIT + NUM_DIST];
    int8_t pextra[NUM_LIT + NUM_DIST];
    int np = 0;
    uint16_t clen_freq[NUM_CLEN];
    memset(clen_freq, 0, sizeof(clen_freq));
    int rle_z = 0, rle_rep = 0;
    int prev = 0xFF;
    auto flush_prev = [&]() {
        if (!rle_rep) return;
        if (rle_rep < 3) {
            clen_freq[prev] = uint16_t(clen_freq[prev] + rle_rep);
            for (int i = 0; i < rle_rep; i++) {
                psym[np] = uint8_t(prev); pextra[np++] = -1;
            }
        } else {
            clen_freq[16]++;
            psym[np] = 16; pextra[np++] = int8_t(rle_rep - 3);
        }
        rle_rep = 0;
    };
    auto flush_zero = [&]() {
        if (!rle_z) return;
        if (rle_z < 3) {
            clen_freq[0] = uint16_t(clen_freq[0] + rle_z);
            for (int i = 0; i < rle_z; i++) { psym[np] = 0; pextra[np++] = -1; }
        } else if (rle_z <= 10) {
            clen_freq[17]++;
            psym[np] = 17; pextra[np++] = int8_t(rle_z - 3);
        } else {
            clen_freq[18]++;
            psym[np] = 18; pextra[np++] = int8_t(rle_z - 11);
        }
        rle_z = 0;
    };
    for (int i = 0; i < total; i++) {
        int size = concat[i];
        if (size == 0) {
            flush_prev();
            if (++rle_z == 138) flush_zero();
        } else {
            flush_zero();
            if (size != prev) {
                flush_prev();
                clen_freq[size]++;
                psym[np] = uint8_t(size); pextra[np++] = -1;
            } else if (++rle_rep == 6) {
                flush_prev();
            }
        }
        prev = size;
    }
    if (rle_rep) flush_prev(); else flush_zero();

    uint8_t clen_sizes[NUM_CLEN];
    int clen_nc[33];
    build_sizes(clen_freq, NUM_CLEN, CLEN_LIMIT, clen_sizes, clen_nc);
    uint16_t clen_codes[NUM_CLEN];
    canonical(clen_sizes, NUM_CLEN, clen_nc, CLEN_LIMIT, clen_codes);

    w.put(2, 2);  // BTYPE = dynamic
    w.put(uint32_t(num_lit - 257), 5);
    w.put(uint32_t(num_dist - 1), 5);
    int nbl = 18;
    while (nbl >= 0 && clen_sizes[CLEN_ORDER[nbl]] == 0) nbl--;
    nbl = nbl + 1 < 4 ? 4 : nbl + 1;
    w.put(uint32_t(nbl - 4), 4);
    for (int i = 0; i < nbl; i++) w.put(clen_sizes[CLEN_ORDER[i]], 3);
    static const int CLEN_EXTRA[3] = {2, 3, 7};
    for (int i = 0; i < np; i++) {
        int sym = psym[i];
        w.put(clen_codes[sym], clen_sizes[sym]);
        if (sym >= 16) w.put(uint32_t(pextra[i]), CLEN_EXTRA[sym - 16]);
    }
}

}  // namespace

extern "C" {

// Batched 2-pass table build + header emit (replaces the per-image
// Python loop around huffman.build_tables / emit_dynamic_block_header).
//   hists:       (B, 288) uint32 token histograms (EOB forced here)
//   prefixes:    (B, prefix_stride) output arena: zlib hdr + BFINAL +
//                dynamic block header, whole bytes
// Per image also emits codes/sizes (B, 288) and the sub-byte pending
// tail (pend_val, pend_n) the device kernel appends as unit 0.
void fp_build_tables_batch(
    const uint32_t* hists, int64_t b_count, int num_chans,
    uint32_t* codes, int32_t* sizes,
    uint8_t* prefixes, int64_t prefix_stride, int32_t* prefix_lens,
    uint32_t* pend_vals, int32_t* pend_ns) {
    for (int64_t b = 0; b < b_count; b++) {
        const uint32_t* hist = hists + b * NUM_LIT;
        // adjust_freq32: scale into uint16 preserving non-zero-ness;
        // EOB re-forced to raw 1 after scaling (fpng.cpp:757)
        uint64_t tot = 0;
        for (int i = 0; i < NUM_LIT; i++)
            tot += (i == 256) ? 1 : uint64_t(hist[i]);
        uint16_t freq16[NUM_LIT];
        for (int i = 0; i < NUM_LIT; i++) {
            uint64_t f = (i == 256) ? 1 : uint64_t(hist[i]);
            if (!f || !tot) { freq16[i] = 0; continue; }
            uint64_t s = (f * 0xFFFFu) / tot;
            freq16[i] = uint16_t(s ? s : 1);
        }
        freq16[256] = 1;

        uint8_t lit_sizes[NUM_LIT];
        int lit_nc[33];
        build_sizes(freq16, NUM_LIT, LIT_LIMIT, lit_sizes, lit_nc);
        uint16_t lit_codes[NUM_LIT];
        canonical(lit_sizes, NUM_LIT, lit_nc, LIT_LIMIT, lit_codes);

        uint16_t dist_freq[NUM_DIST];
        memset(dist_freq, 0, sizeof(dist_freq));
        int ds = num_chans - 1;  // DIST_SYM = {3ch: 2, 4ch: 3}
        dist_freq[ds] = 1;
        dist_freq[ds + 1] = 1;  // wuffs-strictness second code
        uint8_t dist_sizes[NUM_DIST];
        int dist_nc[33];
        build_sizes(dist_freq, NUM_DIST, LIT_LIMIT, dist_sizes, dist_nc);

        for (int i = 0; i < NUM_LIT; i++) {
            codes[b * NUM_LIT + i] = lit_codes[i];
            sizes[b * NUM_LIT + i] = lit_sizes[i];
        }

        BitWr w{prefixes + b * prefix_stride};
        w.put(0x78, 8);
        w.put(0x01, 8);
        w.put(1, 1);  // BFINAL
        emit_header(w, lit_sizes, dist_sizes);
        prefix_lens[b] = w.nbytes;
        pend_vals[b] = uint32_t(w.acc);
        pend_ns[b] = w.nacc;
    }
}

uint32_t fp_crc32(const uint8_t* p, size_t n, uint32_t prev) {
    return crc32_impl(p, n, prev);
}

uint32_t fp_adler32(const uint8_t* p, size_t n, uint32_t prev) {
    return adler32_impl(p, n, prev);
}

int fp_get_info(const uint8_t* d, size_t len, int check_crcs,
                uint32_t* w, uint32_t* h, uint32_t* ch,
                uint32_t* idat_ofs, uint32_t* idat_len) {
    return get_info_impl(d, len, check_crcs, w, h, ch, idat_ofs, idat_len);
}

int fp_parse_dyn_header(const uint8_t* src, size_t src_len, int num_chans,
                        uint32_t* lut, int32_t* p0) {
    return parse_dyn_header_impl(src, src_len, num_chans, lut, p0);
}

// Assemble B PNGs around device-produced deflate payloads.
//   words:      (B, num_words) little-endian uint32 payload buffers
//   total_bits: (B,) deflate stream length in bits (incl. spliced prefix)
//   last_tok:   (B,) bit offset of the last token start (flush-window rule)
//   adler:      (B,) device adler32 of the filtered stream
//   prefix_*:   per-image serialized header prefixes (concatenated)
//   budget:     reference output budget for the deflate stream
// Output: `out` arena of size B*(58+budget+16); out_lens[b] = PNG byte
// length, or 0 when image b needs the stored-block fallback (caller
// handles it; fpng.cpp:1728-1758).
void fp_assemble_batch(
    const uint8_t* words, int64_t num_words,
    const int64_t* total_bits, const int64_t* last_tok,
    const uint32_t* adler,
    const uint8_t* prefix_data, const int64_t* prefix_ofs,
    int64_t b_count, uint32_t w, uint32_t h, int num_chans, int64_t budget,
    uint8_t* out, int64_t out_stride, int64_t* out_lens) {
    for (int64_t b = 0; b < b_count; b++) {
        int64_t tb = total_bits[b];
        int64_t total_bytes = (tb + 7) >> 3;
        int64_t plen = prefix_ofs[b + 1] - prefix_ofs[b];
        bool fail = (last_tok[b] >= 0 && (last_tok[b] >> 3) + 8 > budget) ||
                    total_bytes + 4 > budget || plen > budget;
        if (fail) { out_lens[b] = 0; continue; }
        uint8_t* dst = out + b * out_stride;
        uint32_t zlib_size = uint32_t(total_bytes + 4);
        build_header(dst, zlib_size, w, h, num_chans);
        uint8_t* body = dst + 58;
        memcpy(body, words + b * num_words * 4, total_bytes);
        memcpy(body, prefix_data + prefix_ofs[b], plen);
        wr_be32(body + total_bytes, adler[b]);
        uint32_t idat_crc = crc32_impl(dst + 54, 4 + zlib_size, 0);
        uint8_t* tail = body + zlib_size;
        wr_be32(tail, idat_crc);
        wr_be32(tail + 4, 0);
        memcpy(tail + 8, "IEND", 4);
        wr_be32(tail + 12, crc32_impl(tail + 8, 4, 0));
        out_lens[b] = 58 + zlib_size + 16;
    }
}

// General PNG defilter over h rows of (1 + bpl) filtered bytes (the
// scalar chains of the Sub/Average/Paeth filters; pvpngreader.cpp's
// unpredict_{sub,up,average,paeth} semantics, :1047-1152).  `raw` is
// (h, 1+bpl) row-major; `out` receives (h, bpl).  fb = filter byte
// distance (ceil(bits-per-pixel / 8), >= 1).  Returns 0, or -1 on an
// invalid filter type byte.
int fp_defilter(const uint8_t* raw, int64_t h, int64_t bpl, int fb,
                uint8_t* out) {
    for (int64_t y = 0; y < h; y++) {
        const uint8_t* cur = raw + y * (bpl + 1);
        const uint8_t* prev = y ? out + (y - 1) * bpl : nullptr;
        uint8_t* rec = out + y * bpl;
        switch (cur[0]) {
            case 0:
                memcpy(rec, cur + 1, size_t(bpl));
                break;
            case 1:
                for (int64_t x = 0; x < bpl; x++)
                    rec[x] = uint8_t(cur[1 + x] +
                                     (x >= fb ? rec[x - fb] : 0));
                break;
            case 2:
                if (prev)
                    for (int64_t x = 0; x < bpl; x++)
                        rec[x] = uint8_t(cur[1 + x] + prev[x]);
                else
                    memcpy(rec, cur + 1, size_t(bpl));
                break;
            case 3:
                for (int64_t x = 0; x < bpl; x++) {
                    int left = x >= fb ? rec[x - fb] : 0;
                    int up = prev ? prev[x] : 0;
                    rec[x] = uint8_t(cur[1 + x] + ((left + up) >> 1));
                }
                break;
            case 4:
                for (int64_t x = 0; x < bpl; x++) {
                    int a = x >= fb ? rec[x - fb] : 0;
                    int b = prev ? prev[x] : 0;
                    int c = (prev && x >= fb) ? prev[x - fb] : 0;
                    int p = a + b - c;
                    int pa = p > a ? p - a : a - p;
                    int pb = p > b ? p - b : b - p;
                    int pc = p > c ? p - c : c - p;
                    int pred = (pa <= pb && pa <= pc) ? a
                               : (pb <= pc ? b : c);
                    rec[x] = uint8_t(cur[1 + x] + pred);
                }
                break;
            default:
                return -1;
        }
    }
    return 0;
}

}  // extern "C"
