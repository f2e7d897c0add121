// Incremental deposit Merkle accumulator — native runtime component.
//
// Copy of consensus_specs_tpu/deposit_contract/native/deposit_tree.cpp.
// The upstream specs' only non-Python executable is the deposit contract's
// EVM bytecode (deposit_contract/contracts/validator_registration.v.py:
// 69-140, compiled by Vyper); this is the same O(log n) accumulator as
// compiled native code, exposed through a C ABI for ctypes. Semantics are
// differentially tested against the Python model (deposit_contract/
// contract.py), which is itself pinned to the generic SSZ Merkleizer.
//
// Host code: g++ -O3 -shared -fPIC, built at first use by
// deposit_contract/native.py into the package's _build/ directory.

#include <cstdint>
#include <cstring>

namespace {

// ---------------------------------------------------------------------------
// SHA-256 (FIPS 180-4), self-contained
// ---------------------------------------------------------------------------

constexpr uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

struct Sha256 {
    uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                     0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    uint8_t buf[64];
    uint64_t total = 0;
    size_t fill = 0;

    void compress(const uint8_t *p) {
        uint32_t w[64];
        for (int i = 0; i < 16; i++)
            w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
                   (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
        for (int i = 16; i < 64; i++) {
            uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
            uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
        uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
        for (int i = 0; i < 64; i++) {
            uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
            uint32_t ch = (e & f) ^ (~e & g);
            uint32_t t1 = hh + S1 + ch + K[i] + w[i];
            uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
            uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
            uint32_t t2 = S0 + maj;
            hh = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        h[0] += a; h[1] += b; h[2] += c; h[3] += d;
        h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
    }

    void update(const uint8_t *p, size_t n) {
        total += n;
        while (n) {
            size_t take = 64 - fill < n ? 64 - fill : n;
            std::memcpy(buf + fill, p, take);
            fill += take; p += take; n -= take;
            if (fill == 64) { compress(buf); fill = 0; }
        }
    }

    void final(uint8_t out[32]) {
        uint64_t bits = total * 8;
        uint8_t pad = 0x80;
        update(&pad, 1);
        uint8_t z = 0;
        while (fill != 56) update(&z, 1);
        uint8_t len[8];
        for (int i = 0; i < 8; i++) len[i] = uint8_t(bits >> (56 - 8 * i));
        update(len, 8);
        for (int i = 0; i < 8; i++) {
            out[4 * i] = uint8_t(h[i] >> 24);
            out[4 * i + 1] = uint8_t(h[i] >> 16);
            out[4 * i + 2] = uint8_t(h[i] >> 8);
            out[4 * i + 3] = uint8_t(h[i]);
        }
    }
};

void sha256_2(const uint8_t a[32], const uint8_t b[32], uint8_t out[32]) {
    Sha256 s;
    s.update(a, 32);
    s.update(b, 32);
    s.final(out);
}

void sha256_buf(const uint8_t *p, size_t n, uint8_t out[32]) {
    Sha256 s;
    s.update(p, n);
    s.final(out);
}

// ---------------------------------------------------------------------------
// Accumulator (mirrors deposit_contract/contract.py / the Vyper deposit())
// ---------------------------------------------------------------------------

constexpr int TREE_DEPTH = 32;
constexpr uint64_t MAX_DEPOSIT_COUNT = (uint64_t(1) << TREE_DEPTH) - 1;
constexpr uint64_t MIN_DEPOSIT_GWEI = 1000000000ULL;

struct DepositTree {
    uint8_t branch[TREE_DEPTH][32] = {};
    uint8_t zerohashes[TREE_DEPTH][32] = {};
    uint64_t count = 0;

    DepositTree() {
        for (int i = 1; i < TREE_DEPTH; i++)
            sha256_2(zerohashes[i - 1], zerohashes[i - 1], zerohashes[i]);
    }
};

void le64(uint64_t v, uint8_t out[8]) {
    for (int i = 0; i < 8; i++) out[i] = uint8_t(v >> (8 * i));
}

// hash_tree_root(DepositData) with the contract's hand-rolled chunk tree
// (contract.py:32-44; the EVM code computes the identical shape)
void deposit_data_root(const uint8_t pk[48], const uint8_t wc[32],
                       uint64_t amount_gwei, const uint8_t sig[96],
                       uint8_t out[32]) {
    uint8_t pk_padded[64] = {};
    std::memcpy(pk_padded, pk, 48);
    uint8_t pk_root[32];
    sha256_buf(pk_padded, 64, pk_root);

    uint8_t sig_lo[32], sig_hi_in[64] = {}, sig_hi[32], sig_root[32];
    sha256_buf(sig, 64, sig_lo);
    std::memcpy(sig_hi_in, sig + 64, 32);
    sha256_buf(sig_hi_in, 64, sig_hi);
    sha256_2(sig_lo, sig_hi, sig_root);

    uint8_t left[32], right_in[64] = {}, right[32];
    sha256_2(pk_root, wc, left);
    le64(amount_gwei, right_in);
    std::memcpy(right_in + 32, sig_root, 32);
    sha256_buf(right_in, 64, right);
    sha256_2(left, right, out);
}

}  // namespace

extern "C" {

void *dt_new() { return new DepositTree(); }
void dt_free(void *h) { delete static_cast<DepositTree *>(h); }
uint64_t dt_count(void *h) { return static_cast<DepositTree *>(h)->count; }

// 0 ok; 1 tree full; 2 deposit below minimum
int dt_deposit(void *h, const uint8_t pk[48], const uint8_t wc[32],
               const uint8_t sig[96], uint64_t value_gwei) {
    auto *t = static_cast<DepositTree *>(h);
    if (t->count >= MAX_DEPOSIT_COUNT) return 1;
    if (value_gwei < MIN_DEPOSIT_GWEI) return 2;

    uint8_t node[32];
    deposit_data_root(pk, wc, value_gwei, sig, node);

    uint64_t size = t->count + 1;
    int level = 0;
    while ((size & 1) == 0) {
        sha256_2(t->branch[level], node, node);
        size >>= 1;
        level++;
    }
    std::memcpy(t->branch[level], node, 32);
    t->count++;
    return 0;
}

// contiguous column batches: pks [n*48], wcs [n*32], sigs [n*96], values [n]
int dt_deposit_batch(void *h, uint64_t n, const uint8_t *pks,
                     const uint8_t *wcs, const uint8_t *sigs,
                     const uint64_t *values) {
    for (uint64_t i = 0; i < n; i++) {
        int rc = dt_deposit(h, pks + 48 * i, wcs + 32 * i, sigs + 96 * i,
                            values[i]);
        if (rc) return rc;
    }
    return 0;
}

void dt_root(void *h, uint8_t out[32]) {
    auto *t = static_cast<DepositTree *>(h);
    uint8_t node[32] = {};
    uint64_t size = t->count;
    for (int level = 0; level < TREE_DEPTH; level++) {
        uint8_t next[32];
        if (size & 1)
            sha256_2(t->branch[level], node, next);
        else
            sha256_2(node, t->zerohashes[level], next);
        std::memcpy(node, next, 32);
        size >>= 1;
    }
    std::memcpy(out, node, 32);
}

}  // extern "C"
