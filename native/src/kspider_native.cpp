// Native runtime for kspider_tpu: streaming FASTA/FASTQ sketching,
// phmap-dump-compatible binary IO, and an OpenMP host pairwise engine.
//
// This is the host-side counterpart of the device compute path — the
// roles the reference implements in C++ (kmer decoding/hashing:
// /root/reference/src/fastx_to_kf.cpp; phmap dumps:
// /root/reference/src/index.cpp:333-386; OpenMP pairwise hot loop:
// /root/reference/src/pairwise.cpp:199-237) are re-implemented here from
// scratch with a C ABI consumed via ctypes.  The OpenMP pairwise engine
// doubles as the host baseline that bench.py compares the device Gram
// against.
//
// Build: make -C native   (g++ -O3 -shared, with -fopenmp where the
// toolchain has OpenMP; without it every loop runs on one thread)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#else
#include <chrono>
static inline int omp_get_max_threads() { return 1; }
static inline int omp_get_thread_num() { return 0; }
static inline double omp_get_wtime() {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}
#endif
#include <sys/mman.h>
#include <zlib.h>

extern "C" {

// Bumped whenever an exported signature changes; io/native.py checks it
// and rebuilds a stale .so instead of calling with a mismatched ABI.
int ks_abi_version() { return 5; }

// ---------------------------------------------------------------------------
// memory
// ---------------------------------------------------------------------------

void ks_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// MurmurHash64A (Austin Appleby's 64-bit hash; public domain algorithm) —
// used for the kProcessor-style murmur_int path — and MurmurHash3_x64_128
// (first 64 bits), the hash sourmash applies to canonical k-mer strings
// with seed 42.
// ---------------------------------------------------------------------------

static inline uint64_t murmur64a(const uint8_t* data, size_t len, uint64_t seed) {
    const uint64_t m = 0xc6a4a7935bd1e995ULL;
    const int r = 47;
    uint64_t h = seed ^ (len * m);
    const uint8_t* p = data;
    const uint8_t* end = data + (len & ~size_t(7));
    while (p != end) {
        uint64_t k;
        memcpy(&k, p, 8);
        p += 8;
        k *= m;
        k ^= k >> r;
        k *= m;
        h ^= k;
        h *= m;
    }
    size_t tail = len & 7;
    if (tail) {
        uint64_t t = 0;
        for (size_t i = tail; i-- > 0;) t = (t << 8) | p[i];
        h ^= t;
        h *= m;
    }
    h ^= h >> r;
    h *= m;
    h ^= h >> r;
    return h;
}

void ks_murmur64_batch(const uint8_t* rows, int64_t n, int64_t len,
                       uint64_t seed, uint64_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        out[i] = murmur64a(rows + i * len, (size_t)len, seed);
    }
}

static inline uint64_t rotl64(uint64_t x, int r) {
    return (x << r) | (x >> (64 - r));
}

static inline uint64_t fmix64(uint64_t k) {
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33;
    k *= 0xc4ceb9fe1a85ec53ULL;
    k ^= k >> 33;
    return k;
}

// First 64 bits of MurmurHash3_x64_128 (canonical smhasher algorithm).
static inline uint64_t murmur3_64(const uint8_t* data, size_t len,
                                  uint64_t seed) {
    const uint64_t c1 = 0x87c37b91114253d5ULL;
    const uint64_t c2 = 0x4cf5ad432745937fULL;
    uint64_t h1 = seed, h2 = seed;
    const size_t nblocks = len / 16;
    for (size_t i = 0; i < nblocks; i++) {
        uint64_t k1, k2;
        memcpy(&k1, data + i * 16, 8);
        memcpy(&k2, data + i * 16 + 8, 8);
        k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
        h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729ULL;
        k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
        h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5ULL;
    }
    const uint8_t* tail = data + nblocks * 16;
    const size_t t = len & 15;
    uint64_t k1 = 0, k2 = 0;
    if (t > 8) {
        for (size_t i = t; i-- > 8;) k2 = (k2 << 8) | tail[i];
        k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    }
    if (t > 0) {
        const size_t m = t < 8 ? t : 8;
        for (size_t i = m; i-- > 0;) k1 = (k1 << 8) | tail[i];
        k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    }
    h1 ^= (uint64_t)len; h2 ^= (uint64_t)len;
    h1 += h2; h2 += h1;
    h1 = fmix64(h1); h2 = fmix64(h2);
    return h1 + h2;
}

void ks_murmur3_batch(const uint8_t* rows, int64_t n, int64_t len,
                      uint64_t seed, uint64_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        out[i] = murmur3_64(rows + i * len, (size_t)len, seed);
    }
}

// Thomas-Wang style invertible 64-bit mix masked to 2k bits (MQF family).
static inline uint64_t tw_hash(uint64_t key, uint64_t mask) {
    key = (~key + (key << 21)) & mask;
    key = key ^ (key >> 24);
    key = (key + (key << 3) + (key << 8)) & mask;
    key = key ^ (key >> 14);
    key = (key + (key << 2) + (key << 4)) & mask;
    key = key ^ (key >> 28);
    key = (key + (key << 31)) & mask;
    return key;
}

void ks_integer_hash_batch(const uint64_t* keys, int64_t n, int ksize,
                           uint64_t* out) {
    uint64_t mask = (ksize >= 32) ? ~0ULL : ((1ULL << (2 * ksize)) - 1);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) out[i] = tw_hash(keys[i], mask);
}

// ---------------------------------------------------------------------------
// FASTA/FASTQ streaming sketcher
// ---------------------------------------------------------------------------

namespace {

struct LineReader {
    gzFile f = nullptr;
    std::vector<char> buf;
    explicit LineReader(const char* path) : buf(1 << 20) {
        f = gzopen(path, "rb");
    }
    ~LineReader() {
        if (f) gzclose(f);
    }
    bool ok() const { return f != nullptr; }
    // returns false at EOF; strips trailing newline/CR
    bool getline(std::string& out) {
        out.clear();
        for (;;) {
            char* r = gzgets(f, buf.data(), (int)buf.size());
            if (!r) return !out.empty();
            out += r;
            if (!out.empty() && out.back() == '\n') {
                out.pop_back();
                if (!out.empty() && out.back() == '\r') out.pop_back();
                return true;
            }
            // long line: keep appending
        }
    }
};

constexpr uint8_t kInvalid = 255;

struct Tables {
    uint8_t code[256];
    uint8_t comp[256];
    Tables() {
        memset(code, kInvalid, sizeof(code));
        const char* b = "ACGT";
        const char* lb = "acgt";
        for (int i = 0; i < 4; i++) {
            code[(uint8_t)b[i]] = (uint8_t)i;
            code[(uint8_t)lb[i]] = (uint8_t)i;
        }
        for (int i = 0; i < 256; i++) comp[i] = (uint8_t)i;
        comp['A'] = 'T'; comp['T'] = 'A'; comp['C'] = 'G'; comp['G'] = 'C';
        comp['a'] = 'T'; comp['t'] = 'A'; comp['c'] = 'G'; comp['g'] = 'C';
    }
};
static const Tables kTables;

// Hash every canonical k-mer of seq (sourmash convention:
// MurmurHash3_x64_128 first 64 bits, seed 42),
// appending hashes < max_hash to out.  Counts every window (valid or not
// containing invalid bases are skipped entirely).
void hash_sequence_sourmash(const std::string& seq, int k, uint64_t max_hash,
                            std::vector<uint64_t>& out, uint64_t* total) {
    const size_t n = seq.size();
    if ((int)n < k) return;
    std::string fwd(k, 'N'), rcv(k, 'N');
    // rolling validity: index of last invalid base seen
    ptrdiff_t last_bad = -1;
    for (size_t i = 0; i < n; i++) {
        if (kTables.code[(uint8_t)seq[i]] == kInvalid) last_bad = (ptrdiff_t)i;
        if (i + 1 < (size_t)k) continue;
        size_t start = i + 1 - k;
        if (last_bad >= (ptrdiff_t)start) continue;  // window has invalid base
        (*total)++;  // count valid windows only (matches the Python sketcher)
        // build canonical: compare fwd vs revcomp lexicographically
        for (int j = 0; j < k; j++) {
            char c = seq[start + j];
            fwd[j] = (char)(c >= 'a' ? c - 32 : c);  // uppercase
            rcv[k - 1 - j] = (char)kTables.comp[(uint8_t)c];
        }
        const std::string& canon = (rcv < fwd) ? rcv : fwd;
        uint64_t h = murmur3_64((const uint8_t*)canon.data(), (size_t)k, 42);
        if (h < max_hash) out.push_back(h);
    }
}

// returns 0 on success
int sketch_stream(const char* path, int k, uint64_t max_hash,
                  std::vector<uint64_t>& hashes, uint64_t* total) {
    LineReader rd(path);
    if (!rd.ok()) return 1;
    std::string line, seq;
    if (!rd.getline(line)) return 0;
    if (!line.empty() && line[0] == '>') {  // FASTA
        while (rd.getline(line)) {
            if (!line.empty() && line[0] == '>') {
                hash_sequence_sourmash(seq, k, max_hash, hashes, total);
                seq.clear();
            } else {
                seq += line;
            }
        }
        hash_sequence_sourmash(seq, k, max_hash, hashes, total);
    } else if (!line.empty() && line[0] == '@') {  // FASTQ
        // kseq-compatible (like the reference's kmerDecoder): sequence
        // and quality may wrap over multiple lines; quality ends when
        // its accumulated length reaches the sequence length.  Matches
        // kspider_tpu/io/fastx.py read_records, including the error
        // behavior (rc=3 -> IOError -> Python-parser fallback raises the
        // same ValueError) — the old 4-line-record loop silently
        // mis-parsed wrapped records.
        for (;;) {
            seq.clear();
            bool got_plus = false;
            for (;;) {
                if (!rd.getline(line)) break;     // EOF
                if (!line.empty() && line[0] == '+') { got_plus = true; break; }
                seq += line;
            }
            if (!got_plus) {
                if (!seq.empty()) return 3;       // truncated: no '+' line
                break;
            }
            size_t qlen = 0;
            while (qlen < seq.size()) {
                if (!rd.getline(line)) return 3;  // truncated quality
                qlen += line.size();
            }
            if (qlen > seq.size()) return 3;      // quality overruns seq
            hash_sequence_sourmash(seq, k, max_hash, hashes, total);
            bool have;
            while ((have = rd.getline(line)) && line.empty()) {}  // blanks
            if (!have) break;
            if (line[0] != '@') return 3;         // malformed record start
        }
    } else {
        return 2;
    }
    return 0;
}

}  // namespace

// Sketch one file: canonical k-mers, murmur3 x64_128 seed 42 (sourmash
// convention), keep hash < UINT64_MAX/scale, return UNIQUE sorted hashes.
// Returns 0 on success.  *out is malloc'd; free with ks_free.
int ks_sketch_file(const char* path, int k, uint64_t scale, uint64_t** out,
                   int64_t* n_out, uint64_t* total_kmers,
                   uint64_t* inserted_kmers) {
    uint64_t max_hash = (scale <= 1) ? ~0ULL : (~0ULL / scale);
    std::vector<uint64_t> hashes;
    uint64_t total = 0;
    int rc = sketch_stream(path, k, max_hash, hashes, &total);
    if (rc) return rc;
    *inserted_kmers = (uint64_t)hashes.size();
    *total_kmers = total;
    std::sort(hashes.begin(), hashes.end());
    hashes.erase(std::unique(hashes.begin(), hashes.end()), hashes.end());
    *n_out = (int64_t)hashes.size();
    *out = (uint64_t*)malloc(sizeof(uint64_t) * hashes.size());
    memcpy(*out, hashes.data(), sizeof(uint64_t) * hashes.size());
    return 0;
}

// ---------------------------------------------------------------------------
// phmap-dump-compatible .bin IO (layout documented in kspider_tpu/io/phmap.py)
// ---------------------------------------------------------------------------

static uint64_t normalize_capacity(uint64_t n) {
    if (n == 0) return 1;
    uint64_t cap = 1;
    while (cap - cap / 8 < n) cap = cap * 2 + 1;
    return cap;
}

int ks_write_bin(const char* path, const uint64_t* hashes, int64_t n) {
    FILE* f = fopen(path, "wb");
    if (!f) return 1;
    uint64_t size = (uint64_t)n;
    uint64_t cap = normalize_capacity(size);
    fwrite(&size, 8, 1, f);
    fwrite(&cap, 8, 1, f);
    if (size) {
        std::vector<uint8_t> ctrl(cap + 17, 0x80);
        for (uint64_t i = 0; i < size; i++)
            ctrl[i] = (uint8_t)(hashes[i] & 0x7f);
        ctrl[cap] = 0xff;
        for (int i = 0; i < 16; i++) ctrl[cap + 1 + i] = ctrl[i];
        fwrite(ctrl.data(), 1, ctrl.size(), f);
        fwrite(hashes, 8, size, f);
        // pad the empty slots
        std::vector<uint64_t> zeros(cap - size, 0);
        if (!zeros.empty()) fwrite(zeros.data(), 8, zeros.size(), f);
    }
    fclose(f);
    return 0;
}

int ks_read_bin(const char* path, uint64_t** out, int64_t* n_out) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    uint64_t first = 0, size = 0, cap = 0;
    if (fread(&first, 8, 1, f) != 1) { fclose(f); return 2; }
    if (first >= (~0ULL) - 10) {  // versioned dump
        if (fread(&size, 8, 1, f) != 1) { fclose(f); return 2; }
    } else {
        size = first;
    }
    if (fread(&cap, 8, 1, f) != 1) { fclose(f); return 2; }
    std::vector<uint64_t> vals;
    if (size) {
        std::vector<uint8_t> ctrl(cap + 17);
        if (fread(ctrl.data(), 1, ctrl.size(), f) != ctrl.size()) {
            fclose(f);
            return 2;
        }
        std::vector<uint64_t> slots(cap);
        if (fread(slots.data(), 8, cap, f) != cap) { fclose(f); return 2; }
        vals.reserve(size);
        for (uint64_t i = 0; i < cap; i++)
            if (ctrl[i] < 0x80) vals.push_back(slots[i]);
        if (vals.size() != size) { fclose(f); return 3; }
    }
    fclose(f);
    std::sort(vals.begin(), vals.end());
    *n_out = (int64_t)vals.size();
    *out = (uint64_t*)malloc(sizeof(uint64_t) * vals.size());
    memcpy(*out, vals.data(), sizeof(uint64_t) * vals.size());
    return 0;
}

// ---------------------------------------------------------------------------
// OpenMP host pairwise engine (baseline + fallback)
// ---------------------------------------------------------------------------

// Dense shared-kmer matrix: for each color, add weight to all member
// pairs.  Per-thread partial matrices, reduced at the end — the
// contention-free version of the reference's mutex-guarded hash map
// (/root/reference/src/pairwise.cpp:22-27,220-225).
void ks_pairwise_dense(const int64_t* offsets, const int32_t* members,
                       const int64_t* weights, int64_t n_colors, int32_t n,
                       int threads, int64_t* s_out) {
    size_t nn = (size_t)n * n;
    memset(s_out, 0, nn * sizeof(int64_t));
    if (threads <= 0) threads = omp_get_max_threads();
#pragma omp parallel num_threads(threads)
    {
        std::vector<int64_t> local(nn, 0);
#pragma omp for schedule(dynamic, 256)
        for (int64_t c = 0; c < n_colors; c++) {
            int64_t start = offsets[c], end = offsets[c + 1];
            int64_t w = weights[c];
            for (int64_t i = start; i < end; i++) {
                int32_t a = members[i];
                int64_t* row = local.data() + (size_t)a * n;
                for (int64_t j = i + 1; j < end; j++) {
                    int32_t b = members[j];
                    row[b] += w;
                }
            }
        }
#pragma omp critical
        {
            for (size_t i = 0; i < nn; i++) s_out[i] += local[i];
        }
    }
    // symmetrize (we accumulated upper/lower mixed depending on member order)
    for (int32_t i = 0; i < n; i++) {
        for (int32_t j = i + 1; j < n; j++) {
            int64_t v = s_out[(size_t)i * n + j] + s_out[(size_t)j * n + i];
            s_out[(size_t)i * n + j] = v;
            s_out[(size_t)j * n + i] = v;
        }
        s_out[(size_t)i * n + i] = 0;
    }
}

int ks_omp_max_threads() { return omp_get_max_threads(); }

// ---------------------------------------------------------------------------
// Bitmask block packer — the native replacement of the np.bitwise_or.at
// hot path (kspider_tpu/ops/bitmask.py) feeding the panel-streamed
// engine.  Segment s (color s's postings within one panel) owns output
// row (s / block, s % block); rows are disjoint per segment, so the
// OpenMP split over segments is race-free by construction.  Layout:
// out[n_blocks][block][n8]; ``out`` must be zero-initialized by the
// caller (np.zeros).
// ---------------------------------------------------------------------------

void ks_pack_segments(const int32_t* mem_s, const int64_t* seg_start,
                      const int64_t* seg_count, int64_t n_segs,
                      int64_t panel_base, int64_t n8, int64_t block,
                      uint8_t* out) {
#pragma omp parallel for schedule(dynamic, 16)
    for (int64_t s = 0; s < n_segs; s++) {
        const int64_t blk = s / block, c = s % block;
        const int32_t* m = mem_s + seg_start[s];
        const int64_t cnt = seg_count[s];
        uint8_t* row = out + ((size_t)blk * (size_t)block + (size_t)c) * (size_t)n8;
        for (int64_t i = 0; i < cnt; i++) {
            const int64_t local = (int64_t)m[i] - panel_base;
            row[local >> 3] |= (uint8_t)(0x80u >> (local & 7));
        }
    }
}

// Parallel flat-posting fill: copy per-sample hash arrays into the
// contiguous (hashes, gids) buffers the color build consumes.  The
// Python per-sample loop pays numpy slice dispatch per sample; this is a
// bandwidth-bound memcpy sweep.
int ks_fill_postings(const uint64_t* const* srcs, const int64_t* lens,
                     const int32_t* gids, const int64_t* offs,
                     int64_t n_arrays, uint64_t* hashes_out,
                     int32_t* gids_out) {
#pragma omp parallel for schedule(dynamic, 256)
    for (int64_t i = 0; i < n_arrays; i++) {
        const int64_t m = lens[i];
        if (m <= 0) continue;
        memcpy(hashes_out + offs[i], srcs[i], (size_t)m * sizeof(uint64_t));
        const int32_t g = gids[i];
        int32_t* gp = gids_out + offs[i];
        for (int64_t k = 0; k < m; k++) gp[k] = g;
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Color-class build: sort-based derivation of the final color state
// (the vectorized-native counterpart of core/index.py; replaces the
// reference's sequential color algorithm src/sourmash_indexing.cpp:190-260)
// ---------------------------------------------------------------------------

extern "C" {

// Input: n_postings (hash, gid) pairs.  Output (all malloc'd, ks_free):
//   class_offsets  i64[n_classes+1]
//   class_members  i32[sum degrees]
//   class_counts   i64[n_classes]
// Classes are canonically ordered by (degree, members lexicographic).
// Duplicate (hash, gid) pairs are deduplicated.
static double _ks_now() { return omp_get_wtime(); }
static bool _ks_timing() {
    static int v = -1;
    if (v < 0) v = getenv("KSPIDER_DEBUG_TIMING") ? 1 : 0;
    return v == 1;
}
#define KS_T(label) do { if (_ks_timing()) { double t = _ks_now(); \
    fprintf(stderr, "[ks_build_colors] %-10s %7.2fs\n", label, t - _t_prev); \
    _t_prev = t; } } while (0)

int ks_build_colors(const uint64_t* hashes, const int32_t* gids,
                    int64_t n_postings, int64_t** class_offsets_out,
                    int32_t** class_members_out, int64_t** class_counts_out,
                    int64_t* n_classes_out) {
    double _t_prev = _ks_now();
    if (n_postings == 0) {
        *class_offsets_out = (int64_t*)malloc(sizeof(int64_t));
        (*class_offsets_out)[0] = 0;
        *class_members_out = (int32_t*)malloc(1);
        *class_counts_out = (int64_t*)malloc(1);
        *n_classes_out = 0;
        return 0;
    }
    // sort postings by (hash, gid): parallel 256-bucket top-byte radix
    // partition (murmur hashes are uniform in the high byte) followed
    // by independent per-bucket sorts.  The bucket boundaries double as
    // parallel work ranges for the class scan below — a run (equal
    // hash) never crosses a bucket.
    //
    // Memory discipline matters more than algorithmics on this class of
    // host: first-touch page faults run at ~0.3 GB/s on lazily-backed
    // VMs (measured; steady-state is ~7 GB/s), so the build scatters
    // straight from the caller's arrays into ONE uninitialized packed
    // 12-byte buffer — no copy-in pass, no second partition buffer, no
    // value-initialized vector (each of those was a multi-GB first
    // touch costing more than the sort itself).
    struct HG {
        uint64_t h;
        int32_t g;
        bool operator<(const HG& o) const {
            return h < o.h || (h == o.h && g < o.g);
        }
    } __attribute__((packed, aligned(4)));
    static_assert(sizeof(HG) == 12, "HG must pack to 12 bytes");
    HG* p = (HG*)malloc(sizeof(HG) * (size_t)n_postings);
    if (!p) return 2;
#ifdef MADV_HUGEPAGE
    madvise(p, sizeof(HG) * (size_t)n_postings, MADV_HUGEPAGE);
#endif
    constexpr int NB = 256;
    std::vector<int64_t> boff;  // bucket ranges for the parallel scan
    {
        int nth = omp_get_max_threads();
        if (n_postings >= ((int64_t)1 << 22) && nth > 1) {
            const int64_t chunk = (n_postings + nth - 1) / nth;
            std::vector<int64_t> cursor((size_t)nth * NB, 0);
#pragma omp parallel num_threads(nth)
            {
                int t = omp_get_thread_num();
                int64_t lo = (int64_t)t * chunk;
                int64_t hi = std::min<int64_t>(n_postings, lo + chunk);
                int64_t* h = &cursor[(size_t)t * NB];
                for (int64_t i = lo; i < hi; i++) h[hashes[i] >> 56]++;
            }
            // exclusive prefix over (bucket, thread): each thread gets a
            // disjoint destination range per bucket
            int64_t acc = 0;
            boff.assign(NB + 1, 0);
            for (int b = 0; b < NB; b++) {
                boff[b] = acc;
                for (int t = 0; t < nth; t++) {
                    int64_t c = cursor[(size_t)t * NB + b];
                    cursor[(size_t)t * NB + b] = acc;
                    acc += c;
                }
            }
            boff[NB] = n_postings;
#pragma omp parallel num_threads(nth)
            {
                int t = omp_get_thread_num();
                int64_t lo = (int64_t)t * chunk;
                int64_t hi = std::min<int64_t>(n_postings, lo + chunk);
                int64_t* cur = &cursor[(size_t)t * NB];
                for (int64_t i = lo; i < hi; i++)
                    p[cur[hashes[i] >> 56]++] = {hashes[i], gids[i]};
            }
            KS_T("scatter");
#pragma omp parallel for schedule(dynamic)
            for (int b = 0; b < NB; b++)
                std::sort(p + boff[b], p + boff[b + 1]);
        } else {
#pragma omp parallel for schedule(static)
            for (int64_t i = 0; i < n_postings; i++)
                p[i] = {hashes[i], gids[i]};
            std::sort(p, p + n_postings);
        }
    }
    KS_T("sort");
    if (boff.empty()) {  // serial-sort path: one scan range
        boff.assign(2, 0);
        boff[1] = n_postings;
    }

    // runs of equal hash -> member tuples, deduped into classes.  The
    // previous implementation walked the runs serially, heap-allocating
    // a member vector per class and chaining through an
    // unordered_multimap.  Phase timing at 251M postings split the old
    // build's cost between first-touch faults on the fat buffers
    // (copy-in 38s, double-buffer partition) and that serial scan; the
    // rewrite removes both: a bucket-parallel scan emits per-thread
    // flat member buffers + run records (duplicate (hash,gid) postings
    // dropped inline, singletons tallied per gid without records),
    // then ONE parallel sort of the run records by (degree, members
    // lexicographic) groups identical member sets and yields the
    // canonical class order directly.
    const int n_ranges = (int)(boff.size() - 1);
    int nth2 = omp_get_max_threads();
    std::vector<std::vector<int32_t>> t_mm((size_t)nth2);
    struct RunRec {
        int64_t off;
        int32_t len;
    };
    std::vector<std::vector<RunRec>> t_rr((size_t)nth2);
    std::vector<std::vector<int64_t>> t_single((size_t)nth2);
#pragma omp parallel num_threads(nth2)
    {
        int t = omp_get_thread_num();
        auto& mm = t_mm[(size_t)t];
        auto& rr = t_rr[(size_t)t];
        auto& singles = t_single[(size_t)t];
#pragma omp for schedule(dynamic)
        for (int b = 0; b < n_ranges; b++) {
            int64_t i = boff[b];
            const int64_t hi = boff[b + 1];
            while (i < hi) {
                const uint64_t h = p[i].h;
                int64_t j = i;
                const size_t start = mm.size();
                int32_t prev = -1;
                while (j < hi && p[j].h == h) {
                    int32_t g = p[j].g;
                    if (g != prev) {  // gid-sorted within run: dups adjacent
                        mm.push_back(g);
                        prev = g;
                    }
                    j++;
                }
                const size_t len = mm.size() - start;
                if (len == 1) {
                    if ((size_t)prev >= singles.size())
                        singles.resize((size_t)prev + 1, 0);
                    singles[(size_t)prev]++;
                    mm.resize(start);
                } else {
                    rr.push_back({(int64_t)start, (int32_t)len});
                }
                i = j;
            }
        }
    }
    free(p);
    KS_T("scan");

    // concatenate member buffers; rebase record offsets
    std::vector<int64_t> mm_base((size_t)nth2 + 1, 0);
    for (int t = 0; t < nth2; t++)
        mm_base[(size_t)t + 1] = mm_base[(size_t)t] + (int64_t)t_mm[(size_t)t].size();
    std::vector<int32_t> allmem((size_t)mm_base[(size_t)nth2]);
    int64_t n_recs = 0;
    for (int t = 0; t < nth2; t++) n_recs += (int64_t)t_rr[(size_t)t].size();
    std::vector<RunRec> recs;
    recs.reserve((size_t)n_recs);
#pragma omp parallel for schedule(static)
    for (int t = 0; t < nth2; t++) {
        memcpy(allmem.data() + mm_base[(size_t)t], t_mm[(size_t)t].data(),
               t_mm[(size_t)t].size() * sizeof(int32_t));
    }
    for (int t = 0; t < nth2; t++) {
        for (auto& r : t_rr[(size_t)t])
            recs.push_back({r.off + mm_base[(size_t)t], r.len});
        t_rr[(size_t)t].clear();
        t_rr[(size_t)t].shrink_to_fit();
        t_mm[(size_t)t].clear();
        t_mm[(size_t)t].shrink_to_fit();
    }

    KS_T("concat");
    // canonical order: (degree, members lexicographic) — parallel via
    // _GLIBCXX_PARALLEL; grouping falls out of adjacency
    const int32_t* am = allmem.data();
    std::sort(recs.begin(), recs.end(), [am](const RunRec& a, const RunRec& b) {
        if (a.len != b.len) return a.len < b.len;
        const int32_t* pa = am + a.off;
        const int32_t* pb = am + b.off;
        for (int32_t k = 0; k < a.len; k++)
            if (pa[k] != pb[k]) return pa[k] < pb[k];
        return false;
    });

    KS_T("class-sort");
    // fold per-thread singleton tallies
    size_t max_g = 0;
    for (auto& s : t_single) max_g = std::max(max_g, s.size());
    std::vector<int64_t> singleton_counts(max_g, 0);
    for (auto& s : t_single)
        for (size_t g = 0; g < s.size(); g++) singleton_counts[g] += s[g];

    // count classes + members: singletons (all degree 1, gid ascending)
    // come first in canonical order, then grouped multi records
    int64_t n_single_classes = 0;
    for (size_t g = 0; g < max_g; g++)
        if (singleton_counts[g]) n_single_classes++;
    auto same_rec = [am](const RunRec& a, const RunRec& b) {
        if (a.len != b.len) return false;
        return memcmp(am + a.off, am + b.off,
                      (size_t)a.len * sizeof(int32_t)) == 0;
    };
    int64_t n_multi_classes = 0, multi_members = 0;
    for (int64_t k = 0; k < n_recs; k++) {
        if (k == 0 || !same_rec(recs[(size_t)k - 1], recs[(size_t)k])) {
            n_multi_classes++;
            multi_members += recs[(size_t)k].len;
        }
    }
    const int64_t n_classes = n_single_classes + n_multi_classes;
    const int64_t total_members = n_single_classes + multi_members;
    auto* offs = (int64_t*)malloc(sizeof(int64_t) * (n_classes + 1));
    auto* mems = (int32_t*)malloc(sizeof(int32_t) * std::max<int64_t>(1, total_members));
    auto* counts = (int64_t*)malloc(sizeof(int64_t) * std::max<int64_t>(1, n_classes));
    if (!offs || !mems || !counts) {  // multi-GB at scale; mirror the p check
        free(offs); free(mems); free(counts);
        return 2;
    }
    offs[0] = 0;
    int64_t k_out = 0;
    for (size_t g = 0; g < max_g; g++) {
        if (!singleton_counts[g]) continue;
        offs[k_out + 1] = offs[k_out] + 1;
        mems[offs[k_out]] = (int32_t)g;
        counts[k_out] = singleton_counts[g];
        k_out++;
    }
    for (int64_t k = 0; k < n_recs; k++) {
        if (k > 0 && same_rec(recs[(size_t)k - 1], recs[(size_t)k])) {
            counts[k_out - 1]++;
            continue;
        }
        const RunRec& r = recs[(size_t)k];
        offs[k_out + 1] = offs[k_out] + r.len;
        memcpy(mems + offs[k_out], am + r.off,
               (size_t)r.len * sizeof(int32_t));
        counts[k_out] = 1;
        k_out++;
    }
    KS_T("emit");
    *class_offsets_out = offs;
    *class_members_out = mems;
    *class_counts_out = counts;
    *n_classes_out = n_classes;
    return 0;
}

// ---------------------------------------------------------------------------
// Pairwise TSV emission with C++ float formatting — by construction
// identical to the reference's ostream output (src/pairwise.cpp:242-274).
// ---------------------------------------------------------------------------

int ks_write_pairwise_tsv(const char* path, const int64_t* s, int32_t n,
                          const int64_t* kmer_counts, int64_t min_shared) {
    FILE* f = fopen(path, "wb");
    if (!f) return 1;
    setvbuf(f, nullptr, _IOFBF, 1 << 20);
    fputs("source_1\tsource_2\tshared_kmers\tmin_containment\tavg_containment\tmax_containment\n", f);
    if (min_shared < 1) min_shared = 1;
    char buf[64];
    for (int32_t a = 0; a < n; a++) {
        const int64_t* row = s + (size_t)a * n;
        for (int32_t b = a + 1; b < n; b++) {
            int64_t shared = row[b];
            if (shared < min_shared) continue;
            float c12 = (float)shared / (float)kmer_counts[b];
            float c21 = (float)shared / (float)kmer_counts[a];
            float cmin = c12 < c21 ? c12 : c21;
            float cavg = (float)((c12 + c21) / 2.0);
            float cmax = c12 > c21 ? c12 : c21;
            // %g with 6 significant digits == default ostream float format
            int len = snprintf(buf, sizeof(buf), "%d\t%d\t%lld\t%g\t%g\t%g\n",
                               a + 1, b + 1, (long long)shared,
                               (double)cmin, (double)cavg, (double)cmax);
            fwrite(buf, 1, (size_t)len, f);
        }
    }
    fclose(f);
    return 0;
}

// Streamed COO variant for the panel-tiled engine: rows arrive pre-sorted
// in (source_1, source_2) chunks; header==1 truncates + writes the header.
int ks_write_pairwise_coo(const char* path, const int64_t* gi,
                          const int64_t* gj, const int64_t* shared,
                          int64_t n_rows, const int64_t* kmer_counts,
                          int32_t header) {
    FILE* f = fopen(path, header ? "wb" : "ab");
    if (!f) return 1;
    setvbuf(f, nullptr, _IOFBF, 1 << 20);
    if (header)
        fputs("source_1\tsource_2\tshared_kmers\tmin_containment\tavg_containment\tmax_containment\n", f);
    char buf[96];
    for (int64_t r = 0; r < n_rows; r++) {
        int64_t a = gi[r], b = gj[r], sh = shared[r];
        float c12 = (float)sh / (float)kmer_counts[b];
        float c21 = (float)sh / (float)kmer_counts[a];
        float cmin = c12 < c21 ? c12 : c21;
        float cavg = (float)((c12 + c21) / 2.0);
        float cmax = c12 > c21 ? c12 : c21;
        int len = snprintf(buf, sizeof(buf), "%lld\t%lld\t%lld\t%g\t%g\t%g\n",
                           (long long)(a + 1), (long long)(b + 1),
                           (long long)sh, (double)cmin, (double)cavg,
                           (double)cmax);
        fwrite(buf, 1, (size_t)len, f);
    }
    fclose(f);
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// _color_to_sources.bin batch IO (record stream of u64 color + nested
// flat_hash_set<u32> dump; layout documented in kspider_tpu/io/phmap.py)
// ---------------------------------------------------------------------------

extern "C" {

static uint64_t set_capacity_u32(uint64_t n) { return normalize_capacity(n); }

int ks_write_color_to_sources(const char* path, const uint64_t* colors,
                              const int64_t* offsets, const uint32_t* members,
                              int64_t n_colors) {
    FILE* f = fopen(path, "wb");
    if (!f) return 1;
    setvbuf(f, nullptr, _IOFBF, 1 << 20);
    uint64_t count = (uint64_t)n_colors;
    fwrite(&count, 8, 1, f);
    std::vector<uint8_t> ctrl;
    std::vector<uint32_t> slots;
    for (int64_t c = 0; c < n_colors; c++) {
        fwrite(&colors[c], 8, 1, f);
        uint64_t size = (uint64_t)(offsets[c + 1] - offsets[c]);
        uint64_t cap = set_capacity_u32(size);
        fwrite(&size, 8, 1, f);
        fwrite(&cap, 8, 1, f);
        if (!size) continue;
        ctrl.assign(cap + 17, 0x80);
        const uint32_t* seg = members + offsets[c];
        for (uint64_t i = 0; i < size; i++) ctrl[i] = (uint8_t)(seg[i] & 0x7f);
        ctrl[cap] = 0xff;
        for (int i = 0; i < 16; i++) ctrl[cap + 1 + i] = ctrl[i];
        fwrite(ctrl.data(), 1, ctrl.size(), f);
        slots.assign(cap, 0);
        memcpy(slots.data(), seg, size * 4);
        fwrite(slots.data(), 4, cap, f);
    }
    fclose(f);
    return 0;
}

// Returns malloc'd arrays; members are sorted ascending per color.
int ks_read_color_to_sources(const char* path, uint64_t** colors_out,
                             int64_t** offsets_out, uint32_t** members_out,
                             int64_t* n_colors_out) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    uint64_t count = 0;
    if (fread(&count, 8, 1, f) != 1) { fclose(f); return 2; }
    std::vector<uint64_t> colors(count);
    std::vector<int64_t> offsets(count + 1, 0);
    std::vector<uint32_t> members;
    std::vector<uint8_t> ctrl;
    std::vector<uint32_t> slots;
    for (uint64_t c = 0; c < count; c++) {
        if (fread(&colors[c], 8, 1, f) != 1) { fclose(f); return 2; }
        uint64_t first = 0, size = 0, cap = 0;
        if (fread(&first, 8, 1, f) != 1) { fclose(f); return 2; }
        if (first >= (~0ULL) - 10) {  // versioned nested dump
            if (fread(&size, 8, 1, f) != 1) { fclose(f); return 2; }
        } else {
            size = first;
        }
        if (fread(&cap, 8, 1, f) != 1) { fclose(f); return 2; }
        size_t start = members.size();
        if (size) {
            ctrl.resize(cap + 17);
            if (fread(ctrl.data(), 1, ctrl.size(), f) != ctrl.size()) {
                fclose(f);
                return 2;
            }
            slots.resize(cap);
            if (fread(slots.data(), 4, cap, f) != cap) { fclose(f); return 2; }
            for (uint64_t i = 0; i < cap; i++)
                if (ctrl[i] < 0x80) members.push_back(slots[i]);
            if (members.size() - start != size) { fclose(f); return 3; }
            std::sort(members.begin() + start, members.end());
        }
        offsets[c + 1] = (int64_t)members.size();
    }
    fclose(f);
    *n_colors_out = (int64_t)count;
    *colors_out = (uint64_t*)malloc(8 * std::max<uint64_t>(1, count));
    memcpy(*colors_out, colors.data(), 8 * count);
    *offsets_out = (int64_t*)malloc(8 * (count + 1));
    memcpy(*offsets_out, offsets.data(), 8 * (count + 1));
    *members_out = (uint32_t*)malloc(4 * std::max<size_t>(1, members.size()));
    memcpy(*members_out, members.data(), 4 * members.size());
    return 0;
}

}  // extern "C"
