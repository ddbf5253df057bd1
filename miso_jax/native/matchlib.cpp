// Native host event-compiler kernels: CIGAR parsing + read-isoform
// matching.  The batched analogue of the reference C engine's host
// setup path (pysplicing/src/solve.c:8-108 splicing_matchIso,
// :220-306 splicing_parse_cigar), rebuilt as a batch-oriented library:
// one call matches ALL reads of a gene against all isoforms, with
// signature deduplication done in C++.
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: cc -O2 -shared -fPIC matchlib.cpp -o libmisomatch.so
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <string_view>
#include <unordered_map>
#include <vector>
#include <string>

namespace {

// (position, cigar) signature key without per-read string allocation:
// the cigar bytes live in the caller's packed buffer for the whole call
struct SigKey {
    int64_t pos;
    std::string_view cig;
    bool operator==(const SigKey& o) const {
        return pos == o.pos && cig == o.cig;
    }
};

struct SigKeyHash {
    size_t operator()(const SigKey& k) const {
        size_t h = std::hash<std::string_view>()(k.cig);
        return h ^ (std::hash<int64_t>()(k.pos) + 0x9e3779b97f4a7c15ULL +
                    (h << 6) + (h >> 2));
    }
};

struct NumCigar {
    std::vector<int64_t> runs;  // + exon-consuming, - intron skip
    int64_t length = 0;         // matched length (clipped)
    bool ok = false;
};

// splicing_parse_cigar semantics (solve.c:220-306): M/=/X/S/H/D consume
// ("match"), N skips, I ignored; totals clipped at max_read_len; S/H only
// at the ends.
bool parse_cigar(const char* s, int64_t max_read_len, NumCigar* out) {
    out->runs.clear();
    out->length = 0;
    int mode = 0;  // 0 begin, 1 middle, 2 end
    while (*s) {
        char* end;
        long long l = strtoll(s, &end, 10);
        if (end == s) return false;
        s = end;
        char op = *s;
        if (!op) return false;
        s++;
        if (mode == 0 && op != 'S' && op != 'H') mode = 1;
        else if (mode == 1 && (op == 'S' || op == 'H')) mode = 2;
        else if (mode == 2 && op != 'S' && op != 'H') return false;
        switch (op) {
            case 'N':
                out->runs.push_back(-l);
                break;
            case 'I':
                break;
            case 'M': case '=': case 'X': case 'S': case 'H': case 'D': {
                if (max_read_len > 0 && out->length + l > max_read_len)
                    l = max_read_len - out->length;
                out->runs.push_back(l);
                out->length += l;
                break;
            }
            default:
                return false;
        }
    }
    out->ok = true;
    return true;
}

// splicing_matchIso walk (solve.c:63-95) for one isoform
double match_one(const int64_t* starts, const int64_t* ends, int64_t nex,
                 int64_t pos, const std::vector<int64_t>& runs) {
    // find exon containing pos (exons sorted by start)
    int64_t lo = 0, hi = nex;
    while (lo < hi) {  // upper_bound on starts
        int64_t mid = (lo + hi) / 2;
        if (starts[mid] <= pos) lo = mid + 1; else hi = mid;
    }
    int64_t ex = lo - 1;
    if (ex < 0 || pos > ends[ex]) return 0.0;
    for (int64_t c : runs) {
        if (c > 0) {
            if (pos + c - 1 > ends[ex]) return 0.0;
            pos += c;
        } else {
            if (pos != ends[ex] + 1) return 0.0;
            pos += -c;
            ex += 1;
            if (ex >= nex || pos != starts[ex]) return 0.0;
        }
    }
    return 1.0;
}

}  // namespace

extern "C" {

// Match all reads against all isoforms.
//   positions:    n_reads genomic start positions (1-based)
//   cigar_buf:    NUL-separated cigar strings, offsets[i] = start of read i
//   exon_starts/ends: flat per-isoform exon arrays; exon_idx[i]..exon_idx[i+1]
//                 delimit isoform i's exons (noiso+1 entries)
//   out_match:    noiso * n_reads doubles, row-major [iso][read]
// Returns 0 on success, -1 on a bad cigar.
int64_t miso_match_iso(
    const int64_t* positions, int64_t n_reads,
    const char* cigar_buf, const int64_t* cigar_offsets,
    const int64_t* exon_starts, const int64_t* exon_ends,
    const int64_t* exon_idx, int64_t noiso,
    int64_t read_len, int64_t overhang,
    double* out_match) {
    if (overhang == 0) overhang = 1;

    // dedup (pos, cigar) signatures
    std::unordered_map<std::string, int64_t> sig_index;
    std::vector<int64_t> read_sig(n_reads);
    std::vector<std::pair<int64_t, const char*>> sigs;
    sig_index.reserve(n_reads * 2);
    for (int64_t r = 0; r < n_reads; r++) {
        const char* cig = cigar_buf + cigar_offsets[r];
        std::string key = std::to_string(positions[r]);
        key += '|';
        key += cig;
        auto it = sig_index.find(key);
        if (it == sig_index.end()) {
            int64_t id = (int64_t)sigs.size();
            sig_index.emplace(std::move(key), id);
            sigs.emplace_back(positions[r], cig);
            read_sig[r] = id;
        } else {
            read_sig[r] = it->second;
        }
    }

    // cigar parse cache by string
    std::unordered_map<std::string, NumCigar> cigar_cache;
    int64_t n_sigs = (int64_t)sigs.size();
    std::vector<double> sig_match((size_t)n_sigs * noiso, 0.0);
    for (int64_t s = 0; s < n_sigs; s++) {
        const char* cig = sigs[s].second;
        auto it = cigar_cache.find(cig);
        if (it == cigar_cache.end()) {
            NumCigar nc;
            if (!parse_cigar(cig, read_len, &nc)) return -1;
            it = cigar_cache.emplace(cig, std::move(nc)).first;
        }
        const NumCigar& nc = it->second;
        // read-length filter (solve.c:55) + overhang filter (solve.c:61)
        if (nc.length < read_len) continue;
        if (nc.runs.empty() || nc.runs.front() < overhang ||
            nc.runs.back() < overhang)
            continue;
        for (int64_t i = 0; i < noiso; i++) {
            const int64_t* st = exon_starts + exon_idx[i];
            const int64_t* en = exon_ends + exon_idx[i];
            int64_t nex = exon_idx[i + 1] - exon_idx[i];
            sig_match[(size_t)s * noiso + i] =
                match_one(st, en, nex, sigs[s].first, nc.runs);
        }
    }

    // scatter back: out_match[iso][read]
    for (int64_t r = 0; r < n_reads; r++) {
        const double* src = &sig_match[(size_t)read_sig[r] * noiso];
        for (int64_t i = 0; i < noiso; i++) {
            out_match[(size_t)i * n_reads + r] = src[i];
        }
    }
    return 0;
}

// Fused match + read-class collapse for single-end events (noiso <= 62).
// The match values are {0,1}, so each read reduces to a bitmask over
// isoforms; identical masks form one compatibility class
// (pysplicing/src/miso_paired.c:576-619 splicing_i_miso_classes1, done
// here without ever materializing the noiso x noreads match matrix).
// Bit layout parity with core/matching.py::collapse_to_classes: isoform 0
// is the MOST significant bit, classes sorted ascending by mask key.
//   out_mask / out_count: capacity `cap` >= number of distinct masks
//     (n_reads is always enough).
// Returns the class count (>= 0), -1 on a bad cigar, -2 on overflow.
int64_t miso_match_classes(
    const int64_t* positions, int64_t n_reads,
    const char* cigar_buf, const int64_t* cigar_offsets,
    const int64_t* exon_starts, const int64_t* exon_ends,
    const int64_t* exon_idx, int64_t noiso,
    int64_t read_len, int64_t overhang,
    uint64_t* out_mask, int64_t* out_count, int64_t cap) {
    if (overhang == 0) overhang = 1;
    if (noiso > 62) return -2;

    // dedup (pos, cigar) signatures, counting reads per signature
    std::unordered_map<std::string, int64_t> sig_index;
    std::vector<std::pair<int64_t, const char*>> sigs;
    std::vector<int64_t> sig_count;
    sig_index.reserve(n_reads * 2);
    for (int64_t r = 0; r < n_reads; r++) {
        const char* cig = cigar_buf + cigar_offsets[r];
        std::string key = std::to_string(positions[r]);
        key += '|';
        key += cig;
        auto it = sig_index.find(key);
        if (it == sig_index.end()) {
            int64_t id = (int64_t)sigs.size();
            sig_index.emplace(std::move(key), id);
            sigs.emplace_back(positions[r], cig);
            sig_count.push_back(1);
        } else {
            sig_count[it->second]++;
        }
    }

    std::unordered_map<std::string, NumCigar> cigar_cache;
    std::unordered_map<uint64_t, int64_t> mask_count;
    mask_count.reserve(sigs.size() * 2);
    for (size_t s = 0; s < sigs.size(); s++) {
        const char* cig = sigs[s].second;
        auto it = cigar_cache.find(cig);
        if (it == cigar_cache.end()) {
            NumCigar nc;
            if (!parse_cigar(cig, read_len, &nc)) return -1;
            it = cigar_cache.emplace(cig, std::move(nc)).first;
        }
        const NumCigar& nc = it->second;
        uint64_t mask = 0;
        // read-length filter (solve.c:55) + overhang filter (solve.c:61):
        // filtered reads keep mask 0 (the all-incompatible class)
        if (nc.length >= read_len && !nc.runs.empty() &&
            nc.runs.front() >= overhang && nc.runs.back() >= overhang) {
            for (int64_t i = 0; i < noiso; i++) {
                const int64_t* st = exon_starts + exon_idx[i];
                const int64_t* en = exon_ends + exon_idx[i];
                int64_t nex = exon_idx[i + 1] - exon_idx[i];
                if (match_one(st, en, nex, sigs[s].first, nc.runs) > 0.0)
                    mask |= (uint64_t)1 << (noiso - 1 - i);
            }
        }
        mask_count[mask] += sig_count[s];
    }

    if ((int64_t)mask_count.size() > cap) return -2;
    std::vector<uint64_t> keys;
    keys.reserve(mask_count.size());
    for (auto& kv : mask_count) keys.push_back(kv.first);
    std::sort(keys.begin(), keys.end());
    for (size_t c = 0; c < keys.size(); c++) {
        out_mask[c] = keys[c];
        out_count[c] = mask_count[keys[c]];
    }
    return (int64_t)keys.size();
}

// Whole-chromosome batch of miso_match_classes: one call compiles read
// classes for EVERY gene on a chromosome against one columnar read pool
// (io/sam.py ChromReads arrays).  Per-gene ctypes dispatch and dedup-map
// allocation dominated the 10k-gene host-compile profile; here the CIGAR
// parse cache persists across genes and Python is re-entered once.
//
//   positions/ref_end/cigar_offsets: chromosome-level arrays (0-based,
//     coordinate-sorted); cigar_buf NUL-terminated packed strings.
//   read_lo/read_hi: gene g considers reads [read_lo[g], read_hi[g]);
//     reads with ref_end <= span_start[g] are skipped -- exactly
//     ChromReads.slice's region mask (pos < end is the read_hi bound).
//   eidx_ofs/noiso: (n_genes,) gene g's exon_idx block is
//     exon_idx_flat[eidx_ofs[g] .. eidx_ofs[g]+noiso[g]+1) -- noiso[g]+1
//     entries of GLOBAL indices into exon_starts/ends.  (Offsets, not a
//     cumulative array: callers gather them from whole-chromosome
//     compile tables for an arbitrary subset of genes.)
//   pos_offset: added to each position before matching (0-based BAM ->
//     1-based matcher coordinates, miso_sampler.py:284).
//   out_mask/out_count: flat class stream; out_class_ofs (n_genes+1,)
//     delimits gene g's classes; out_nreads (n_genes,) = reads considered.
// Returns 0, -1 on bad cigar, -2 on overflow/noiso > 62.
int64_t miso_match_classes_multi(
    const int64_t* positions, const int64_t* ref_end,
    const char* cigar_buf, const int64_t* cigar_offsets,
    int64_t n_genes,
    const int64_t* read_lo, const int64_t* read_hi,
    const int64_t* span_start,
    const int64_t* exon_starts, const int64_t* exon_ends,
    const int64_t* exon_idx_flat, const int64_t* eidx_ofs,
    const int64_t* noiso_arr,
    int64_t read_len, int64_t overhang, int64_t pos_offset,
    uint64_t* out_mask, int64_t* out_count, int64_t cap,
    int64_t* out_class_ofs, int64_t* out_nreads) {
    if (overhang == 0) overhang = 1;
    std::unordered_map<std::string_view, NumCigar> cigar_cache;
    std::unordered_map<SigKey, int64_t, SigKeyHash> sig_index;
    std::vector<std::pair<int64_t, const char*>> sigs;
    std::vector<int64_t> sig_count;
    std::unordered_map<uint64_t, int64_t> mask_count;
    std::vector<uint64_t> keys;
    int64_t written = 0;
    out_class_ofs[0] = 0;
    for (int64_t g = 0; g < n_genes; g++) {
        int64_t noiso = noiso_arr[g];
        if (noiso > 62) return -2;
        const int64_t* eidx = exon_idx_flat + eidx_ofs[g];
        sig_index.clear();
        sigs.clear();
        sig_count.clear();
        mask_count.clear();
        int64_t considered = 0;
        for (int64_t r = read_lo[g]; r < read_hi[g]; r++) {
            if (ref_end[r] <= span_start[g]) continue;
            considered++;
            const char* cig = cigar_buf + cigar_offsets[r];
            SigKey key{positions[r], std::string_view(cig)};
            auto it = sig_index.find(key);
            if (it == sig_index.end()) {
                int64_t id = (int64_t)sigs.size();
                sig_index.emplace(key, id);
                sigs.emplace_back(positions[r] + pos_offset, cig);
                sig_count.push_back(1);
            } else {
                sig_count[it->second]++;
            }
        }
        out_nreads[g] = considered;
        for (size_t s = 0; s < sigs.size(); s++) {
            const char* cig = sigs[s].second;
            auto it = cigar_cache.find(std::string_view(cig));
            if (it == cigar_cache.end()) {
                NumCigar nc;
                if (!parse_cigar(cig, read_len, &nc)) return -1;
                it = cigar_cache.emplace(std::string_view(cig),
                                         std::move(nc)).first;
            }
            const NumCigar& nc = it->second;
            uint64_t mask = 0;
            if (nc.length >= read_len && !nc.runs.empty() &&
                nc.runs.front() >= overhang && nc.runs.back() >= overhang) {
                for (int64_t i = 0; i < noiso; i++) {
                    const int64_t* st = exon_starts + eidx[i];
                    const int64_t* en = exon_ends + eidx[i];
                    int64_t nex = eidx[i + 1] - eidx[i];
                    if (match_one(st, en, nex, sigs[s].first, nc.runs) > 0.0)
                        mask |= (uint64_t)1 << (noiso - 1 - i);
                }
            }
            mask_count[mask] += sig_count[s];
        }
        if (written + (int64_t)mask_count.size() > cap) return -2;
        keys.clear();
        for (auto& kv : mask_count) keys.push_back(kv.first);
        std::sort(keys.begin(), keys.end());
        for (uint64_t k : keys) {
            out_mask[written] = k;
            out_count[written] = mask_count[k];
            written++;
        }
        out_class_ofs[g + 1] = written;
    }
    return 0;
}

namespace {

// 1-based genomic -> 1-based isoform coordinate; -1 outside exons.
// Mirrors miso_genomic_to_iso for one position with precomputed cum.
int64_t g2i_one(const int64_t* starts, const int64_t* ends,
                const int64_t* cum, int64_t nex, int64_t p) {
    int64_t lo = 0, hi = nex;
    while (lo < hi) {
        int64_t mid = (lo + hi) / 2;
        if (starts[mid] <= p) lo = mid + 1; else hi = mid;
    }
    int64_t ex = lo - 1;
    if (ex < 0 || p > ends[ex]) return -1;
    return cum[ex] + (p - starts[ex]) + 1;
}

}  // namespace

// Whole-chromosome batch match + class collapse for PAIRED-END events.
// Pairs come from io/sam.py ChromPairs (pmin-sorted): mate positions
// p1/p2 + reference ends e1/e2 (0-based) and NUL-terminated cigars at
// co1/co2 in cigar_buf.  Gene g considers pairs [pair_lo[g], pair_hi[g])
// passing the region mask (p<end && e>start for BOTH mates) -- exactly
// ChromPairs.slice.  A pair's class key is its per-isoform fragment
// length vector (miso_paired.c:576-619 splicing_i_miso_classes1:
// identical (match, fragLen) columns collapse); fl = isopos(p2) -
// isopos(p1) + read_len when both mates match the isoform
// (solve.c:141-218 splicing_matchIso_paired), -1 otherwise; match value
// = frag_prob[fl - frag_start] when fl is in-support.  Classes are
// emitted per gene in ascending lexicographic (match..., fl...) order
// -- byte-identical to core/matching.py collapse_to_classes's
// np.unique over the concatenated (match; frag_len) columns.
//
//   out_fl / out_match: flat streams; gene g's class c occupies noiso_g
//     consecutive entries (offsets reconstructed host-side from
//     out_class_ofs and noiso).
// Returns 0, -1 on bad cigar, -2 on overflow/noiso > 62.
int64_t miso_match_classes_paired_multi(
    const int64_t* p1, const int64_t* e1,
    const int64_t* p2, const int64_t* e2,
    const char* cigar_buf, const int64_t* co1, const int64_t* co2,
    int64_t n_genes,
    const int64_t* pair_lo, const int64_t* pair_hi,
    const int64_t* span_start, const int64_t* span_end,
    const int64_t* exon_starts, const int64_t* exon_ends,
    const int64_t* exon_idx_flat, const int64_t* eidx_ofs,
    const int64_t* noiso_arr,
    int64_t read_len, int64_t overhang, int64_t pos_offset,
    const double* frag_prob, int64_t frag_start, int64_t il,
    int64_t* out_fl, double* out_match, int64_t* out_count,
    int64_t cap_classes, int64_t cap_entries,
    int64_t* out_class_ofs, int64_t* out_npairs) {
    if (overhang == 0) overhang = 1;
    std::unordered_map<std::string_view, NumCigar> cigar_cache;
    std::unordered_map<std::string, int64_t> sig_index;  // pair signature
    std::vector<std::pair<int64_t, int64_t>> sig_pairs;  // rep pair idx
    std::vector<int64_t> sig_count;
    std::unordered_map<std::string, int64_t> key_index;  // fl-vector key
    std::vector<std::vector<int64_t>> key_fl;
    std::vector<int64_t> key_count;
    std::vector<int64_t> order;
    std::vector<int64_t> cum;  // per-isoform exon cumsum scratch
    int64_t n_classes = 0, n_entries = 0;
    out_class_ofs[0] = 0;
    for (int64_t g = 0; g < n_genes; g++) {
        int64_t noiso = noiso_arr[g];
        if (noiso > 62) return -2;
        const int64_t* eidx = exon_idx_flat + eidx_ofs[g];
        sig_index.clear();
        sig_pairs.clear();
        sig_count.clear();
        key_index.clear();
        key_fl.clear();
        key_count.clear();
        int64_t considered = 0;
        int64_t st = span_start[g], en = span_end[g];
        for (int64_t r = pair_lo[g]; r < pair_hi[g]; r++) {
            if (!(p1[r] < en && e1[r] > st && p2[r] < en && e2[r] > st))
                continue;
            considered++;
            std::string key = std::to_string(p1[r]);
            key += '|';
            key += cigar_buf + co1[r];
            key += '|';
            key += std::to_string(p2[r]);
            key += '|';
            key += cigar_buf + co2[r];
            auto it = sig_index.find(key);
            if (it == sig_index.end()) {
                sig_index.emplace(std::move(key),
                                  (int64_t)sig_pairs.size());
                sig_pairs.emplace_back(r, 0);
                sig_count.push_back(1);
            } else {
                sig_count[it->second]++;
            }
        }
        out_npairs[g] = considered;
        std::vector<int64_t> fl(noiso);
        for (size_t s = 0; s < sig_pairs.size(); s++) {
            int64_t r = sig_pairs[s].first;
            const char* cig1 = cigar_buf + co1[r];
            const char* cig2 = cigar_buf + co2[r];
            const NumCigar* nc[2];
            bool bad = false;
            const char* cigs[2] = {cig1, cig2};
            for (int m = 0; m < 2; m++) {
                auto it = cigar_cache.find(std::string_view(cigs[m]));
                if (it == cigar_cache.end()) {
                    NumCigar c;
                    if (!parse_cigar(cigs[m], read_len, &c)) return -1;
                    it = cigar_cache.emplace(std::string_view(cigs[m]),
                                             std::move(c)).first;
                }
                nc[m] = &it->second;
                if (nc[m]->length < read_len || nc[m]->runs.empty() ||
                    nc[m]->runs.front() < overhang ||
                    nc[m]->runs.back() < overhang)
                    bad = true;
            }
            int64_t g1 = p1[r] + pos_offset;
            int64_t g2 = p2[r] + pos_offset;
            for (int64_t i = 0; i < noiso; i++) {
                fl[i] = -1;
                if (bad) continue;
                const int64_t* es = exon_starts + eidx[i];
                const int64_t* ee = exon_ends + eidx[i];
                int64_t nex = eidx[i + 1] - eidx[i];
                if (match_one(es, ee, nex, g1, nc[0]->runs) <= 0.0)
                    continue;
                if (match_one(es, ee, nex, g2, nc[1]->runs) <= 0.0)
                    continue;
                cum.assign(nex + 1, 0);
                for (int64_t e = 0; e < nex; e++)
                    cum[e + 1] = cum[e] + (ee[e] - es[e] + 1);
                int64_t i1 = g2i_one(es, ee, cum.data(), nex, g1);
                int64_t i2 = g2i_one(es, ee, cum.data(), nex, g2);
                if (i1 < 0 || i2 < 0) continue;
                int64_t f = i2 - i1 + read_len;
                if (f >= frag_start && f < frag_start + il) fl[i] = f;
            }
            std::string kb((const char*)fl.data(),
                           noiso * sizeof(int64_t));
            auto it = key_index.find(kb);
            if (it == key_index.end()) {
                key_index.emplace(std::move(kb),
                                  (int64_t)key_fl.size());
                key_fl.push_back(fl);
                key_count.push_back(sig_count[s]);
            } else {
                key_count[it->second] += sig_count[s];
            }
        }
        int64_t nk = (int64_t)key_fl.size();
        if (n_classes + nk > cap_classes ||
            n_entries + nk * noiso > cap_entries)
            return -2;
        // ascending lexicographic (match values..., fl values...)
        order.resize(nk);
        for (int64_t k = 0; k < nk; k++) order[k] = k;
        auto mval = [&](int64_t k, int64_t i) -> double {
            int64_t f = key_fl[k][i];
            return f < 0 ? 0.0 : frag_prob[f - frag_start];
        };
        std::sort(order.begin(), order.end(),
                  [&](int64_t a, int64_t b) {
            for (int64_t i = 0; i < noiso; i++) {
                double ma = mval(a, i), mb = mval(b, i);
                if (ma != mb) return ma < mb;
            }
            for (int64_t i = 0; i < noiso; i++) {
                if (key_fl[a][i] != key_fl[b][i])
                    return key_fl[a][i] < key_fl[b][i];
            }
            return false;
        });
        for (int64_t k = 0; k < nk; k++) {
            int64_t src = order[k];
            for (int64_t i = 0; i < noiso; i++) {
                out_fl[n_entries + i] = key_fl[src][i];
                out_match[n_entries + i] = mval(src, i);
            }
            out_count[n_classes] = key_count[src];
            n_classes++;
            n_entries += noiso;
        }
        out_class_ofs[g + 1] = n_classes;
    }
    return 0;
}

// Genomic -> isoform coordinates for one isoform (gff.c:1041-1160).
// ipos[j] = -1 when pos falls outside the isoform's exons.
void miso_genomic_to_iso(
    const int64_t* starts, const int64_t* ends, int64_t nex,
    const int64_t* pos, int64_t n, int64_t* ipos) {
    std::vector<int64_t> cum(nex + 1, 0);
    for (int64_t e = 0; e < nex; e++)
        cum[e + 1] = cum[e] + (ends[e] - starts[e] + 1);
    for (int64_t j = 0; j < n; j++) {
        int64_t p = pos[j];
        int64_t lo = 0, hi = nex;
        while (lo < hi) {
            int64_t mid = (lo + hi) / 2;
            if (starts[mid] <= p) lo = mid + 1; else hi = mid;
        }
        int64_t ex = lo - 1;
        if (ex < 0 || p > ends[ex]) { ipos[j] = -1; continue; }
        ipos[j] = cum[ex] + (p - starts[ex]) + 1;
    }
}

}  // extern "C"
