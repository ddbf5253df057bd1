// Native BAM record scanner: the host data-loader hot path.
//
// The reference reads BAM through pysam (htslib, C); the Python decoder
// in miso_jax/io/sam.py::_decode_bam_record is its from-scratch
// replacement but costs ~4us/record -- minutes on genome-scale BAMs.
// This scanner decodes size-prefixed alignment records from a
// decompressed BGZF byte window into columnar arrays in one pass
// (~0.05us/record); io/sam.py uses it for .bai index construction and
// batch fetch decoding, with the Python decoder kept as the fallback
// (MISO_NO_NATIVE=1).
//
// BAM record layout (SAM spec section 4.2): int32 block_size, then
// refID, pos, l_read_name(u8), mapq(u8), bin(u16), n_cigar_op(u16),
// flag(u16), l_seq(i32), next_refID, next_pos, tlen, read_name
// (NUL-terminated), cigar (u32: len<<4|op), seq, qual, tags.
#include <cstdint>
#include <cstring>
#include <new>

namespace {

const char kCigarOps[] = "MIDNSHP=X???????";

inline int32_t rd_i32(const uint8_t* p) {
    int32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint16_t rd_u16(const uint8_t* p) {
    uint16_t v;
    std::memcpy(&v, p, 2);
    return v;
}

inline uint32_t rd_u32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

// unsigned itoa; returns chars written
inline int64_t put_u32(char* dst, uint32_t v) {
    char tmp[10];
    int n = 0;
    do {
        tmp[n++] = char('0' + v % 10);
        v /= 10;
    } while (v);
    for (int i = 0; i < n; ++i) dst[i] = tmp[n - 1 - i];
    return n;
}

}  // namespace

extern "C" {

// Scan up to max_records records from buf[start..n).  Per record i:
//   rec_off[i]          offset of the record's 4-byte size prefix
//   ref_id/pos/flags/mapq/l_seq[i]  fixed fields
//   ref_end[i]          pos + reference span from CIGAR (>= pos + 1)
//   qname_off[i]/qname_len[i]       read name location in buf (no NUL)
//   cigar_off[i]        start of the record's CIGAR string in cigar_buf
//                       ("*" when n_cigar_op == 0); each string is
//                       NUL-terminated (so the matcher can consume the
//                       buffer in place), packed back-to-back;
//                       cigar_off[count] = total length incl. NULs
// Stops early (without error) on a record that is incomplete in the
// window or whose CIGAR text would overflow cigar_cap.  Returns the
// number of whole records decoded, or -1 on a structurally invalid
// record (negative size / fields past the record end).
int64_t miso_bam_scan(
    const uint8_t* buf, int64_t n, int64_t start, int64_t max_records,
    int64_t* rec_off,
    int32_t* ref_id, int32_t* pos, int32_t* flags, int32_t* mapq,
    int32_t* l_seq, int32_t* ref_end,
    int64_t* qname_off, int32_t* qname_len,
    char* cigar_buf, int64_t cigar_cap, int64_t* cigar_off,
    int64_t* consumed) {
    int64_t off = start;
    int64_t count = 0;
    int64_t cpos = 0;
    while (count < max_records && off + 4 <= n) {
        const int64_t rec_sz = rd_i32(buf + off);
        if (rec_sz < 32) return -1;  // below the fixed-field size: corrupt
        if (off + 4 + rec_sz > n) break;  // incomplete: next window
        const uint8_t* r = buf + off + 4;
        const int32_t l_read_name = r[8];
        const uint16_t n_cigar = rd_u16(r + 12);
        // structural validity FIRST: a field overrun is corruption and
        // must error; only a genuinely big record may break to let the
        // caller grow the window (and with it cigar_cap)
        if (32 + l_read_name + int64_t(n_cigar) * 4 > rec_sz) return -1;
        // worst case 10 digits + 1 op per cigar element, or "*", + NUL
        if (cpos + (n_cigar ? int64_t(n_cigar) * 11 : 1) + 2 > cigar_cap)
            break;
        rec_off[count] = off;
        ref_id[count] = rd_i32(r);
        pos[count] = rd_i32(r + 4);
        mapq[count] = r[9];
        flags[count] = rd_u16(r + 14);
        l_seq[count] = rd_i32(r + 16);
        qname_off[count] = off + 4 + 32;
        qname_len[count] = l_read_name > 0 ? l_read_name - 1 : 0;
        cigar_off[count] = cpos;
        const uint8_t* cg = r + 32 + l_read_name;
        int64_t span = 0;
        if (n_cigar == 0) {
            cigar_buf[cpos++] = '*';
        } else {
            for (uint16_t k = 0; k < n_cigar; ++k) {
                const uint32_t opv = rd_u32(cg + 4 * k);
                const uint32_t len = opv >> 4;
                const uint32_t op = opv & 0xF;
                cpos += put_u32(cigar_buf + cpos, len);
                cigar_buf[cpos++] = kCigarOps[op];
                // M D N = X consume reference
                if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
                    span += len;
            }
        }
        cigar_buf[cpos++] = '\0';
        ref_end[count] = pos[count] + int32_t(span > 0 ? span : 1);
        off += 4 + rec_sz;
        ++count;
    }
    cigar_off[count] = cpos;
    *consumed = off;
    return count;
}

// Pair records by read name (qname), replicating the reference's
// dict-based mate pairing (misopy/sam_utils.py:210-289 via
// miso_jax/io/sam.py::pair_sam_reads): names are grouped after
// stripping a trailing /1 /2 #1 #2 mate id; ONLY names seen exactly
// twice form a pair.  partner[i] = index of i's mate (or -1); the
// first-seen mate is the one with the smaller index, preserving the
// reference's insertion order semantics.
//
// qname_off are byte offsets into `buf`; open-addressed hash table,
// FNV-1a.  Returns the number of pairs, or -1 on allocation failure.
int64_t miso_pair_qnames(
    const uint8_t* buf, int64_t n_records,
    const int64_t* qname_off, const int32_t* qname_len,
    int64_t* partner) {
    for (int64_t i = 0; i < n_records; ++i) partner[i] = -1;
    if (n_records == 0) return 0;
    uint64_t cap = 16;
    while (cap < uint64_t(n_records) * 2) cap <<= 1;
    struct Slot {
        uint64_t hash;
        int64_t first;   // -1 = empty
        int64_t second;  // -1 = single
        int32_t count;
    };
    Slot* slots = new (std::nothrow) Slot[cap];
    if (!slots) return -1;
    for (uint64_t s = 0; s < cap; ++s) slots[s].first = -1;
    const uint64_t mask = cap - 1;
    for (int64_t i = 0; i < n_records; ++i) {
        const uint8_t* p = buf + qname_off[i];
        int64_t len = qname_len[i];
        if (len >= 2 && (p[len - 2] == '/' || p[len - 2] == '#') &&
            (p[len - 1] == '1' || p[len - 1] == '2'))
            len -= 2;
        uint64_t h = 1469598103934665603ull;  // FNV-1a 64
        for (int64_t k = 0; k < len; ++k) {
            h ^= p[k];
            h *= 1099511628211ull;
        }
        uint64_t s = h & mask;
        for (;;) {
            Slot& sl = slots[s];
            if (sl.first < 0) {
                sl.hash = h;
                sl.first = i;
                sl.second = -1;
                sl.count = 1;
                break;
            }
            if (sl.hash == h) {
                const uint8_t* q = buf + qname_off[sl.first];
                int64_t qlen = qname_len[sl.first];
                if (qlen >= 2 &&
                    (q[qlen - 2] == '/' || q[qlen - 2] == '#') &&
                    (q[qlen - 1] == '1' || q[qlen - 1] == '2'))
                    qlen -= 2;
                if (qlen == len && std::memcmp(p, q, size_t(len)) == 0) {
                    if (sl.count == 1) sl.second = i;
                    ++sl.count;
                    break;
                }
            }
            s = (s + 1) & mask;
        }
    }
    int64_t pairs = 0;
    for (uint64_t s = 0; s < cap; ++s) {
        const Slot& sl = slots[s];
        if (sl.first >= 0 && sl.count == 2) {
            partner[sl.first] = sl.second;
            partner[sl.second] = sl.first;
            ++pairs;
        }
    }
    delete[] slots;
    return pairs;
}

}  // extern "C"
