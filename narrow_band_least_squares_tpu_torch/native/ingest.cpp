// Streaming ingest runtime: miniSEED record decoder and encoder, and a
// multi-channel ring buffer, for the continuous-monitoring workflow.
//
// The port's own copy of the JAX package's ingest runtime (same C entry
// points, same semantics).  Decode incoming records (miniSEED is the
// interchange format IRIS/IMS stations emit), place samples into a
// gap-tracking ring buffer keyed by absolute sample index, and hand out
// contiguous (chans, segment) blocks the monitor can consume.  Both pieces
// are native, and ctypes releases the interpreter lock around every call, so
// a host thread feeding the card does not hold the other threads back.
//
// miniSEED v2 support: fixed 48-byte header, blockette walk to 1000
// (encoding / word order / record length), encodings: 1 (int16), 3 (int32),
// 4 (float32), 5 (float64), 10 (Steim1), 11 (Steim2).  Both byte orders.
//
// Built by g++ at first use and loaded through ctypes by native/__init__.py.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// byte-order helpers
// ---------------------------------------------------------------------------

inline uint16_t load_u16(const uint8_t* p, bool big) {
    return big ? (uint16_t)((p[0] << 8) | p[1])
               : (uint16_t)((p[1] << 8) | p[0]);
}
inline int16_t load_i16(const uint8_t* p, bool big) {
    return (int16_t)load_u16(p, big);
}
inline uint32_t load_u32(const uint8_t* p, bool big) {
    return big ? ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                     ((uint32_t)p[2] << 8) | p[3]
               : ((uint32_t)p[3] << 24) | ((uint32_t)p[2] << 16) |
                     ((uint32_t)p[1] << 8) | p[0];
}
inline int32_t load_i32(const uint8_t* p, bool big) {
    return (int32_t)load_u32(p, big);
}
inline float load_f32(const uint8_t* p, bool big) {
    uint32_t u = load_u32(p, big);
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}
inline double load_f64(const uint8_t* p, bool big) {
    uint64_t u = ((uint64_t)load_u32(p, big) << 32) | load_u32(p + 4, big);
    if (!big) u = ((uint64_t)load_u32(p + 4, big) << 32) | load_u32(p, big);
    double d;
    std::memcpy(&d, &u, 8);
    return d;
}

// days since 1970-01-01 for Jan 1 of `year` (civil-from-days, Hinnant)
inline int64_t days_from_civil(int64_t y, unsigned m, unsigned d) {
    y -= m <= 2;
    const int64_t era = (y >= 0 ? y : y - 399) / 400;
    const unsigned yoe = (unsigned)(y - era * 400);
    const unsigned doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
    const unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
    return era * 146097 + (int64_t)doe - 719468;
}

// ---------------------------------------------------------------------------
// miniSEED record parsing
// ---------------------------------------------------------------------------

struct RecordInfo {
    char sid[64];        // "NET.STA.LOC.CHA"
    double t0 = 0.0;     // epoch seconds of first sample
    double fs = 0.0;
    int64_t nsamp = 0;
    int encoding = -1;
    bool data_big = true;
    int reclen = 0;
    int data_offset = 0;
};

inline bool plausible_year(uint16_t y) { return y >= 1900 && y <= 2100; }

// trim trailing spaces/NULs from fixed-width ASCII fields
inline void trim_copy(char* dst, const uint8_t* src, int n) {
    int end = n;
    while (end > 0 && (src[end - 1] == ' ' || src[end - 1] == '\0')) --end;
    std::memcpy(dst, src, end);
    dst[end] = '\0';
}

// Parses header + blockette 1000 of one record.  Returns bytes consumed
// (the record length), or negative on malformed input.
int parse_record_header(const uint8_t* p, int64_t avail, RecordInfo& out) {
    if (avail < 64) return -1;
    // data header/quality indicator
    char q = (char)p[6];
    if (q != 'D' && q != 'R' && q != 'Q' && q != 'M') return -2;

    // header byte order: sniff the year field
    bool big = plausible_year(load_u16(p + 20, true));
    if (!big && !plausible_year(load_u16(p + 20, false))) return -3;

    uint16_t year = load_u16(p + 20, big);
    uint16_t doy = load_u16(p + 22, big);
    uint8_t hour = p[24], minute = p[25], sec = p[26];
    uint16_t fract = load_u16(p + 28, big);  // 1e-4 s
    uint16_t nsamp = load_u16(p + 30, big);
    int16_t rfact = load_i16(p + 32, big);
    int16_t rmult = load_i16(p + 34, big);
    uint8_t act_flags = p[36];
    int32_t time_corr = load_i32(p + 40, big);
    uint16_t data_offset = load_u16(p + 44, big);
    uint16_t blk_offset = load_u16(p + 46, big);

    double fs = 0.0;
    if (rfact > 0 && rmult > 0) fs = (double)rfact * rmult;
    else if (rfact > 0 && rmult < 0) fs = -(double)rfact / rmult;
    else if (rfact < 0 && rmult > 0) fs = -(double)rmult / rfact;
    else if (rfact < 0 && rmult < 0) fs = 1.0 / ((double)rfact * rmult);

    // SID: NET.STA.LOC.CHA
    char sta[8], loc[4], cha[4], net[4];
    trim_copy(sta, p + 8, 5);
    trim_copy(loc, p + 13, 2);
    trim_copy(cha, p + 15, 3);
    trim_copy(net, p + 18, 2);
    std::snprintf(out.sid, sizeof(out.sid), "%s.%s.%s.%s", net, sta, loc, cha);

    double t0 = (double)(days_from_civil(year, 1, 1) + (int64_t)doy - 1) *
                    86400.0 +
                hour * 3600.0 + minute * 60.0 + sec + fract * 1e-4;
    if (!(act_flags & 0x02)) t0 += time_corr * 1e-4;  // correction not applied

    // blockette walk to 1000
    int encoding = -1, reclen = 0;
    bool data_big = big;
    uint16_t boff = blk_offset;
    int guard = 0;
    while (boff >= 48 && boff + 8 <= avail && guard++ < 16) {
        uint16_t btype = load_u16(p + boff, big);
        uint16_t bnext = load_u16(p + boff + 2, big);
        if (btype == 1000) {
            encoding = p[boff + 4];
            data_big = p[boff + 5] == 1;
            reclen = 1 << p[boff + 6];
            break;
        }
        if (bnext == 0 || bnext <= boff) break;
        boff = bnext;
    }
    if (encoding < 0 || reclen < 64 || reclen > (1 << 20)) return -4;
    if (reclen > avail) return -5;

    out.t0 = t0;
    out.fs = fs;
    out.nsamp = nsamp;
    out.encoding = encoding;
    out.data_big = data_big;
    out.reclen = reclen;
    out.data_offset = data_offset;
    return reclen;
}

// sign-extend the low `bits` of v
inline int32_t sext(uint32_t v, int bits) {
    uint32_t m = 1u << (bits - 1);
    v &= (1u << bits) - 1;
    return (int32_t)((v ^ m) - m);
}

// Steim1/2 share the frame layout: 64-byte frames of 16 big/little words,
// word 0 = packed 2-bit nibbles; frame 0 words 1-2 = X0 / Xn integration
// constants.  Differences accumulate from X0.
int64_t decode_steim(const uint8_t* data, int nbytes, bool big, int version,
                     int64_t nsamp, double* out) {
    const int nframes = nbytes / 64;
    int64_t n = 0;
    int32_t x = 0;
    bool have_x0 = false;
    int32_t x0 = 0;
    for (int f = 0; f < nframes && n < nsamp; ++f) {
        const uint8_t* fr = data + (int64_t)f * 64;
        uint32_t nib = load_u32(fr, big);
        for (int w = 1; w < 16 && n < nsamp; ++w) {
            int c = (int)((nib >> (2 * (15 - w))) & 0x3);
            const uint8_t* wp = fr + 4 * w;
            if (f == 0 && w == 1) { x0 = load_i32(wp, big); have_x0 = true; continue; }
            if (f == 0 && w == 2) { continue; }  // Xn (reverse constant)
            if (c == 0) continue;                 // non-data word
            uint32_t v = load_u32(wp, big);
            int32_t diffs[7];
            int nd = 0;
            if (c == 1) {  // four 8-bit differences (both versions)
                for (int k = 0; k < 4; ++k)
                    diffs[nd++] = (int8_t)((v >> (8 * (3 - k))) & 0xff);
            } else if (version == 1) {
                if (c == 2) {
                    for (int k = 0; k < 2; ++k)
                        diffs[nd++] = (int16_t)((v >> (16 * (1 - k))) & 0xffff);
                } else {  // c == 3
                    diffs[nd++] = (int32_t)v;
                }
            } else {  // Steim2
                int dnib = (int)(v >> 30);
                if (c == 2) {
                    if (dnib == 1) diffs[nd++] = sext(v, 30);
                    else if (dnib == 2)
                        for (int k = 0; k < 2; ++k)
                            diffs[nd++] = sext(v >> (15 * (1 - k)), 15);
                    else if (dnib == 3)
                        for (int k = 0; k < 3; ++k)
                            diffs[nd++] = sext(v >> (10 * (2 - k)), 10);
                    else return -10;  // dnib 0 invalid for c=2
                } else {  // c == 3
                    if (dnib == 0)
                        for (int k = 0; k < 5; ++k)
                            diffs[nd++] = sext(v >> (6 * (4 - k)), 6);
                    else if (dnib == 1)
                        for (int k = 0; k < 6; ++k)
                            diffs[nd++] = sext(v >> (5 * (5 - k)), 5);
                    else if (dnib == 2)
                        for (int k = 0; k < 7; ++k)
                            diffs[nd++] = sext(v >> (4 * (6 - k)), 4);
                    else return -11;
                }
            }
            for (int k = 0; k < nd && n < nsamp; ++k) {
                if (n == 0 && have_x0) {
                    x = x0;  // first sample = forward constant; diff ignored
                } else {
                    x += diffs[k];
                }
                out[n++] = (double)x;
            }
        }
    }
    return n;
}

int64_t decode_data(const RecordInfo& ri, const uint8_t* rec, double* out) {
    const uint8_t* d = rec + ri.data_offset;
    const int nbytes = ri.reclen - ri.data_offset;
    const bool big = ri.data_big;
    const int64_t ns = ri.nsamp;
    switch (ri.encoding) {
        case 1:  // int16
            if ((int64_t)nbytes < 2 * ns) return -20;
            for (int64_t i = 0; i < ns; ++i) out[i] = load_i16(d + 2 * i, big);
            return ns;
        case 3:  // int32
            if ((int64_t)nbytes < 4 * ns) return -20;
            for (int64_t i = 0; i < ns; ++i) out[i] = load_i32(d + 4 * i, big);
            return ns;
        case 4:  // float32
            if ((int64_t)nbytes < 4 * ns) return -20;
            for (int64_t i = 0; i < ns; ++i) out[i] = load_f32(d + 4 * i, big);
            return ns;
        case 5:  // float64
            if ((int64_t)nbytes < 8 * ns) return -20;
            for (int64_t i = 0; i < ns; ++i) out[i] = load_f64(d + 8 * i, big);
            return ns;
        case 10:
            return decode_steim(d, nbytes, big, 1, ns, out);
        case 11:
            return decode_steim(d, nbytes, big, 2, ns, out);
        default:
            return -21;  // unsupported encoding
    }
}

// ---------------------------------------------------------------------------
// miniSEED writing (Steim1, 512-byte records, big-endian, blockette 1000)
// ---------------------------------------------------------------------------

inline void store_u16(uint8_t* p, uint16_t v) {
    p[0] = (uint8_t)(v >> 8);
    p[1] = (uint8_t)v;
}
inline void store_u32(uint8_t* p, uint32_t v) {
    p[0] = (uint8_t)(v >> 24);
    p[1] = (uint8_t)(v >> 16);
    p[2] = (uint8_t)(v >> 8);
    p[3] = (uint8_t)v;
}

// inverse of days_from_civil (Hinnant civil_from_days)
inline void civil_from_days(int64_t z, int* y, unsigned* m, unsigned* d) {
    z += 719468;
    const int64_t era = (z >= 0 ? z : z - 146096) / 146097;
    const unsigned doe = (unsigned)(z - era * 146097);
    const unsigned yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
    const int64_t yy = (int64_t)yoe + era * 400;
    const unsigned doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
    const unsigned mp = (5 * doy + 2) / 153;
    *d = doy - (153 * mp + 2) / 5 + 1;
    *m = mp + (mp < 10 ? 3 : -9);
    *y = (int)(yy + (*m <= 2));
}

// fixed-width ASCII copy, space padded
inline void pad_copy(uint8_t* dst, const char* src, int n) {
    int i = 0;
    for (; i < n && src[i]; ++i) dst[i] = (uint8_t)src[i];
    for (; i < n; ++i) dst[i] = ' ';
}

void write_header(uint8_t* rec, int seqno, const char* net, const char* sta,
                  const char* loc, const char* cha, double t0, double fs,
                  int nsamp, int reclen_log2) {
    std::memset(rec, 0, 64);
    char seq[8];
    std::snprintf(seq, sizeof(seq), "%06d", seqno % 1000000);
    std::memcpy(rec, seq, 6);
    rec[6] = 'D';
    rec[7] = ' ';
    pad_copy(rec + 8, sta, 5);
    pad_copy(rec + 13, loc, 2);
    pad_copy(rec + 15, cha, 3);
    pad_copy(rec + 18, net, 2);
    int64_t isec = (int64_t)t0;
    double frac = t0 - (double)isec;
    if (frac < 0) { frac += 1.0; isec -= 1; }
    int64_t days = isec / 86400;
    int64_t rem = isec - days * 86400;
    if (rem < 0) { rem += 86400; days -= 1; }
    int y; unsigned mo, dd;
    civil_from_days(days, &y, &mo, &dd);
    // day-of-year
    int doy = (int)(days - days_from_civil(y, 1, 1)) + 1;
    store_u16(rec + 20, (uint16_t)y);
    store_u16(rec + 22, (uint16_t)doy);
    rec[24] = (uint8_t)(rem / 3600);
    rec[25] = (uint8_t)((rem % 3600) / 60);
    rec[26] = (uint8_t)(rem % 60);
    store_u16(rec + 28, (uint16_t)(frac * 1e4 + 0.5));
    store_u16(rec + 30, (uint16_t)nsamp);
    // sample rate as factor*multiplier; integral rates directly, else 1/period
    if (fs >= 1.0 && fs == (double)(int16_t)fs) {
        store_u16(rec + 32, (uint16_t)(int16_t)fs);
        store_u16(rec + 34, 1);
    } else {
        // fs < 1: factor = -period (s), multiplier 1
        store_u16(rec + 32, (uint16_t)(int16_t)(-1.0 / fs));
        store_u16(rec + 34, 1);
    }
    rec[36] = 0x02;  // time correction applied
    rec[39] = 1;     // one blockette follows
    store_u16(rec + 44, 64);  // data offset
    store_u16(rec + 46, 48);  // first blockette offset
    store_u16(rec + 48, 1000);
    store_u16(rec + 50, 0);
    rec[52] = 10;  // Steim1
    rec[53] = 1;   // big endian
    rec[54] = (uint8_t)reclen_log2;
}

// Pack integer diffs into one Steim1 record's data frames.  Consumes as
// many samples as fit; returns the count packed and fills X0/Xn.
int steim1_pack_record(const int32_t* x, int64_t n, uint8_t* data,
                       int nframes) {
    // nibble word per frame written at the end
    int np = 0;  // samples packed
    std::vector<uint32_t> nibs((size_t)nframes, 0u);
    for (int f = 0; f < nframes; ++f) {
        uint8_t* fr = data + (int64_t)f * 64;
        std::memset(fr, 0, 64);
        for (int w = 1; w < 16; ++w) {
            if (f == 0 && (w == 1 || w == 2)) continue;  // X0 / Xn
            if (np >= n) continue;                        // leave c=0
            // diffs relative to previous sample (d0 vs previous record's
            // last sample is irrelevant: decoder starts from X0)
            int32_t d[4];
            int avail = (int)(n - np < 4 ? n - np : 4);
            for (int k = 0; k < avail; ++k)
                d[k] = x[np + k] - (np + k > 0 ? x[np + k - 1] : 0);
            auto fits8 = [&](int c) {
                for (int k = 0; k < c; ++k)
                    if (d[k] < -128 || d[k] > 127) return false;
                return true;
            };
            auto fits16 = [&](int c) {
                for (int k = 0; k < c; ++k)
                    if (d[k] < -32768 || d[k] > 32767) return false;
                return true;
            };
            uint8_t* wp = fr + 4 * w;
            if (avail >= 4 && fits8(4)) {
                for (int k = 0; k < 4; ++k) wp[k] = (uint8_t)(int8_t)d[k];
                nibs[(size_t)f] |= 1u << (2 * (15 - w));
                np += 4;
            } else if (avail >= 2 && fits16(2)) {
                store_u16(wp, (uint16_t)(int16_t)d[0]);
                store_u16(wp + 2, (uint16_t)(int16_t)d[1]);
                nibs[(size_t)f] |= 2u << (2 * (15 - w));
                np += 2;
            } else {
                store_u32(wp, (uint32_t)d[0]);
                nibs[(size_t)f] |= 3u << (2 * (15 - w));
                np += 1;
            }
        }
    }
    for (int f = 0; f < nframes; ++f)
        store_u32(data + (int64_t)f * 64, nibs[(size_t)f]);
    // X0 / Xn integration constants
    if (np > 0) {
        store_u32(data + 4, (uint32_t)x[0]);
        store_u32(data + 8, (uint32_t)x[np - 1]);
    }
    return np;
}

}  // namespace

extern "C" {

// Encode one channel's samples (must be integral; rounded) as Steim1
// 512-byte big-endian records.  Returns bytes written into `out`, or a
// negative error code (-40 buffer too small, -41 bad args, -42 value
// exceeds int32).
int64_t nbls_mseed_encode(const char* net, const char* sta, const char* loc,
                          const char* cha, double t0, double fs,
                          const double* samples, int64_t n, uint8_t* out,
                          int64_t max_bytes) {
    if (!net || !sta || !cha || !samples || !out || fs <= 0 || n < 0)
        return -41;
    const int reclen = 512;
    const int nframes = (reclen - 64) / 64;  // 7
    std::vector<int32_t> xi((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
        double v = samples[i] < 0 ? samples[i] - 0.5 : samples[i] + 0.5;
        if (v < -2147483648.0 || v > 2147483647.0) return -42;
        xi[(size_t)i] = (int32_t)v;
    }
    int64_t done = 0, off = 0;
    int seq = 1;
    while (done < n) {
        if (off + reclen > max_bytes) return -40;
        uint8_t* rec = out + off;
        int np = steim1_pack_record(xi.data() + done, n - done, rec + 64,
                                    nframes);
        if (np <= 0) return -43;
        write_header(rec, seq++, net, sta, loc ? loc : "", cha,
                     t0 + (double)done / fs, fs, np, 9);
        done += np;
        off += reclen;
    }
    return off;
}

// Scan a buffer of concatenated records: counts records and total samples.
// Returns 0, or a negative error code at the first malformed record.
int nbls_mseed_scan(const uint8_t* buf, int64_t nbytes, int64_t* nrecords,
                    int64_t* total_samples) {
    int64_t off = 0, nrec = 0, nsamp = 0;
    while (off + 64 <= nbytes) {
        RecordInfo ri;
        int consumed = parse_record_header(buf + off, nbytes - off, ri);
        if (consumed < 0) return consumed;
        nrec += 1;
        nsamp += ri.nsamp;
        off += consumed;
    }
    *nrecords = nrec;
    *total_samples = nsamp;
    return 0;
}

// Decode every record.  Caller allocates:
//   sids:    max_records * 64 bytes
//   t0s/fss: max_records doubles
//   nsamps:  max_records int64 (samples decoded per record)
//   samples: max_samples doubles (records' samples, concatenated)
// Returns the number of records decoded, or a negative error code.
int64_t nbls_mseed_decode(const uint8_t* buf, int64_t nbytes, char* sids,
                          double* t0s, double* fss, int64_t* nsamps,
                          double* samples, int64_t max_records,
                          int64_t max_samples) {
    int64_t off = 0, rec = 0, sout = 0;
    while (off + 64 <= nbytes) {
        RecordInfo ri;
        int consumed = parse_record_header(buf + off, nbytes - off, ri);
        if (consumed < 0) return consumed;
        if (rec >= max_records) return -30;
        if (sout + ri.nsamp > max_samples) return -31;
        int64_t got = decode_data(ri, buf + off, samples + sout);
        if (got < 0) return got;
        std::memcpy(sids + rec * 64, ri.sid, 64);
        t0s[rec] = ri.t0;
        fss[rec] = ri.fs;
        nsamps[rec] = got;
        sout += got;
        rec += 1;
        off += consumed;
    }
    return rec;
}

// ---------------------------------------------------------------------------
// Multi-channel gap-tracking ring buffer (absolute-sample-index addressed)
// ---------------------------------------------------------------------------

struct Ring {
    int64_t nchans = 0;
    int64_t cap = 0;
    int64_t base = 0;      // lowest absolute index still representable
    int64_t hi = 0;        // one past the highest index ever appended
    bool started = false;  // base is set by the first append (may be < 0)
    std::vector<double> data;    // nchans * cap
    std::vector<uint8_t> valid;  // nchans * cap
};

// floor-mod: non-negative position for any absolute index
inline int64_t rpos(int64_t i, int64_t cap) {
    int64_t m = i % cap;
    return m < 0 ? m + cap : m;
}

void* nbls_ring_create(int64_t nchans, int64_t capacity) {
    if (nchans <= 0 || capacity <= 0) return nullptr;
    Ring* r = new Ring();
    r->nchans = nchans;
    r->cap = capacity;
    r->data.assign((size_t)(nchans * capacity), 0.0);
    r->valid.assign((size_t)(nchans * capacity), 0);
    return r;
}

void nbls_ring_destroy(void* h) { delete (Ring*)h; }

// Append n samples of channel `chan` at absolute sample index `start`.
// Duplicate/overlapping appends overwrite.  Appends past base+cap advance
// the window (oldest data is invalidated).  Returns 0, or -1 on bad args,
// -2 if the block is entirely below the current window (too old).
int nbls_ring_append(void* h, int64_t chan, int64_t start, const double* x,
                     int64_t n) {
    Ring* r = (Ring*)h;
    if (!r || chan < 0 || chan >= r->nchans || n < 0) return -1;
    if (n == 0) return 0;
    if (!r->started) {
        r->base = start;
        r->hi = start;
        r->started = true;
    }
    int64_t end = start + n;
    if (start < r->base && r->hi - start <= r->cap) {
        // extend the window downward: positions below base cannot alias
        // live data when hi - start fits within capacity
        r->base = start;
    }
    if (end > r->base + r->cap) {
        // advance the window so [end-cap, end) is representable
        int64_t new_base = end - r->cap;
        // invalidate [base, new_base) for all channels
        int64_t drop = new_base - r->base;
        if (drop >= r->cap) {
            std::fill(r->valid.begin(), r->valid.end(), 0);
        } else {
            for (int64_t c = 0; c < r->nchans; ++c)
                for (int64_t i = r->base; i < new_base; ++i)
                    r->valid[(size_t)(c * r->cap + rpos(i, r->cap))] = 0;
        }
        r->base = new_base;
    }
    if (end <= r->base) return -2;
    if (end > r->hi) r->hi = end;
    int64_t lo = start < r->base ? r->base : start;
    // contiguous spans (at most one wrap) instead of a per-sample
    // modulo walk: the feed path is called per telemetry record
    double* dch = r->data.data() + chan * r->cap;
    uint8_t* vch = r->valid.data() + chan * r->cap;
    int64_t i = lo;
    while (i < end) {
        int64_t p = rpos(i, r->cap);
        int64_t span = end - i;
        if (span > r->cap - p) span = r->cap - p;
        std::memcpy(dch + p, x + (i - start), (size_t)span * sizeof(double));
        std::memset(vch + p, 1, (size_t)span);
        i += span;
    }
    return 0;
}

// Append a whole batch of records in one call: record r carries lens[r]
// samples of channel chans[r] starting at absolute index starts[r]; the
// sample payloads ride concatenated in `samples`.  One library call per
// telemetry batch instead of one per record: the Python/ctypes call
// overhead, not the copy, bounds the monitoring feed path.
// Returns the number of records accepted (too-old records are skipped,
// matching nbls_ring_append's -2), or -1 on bad args.
int64_t nbls_ring_append_batch(void* h, const int64_t* chans,
                               const int64_t* starts, const int64_t* lens,
                               const double* samples, int64_t nrec) {
    Ring* r = (Ring*)h;
    if (!r || nrec < 0) return -1;
    int64_t off = 0, ok = 0;
    for (int64_t k = 0; k < nrec; ++k) {
        int rc = nbls_ring_append(h, chans[k], starts[k], samples + off,
                                  lens[k]);
        if (rc == -1) return -1;
        if (rc == 0) ++ok;
        off += lens[k];
    }
    return ok;
}

int64_t nbls_ring_base(void* h) { return ((Ring*)h)->base; }

// Largest r such that every sample in [from_idx, r) is valid on EVERY
// channel (the contiguous ready frontier the monitor can consume).
int64_t nbls_ring_ready(void* h, int64_t from_idx) {
    Ring* r = (Ring*)h;
    if (!r) return -1;
    if (from_idx < r->base) return from_idx;  // already dropped: not ready
    int64_t i = from_idx;
    int64_t hi = r->base + r->cap;
    for (; i < hi; ++i) {
        size_t p = (size_t)rpos(i, r->cap);
        bool ok = true;
        for (int64_t c = 0; c < r->nchans; ++c)
            if (!r->valid[(size_t)(c * r->cap) + p]) { ok = false; break; }
        if (!ok) break;
    }
    return i;
}

// Copy [start, start+n) for all channels into out (nchans, n) row-major,
// writing `fill` where samples are missing.  Returns the number of missing
// samples (0 = complete), or -1 on bad args.
int64_t nbls_ring_read(void* h, int64_t start, int64_t n, double fill,
                       double* out) {
    Ring* r = (Ring*)h;
    if (!r || n < 0) return -1;
    int64_t missing = 0;
    for (int64_t c = 0; c < r->nchans; ++c) {
        for (int64_t i = 0; i < n; ++i) {
            int64_t idx = start + i;
            if (idx < r->base || idx >= r->base + r->cap) {
                out[c * n + i] = fill;
                ++missing;
                continue;
            }
            size_t pos = (size_t)(c * r->cap + rpos(idx, r->cap));
            if (r->valid[pos]) {
                out[c * n + i] = r->data[pos];
            } else {
                out[c * n + i] = fill;
                ++missing;
            }
        }
    }
    return missing;
}

// Invalidate everything below idx (consumed data the monitor is done with).
void nbls_ring_release(void* h, int64_t idx) {
    Ring* r = (Ring*)h;
    if (!r || idx <= r->base) return;
    int64_t hi = idx < r->base + r->cap ? idx : r->base + r->cap;
    for (int64_t c = 0; c < r->nchans; ++c)
        for (int64_t i = r->base; i < hi; ++i)
            r->valid[(size_t)(c * r->cap + rpos(i, r->cap))] = 0;
    r->base = idx;
}

}  // extern "C"
