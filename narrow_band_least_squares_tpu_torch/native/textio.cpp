// TSV results codec for the continuous-monitoring workflow.
//
// The port's own copy of the JAX package's C++ codec.  Results are
// persisted as TSV (the reference's checkpoint format), which the Python
// writer produces by a per-row string loop; at monitoring scale (weeks of
// segments, millions of (band, window) rows) that loop sets the host's pace,
// so the codec is native: Python-repr float formatting and a streaming
// parser.  Loaded through ctypes (io/textio.py), which releases the
// interpreter lock around the call.
//
// Row format (byte for byte the Python writer's):
//   header: "Fmin \t Fmax \t Time \t Trace_vel \t Backaz \t MdCCM \n"
//   per band b, rows j < num_compute[b]:
//   str(fmin_b)\t str(fmax_b)\t str(t[b,j])\t str(vel[b,j])\t
//   str(baz[b,j])\t str(mdccm[b,j])\n

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Python's repr of a float (float_repr_style 'short'): the shortest digits
// that round-trip, written in fixed notation when the decimal exponent lies
// in [-4, 16), else as d[.ddd]e+XX; "1.0" not "1"; "nan", "inf", "-inf".
void format_double(double v, std::string& out) {
    if (std::isnan(v)) { out.append("nan"); return; }
    if (std::isinf(v)) { out.append(v < 0 ? "-inf" : "inf"); return; }
    char buf[40];
    auto res = std::to_chars(buf, buf + sizeof(buf), v,
                             std::chars_format::scientific);
    // buf: [-]d[.ddd]e(+|-)XX
    const char* p = buf;
    const char* end = res.ptr;
    if (*p == '-') { out.push_back('-'); ++p; }
    char digits[24];
    int nd = 0;
    while (p < end && *p != 'e') {
        if (*p != '.') digits[nd++] = *p;
        ++p;
    }
    int exp10 = 0;
    std::from_chars(p + (p[1] == '+' ? 2 : 1), end, exp10);
    const int decpt = exp10 + 1;  // digits d1 d2 ... = 0.d1d2... x 10^decpt
    if (decpt > -4 && decpt <= 16) {
        if (decpt <= 0) {
            out.append("0.");
            out.append((size_t)(-decpt), '0');
            out.append(digits, (size_t)nd);
        } else if (decpt >= nd) {
            out.append(digits, (size_t)nd);
            out.append((size_t)(decpt - nd), '0');
            out.append(".0");
        } else {
            out.append(digits, (size_t)decpt);
            out.push_back('.');
            out.append(digits + decpt, (size_t)(nd - decpt));
        }
        return;
    }
    out.push_back(digits[0]);
    if (nd > 1) {
        out.push_back('.');
        out.append(digits + 1, (size_t)(nd - 1));
    }
    char ebuf[8];
    const int e = decpt - 1;
    std::snprintf(ebuf, sizeof(ebuf), "e%c%02d", e < 0 ? '-' : '+', e < 0 ? -e : e);
    out.append(ebuf);
}

}  // namespace

extern "C" {

// Returns 0 on success, negative errno-style code on failure.
int nbls_write_tsv(const char* path,
                   const double* freqlist,      // nbands + 1 edges
                   const double* t,             // (nbands, width) row-major
                   const double* vel,
                   const double* baz,
                   const double* mdccm,
                   const int64_t* num_compute,  // nbands
                   int64_t nbands,
                   int64_t width) {
    std::FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    std::string buf;
    buf.reserve(1 << 22);
    buf.append("Fmin \t Fmax \t Time \t Trace_vel \t Backaz \t MdCCM \n");
    for (int64_t b = 0; b < nbands; ++b) {
        const int64_t n = num_compute[b];
        for (int64_t j = 0; j < n && j < width; ++j) {
            const int64_t k = b * width + j;
            format_double(freqlist[b], buf);
            buf.push_back('\t');
            format_double(freqlist[b + 1], buf);
            buf.push_back('\t');
            format_double(t[k], buf);
            buf.push_back('\t');
            format_double(vel[k], buf);
            buf.push_back('\t');
            format_double(baz[k], buf);
            buf.push_back('\t');
            format_double(mdccm[k], buf);
            buf.push_back('\n');
            if (buf.size() > (1 << 22) - 256) {
                if (std::fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
                    std::fclose(f);
                    return -2;
                }
                buf.clear();
            }
        }
    }
    if (!buf.empty() &&
        std::fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
        std::fclose(f);
        return -2;
    }
    std::fclose(f);
    return 0;
}

// Counts data rows (excluding the header).  Returns row count or negative.
int64_t nbls_count_tsv_rows(const char* path) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::vector<char> chunk(1 << 20);
    int64_t rows = 0;
    size_t got;
    while ((got = std::fread(chunk.data(), 1, chunk.size(), f)) > 0) {
        for (size_t i = 0; i < got; ++i)
            if (chunk[i] == '\n') ++rows;
    }
    std::fclose(f);
    return rows > 0 ? rows - 1 : 0;  // minus header
}

// Parses the 6 float columns into caller-allocated arrays of length nrows.
// Returns rows parsed, or negative on error.
int64_t nbls_read_tsv(const char* path,
                      double* fmin, double* fmax, double* t,
                      double* vel, double* baz, double* mdccm,
                      int64_t nrows) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::string content;
    {
        std::fseek(f, 0, SEEK_END);
        long sz = std::ftell(f);
        std::fseek(f, 0, SEEK_SET);
        content.resize(sz);
        if (sz > 0 && std::fread(&content[0], 1, sz, f) != (size_t)sz) {
            std::fclose(f);
            return -2;
        }
    }
    std::fclose(f);

    const char* p = content.data();
    const char* end = p + content.size();
    // skip header line
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;

    double* cols[6] = {fmin, fmax, t, vel, baz, mdccm};
    int64_t row = 0;
    while (p < end && row < nrows) {
        for (int c = 0; c < 6; ++c) {
            while (p < end && (*p == ' ' || *p == '\t')) ++p;
            double v;
            auto res = std::from_chars(p, end, v);
            if (res.ec != std::errc()) {
                return row;  // truncated/garbled tail: return what we have
            }
            cols[c][row] = v;
            p = res.ptr;
        }
        while (p < end && *p != '\n') ++p;
        if (p < end) ++p;
        ++row;
    }
    return row;
}

}  // extern "C"
