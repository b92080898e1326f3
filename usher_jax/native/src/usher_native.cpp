// usher_jax native host layer: transpose-VCF codec + fast VCF ingest.
//
// The reference implements these in C++ with TBB pipelines
// (/root/reference/src/matOptimize/transpose_vcf/transpose_vcf.hpp and
// src/matOptimize/import_vcf_fast.cpp); this extension provides the same
// on-disk formats and parsing semantics behind a CPython API, with the
// device compute left to JAX/XLA.
//
// Transposed-VCF format (transposed_vcf.md):
//   [u32 little-endian compressed block length][zlib block]*
//   block = sample records; record =
//     name\0
//     called mutations\0: (varint pos1 [varint pos2] allele_byte)*,
//       allele_byte = (allele2<<4)|allele1 one-hot nibbles
//     N ranges\0: varint end [varint start if start<end] per range
//       (decoder rule: first>second => range [second,first], else single)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <zlib.h>

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

void write_varint(std::string& out, unsigned int v) {
    while (v >= 0x80) {
        out.push_back(static_cast<char>((v & 0x7f) | 0x80));
        v >>= 7;
    }
    out.push_back(static_cast<char>(v));
}

// LEB128-style decoder for the transposed-VCF on-disk format (7 payload
// bits per byte, high bit = continuation; same wire layout as the
// reference codec, required for file-format parity).
unsigned int load_varint(const uint8_t*& cursor) {
    unsigned int value = 0;
    for (int shift = 0;; shift += 7) {
        uint8_t byte = *cursor++;
        value |= static_cast<unsigned int>(byte & 0x7f) << shift;
        if (!(byte & 0x80)) break;
    }
    return value;
}

// ---------------------------------------------------------------- encode

// samples: list of (name, [(pos, allele)], [(start, end)]) tuples
PyObject* transpose_encode(PyObject*, PyObject* args) {
    PyObject* samples;
    const char* path;
    int append = 0;
    if (!PyArg_ParseTuple(args, "Os|p", &samples, &path, &append)) {
        return nullptr;
    }
    PyObject* seq = PySequence_Fast(samples, "samples must be a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);

    std::string raw;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
        PyObject* name_obj = PyTuple_GetItem(item, 0);
        PyObject* muts = PyTuple_GetItem(item, 1);
        PyObject* nranges = PyTuple_GetItem(item, 2);
        if (!name_obj || !muts || !nranges) {
            Py_DECREF(seq);
            return nullptr;
        }
        const char* name = PyUnicode_AsUTF8(name_obj);
        if (!name) {
            Py_DECREF(seq);
            return nullptr;
        }
        raw.append(name);
        raw.push_back('\0');

        Py_ssize_t nm = PySequence_Size(muts);
        for (Py_ssize_t k = 0; k + 1 < nm; k += 2) {
            PyObject* m1 = PySequence_GetItem(muts, k);
            PyObject* m2 = PySequence_GetItem(muts, k + 1);
            unsigned p1 = PyLong_AsUnsignedLong(PyTuple_GetItem(m1, 0));
            unsigned a1 = PyLong_AsUnsignedLong(PyTuple_GetItem(m1, 1));
            unsigned p2 = PyLong_AsUnsignedLong(PyTuple_GetItem(m2, 0));
            unsigned a2 = PyLong_AsUnsignedLong(PyTuple_GetItem(m2, 1));
            Py_DECREF(m1);
            Py_DECREF(m2);
            write_varint(raw, p1);
            write_varint(raw, p2);
            raw.push_back(static_cast<char>((a2 << 4) | (a1 & 0xf)));
        }
        if (nm & 1) {
            PyObject* m1 = PySequence_GetItem(muts, nm - 1);
            unsigned p1 = PyLong_AsUnsignedLong(PyTuple_GetItem(m1, 0));
            unsigned a1 = PyLong_AsUnsignedLong(PyTuple_GetItem(m1, 1));
            Py_DECREF(m1);
            write_varint(raw, p1);
            raw.push_back(static_cast<char>(a1 & 0xf));
        }
        raw.push_back('\0');

        Py_ssize_t nr = PySequence_Size(nranges);
        for (Py_ssize_t k = 0; k < nr; k++) {
            PyObject* r = PySequence_GetItem(nranges, k);
            unsigned start = PyLong_AsUnsignedLong(PyTuple_GetItem(r, 0));
            unsigned end = PyLong_AsUnsignedLong(PyTuple_GetItem(r, 1));
            Py_DECREF(r);
            write_varint(raw, end);
            if (start < end) {
                write_varint(raw, start);
            }
        }
        raw.push_back('\0');
    }
    Py_DECREF(seq);

    uLongf bound = compressBound(raw.size());
    std::vector<uint8_t> comp(bound);
    if (compress2(comp.data(), &bound,
                  reinterpret_cast<const Bytef*>(raw.data()), raw.size(),
                  Z_DEFAULT_COMPRESSION) != Z_OK) {
        PyErr_SetString(PyExc_RuntimeError, "zlib compress failed");
        return nullptr;
    }

    FILE* f = fopen(path, append ? "ab" : "wb");
    if (!f) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }
    uint32_t len = static_cast<uint32_t>(bound);
    fwrite(&len, 4, 1, f);
    fwrite(comp.data(), 1, bound, f);
    fclose(f);
    Py_RETURN_NONE;
}

// ---------------------------------------------------------------- decode

PyObject* transpose_decode(PyObject*, PyObject* args) {
    const char* path;
    if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
    FILE* f = fopen(path, "rb");
    if (!f) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }
    PyObject* out = PyList_New(0);
    uint32_t len;
    std::vector<uint8_t> comp, raw;
    while (fread(&len, 4, 1, f) == 1) {
        comp.resize(len);
        if (fread(comp.data(), 1, len, f) != len) {
            fclose(f);
            Py_DECREF(out);
            PyErr_SetString(PyExc_ValueError, "truncated transpose-vcf block");
            return nullptr;
        }
        // blocks are bounded (MAX_SIZ=0x30000 in the reference); grow as
        // needed for robustness
        uLongf out_len = 0x30000;
        int zrc;
        do {
            raw.resize(out_len);
            zrc = uncompress(raw.data(), &out_len, comp.data(), len);
            if (zrc == Z_BUF_ERROR) out_len *= 2;
        } while (zrc == Z_BUF_ERROR && out_len < (1u << 28));
        if (zrc != Z_OK) {
            fclose(f);
            Py_DECREF(out);
            PyErr_SetString(PyExc_ValueError, "zlib uncompress failed");
            return nullptr;
        }
        const uint8_t* in = raw.data();
        const uint8_t* end = raw.data() + out_len;
        while (in < end) {
            std::string name;
            while (*in) name.push_back(static_cast<char>(*in++));
            in++;
            PyObject* muts = PyList_New(0);
            while (*in) {
                unsigned p1 = load_varint(in);
                if (*(in + 1)) {
                    unsigned p2 = load_varint(in);
                    PyObject* t1 = Py_BuildValue("(II)", p1, (*in) & 0xf);
                    PyObject* t2 = Py_BuildValue("(II)", p2, ((*in) >> 4) & 0xf);
                    PyList_Append(muts, t1);
                    PyList_Append(muts, t2);
                    Py_DECREF(t1);
                    Py_DECREF(t2);
                } else {
                    PyObject* t1 = Py_BuildValue("(II)", p1, (*in) & 0xf);
                    PyList_Append(muts, t1);
                    Py_DECREF(t1);
                }
                in++;
            }
            in++;
            PyObject* nranges = PyList_New(0);
            while (*in) {
                unsigned first = load_varint(in);
                const uint8_t* after_first = in;
                if (!(*in)) {
                    PyObject* r = Py_BuildValue("(II)", first, first);
                    PyList_Append(nranges, r);
                    Py_DECREF(r);
                    break;
                }
                unsigned second = load_varint(in);
                if (first > second) {
                    PyObject* r = Py_BuildValue("(II)", second, first);
                    PyList_Append(nranges, r);
                    Py_DECREF(r);
                } else {
                    PyObject* r = Py_BuildValue("(II)", first, first);
                    PyList_Append(nranges, r);
                    Py_DECREF(r);
                    in = after_first;
                }
            }
            in++;
            PyObject* rec = Py_BuildValue("(sNN)", name.c_str(), muts, nranges);
            PyList_Append(out, rec);
            Py_DECREF(rec);
        }
    }
    fclose(f);
    return out;
}

// ---------------------------------------------------------------- VCF parse

// one-hot nibble per IUPAC char, matching the reference get_nuc_id
// (mutation_annotated_tree.cpp:19-86, including the V->N quirk)
uint8_t nuc_table[256];

void init_nuc_table() {
    for (int i = 0; i < 256; i++) nuc_table[i] = 0xf;
    nuc_table['a'] = nuc_table['A'] = 0x1;
    nuc_table['c'] = nuc_table['C'] = 0x2;
    nuc_table['g'] = nuc_table['G'] = 0x4;
    nuc_table['t'] = nuc_table['T'] = 0x8;
    nuc_table['R'] = 0x5;
    nuc_table['Y'] = 0xa;
    nuc_table['S'] = 0x6;
    nuc_table['W'] = 0x9;
    nuc_table['K'] = 0xc;
    nuc_table['M'] = 0x3;
    nuc_table['B'] = 0xe;
    nuc_table['D'] = 0xd;
    nuc_table['H'] = 0xb;
    // 'V' falls through to N in the reference
}

// Returns (sample_ids: list[str],
//          sites: list[(chrom, pos, ref_nuc, [(col, nuc)])]).
// Genotype semantics match usher_jax.io.vcf.read_vcf_sites: allele index 0
// = ref (not recorded), '.'/missing = N recorded as 0xf, multi-allele GT
// uses the first index; per-sample allele = alleles[idx].
PyObject* parse_vcf(PyObject*, PyObject* args) {
    const char* path;
    if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
    gzFile f = gzopen(path, "rb");
    if (!f) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }
    gzbuffer(f, 1 << 20);

    PyObject* sample_ids = PyList_New(0);
    PyObject* sites = PyList_New(0);

    std::string line;
    line.reserve(1 << 20);
    std::vector<char> buf(1 << 20);
    bool header_done = false;
    std::string carry;

    auto is_sep = [](char c) { return c == '\t' || c == ' '; };

    // header row is detected like the reference read_vcf: second
    // whitespace-separated field == "POS" (mutation_annotated_tree.cpp:2062)
    auto process_line = [&](const char* s, size_t n) -> bool {
        if (n == 0) return true;
        const char* end = s + n;
        if (!header_done) {
            // tokenize fully; cheap for header-ish lines
            std::vector<std::pair<const char*, size_t>> fields;
            size_t start = 0;
            for (size_t i = 0; i <= n; i++) {
                if (i == n || is_sep(s[i])) {
                    if (i > start) fields.emplace_back(s + start, i - start);
                    start = i + 1;
                }
            }
            if (fields.size() > 1 && fields[1].second == 3 &&
                memcmp(fields[1].first, "POS", 3) == 0) {
                for (size_t k = 9; k < fields.size(); k++) {
                    PyObject* nm = PyUnicode_FromStringAndSize(
                        fields[k].first, fields[k].second);
                    PyList_Append(sample_ids, nm);
                    Py_DECREF(nm);
                }
                header_done = true;
            }
            return true;
        }
        // data row: CHROM POS ID REF ALT QUAL FILTER INFO FORMAT GT...
        const char* field_start[9];
        size_t field_len[9];
        size_t col = 0, start = 0;
        size_t i = 0;
        for (; i <= n && col < 9; i++) {
            if (i == n || is_sep(s[i])) {
                field_start[col] = s + start;
                field_len[col] = i - start;
                col++;
                start = i + 1;
            }
        }
        if (col < 9) return true;  // malformed / no genotypes
        std::string chrom(field_start[0], field_len[0]);
        long pos = strtol(std::string(field_start[1], field_len[1]).c_str(),
                          nullptr, 10);
        // alleles: index 0 = ref, then ALT comma-separated
        std::vector<uint8_t> alleles;
        alleles.push_back(field_len[3] ? nuc_table[(uint8_t)field_start[3][0]]
                                       : 0xf);
        {
            const char* a = field_start[4];
            const char* ae = a + field_len[4];
            while (a < ae) {
                const char* c = a;
                while (c < ae && *c != ',') c++;
                alleles.push_back(a < c ? nuc_table[(uint8_t)*a] : 0xf);
                a = c + 1;
            }
        }
        uint8_t ref_nuc = alleles[0];
        PyObject* variants = PyList_New(0);
        long sample_col = 0;
        const char* gt = s + start;
        while (gt <= end) {
            const char* t = gt;
            while (t < end && *t != '\t' && *t != ' ') t++;
            // parse leading integer (or '.' = missing)
            long idx = -1;
            if (t > gt) {
                if (*gt == '.') {
                    idx = -1;
                } else {
                    idx = 0;
                    const char* d = gt;
                    while (d < t && *d >= '0' && *d <= '9') {
                        idx = idx * 10 + (*d - '0');
                        d++;
                    }
                    if (d == gt) idx = -1;
                }
            }
            uint8_t nuc;
            bool record;
            if (idx < 0) {
                nuc = 0xf;
                record = true;
            } else if (idx == 0) {
                nuc = ref_nuc;
                record = false;
            } else if ((size_t)idx < alleles.size()) {
                nuc = alleles[idx];
                record = true;
            } else {
                nuc = 0xf;
                record = true;
            }
            if (record) {
                PyObject* v = Py_BuildValue("(lB)", sample_col, nuc);
                PyList_Append(variants, v);
                Py_DECREF(v);
            }
            sample_col++;
            if (t >= end) break;
            gt = t + 1;
        }
        PyObject* site = Py_BuildValue("(slBN)", chrom.c_str(), pos,
                                       ref_nuc, variants);
        PyList_Append(sites, site);
        Py_DECREF(site);
        return true;
    };

    int nread;
    while ((nread = gzread(f, buf.data(), buf.size())) > 0) {
        size_t begin = 0;
        for (int i = 0; i < nread; i++) {
            if (buf[i] == '\n') {
                if (!carry.empty()) {
                    carry.append(buf.data() + begin, i - begin);
                    process_line(carry.data(), carry.size());
                    carry.clear();
                } else {
                    process_line(buf.data() + begin, i - begin);
                }
                begin = i + 1;
            }
        }
        if (begin < (size_t)nread) {
            carry.append(buf.data() + begin, nread - begin);
        }
    }
    if (!carry.empty()) {
        process_line(carry.data(), carry.size());
    }
    gzclose(f);
    return Py_BuildValue("(NN)", sample_ids, sites);
}

// ---------------------------------------------------------------------------
// Parallel VCF ingest: the reference's TBB flow-graph pipeline
// (src/matOptimize/import_vcf_fast.cpp:32-456: decompressor -> line aligner
// -> parallel line parser) re-built on std::thread.  The gzip inflate is
// inherently serial; chunks aligned to line boundaries fan out to a worker
// pool that tokenizes rows into plain C++ records with the GIL released;
// Python objects are materialized once, in order, at the end.
// ---------------------------------------------------------------------------

struct SiteRec {
    std::string chrom;
    long pos;
    uint8_t ref_nuc;
    std::vector<std::pair<long, uint8_t>> variants;
};

// parse one data row into `out`; returns false for non-data rows
static bool parse_data_line(const char* s, size_t n, SiteRec& out) {
    if (n == 0 || s[0] == '#') return false;
    auto is_sep = [](char c) { return c == '\t' || c == ' '; };
    const char* end = s + n;
    const char* field_start[9];
    size_t field_len[9];
    size_t col = 0, start = 0, i = 0;
    for (; i <= n && col < 9; i++) {
        if (i == n || is_sep(s[i])) {
            field_start[col] = s + start;
            field_len[col] = i - start;
            col++;
            start = i + 1;
        }
    }
    if (col < 9) return false;
    out.chrom.assign(field_start[0], field_len[0]);
    out.pos = strtol(std::string(field_start[1], field_len[1]).c_str(),
                     nullptr, 10);
    std::vector<uint8_t> alleles;
    alleles.push_back(field_len[3] ? nuc_table[(uint8_t)field_start[3][0]]
                                   : 0xf);
    {
        const char* a = field_start[4];
        const char* ae = a + field_len[4];
        while (a < ae) {
            const char* c = a;
            while (c < ae && *c != ',') c++;
            alleles.push_back(a < c ? nuc_table[(uint8_t)*a] : 0xf);
            a = c + 1;
        }
    }
    out.ref_nuc = alleles[0];
    out.variants.clear();
    long sample_col = 0;
    const char* gt = s + start;
    while (gt <= end) {
        const char* t = gt;
        while (t < end && *t != '\t' && *t != ' ') t++;
        long idx = -1;
        if (t > gt) {
            if (*gt == '.') {
                idx = -1;
            } else {
                idx = 0;
                const char* d = gt;
                while (d < t && *d >= '0' && *d <= '9') {
                    idx = idx * 10 + (*d - '0');
                    d++;
                }
                if (d == gt) idx = -1;
            }
        }
        if (idx < 0) {
            out.variants.emplace_back(sample_col, 0xf);
        } else if (idx == 0) {
            // ref call: not recorded
        } else if ((size_t)idx < alleles.size()) {
            out.variants.emplace_back(sample_col, alleles[idx]);
        } else {
            out.variants.emplace_back(sample_col, 0xf);
        }
        sample_col++;
        if (t >= end) break;
        gt = t + 1;
    }
    return true;
}

struct VcfChunk {
    size_t index;
    std::string data;   // whole lines only
};

PyObject* parse_vcf_mt(PyObject*, PyObject* args) {
    const char* path;
    int n_threads = 0;
    if (!PyArg_ParseTuple(args, "s|i", &path, &n_threads)) return nullptr;
    if (n_threads <= 0) {
        n_threads = (int)std::thread::hardware_concurrency();
        if (n_threads <= 0) n_threads = 4;
    }
    gzFile f = gzopen(path, "rb");
    if (!f) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }
    gzbuffer(f, 1 << 20);

    std::vector<std::vector<SiteRec>> results;  // per chunk, in order
    std::string header_line;
    bool read_error = false;

    Py_BEGIN_ALLOW_THREADS
    std::deque<VcfChunk> queue;
    std::mutex mu;
    std::condition_variable cv_work, cv_space;
    bool done = false;
    const size_t MAX_QUEUE = 64;

    auto worker = [&]() {
        for (;;) {
            VcfChunk chunk;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_work.wait(lk, [&] { return done || !queue.empty(); });
                if (queue.empty()) return;
                chunk = std::move(queue.front());
                queue.pop_front();
                cv_space.notify_one();
            }
            std::vector<SiteRec> local;
            const char* s = chunk.data.data();
            size_t n = chunk.data.size();
            size_t begin = 0;
            for (size_t i = 0; i <= n; i++) {
                if (i == n || s[i] == '\n') {
                    SiteRec rec;
                    if (parse_data_line(s + begin, i - begin, rec)) {
                        local.push_back(std::move(rec));
                    } else if (i > begin && s[begin] == '#') {
                        // stash the #CHROM header row for the main thread
                        std::string h(s + begin, i - begin);
                        if (h.rfind("##", 0) != 0) {
                            std::lock_guard<std::mutex> lk(mu);
                            if (header_line.empty()) header_line = h;
                        }
                    }
                    begin = i + 1;
                }
            }
            {
                std::lock_guard<std::mutex> lk(mu);
                if (results.size() <= chunk.index)
                    results.resize(chunk.index + 1);
                results[chunk.index] = std::move(local);
            }
        }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);

    // producer: serial inflate, align chunks to line boundaries
    std::vector<char> buf(8 << 20);
    std::string carry;
    size_t next_index = 0;
    int nread;
    while ((nread = gzread(f, buf.data(), (unsigned)buf.size())) > 0) {
        int last_nl = -1;
        for (int i = nread - 1; i >= 0; i--) {
            if (buf[i] == '\n') { last_nl = i; break; }
        }
        VcfChunk chunk;
        chunk.index = next_index++;
        chunk.data = std::move(carry);
        carry.clear();
        if (last_nl >= 0) {
            chunk.data.append(buf.data(), last_nl + 1);
            carry.assign(buf.data() + last_nl + 1, nread - last_nl - 1);
        } else {
            // no newline in this read: accumulate and continue
            carry = std::move(chunk.data);
            carry.append(buf.data(), nread);
            next_index--;
            continue;
        }
        {
            std::unique_lock<std::mutex> lk(mu);
            cv_space.wait(lk, [&] { return queue.size() < MAX_QUEUE; });
            queue.push_back(std::move(chunk));
        }
        cv_work.notify_one();
    }
    if (nread < 0) read_error = true;
    if (!carry.empty()) {
        VcfChunk chunk;
        chunk.index = next_index++;
        chunk.data = std::move(carry);
        {
            std::lock_guard<std::mutex> lk(mu);
            queue.push_back(std::move(chunk));
        }
        cv_work.notify_one();
    }
    {
        std::lock_guard<std::mutex> lk(mu);
        done = true;
    }
    cv_work.notify_all();
    for (auto& t : pool) t.join();
    gzclose(f);
    Py_END_ALLOW_THREADS

    if (read_error) {
        PyErr_Format(PyExc_OSError, "error reading %s", path);
        return nullptr;
    }

    // sample ids from the header row
    PyObject* sample_ids = PyList_New(0);
    {
        std::vector<std::pair<size_t, size_t>> fields;
        const std::string& h = header_line;
        size_t start = 0;
        for (size_t i = 0; i <= h.size(); i++) {
            if (i == h.size() || h[i] == '\t' || h[i] == ' ') {
                if (i > start) fields.emplace_back(start, i - start);
                start = i + 1;
            }
        }
        if (fields.size() > 9) {
            for (size_t k = 9; k < fields.size(); k++) {
                PyObject* nm = PyUnicode_FromStringAndSize(
                    h.data() + fields[k].first, fields[k].second);
                PyList_Append(sample_ids, nm);
                Py_DECREF(nm);
            }
        }
    }

    PyObject* sites = PyList_New(0);
    for (const auto& chunk_sites : results) {
        for (const auto& rec : chunk_sites) {
            PyObject* variants = PyList_New((Py_ssize_t)rec.variants.size());
            for (size_t k = 0; k < rec.variants.size(); k++) {
                PyList_SET_ITEM(variants, (Py_ssize_t)k,
                                Py_BuildValue("(lB)", rec.variants[k].first,
                                              rec.variants[k].second));
            }
            PyObject* site = Py_BuildValue("(slBN)", rec.chrom.c_str(),
                                           rec.pos, rec.ref_nuc, variants);
            PyList_Append(sites, site);
            Py_DECREF(site);
        }
    }
    return Py_BuildValue("(NN)", sample_ids, sites);
}


// ------------------------------------------------------- pandemic-scale load
//
// Array-form loaders for the parsimony.pb interchange format
// (/root/reference/parsimony.proto; loader semantics
// mutation_annotated_tree.cpp:522-613): at >2M nodes, building Python Node
// objects costs minutes and GBs — these return flat arrays (as bytes
// buffers; Python wraps them with np.frombuffer, zero-copy) that feed
// core/bigmat.py directly.

inline uint64_t read_uvarint(const uint8_t*& p, const uint8_t* end) {
    uint64_t v = 0;
    int shift = 0;
    while (p < end) {
        uint8_t b = *p++;
        v |= (uint64_t)(b & 0x7f) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
    }
    return v;
}

// pb_to_arrays(data: bytes) ->
//   (newick_bytes, counts_bytes(i32/node), pos_bytes(i32/mut),
//    ref_bytes(i8), par_bytes(i8), mask_bytes(u8), chrom_str,
//    condensed_list, ann_counts_bytes(i32), ann_blob_bytes)
PyObject* pb_to_arrays(PyObject*, PyObject* args) {
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
    const uint8_t* p = (const uint8_t*)buf.buf;
    const uint8_t* end = p + buf.len;

    std::string newick;
    std::vector<int32_t> counts;
    std::vector<int32_t> pos;
    std::vector<int8_t> refn, parn;
    std::vector<uint8_t> mask;
    std::string chrom;
    std::vector<int32_t> ann_counts;
    std::string ann_blob;
    PyObject* condensed = PyList_New(0);

    while (p < end) {
        uint64_t key = read_uvarint(p, end);
        int fn = (int)(key >> 3), wt = (int)(key & 7);
        if (wt != 2) {  // all data-level fields are length-delimited
            if (wt == 0) { read_uvarint(p, end); continue; }
            PyErr_SetString(PyExc_ValueError, "unexpected wire type");
            Py_DECREF(condensed);
            PyBuffer_Release(&buf);
            return nullptr;
        }
        uint64_t len = read_uvarint(p, end);
        const uint8_t* fend = p + len;
        if (fn == 1) {
            newick.assign((const char*)p, len);
            p = fend;
        } else if (fn == 2) {  // mutation_list
            int32_t cnt = 0;
            while (p < fend) {
                uint64_t k2 = read_uvarint(p, fend);
                uint64_t l2 = read_uvarint(p, fend);
                const uint8_t* mend = p + l2;
                if ((int)(k2 >> 3) != 1) { p = mend; continue; }
                int32_t mpos = 0, mref = 0, mpar = 0;
                uint8_t mmask = 0;
                while (p < mend) {
                    uint64_t k3 = read_uvarint(p, mend);
                    int f3 = (int)(k3 >> 3), w3 = (int)(k3 & 7);
                    if (w3 == 0) {
                        int64_t v = (int64_t)read_uvarint(p, mend);
                        if (f3 == 1) mpos = (int32_t)v;
                        else if (f3 == 2) mref = (int32_t)v;
                        else if (f3 == 3) mpar = (int32_t)v;
                        else if (f3 == 4 && v >= 0 && v < 4)
                            mmask |= (uint8_t)(1u << v);
                    } else if (w3 == 2) {
                        uint64_t l3 = read_uvarint(p, mend);
                        const uint8_t* e3 = p + l3;
                        if (f3 == 4) {  // packed mut_nuc
                            while (p < e3) {
                                int64_t v = (int64_t)read_uvarint(p, e3);
                                if (v >= 0 && v < 4)
                                    mmask |= (uint8_t)(1u << v);
                            }
                        } else if (f3 == 5) {
                            if (chrom.empty())
                                chrom.assign((const char*)p, l3);
                            p = e3;
                        }
                        p = e3;
                    } else {
                        break;
                    }
                }
                p = mend;
                pos.push_back(mpos);
                refn.push_back((int8_t)mref);
                parn.push_back((int8_t)mpar);
                mask.push_back(mmask);
                cnt++;
            }
            counts.push_back(cnt);
            p = fend;
        } else if (fn == 3) {  // condensed_node
            PyObject* name = nullptr;
            PyObject* leaves = PyList_New(0);
            while (p < fend) {
                uint64_t k2 = read_uvarint(p, fend);
                uint64_t l2 = read_uvarint(p, fend);
                if ((int)(k2 >> 3) == 1) {
                    Py_XDECREF(name);
                    name = PyUnicode_FromStringAndSize((const char*)p, l2);
                } else if ((int)(k2 >> 3) == 2) {
                    PyObject* s =
                        PyUnicode_FromStringAndSize((const char*)p, l2);
                    PyList_Append(leaves, s);
                    Py_DECREF(s);
                }
                p += l2;
            }
            if (!name) name = PyUnicode_FromString("");
            PyObject* t = Py_BuildValue("(NN)", name, leaves);
            PyList_Append(condensed, t);
            Py_DECREF(t);
            p = fend;
        } else if (fn == 4) {  // node_metadata
            int32_t cnt = 0;
            while (p < fend) {
                uint64_t k2 = read_uvarint(p, fend);
                uint64_t l2 = read_uvarint(p, fend);
                if ((int)(k2 >> 3) == 1) {
                    ann_blob.append((const char*)p, l2);
                    ann_blob.push_back('\0');
                    cnt++;
                }
                p += l2;
            }
            ann_counts.push_back(cnt);
            p = fend;
        } else {
            p = fend;
        }
    }
    PyBuffer_Release(&buf);

    PyObject* out = Py_BuildValue(
        "(y#y#y#y#y#y#s#Ny#y#)",
        newick.data(), (Py_ssize_t)newick.size(),
        (const char*)counts.data(), (Py_ssize_t)(counts.size() * 4),
        (const char*)pos.data(), (Py_ssize_t)(pos.size() * 4),
        (const char*)refn.data(), (Py_ssize_t)refn.size(),
        (const char*)parn.data(), (Py_ssize_t)parn.size(),
        (const char*)mask.data(), (Py_ssize_t)mask.size(),
        chrom.data(), (Py_ssize_t)chrom.size(),
        condensed,
        (const char*)ann_counts.data(), (Py_ssize_t)(ann_counts.size() * 4),
        ann_blob.data(), (Py_ssize_t)ann_blob.size());
    return out;
}

// newick_to_arrays(newick: bytes) ->
//   (n, parent_bytes(i32; root -> self), names_blob(\0-joined, creation
//    order), blen_bytes(f64))
// Node creation order matches io/newick.parse_newick_string exactly:
// internals at '(' (ids node_1, node_2, ... = preorder), leaves at their
// name token — so creation order IS the DFS preorder that parsimony.pb's
// node_mutations follow.
PyObject* newick_to_arrays(PyObject*, PyObject* args) {
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
    const char* s = (const char*)buf.buf;
    Py_ssize_t len = buf.len;

    std::vector<int32_t> parent;
    std::vector<double> blen;
    std::string names;
    std::vector<int32_t> stack;
    long internal_counter = 0;
    char numbuf[32];

    auto add_node = [&](int32_t par, const char* name, size_t nlen,
                        double bl) {
        int32_t id = (int32_t)parent.size();
        parent.push_back(par < 0 ? id : par);
        blen.push_back(bl);
        names.append(name, nlen);
        names.push_back('\0');
        return id;
    };

    Py_ssize_t i = 0;
    bool root_created = false;
    bool fail = false;
    while (i < len && !fail) {
        char c = s[i];
        if (c == ' ' || c == '\t' || c == '\n' || c == '\r') { i++; continue; }
        if (c == '(') {
            int nlen = snprintf(numbuf, sizeof numbuf, "node_%ld",
                                ++internal_counter);
            int32_t par = stack.empty() ? -1 : stack.back();
            if (stack.empty()) {
                if (root_created) { fail = true; break; }
                root_created = true;
            }
            stack.push_back(add_node(par, numbuf, (size_t)nlen, -1.0));
            i++;
        } else if (c == ')') {
            if (stack.empty()) { fail = true; break; }
            int32_t node = stack.back();
            stack.pop_back();
            i++;
            // optional internal label: dropped (reference drops it)
            while (i < len && !strchr("(),;:", s[i])
                   && !isspace((unsigned char)s[i])) i++;
            if (i < len && s[i] == ':') {
                i++;
                std::string num;
                while (i < len && !strchr("(),;:", s[i])) {
                    char ch = s[i++];
                    if (isdigit((unsigned char)ch) || ch == '.' || ch == 'e'
                        || ch == 'E' || ch == '-' || ch == '+')
                        num.push_back(ch);
                }
                if (!num.empty()) blen[node] = atof(num.c_str());
            }
        } else if (c == ',' || c == ';') {
            i++;
        } else if (c == ':') {
            fail = true;
        } else {
            Py_ssize_t start = i;
            while (i < len && !strchr("(),;:", s[i])
                   && !isspace((unsigned char)s[i])) i++;
            double bl = -1.0;
            Py_ssize_t name_end = i;
            if (i < len && s[i] == ':') {
                i++;
                std::string num;
                while (i < len && !strchr("(),;:", s[i])) {
                    char ch = s[i++];
                    if (isdigit((unsigned char)ch) || ch == '.' || ch == 'e'
                        || ch == 'E' || ch == '-' || ch == '+')
                        num.push_back(ch);
                }
                if (!num.empty()) bl = atof(num.c_str());
            }
            int32_t par = stack.empty() ? -1 : stack.back();
            if (stack.empty()) {
                if (root_created) { fail = true; break; }
                root_created = true;
            }
            add_node(par, s + start, (size_t)(name_end - start), bl);
        }
    }
    PyBuffer_Release(&buf);
    if (fail || !stack.empty()) {
        PyErr_SetString(PyExc_ValueError, "incorrect Newick format");
        return nullptr;
    }
    return Py_BuildValue(
        "(ny#y#y#)", (Py_ssize_t)parent.size(),
        (const char*)parent.data(), (Py_ssize_t)(parent.size() * 4),
        names.data(), (Py_ssize_t)names.size(),
        (const char*)blen.data(), (Py_ssize_t)(blen.size() * 8));
}

PyMethodDef methods[] = {
    {"transpose_encode", transpose_encode, METH_VARARGS,
     "transpose_encode(samples, path, append=False): write a transposed-VCF "
     "block (reference transpose_vcf format)"},
    {"transpose_decode", transpose_decode, METH_VARARGS,
     "transpose_decode(path) -> [(name, [(pos, allele)], [(start, end)])]"},
    {"parse_vcf", parse_vcf, METH_VARARGS,
     "parse_vcf(path) -> (sample_ids, sites); gzip-transparent"},
    {"parse_vcf_mt", parse_vcf_mt, METH_VARARGS,
     "parse_vcf_mt(path, n_threads=0) -> (sample_ids, sites); parallel "
     "line parsing (TBB-pipeline analog)"},
    {"pb_to_arrays", pb_to_arrays, METH_VARARGS,
     "pb_to_arrays(data) -> flat arrays of a parsimony.pb 'data' message"},
    {"newick_to_arrays", newick_to_arrays, METH_VARARGS,
     "newick_to_arrays(newick) -> (n, parent_i32, names_blob, blen_f64)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_usher_native",
    "Native host layer: transpose-VCF codec + fast VCF ingest", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__usher_native() {
    init_nuc_table();
    return PyModule_Create(&moduledef);
}
