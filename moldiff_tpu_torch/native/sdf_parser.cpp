// Native SDF / MDL V2000 parser: the dataset-ingestion hot path (a copy of
// moldiff_tpu/native/sdf_parser.cpp, the port's own: it is built into the
// checkout's build/native/, never into the JAX package).
//
// It parses a whole .sdf file in one pass into flat arrays read through
// ctypes (binding: moldiff_tpu_torch/chem/sdf_native.py), with the
// semantics of chem/sdf.py:molblock_to_mol (same column slices, same charge
// codes, per-record error -> None), so the two parsers are interchangeable
// (tests/test_torch_sdf_native.py holds it to the JAX package's parser and
// to the Python one).
//
// Covered V2000 subset (what GEOM-Drug and our own writer emit): counts
// line, atom block (coords + symbol), bond block (order 1..4), M CHG.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <string>
#include <vector>

namespace {

struct MolRec {
    bool ok = false;
    std::vector<int32_t> z;        // [n]
    std::vector<double> pos;       // [3n]
    std::vector<int32_t> charge;   // [n]
    std::vector<int32_t> bonds;    // [3m] (i, j, order), 0-based
};

struct Parsed {
    std::vector<MolRec> mols;
};

// same element set as chem/periodic.py:SYMBOL_TO_Z
int32_t symbol_to_z(const std::string& s) {
    static const struct { const char* sym; int32_t z; } TAB[] = {
        {"H", 1},  {"B", 5},  {"C", 6},  {"N", 7},   {"O", 8},  {"F", 9},
        {"Si", 14},{"P", 15}, {"S", 16}, {"Cl", 17}, {"Br", 35},{"I", 53},
    };
    for (const auto& e : TAB)
        if (s == e.sym) return e.z;
    return -1;
}

// mol-file charge codes (chem/sdf.py:_CHG_CODE) — unused directly (M CHG
// carries literal charges) but kept for the atom-block charge column if a
// future writer emits it.

std::string strip(const std::string& s) {
    size_t a = s.find_first_not_of(" \t\r\n");
    if (a == std::string::npos) return "";
    size_t b = s.find_last_not_of(" \t\r\n");
    return s.substr(a, b - a + 1);
}

// python-slice s[a:b] (clamped, never throws)
std::string pyslice(const std::string& s, size_t a, size_t b) {
    if (a >= s.size()) return "";
    return s.substr(a, std::min(b, s.size()) - a);
}

bool to_long(const std::string& s, long* out) {
    std::string t = strip(s);
    if (t.empty()) return false;
    char* end = nullptr;
    long v = strtol(t.c_str(), &end, 10);
    if (end == nullptr || *end != '\0') return false;
    *out = v;
    return true;
}

bool to_double(const std::string& s, double* out) {
    std::string t = strip(s);
    if (t.empty()) return false;
    char* end = nullptr;
    double v = strtod(t.c_str(), &end);
    if (end == nullptr || *end != '\0') return false;
    *out = v;
    return true;
}

// one molblock -> MolRec (ok=false on any parse error, mirroring
// chem/sdf.py:molblock_to_mol raising MolError/ValueError/IndexError)
MolRec parse_molblock(const std::vector<std::string>& lines) {
    MolRec rec;
    if (lines.size() < 4) return rec;
    long n = 0, m = 0;
    if (!to_long(pyslice(lines[3], 0, 3), &n)) return rec;
    if (!to_long(pyslice(lines[3], 3, 6), &m)) return rec;
    if (n < 0 || m < 0 || lines.size() < (size_t)(4 + n + m)) return rec;

    rec.z.reserve(n);
    rec.pos.reserve(3 * n);
    rec.charge.assign(n, 0);
    for (long i = 0; i < n; ++i) {
        const std::string& ln = lines[4 + i];
        double x, y, zc;
        if (!to_double(pyslice(ln, 0, 10), &x) ||
            !to_double(pyslice(ln, 10, 20), &y) ||
            !to_double(pyslice(ln, 20, 30), &zc))
            return rec;
        int32_t elem = symbol_to_z(strip(pyslice(ln, 31, 34)));
        if (elem < 0) return rec;
        rec.z.push_back(elem);
        rec.pos.push_back(x);
        rec.pos.push_back(y);
        rec.pos.push_back(zc);
    }
    rec.bonds.reserve(3 * m);
    for (long k = 0; k < m; ++k) {
        const std::string& ln = lines[4 + n + k];
        long i, j, o;
        if (!to_long(pyslice(ln, 0, 3), &i) ||
            !to_long(pyslice(ln, 3, 6), &j) ||
            !to_long(pyslice(ln, 6, 9), &o))
            return rec;
        rec.bonds.push_back((int32_t)(i - 1));
        rec.bonds.push_back((int32_t)(j - 1));
        rec.bonds.push_back((int32_t)o);
    }
    for (size_t li = 4 + n + m; li < lines.size(); ++li) {
        const std::string& ln = lines[li];
        if (ln.rfind("M  CHG", 0) == 0) {
            long cnt;
            if (!to_long(pyslice(ln, 6, 9), &cnt)) return rec;
            for (long c = 0; c < cnt; ++c) {
                long idx, chg;
                if (!to_long(pyslice(ln, 9 + 8 * c, 13 + 8 * c), &idx) ||
                    !to_long(pyslice(ln, 13 + 8 * c, 17 + 8 * c), &chg))
                    return rec;
                if (idx < 1 || idx > n) return rec;
                rec.charge[idx - 1] = (int32_t)chg;
            }
        } else if (ln.rfind("M  END", 0) == 0) {
            break;
        }
    }
    rec.ok = true;
    return rec;
}

}  // namespace

extern "C" {

// Parse a whole .sdf file. Returns an opaque handle (sdf_free to release)
// or nullptr if the file can't be read. Per-record parse errors keep their
// slot with ok=false (sdf_fill_all marks it n_atoms = -1), matching
// chem/sdf.py:read_sdf skip_errors yielding None.
void* sdf_parse_file(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    std::string data;
    char buf[1 << 16];
    size_t got;
    while ((got = fread(buf, 1, sizeof(buf), f)) > 0) data.append(buf, got);
    fclose(f);

    Parsed* p = new Parsed();
    std::vector<std::string> cur;
    bool any_content = false;
    size_t start = 0;
    while (start <= data.size()) {
        size_t nl = data.find('\n', start);
        std::string line = (nl == std::string::npos)
            ? data.substr(start) : data.substr(start, nl - start);
        if (!line.empty() && line.back() == '\r') line.pop_back();
        bool last = (nl == std::string::npos);
        if (strip(line) == "$$$$") {
            p->mols.push_back(parse_molblock(cur));
            cur.clear();
            any_content = false;
        } else if (!(last && line.empty())) {
            cur.push_back(line);
            if (!strip(line).empty()) any_content = true;
        }
        if (last) break;
        start = nl + 1;
    }
    if (any_content) p->mols.push_back(parse_molblock(cur));
    return p;
}

int64_t sdf_num_mols(void* h) {
    return h ? (int64_t)((Parsed*)h)->mols.size() : -1;
}

// Whole-file batch access: totals over all OK records (failed records
// contribute zero)...
void sdf_totals(void* h, int64_t* total_atoms, int64_t* total_bonds) {
    Parsed* p = (Parsed*)h;
    int64_t ta = 0, tb = 0;
    for (const auto& r : p->mols) {
        if (!r.ok) continue;
        ta += (int64_t)r.z.size();
        tb += (int64_t)(r.bonds.size() / 3);
    }
    *total_atoms = ta;
    *total_bonds = tb;
}

// ...and ONE fill of concatenated arrays (z/pos/charge packed in record
// order, bonds likewise): n_atoms[i] = -1 marks a failed record. This is
// the ingestion fast path — one ctypes call per file instead of three per
// molecule.
int sdf_fill_all(void* h, int64_t* n_atoms, int64_t* n_bonds,
                 int32_t* z, double* pos, int32_t* charge, int32_t* bonds) {
    Parsed* p = (Parsed*)h;
    if (!p) return -2;
    size_t za = 0, ba = 0;
    for (size_t i = 0; i < p->mols.size(); ++i) {
        const MolRec& r = p->mols[i];
        if (!r.ok) {
            n_atoms[i] = -1;
            n_bonds[i] = -1;
            continue;
        }
        n_atoms[i] = (int64_t)r.z.size();
        n_bonds[i] = (int64_t)(r.bonds.size() / 3);
        memcpy(z + za, r.z.data(), r.z.size() * sizeof(int32_t));
        memcpy(charge + za, r.charge.data(), r.charge.size() * sizeof(int32_t));
        memcpy(pos + 3 * za, r.pos.data(), r.pos.size() * sizeof(double));
        memcpy(bonds + 3 * ba, r.bonds.data(), r.bonds.size() * sizeof(int32_t));
        za += r.z.size();
        ba += r.bonds.size() / 3;
    }
    return 0;
}

void sdf_free(void* h) {
    delete (Parsed*)h;
}

}  // extern "C"
