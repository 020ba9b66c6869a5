// Native legacy-VTK writer for tpufluids_torch (a copy of tpufluids's).
//
// Fresh C++ implementation of the file-format contract documented in
// tpufluids_torch/io/vtk.py (semantics of the vendored LLNL visit_writer the
// reference uses, visit_writer.cpp/.h): legacy VTK 2.0, ASCII floats as
// "%20.12e " 9-per-line, binary as 4-byte big-endian, CELL_DATA then
// POINT_DATA with first-scalar/first-vector promotion and FIELD groups.
//
// Exposed as a C ABI for ctypes; all entry points return 0 on success,
// nonzero errno-style codes on failure.  Unlike the reference (global
// FILE* + abort-free error ignoring), this writer is reentrant and
// reports I/O errors.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kPerLine = 9;

inline uint32_t ToBigEndian(uint32_t v) {
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  return __builtin_bswap32(v);
#else
  return v;
#endif
}

class VtkFile {
 public:
  VtkFile(const char* filename, bool binary) : binary_(binary) {
    std::string name(filename);
    if (name.size() < 4 || name.compare(name.size() - 4, 4, ".vtk") != 0) {
      name += ".vtk";
    }
    fp_ = std::fopen(name.c_str(), "wb");
    buf_.reserve(1 << 16);
  }
  ~VtkFile() {
    if (fp_) Close();
  }

  bool ok() const { return fp_ != nullptr; }

  int Close() {
    EndLine();
    Flush();
    int rc = std::ferror(fp_) ? 1 : 0;
    std::fclose(fp_);
    fp_ = nullptr;
    return rc;
  }

  void Str(const char* s) {
    Flush();
    std::fwrite(s, 1, std::strlen(s), fp_);
  }

  void EndLine() {
    if (!binary_) {
      buf_.push_back('\n');
      col_ = 0;
    }
  }

  void NewSection() {
    if (col_ != 0) EndLine();
    col_ = 0;
  }

  void Floats(const float* vals, int64_t n) {
    if (binary_) {
      WriteSwapped(reinterpret_cast<const uint32_t*>(vals), n);
      return;
    }
    char tmp[48];
    for (int64_t i = 0; i < n; ++i) {
      int len = std::snprintf(tmp, sizeof tmp, "%20.12e ",
                              static_cast<double>(vals[i]));
      buf_.insert(buf_.end(), tmp, tmp + len);
      if ((col_++ % kPerLine) == kPerLine - 1) {
        buf_.push_back('\n');
        col_ = 0;
      }
      if (buf_.size() > (1 << 16)) Flush();
    }
  }

  void Ints(const int32_t* vals, int64_t n) {
    if (binary_) {
      WriteSwapped(reinterpret_cast<const uint32_t*>(vals), n);
      return;
    }
    char tmp[16];
    for (int64_t i = 0; i < n; ++i) {
      int len = std::snprintf(tmp, sizeof tmp, "%d ", vals[i]);
      buf_.insert(buf_.end(), tmp, tmp + len);
      if ((col_++ % kPerLine) == kPerLine - 1) {
        buf_.push_back('\n');
        col_ = 0;
      }
      if (buf_.size() > (1 << 16)) Flush();
    }
  }

  void Int(int32_t v) { Ints(&v, 1); }

  void Header() {
    Str("# vtk DataFile Version 2.0\n");
    Str("Written using VisIt writer\n");
    Str(binary_ ? "BINARY\n" : "ASCII\n");
  }

 private:
  void WriteSwapped(const uint32_t* vals, int64_t n) {
    std::vector<uint32_t> out(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) out[i] = ToBigEndian(vals[i]);
    Flush();
    std::fwrite(out.data(), 4, out.size(), fp_);
  }

  void Flush() {
    if (!buf_.empty()) {
      std::fwrite(buf_.data(), 1, buf_.size(), fp_);
      buf_.clear();
    }
  }

  FILE* fp_ = nullptr;
  bool binary_;
  int col_ = 0;
  std::vector<char> buf_;
};

void WriteVariables(VtkFile& w, int nvars, const int* vardim,
                    const int* centering, const char* const* varnames,
                    const float* const* vars, int64_t npts, int64_t ncells) {
  char line[512];
  for (int pass = 0; pass < 2; ++pass) {  // 0 = cell data, 1 = point data
    const int64_t count = pass == 0 ? ncells : npts;
    w.NewSection();
    std::snprintf(line, sizeof line, "%s %lld\n",
                  pass == 0 ? "CELL_DATA" : "POINT_DATA",
                  static_cast<long long>(count));
    w.Str(line);
    bool have_scalar = false, have_vector = false;
    std::vector<int> extra_scalars, extra_vectors;
    for (int i = 0; i < nvars; ++i) {
      const bool is_point = centering[i] != 0;
      if (is_point != (pass == 1)) continue;
      if (vardim[i] == 1) {
        if (!have_scalar) {
          std::snprintf(line, sizeof line, "SCALARS %s float\n", varnames[i]);
          w.Str(line);
          w.Str("LOOKUP_TABLE default\n");
          w.Floats(vars[i], count);
          w.EndLine();
          have_scalar = true;
        } else {
          extra_scalars.push_back(i);
        }
      } else if (vardim[i] == 3) {
        if (!have_vector) {
          std::snprintf(line, sizeof line, "VECTORS %s float\n", varnames[i]);
          w.Str(line);
          w.Floats(vars[i], count * 3);
          w.EndLine();
          have_vector = true;
        } else {
          extra_vectors.push_back(i);
        }
      }
    }
    if (!extra_scalars.empty()) {
      std::snprintf(line, sizeof line, "FIELD FieldData %zu\n",
                    extra_scalars.size());
      w.Str(line);
      for (int i : extra_scalars) {
        std::snprintf(line, sizeof line, "%s 1 %lld float\n", varnames[i],
                      static_cast<long long>(count));
        w.Str(line);
        w.Floats(vars[i], count);
        w.EndLine();
      }
    }
    if (!extra_vectors.empty()) {
      std::snprintf(line, sizeof line, "FIELD FieldData %zu\n",
                    extra_vectors.size());
      w.Str(line);
      for (int i : extra_vectors) {
        std::snprintf(line, sizeof line, "%s 3 %lld float\n", varnames[i],
                      static_cast<long long>(count));
        w.Str(line);
        w.Floats(vars[i], count * 3);
        w.EndLine();
      }
    }
  }
}

int CellPointCount(int celltype) {
  switch (celltype) {
    case 1: return 1;   // vertex
    case 3: return 2;   // line
    case 5: return 3;   // triangle
    case 9: return 4;   // quad
    case 10: return 4;  // tetra
    case 12: return 8;  // hexahedron
    case 13: return 6;  // wedge
    case 14: return 5;  // pyramid
    default: return 0;
  }
}

}  // namespace

extern "C" {

int vw_write_point_mesh(const char* filename, int use_binary, int64_t npts,
                        const float* pts, int nvars, const int* vardim,
                        const char* const* varnames,
                        const float* const* vars) {
  VtkFile w(filename, use_binary != 0);
  if (!w.ok()) return 2;
  char line[256];
  w.Header();
  w.Str("DATASET UNSTRUCTURED_GRID\n");
  std::snprintf(line, sizeof line, "POINTS %lld float\n",
                static_cast<long long>(npts));
  w.Str(line);
  w.Floats(pts, npts * 3);
  w.NewSection();
  std::snprintf(line, sizeof line, "CELLS %lld %lld\n",
                static_cast<long long>(npts),
                static_cast<long long>(2 * npts));
  w.Str(line);
  for (int64_t i = 0; i < npts; ++i) {
    w.Int(1);
    w.Int(static_cast<int32_t>(i));
    w.EndLine();
  }
  w.NewSection();
  std::snprintf(line, sizeof line, "CELL_TYPES %lld\n",
                static_cast<long long>(npts));
  w.Str(line);
  for (int64_t i = 0; i < npts; ++i) {
    w.Int(1);  // VISIT_VERTEX
    w.EndLine();
  }
  std::vector<int> centering(static_cast<size_t>(nvars), 1);
  WriteVariables(w, nvars, vardim, centering.data(), varnames, vars, npts,
                 npts);
  return w.Close();
}

int vw_write_unstructured_mesh(const char* filename, int use_binary,
                               int64_t npts, const float* pts, int64_t ncells,
                               const int* celltypes, const int* conn,
                               int nvars, const int* vardim,
                               const int* centering,
                               const char* const* varnames,
                               const float* const* vars) {
  VtkFile w(filename, use_binary != 0);
  if (!w.ok()) return 2;
  char line[256];
  w.Header();
  w.Str("DATASET UNSTRUCTURED_GRID\n");
  std::snprintf(line, sizeof line, "POINTS %lld float\n",
                static_cast<long long>(npts));
  w.Str(line);
  w.Floats(pts, npts * 3);
  w.NewSection();
  int64_t conn_size = 0;
  for (int64_t i = 0; i < ncells; ++i) {
    conn_size += CellPointCount(celltypes[i]) + 1;
  }
  std::snprintf(line, sizeof line, "CELLS %lld %lld\n",
                static_cast<long long>(ncells),
                static_cast<long long>(conn_size));
  w.Str(line);
  const int* cur = conn;
  for (int64_t i = 0; i < ncells; ++i) {
    const int k = CellPointCount(celltypes[i]);
    w.Int(k);
    w.Ints(cur, k);
    w.EndLine();
    cur += k;
  }
  w.NewSection();
  std::snprintf(line, sizeof line, "CELL_TYPES %lld\n",
                static_cast<long long>(ncells));
  w.Str(line);
  for (int64_t i = 0; i < ncells; ++i) {
    w.Int(celltypes[i]);
    w.EndLine();
  }
  WriteVariables(w, nvars, vardim, centering, varnames, vars, npts, ncells);
  return w.Close();
}

int vw_write_rectilinear_mesh(const char* filename, int use_binary,
                              const int* dims, const float* x, const float* y,
                              const float* z, int nvars, const int* vardim,
                              const int* centering,
                              const char* const* varnames,
                              const float* const* vars) {
  VtkFile w(filename, use_binary != 0);
  if (!w.ok()) return 2;
  char line[256];
  const int64_t npts =
      static_cast<int64_t>(dims[0]) * dims[1] * dims[2];
  auto nc = [](int d) { return d - 1 < 1 ? 1 : d - 1; };
  const int64_t ncells =
      static_cast<int64_t>(nc(dims[0])) * nc(dims[1]) * nc(dims[2]);
  w.Header();
  w.Str("DATASET RECTILINEAR_GRID\n");
  std::snprintf(line, sizeof line, "DIMENSIONS %d %d %d\n", dims[0], dims[1],
                dims[2]);
  w.Str(line);
  const char* labels[3] = {"X", "Y", "Z"};
  const float* coords[3] = {x, y, z};
  for (int a = 0; a < 3; ++a) {
    std::snprintf(line, sizeof line, "%s_COORDINATES %d float\n", labels[a],
                  dims[a]);
    w.Str(line);
    w.Floats(coords[a], dims[a]);
    w.NewSection();
  }
  WriteVariables(w, nvars, vardim, centering, varnames, vars, npts, ncells);
  return w.Close();
}

int vw_write_regular_mesh(const char* filename, int use_binary,
                          const int* dims, int nvars, const int* vardim,
                          const int* centering, const char* const* varnames,
                          const float* const* vars) {
  std::vector<float> x(dims[0]), y(dims[1]), z(dims[2]);
  for (int i = 0; i < dims[0]; ++i) x[i] = static_cast<float>(i);
  for (int i = 0; i < dims[1]; ++i) y[i] = static_cast<float>(i);
  for (int i = 0; i < dims[2]; ++i) z[i] = static_cast<float>(i);
  return vw_write_rectilinear_mesh(filename, use_binary, dims, x.data(),
                                   y.data(), z.data(), nvars, vardim,
                                   centering, varnames, vars);
}

int vw_write_curvilinear_mesh(const char* filename, int use_binary,
                              const int* dims, const float* pts, int nvars,
                              const int* vardim, const int* centering,
                              const char* const* varnames,
                              const float* const* vars) {
  VtkFile w(filename, use_binary != 0);
  if (!w.ok()) return 2;
  char line[256];
  const int64_t npts =
      static_cast<int64_t>(dims[0]) * dims[1] * dims[2];
  auto nc = [](int d) { return d - 1 < 1 ? 1 : d - 1; };
  const int64_t ncells =
      static_cast<int64_t>(nc(dims[0])) * nc(dims[1]) * nc(dims[2]);
  w.Header();
  w.Str("DATASET STRUCTURED_GRID\n");
  std::snprintf(line, sizeof line, "DIMENSIONS %d %d %d\n", dims[0], dims[1],
                dims[2]);
  w.Str(line);
  std::snprintf(line, sizeof line, "POINTS %lld float\n",
                static_cast<long long>(npts));
  w.Str(line);
  w.Floats(pts, npts * 3);
  WriteVariables(w, nvars, vardim, centering, varnames, vars, npts, ncells);
  return w.Close();
}

}  // extern "C"
