// gpr_tpu native runtime: threaded image/matrix loaders.
//
// The equivalent of the reference's native data path — the C++
// DataParser image-parsing loops (reference include/DataParser.h:536-613)
// and the MatrixIO binary codec (reference lib/MatrixIO.cpp:38-100) — built
// as a small C library driven from Python via ctypes.  The feature pipeline
// is I/O bound on thousands of per-frame files (reference SURVEY.md §3.1
// "I/O-bound loop"); this loader parses legacy-VTK frames into the
// (features, frames) matrix with an OpenMP worker pool and bulk reads,
// feeding jax.device_put directly.
//
// Exposed C ABI (see gpr_tpu/utils/native.py):
//   gpr_read_matrix / gpr_write_matrix       MatrixIO codec
//   gpr_probe_vtk                            header probe (dims/comps)
//   gpr_load_vtk_dir                         threaded directory -> matrix
//
// All functions return 0 on success, negative error codes otherwise.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// MatrixIO: ASCII "rows cols\n" header + row-major raw dump
// (byte-compatible with reference lib/MatrixIO.cpp:38-100)
// ---------------------------------------------------------------------------

int read_header(FILE* f, long* rows, long* cols) {
  char line[128];
  if (!fgets(line, sizeof line, f)) return -2;
  if (sscanf(line, "%ld %ld", rows, cols) != 2) return -2;
  return 0;
}

// big-endian <-> host for f32/f64 payloads (legacy VTK is big-endian)
inline float be32(const unsigned char* p) {
  uint32_t v = (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
               (uint32_t(p[2]) << 8) | uint32_t(p[3]);
  float out;
  std::memcpy(&out, &v, 4);
  return out;
}
inline double be64(const unsigned char* p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; ++i) v = (v << 8) | uint64_t(p[i]);
  double out;
  std::memcpy(&out, &v, 8);
  return out;
}

struct VtkInfo {
  long nx = 0, ny = 0, nz = 0;
  long ncomp = 1;
  long header_bytes = 0;  // offset of the binary payload
  int dtype = 0;          // 0=float64, 1=float32, 2=uint8, 3=int16
  bool ascii = false;
};

// Minimal legacy-VTK STRUCTURED_POINTS header parse (binary payload).
int probe_vtk(const char* path, VtkInfo* info) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char line[512];
  long pos = 0;
  int lineno = 0;
  bool have_dims = false, have_attr = false;
  while (fgets(line, sizeof line, f)) {
    pos = ftell(f);
    ++lineno;
    if (lineno == 3) {
      info->ascii = (strncmp(line, "ASCII", 5) == 0);
      continue;
    }
    if (strncmp(line, "DIMENSIONS", 10) == 0) {
      if (sscanf(line, "DIMENSIONS %ld %ld %ld", &info->nx, &info->ny,
                 &info->nz) != 3) {
        fclose(f);
        return -2;
      }
      have_dims = true;
    } else if (strncmp(line, "SCALARS", 7) == 0) {
      char type[64];
      long ncomp = 1;
      int n = sscanf(line, "SCALARS %*s %63s %ld", type, &ncomp);
      info->ncomp = (n >= 2) ? ncomp : 1;
      if (strcmp(type, "double") == 0) info->dtype = 0;
      else if (strcmp(type, "float") == 0) info->dtype = 1;
      else if (strcmp(type, "unsigned_char") == 0) info->dtype = 2;
      else if (strcmp(type, "short") == 0) info->dtype = 3;
      else { fclose(f); return -3; }
      // consume LOOKUP_TABLE line
      if (fgets(line, sizeof line, f) &&
          strncmp(line, "LOOKUP_TABLE", 12) != 0) {
        fseek(f, pos, SEEK_SET);
      }
      pos = ftell(f);
      have_attr = true;
      break;
    } else if (strncmp(line, "VECTORS", 7) == 0) {
      char type[64];
      if (sscanf(line, "VECTORS %*s %63s", type) != 1) { fclose(f); return -2; }
      info->ncomp = 3;
      if (strcmp(type, "double") == 0) info->dtype = 0;
      else if (strcmp(type, "float") == 0) info->dtype = 1;
      else { fclose(f); return -3; }
      pos = ftell(f);
      have_attr = true;
      break;
    }
  }
  fclose(f);
  if (!have_dims || !have_attr) return -2;
  info->header_bytes = pos;
  return 0;
}

// Read one binary VTK payload into out[npoints*ncomp] as double, applying
// an optional scale (the reference's /255 for images, DataParser.h:564).
int read_vtk_payload(const char* path, const VtkInfo& info, double scale,
                     double* out) {
  if (info.ascii) return -4;  // the Python codec handles ASCII files
  const long n = info.nx * info.ny * info.nz * info.ncomp;
  const int elem = info.dtype == 0 ? 8 : info.dtype == 1 ? 4
                   : info.dtype == 2 ? 1 : 2;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, info.header_bytes, SEEK_SET) != 0) { fclose(f); return -2; }
  std::vector<unsigned char> buf(size_t(n) * elem);
  const size_t got = fread(buf.data(), 1, buf.size(), f);
  fclose(f);
  if (got < buf.size()) return -5;
  const unsigned char* p = buf.data();
  switch (info.dtype) {
    case 0:
      for (long i = 0; i < n; ++i) out[i] = be64(p + 8 * i) * scale;
      break;
    case 1:
      for (long i = 0; i < n; ++i) out[i] = double(be32(p + 4 * i)) * scale;
      break;
    case 2:
      for (long i = 0; i < n; ++i) out[i] = double(p[i]) * scale;
      break;
    case 3:
      for (long i = 0; i < n; ++i) {
        int16_t v = int16_t((uint16_t(p[2 * i]) << 8) | p[2 * i + 1]);
        out[i] = double(v) * scale;
      }
      break;
  }
  return 0;
}

struct MhaInfo {
  long n = 0;       // voxels * channels
  long header_bytes = 0;
  int dtype = 0;    // 0=f64, 1=f32, 2=u8, 3=i16
  bool compressed = false;
  bool msb = false;
};

// Minimal MetaImage header parse (LOCAL raw payloads only).
int probe_mha(const char* path, MhaInfo* info) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char line[512];
  long dims[8] = {0};
  int ndims = 3, channels = 1;
  bool local = false;
  while (fgets(line, sizeof line, f)) {
    if (strncmp(line, "NDims", 5) == 0) sscanf(line, "NDims = %d", &ndims);
    else if (strncmp(line, "DimSize", 7) == 0)
      sscanf(line, "DimSize = %ld %ld %ld %ld", &dims[0], &dims[1], &dims[2],
             &dims[3]);
    else if (strncmp(line, "ElementNumberOfChannels", 23) == 0)
      sscanf(line, "ElementNumberOfChannels = %d", &channels);
    else if (strncmp(line, "CompressedData = True", 21) == 0)
      info->compressed = true;
    else if (strncmp(line, "BinaryDataByteOrderMSB = True", 29) == 0 ||
             strncmp(line, "ElementByteOrderMSB = True", 26) == 0)
      info->msb = true;
    else if (strncmp(line, "ElementType", 11) == 0) {
      char t[64];
      sscanf(line, "ElementType = %63s", t);
      if (strcmp(t, "MET_DOUBLE") == 0) info->dtype = 0;
      else if (strcmp(t, "MET_FLOAT") == 0) info->dtype = 1;
      else if (strcmp(t, "MET_UCHAR") == 0) info->dtype = 2;
      else if (strcmp(t, "MET_SHORT") == 0) info->dtype = 3;
      else { fclose(f); return -3; }
    } else if (strncmp(line, "ElementDataFile", 15) == 0) {
      local = (strstr(line, "LOCAL") != nullptr);
      info->header_bytes = ftell(f);
      break;
    }
  }
  fclose(f);
  if (!local) return -4;  // detached raw: python fallback
  long n = channels;
  for (int i = 0; i < ndims; ++i) n *= (dims[i] > 0 ? dims[i] : 1);
  info->n = n;
  return 0;
}

int read_mha_payload(const char* path, const MhaInfo& info, double scale,
                     double* out) {
  if (info.compressed) return -4;  // python handles zlib
  const int elem = info.dtype == 0 ? 8 : info.dtype == 1 ? 4
                   : info.dtype == 2 ? 1 : 2;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, info.header_bytes, SEEK_SET) != 0) { fclose(f); return -2; }
  std::vector<unsigned char> buf(size_t(info.n) * elem);
  const size_t got = fread(buf.data(), 1, buf.size(), f);
  fclose(f);
  if (got < buf.size()) return -5;
  const unsigned char* p = buf.data();
  // payloads are little-endian unless MSB was declared
  for (long i = 0; i < info.n; ++i) {
    double v = 0;
    switch (info.dtype) {
      case 0: {
        double d;
        if (info.msb) d = be64(p + 8 * i);
        else std::memcpy(&d, p + 8 * i, 8);
        v = d;
        break;
      }
      case 1: {
        float x;
        if (info.msb) x = be32(p + 4 * i);
        else std::memcpy(&x, p + 4 * i, 4);
        v = x;
        break;
      }
      case 2: v = double(p[i]); break;
      case 3: {
        int16_t x;
        if (info.msb) x = int16_t((uint16_t(p[2 * i]) << 8) | p[2 * i + 1]);
        else std::memcpy(&x, p + 2 * i, 2);
        v = x;
        break;
      }
    }
    out[i] = v * scale;
  }
  return 0;
}

}  // namespace

extern "C" {

// ---- MatrixIO --------------------------------------------------------------

int gpr_matrix_shape(const char* path, long* rows, long* cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int rc = read_header(f, rows, cols);
  fclose(f);
  return rc;
}

// dtype_code: 0 = float64, 1 = float32 (inferred by the Python wrapper from
// the payload size, like the reference's template instantiation).
int gpr_read_matrix(const char* path, double* out, long rows, long cols,
                    int dtype_code) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  long r, c;
  if (read_header(f, &r, &c) != 0 || r != rows || c != cols) {
    fclose(f);
    return -2;
  }
  const long n = rows * cols;
  int rc = 0;
  if (dtype_code == 0) {
    if (long(fread(out, 8, n, f)) < n) rc = -5;
  } else {
    std::vector<float> tmp(n);
    if (long(fread(tmp.data(), 4, n, f)) < n) rc = -5;
    else
      for (long i = 0; i < n; ++i) out[i] = tmp[i];
  }
  fclose(f);
  return rc;
}

int gpr_write_matrix(const char* path, const double* data, long rows,
                     long cols) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "%ld %ld\n", rows, cols);
  const long n = rows * cols;
  int rc = long(fwrite(data, 8, n, f)) == n ? 0 : -5;
  fclose(f);
  return rc;
}

// ---- VTK loaders -----------------------------------------------------------

int gpr_probe_vtk(const char* path, long* npoints, long* ncomp) {
  VtkInfo info;
  int rc = probe_vtk(path, &info);
  if (rc != 0) return rc;
  *npoints = info.nx * info.ny * info.nz;
  *ncomp = info.ncomp;
  return 0;
}

// Load `nfiles` VTK frames (NUL-joined `paths`, each of identical geometry)
// into the column-major (nrows, nfiles) matrix `out` — column j = flattened
// frame j (ITK iteration order), scaled by `scale`.  OpenMP-parallel over
// files: this is the reference's ParseImageFiles/ParseDisplacementFiles
// loop (DataParser.h:536-613) with threads in place of its serial reads.
int gpr_load_vtk_dir(const char* paths, long nfiles, long nrows, double scale,
                     double* out) {
  // split the NUL-joined path list
  std::vector<const char*> files(nfiles);
  const char* p = paths;
  for (long i = 0; i < nfiles; ++i) {
    files[i] = p;
    p += strlen(p) + 1;
  }
  int err = 0;
#pragma omp parallel for schedule(dynamic)
  for (long j = 0; j < nfiles; ++j) {
    VtkInfo info;
    int rc = probe_vtk(files[j], &info);
    if (rc == 0) {
      const long n = info.nx * info.ny * info.nz * info.ncomp;
      if (n != nrows) rc = -6;
      else rc = read_vtk_payload(files[j], info, scale, out + j * nrows);
    }
    if (rc != 0) {
#pragma omp critical
      err = rc;
    }
  }
  return err;
}

// MetaImage analogues of the VTK loaders (LOCAL uncompressed payloads).
int gpr_probe_mha(const char* path, long* nvalues) {
  MhaInfo info;
  int rc = probe_mha(path, &info);
  if (rc != 0) return rc;
  if (info.compressed) return -4;
  *nvalues = info.n;
  return 0;
}

int gpr_load_mha_dir(const char* paths, long nfiles, long nrows, double scale,
                     double* out) {
  std::vector<const char*> files(nfiles);
  const char* p = paths;
  for (long i = 0; i < nfiles; ++i) {
    files[i] = p;
    p += strlen(p) + 1;
  }
  int err = 0;
#pragma omp parallel for schedule(dynamic)
  for (long j = 0; j < nfiles; ++j) {
    MhaInfo info;
    int rc = probe_mha(files[j], &info);
    if (rc == 0) {
      if (info.n != nrows) rc = -6;
      else rc = read_mha_payload(files[j], info, scale, out + j * nrows);
    }
    if (rc != 0) {
#pragma omp critical
      err = rc;
    }
  }
  return err;
}

int gpr_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
