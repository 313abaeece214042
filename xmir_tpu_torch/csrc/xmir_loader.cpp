// xmir_loader: native host-side data loader for the NIH .npy path.
//
// The reference loads NIH images via numpy + PIL per item
// (read_data.py:184-190: np.load -> min-max normalize to uint8 -> PIL
// convert("L")). At the >=10k images/sec ingest target the host decode is the
// bottleneck (SURVEY.md §7 hard parts: input-pipeline throughput), so this
// module does npy parse + normalize + bilinear resize + gray->RGB in C++ with
// a pthread worker pool, exposed through a C ABI consumed via ctypes
// (xmir_tpu_torch/data/native_loader.py). No external dependencies. Host
// code, not a CUDA kernel: the JAX package's native/xmir_loader.cpp, copied.
//
// Build (native_loader.py does it at first use, into build/xmir_tpu_torch/):
//   g++ -O3 -march=native -shared -fPIC -pthread xmir_loader.cpp -o libxmir_loader.so

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <thread>
#include <atomic>
#include <algorithm>

namespace {

struct NpyArray {
  std::vector<char> raw;     // file bytes (header skipped -> data at `data`)
  const char* data = nullptr;
  std::vector<int64_t> shape;
  char dtype = 0;            // 'f' f32, 'd' f64, 'B' u8, 'H' u16, 'h' i16, 'i' i32
  bool fortran = false;
};

bool parse_npy(const char* path, NpyArray* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 16) { std::fclose(f); return false; }
  out->raw.resize(size);
  if (std::fread(out->raw.data(), 1, size, f) != (size_t)size) {
    std::fclose(f);
    return false;
  }
  std::fclose(f);

  const unsigned char* p = (const unsigned char*)out->raw.data();
  if (std::memcmp(p, "\x93NUMPY", 6) != 0) return false;
  int major = p[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = p[8] | (p[9] << 8);
    header_off = 10;
  } else {
    header_len = p[8] | (p[9] << 8) | ((size_t)p[10] << 16) | ((size_t)p[11] << 24);
    header_off = 12;
  }
  if (header_off + header_len > (size_t)size) return false;
  std::string header(out->raw.data() + header_off, header_len);

  // descr
  size_t dpos = header.find("'descr'");
  if (dpos == std::string::npos) return false;
  size_t q1 = header.find('\'', dpos + 7);
  size_t q2 = header.find('\'', q1 + 1);
  std::string descr = header.substr(q1 + 1, q2 - q1 - 1);
  char endian = descr[0];
  if (endian == '>') return false;  // big-endian unsupported
  std::string kind = descr.substr(1);
  if (kind == "f4") out->dtype = 'f';
  else if (kind == "f8") out->dtype = 'd';
  else if (kind == "u1" || descr == "|u1") out->dtype = 'B';
  else if (kind == "u2") out->dtype = 'H';
  else if (kind == "i2") out->dtype = 'h';
  else if (kind == "i4") out->dtype = 'i';
  else return false;

  out->fortran = header.find("'fortran_order': True") != std::string::npos;
  if (out->fortran) return false;

  size_t spos = header.find("'shape'");
  size_t open = header.find('(', spos);
  size_t close = header.find(')', open);
  std::string shape_s = header.substr(open + 1, close - open - 1);
  out->shape.clear();
  const char* s = shape_s.c_str();
  while (*s) {
    while (*s == ' ' || *s == ',') s++;
    if (!*s) break;
    out->shape.push_back(std::strtoll(s, (char**)&s, 10));
  }
  out->data = out->raw.data() + header_off + header_len;
  return !out->shape.empty();
}

template <typename T>
void minmax_to_float(const T* src, float* dst, int64_t n) {
  T lo = src[0], hi = src[0];
  for (int64_t i = 1; i < n; i++) {
    lo = std::min(lo, src[i]);
    hi = std::max(hi, src[i]);
  }
  float flo = (float)lo, range = (float)hi - (float)lo;
  if (range <= 0.f) {
    std::memset(dst, 0, n * sizeof(float));
    return;
  }
  float inv = 255.f / range;
  for (int64_t i = 0; i < n; i++) dst[i] = ((float)src[i] - flo) * inv;
}

// PIL-equivalent antialiased BILINEAR resampling (separable triangle filter;
// Pillow applies antialias to all resizes, with filter support scaled by the
// downscale ratio). Precompute per-output-pixel weight tables per axis, then
// do the two passes.
struct ResampleAxis {
  std::vector<int> xmin;      // first source index per output pixel
  std::vector<int> count;     // taps per output pixel
  std::vector<float> weights; // flattened [out][tap]
  int max_taps = 0;
};

void build_axis(int in_size, int out_size, ResampleAxis* ax) {
  double scale = (double)in_size / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 1.0 * filterscale;  // triangle filter support = 1
  int max_taps = (int)std::ceil(support) * 2 + 1;
  ax->xmin.resize(out_size);
  ax->count.resize(out_size);
  ax->weights.assign((size_t)out_size * max_taps, 0.f);
  ax->max_taps = max_taps;
  for (int i = 0; i < out_size; i++) {
    double center = (i + 0.5) * scale;
    int lo = (int)(center - support + 0.5);
    if (lo < 0) lo = 0;
    int hi = (int)(center + support + 0.5);
    if (hi > in_size) hi = in_size;
    int n = hi - lo;
    double sum = 0.0;
    std::vector<double> w(n);
    for (int j = 0; j < n; j++) {
      double x = (lo + j - center + 0.5) / filterscale;
      double t = x < 0 ? -x : x;
      w[j] = t < 1.0 ? 1.0 - t : 0.0;
      sum += w[j];
    }
    ax->xmin[i] = lo;
    ax->count[i] = n;
    for (int j = 0; j < n; j++)
      ax->weights[(size_t)i * max_taps + j] = (float)(sum > 0 ? w[j] / sum : 0.0);
  }
}

void resize_bilinear_gray(const float* src, int sh, int sw, uint8_t* dst,
                          int dh, int dw) {
  ResampleAxis hax, vax;
  build_axis(sw, dw, &hax);
  build_axis(sh, dh, &vax);
  // horizontal pass: (sh, sw) -> (sh, dw)
  std::vector<float> tmp((size_t)sh * dw);
  for (int y = 0; y < sh; y++) {
    const float* row = src + (size_t)y * sw;
    for (int x = 0; x < dw; x++) {
      const float* w = &hax.weights[(size_t)x * hax.max_taps];
      int lo = hax.xmin[x], n = hax.count[x];
      float acc = 0.f;
      for (int j = 0; j < n; j++) acc += row[lo + j] * w[j];
      tmp[(size_t)y * dw + x] = acc;
    }
  }
  // vertical pass: (sh, dw) -> (dh, dw)
  for (int y = 0; y < dh; y++) {
    const float* w = &vax.weights[(size_t)y * vax.max_taps];
    int lo = vax.xmin[y], n = vax.count[y];
    for (int x = 0; x < dw; x++) {
      float acc = 0.f;
      for (int j = 0; j < n; j++) acc += tmp[(size_t)(lo + j) * dw + x] * w[j];
      acc = std::min(std::max(acc, 0.f), 255.f);
      dst[(size_t)y * dw + x] = (uint8_t)(acc + 0.5f);
    }
  }
}

// Read a 3-channel array as interleaved float RGB (HWC order).
template <typename T>
void gather_rgb(const T* s, float* dst, int64_t n, bool chw) {
  if (chw) {
    for (int64_t i = 0; i < n; i++) {
      dst[3 * i + 0] = (float)s[i];
      dst[3 * i + 1] = (float)s[n + i];
      dst[3 * i + 2] = (float)s[2 * n + i];
    }
  } else {
    for (int64_t i = 0; i < 3 * n; i++) dst[i] = (float)s[i];
  }
}

// Load one npy, normalize, resize, write (out_h, out_w, 3) uint8 RGB.
// aspect_crop != 0: torchvision Resize(short_side=out_h)+CenterCrop(out_h)
// semantics instead of a square squash (out_h must equal out_w).
int load_one(const char* path, uint8_t* out, int out_h, int out_w,
             int aspect_crop = 0) {
  NpyArray arr;
  if (!parse_npy(path, &arr)) return -1;
  int64_t h, w, c = 1;
  bool chw = false;
  if (arr.shape.size() == 2) {
    h = arr.shape[0];
    w = arr.shape[1];
  } else if (arr.shape.size() == 3 && (arr.shape[0] == 1 || arr.shape[0] == 3)) {
    c = arr.shape[0];
    h = arr.shape[1];
    w = arr.shape[2];
    chw = true;
  } else if (arr.shape.size() == 3 && (arr.shape[2] == 1 || arr.shape[2] == 3)) {
    h = arr.shape[0];
    w = arr.shape[1];
    c = arr.shape[2];
  } else {
    return -2;
  }
  int64_t n = h * w;
  std::vector<float> gray(n);
  if (c == 3) {
    // Reference path for RGB inputs (read_data.py:71-90,188): min-max
    // normalize the WHOLE array jointly to uint8 (truncating astype), then
    // PIL convert("L") ITU-R 601-2 luma (r*19595 + g*38470 + b*7471 + 0x8000
    // >> 16).
    std::vector<float> rgb((size_t)3 * n);
    switch (arr.dtype) {
      case 'f': gather_rgb((const float*)arr.data, rgb.data(), n, chw); break;
      case 'd': gather_rgb((const double*)arr.data, rgb.data(), n, chw); break;
      case 'B': gather_rgb((const uint8_t*)arr.data, rgb.data(), n, chw); break;
      case 'H': gather_rgb((const uint16_t*)arr.data, rgb.data(), n, chw); break;
      case 'h': gather_rgb((const int16_t*)arr.data, rgb.data(), n, chw); break;
      case 'i': gather_rgb((const int32_t*)arr.data, rgb.data(), n, chw); break;
      default: return -3;
    }
    if (arr.dtype != 'B') {
      float lo = rgb[0], hi = rgb[0];
      for (int64_t i = 1; i < 3 * n; i++) {
        lo = std::min(lo, rgb[i]);
        hi = std::max(hi, rgb[i]);
      }
      float range = hi - lo;
      if (range <= 0.f) {
        std::fill(rgb.begin(), rgb.end(), 0.f);
      } else {
        float inv = 255.f / range;
        for (int64_t i = 0; i < 3 * n; i++) {
          float v = (rgb[i] - lo) * inv;
          // np.clip(...).astype(np.uint8) truncates
          rgb[i] = (float)(uint8_t)std::min(std::max(v, 0.f), 255.f);
        }
      }
    }
    for (int64_t i = 0; i < n; i++) {
      uint32_t r = (uint32_t)rgb[3 * i + 0];
      uint32_t g = (uint32_t)rgb[3 * i + 1];
      uint32_t b = (uint32_t)rgb[3 * i + 2];
      gray[i] = (float)((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16);
    }
  } else {
    // single channel (2D, CHW c=1, or HWC c=1): contiguous n-element plane
    switch (arr.dtype) {
      case 'f': minmax_to_float((const float*)arr.data, gray.data(), n); break;
      case 'd': minmax_to_float((const double*)arr.data, gray.data(), n); break;
      case 'B': {
        // uint8 passes through unnormalized (reference read_data.py:78-79)
        const uint8_t* s = (const uint8_t*)arr.data;
        for (int64_t i = 0; i < n; i++) gray[i] = s[i];
        break;
      }
      case 'H': minmax_to_float((const uint16_t*)arr.data, gray.data(), n); break;
      case 'h': minmax_to_float((const int16_t*)arr.data, gray.data(), n); break;
      case 'i': minmax_to_float((const int32_t*)arr.data, gray.data(), n); break;
      default: return -3;
    }
  }
  int nh = out_h, nw = out_w, top = 0, left = 0;
  if (aspect_crop) {
    // torchvision _compute_resized_output_size: short side -> S, long side
    // int(S * long / short) with Python float-division truncation; then
    // CenterCrop's int(round((n - S) / 2.0)) (nearest-even like Python)
    int S = out_h;
    if (h <= w) {
      nh = S;
      nw = (int)((double)S * (double)w / (double)h);
    } else {
      nw = S;
      nh = (int)((double)S * (double)h / (double)w);
    }
    top = (int)std::nearbyint((double)(nh - S) / 2.0);
    left = (int)std::nearbyint((double)(nw - S) / 2.0);
  }
  std::vector<uint8_t> resized((size_t)nh * nw);
  resize_bilinear_gray(gray.data(), (int)h, (int)w, resized.data(), nh, nw);
  for (int64_t oy = 0; oy < out_h; oy++) {
    const uint8_t* row = resized.data() + (size_t)(oy + top) * nw + left;
    uint8_t* dst = out + (size_t)oy * out_w * 3;
    for (int64_t ox = 0; ox < out_w; ox++) {
      dst[ox * 3 + 0] = row[ox];
      dst[ox * 3 + 1] = row[ox];
      dst[ox * 3 + 2] = row[ox];
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Load one file. Returns 0 on success, negative error code otherwise.
int xmir_load_npy(const char* path, uint8_t* out, int out_h, int out_w) {
  return load_one(path, out, out_h, out_w);
}

// Load a batch of files in parallel. paths: array of C strings; out: one
// (out_h, out_w, 3) uint8 buffer per file, contiguous. status: per-file
// return codes. Returns number of failures.
static int batch_load(const char** paths, int n_files, uint8_t* out,
                      int out_h, int out_w, int n_threads, int* status,
                      int aspect_crop) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  n_threads = std::max(1, std::min(n_threads, n_files));
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  size_t item = (size_t)out_h * out_w * 3;
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n_files) break;
      int rc = load_one(paths[i], out + item * i, out_h, out_w, aspect_crop);
      if (status) status[i] = rc;
      if (rc != 0) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

int xmir_load_npy_batch(const char** paths, int n_files, uint8_t* out,
                        int out_h, int out_w, int n_threads, int* status) {
  return batch_load(paths, n_files, out, out_h, out_w, n_threads, status, 0);
}

// Aspect-preserving variants: Resize(short=size) + CenterCrop(size), the
// reference's 224/DINOv2/NIH eval transform shape (test.py:1330-1333,
// nih_multilabel_retrieval.py:48-61).
int xmir_load_npy_crop(const char* path, uint8_t* out, int size) {
  return load_one(path, out, size, size, 1);
}

int xmir_load_npy_batch_crop(const char** paths, int n_files, uint8_t* out,
                             int size, int n_threads, int* status) {
  return batch_load(paths, n_files, out, size, size, n_threads, status, 1);
}

int xmir_loader_version() { return 2; }

}  // extern "C"
