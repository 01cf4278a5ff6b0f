// Native data-loader core: threaded JPEG decode + resize + crop.
//
// The PyTorch port's copy of the JAX package's decoder (same arithmetic, so
// the two builds give the same pixels on one host).  Each worker thread
// decodes a JPEG with libjpeg (using DCT scaling to land near the target
// size cheaply), bilinearly resizes the shorter side to the requested
// target, then random- or center-crops (reflect-padding when the image is
// smaller than the crop) straight into the caller's pre-allocated uint8
// batch buffer.  Exposed as a C ABI consumed via ctypes; per-image RNG
// seeds come from the caller so augmentation stays reproducible.
//
// Build (semantic_embeddings_torch/native/__init__.py does it at first use):
//   g++ -O3 -shared -fPIC sed_decode.cpp -o libsed_decode.so -ljpeg -lpthread
// No -march=native: without FMA contraction the bilinear arithmetic rounds
// as the JAX package's build does.

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// xorshift64* — deterministic per-image RNG from a caller-provided seed.
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545F4914F6CDD1DULL;
  }
  // uniform integer in [0, n)
  uint32_t uniform(uint32_t n) { return n ? (uint32_t)(next() % n) : 0; }
};

struct Image {
  std::vector<uint8_t> data;  // RGB interleaved
  // Scanline scratch for non-RGB expansion.  Lives HERE (caller-owned,
  // outside the setjmp region) rather than as a decode_body local: libjpeg's
  // error_exit longjmps out of decode_body, which would skip a local
  // vector's destructor and leak its allocation on every corrupt image —
  // the serving path decodes untrusted request bodies.
  std::vector<uint8_t> scratch;
  int w = 0, h = 0;
};

// Shared header-to-scanlines body; runs with the caller's setjmp active so
// libjpeg errors unwind to the caller's cleanup.
void decode_body(jpeg_decompress_struct* cinfo_ptr, int hint_size, Image* out);

bool decode_jpeg(const char* path, int hint_size, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  decode_body(&cinfo, hint_size, out);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// In-memory variant (serving path: request bodies never touch disk).
bool decode_jpeg_mem(const uint8_t* buf, size_t len, int hint_size,
                     Image* out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
  decode_body(&cinfo, hint_size, out);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

void decode_body(jpeg_decompress_struct* cinfo_ptr, int hint_size,
                 Image* out) {
  jpeg_decompress_struct& cinfo = *cinfo_ptr;
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  // DCT scaling: pick the largest 1/N (N in 1,2,4,8) whose output still
  // covers the resize target, so the IDCT does most of the downscale.
  if (hint_size > 0) {
    int shorter = cinfo.image_width < cinfo.image_height
                      ? cinfo.image_width
                      : cinfo.image_height;
    int denom = 1;
    while (denom < 8 && shorter / (denom * 2) >= hint_size) denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }

  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize((size_t)out->w * out->h * 3);
  std::vector<uint8_t>& row = out->scratch;
  row.resize((size_t)out->w * cinfo.output_components);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* dst = out->data.data() + (size_t)cinfo.output_scanline * out->w * 3;
    if (cinfo.output_components == 3) {
      JSAMPROW ptr = dst;
      jpeg_read_scanlines(&cinfo, &ptr, 1);
    } else {  // grayscale or other: expand to RGB
      JSAMPROW ptr = row.data();
      jpeg_read_scanlines(&cinfo, &ptr, 1);
      for (int x = 0; x < out->w; ++x) {
        uint8_t v = row[(size_t)x * cinfo.output_components];
        dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = v;
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
}

// Bilinear resize (RGB uint8).
void resize_bilinear(const Image& src, int tw, int th, Image* dst) {
  dst->w = tw;
  dst->h = th;
  dst->data.resize((size_t)tw * th * 3);
  const float sx = (float)src.w / tw;
  const float sy = (float)src.h / th;
  for (int y = 0; y < th; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = (int)fy;
    int y1 = y0 + 1 < src.h ? y0 + 1 : src.h - 1;
    float wy = fy - y0;
    const uint8_t* r0 = src.data.data() + (size_t)y0 * src.w * 3;
    const uint8_t* r1 = src.data.data() + (size_t)y1 * src.w * 3;
    uint8_t* drow = dst->data.data() + (size_t)y * tw * 3;
    for (int x = 0; x < tw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = (int)fx;
      int x1 = x0 + 1 < src.w ? x0 + 1 : src.w - 1;
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        float top = r0[3 * x0 + c] * (1 - wx) + r0[3 * x1 + c] * wx;
        float bot = r1[3 * x0 + c] * (1 - wx) + r1[3 * x1 + c] * wx;
        drow[3 * x + c] = (uint8_t)(top * (1 - wy) + bot * wy + 0.5f);
      }
    }
  }
}

inline int reflect(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
  }
  return i;
}

// Crop/pad `img` to (crop_h, crop_w) into `out` (row-major RGB).
void crop_or_pad(const Image& img, int crop_h, int crop_w, bool random,
                 Rng* rng, uint8_t* out) {
  int off_y = 0, off_x = 0;   // crop offsets into the image
  int pad_y = 0, pad_x = 0;   // placement offsets into the output
  if (img.h > crop_h) {
    off_y = random ? (int)rng->uniform(img.h - crop_h + 1) : (img.h - crop_h) / 2;
  } else if (img.h < crop_h) {
    pad_y = random ? (int)rng->uniform(crop_h - img.h + 1) : (crop_h - img.h) / 2;
  }
  if (img.w > crop_w) {
    off_x = random ? (int)rng->uniform(img.w - crop_w + 1) : (img.w - crop_w) / 2;
  } else if (img.w < crop_w) {
    pad_x = random ? (int)rng->uniform(crop_w - img.w + 1) : (crop_w - img.w) / 2;
  }
  for (int y = 0; y < crop_h; ++y) {
    int sy = reflect(y - pad_y + off_y, img.h);
    const uint8_t* srow = img.data.data() + (size_t)sy * img.w * 3;
    uint8_t* drow = out + (size_t)y * crop_w * 3;
    if (pad_x == 0 && img.w >= crop_w) {
      memcpy(drow, srow + (size_t)off_x * 3, (size_t)crop_w * 3);
    } else {
      for (int x = 0; x < crop_w; ++x) {
        int sx = reflect(x - pad_x + off_x, img.w);
        memcpy(drow + 3 * x, srow + 3 * sx, 3);
      }
    }
  }
}

}  // namespace

extern "C" {

// Decodes n images into out (n, crop_h, crop_w, 3) uint8.
//
//   paths:        n C strings
//   target_sizes: per-image shorter-side resize target (<=0: no resize)
//   seeds:        per-image RNG seeds (crop/pad randomness)
//   random_crop:  1 = random crop/pad (training), 0 = center
//   ok:           per-image success flags (0 => caller should fall back)
//
// Returns the number of successfully decoded images.
int sed_decode_batch(const char** paths, int n, const int* target_sizes,
                     const uint64_t* seeds, int random_crop, int crop_h,
                     int crop_w, int n_threads, uint8_t* out, uint8_t* ok) {
  std::atomic<int> next(0), n_ok(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      Image img;
      ok[i] = 0;
      if (!decode_jpeg(paths[i], target_sizes[i], &img)) continue;
      int target = target_sizes[i];
      if (target > 0) {
        int shorter = img.w < img.h ? img.w : img.h;
        if (shorter != target) {
          int tw, th;
          if (img.w < img.h) {
            tw = target;
            th = (int)std::lround((double)img.h * target / img.w);
          } else {
            th = target;
            tw = (int)std::lround((double)img.w * target / img.h);
          }
          Image resized;
          resize_bilinear(img, tw, th, &resized);
          img = std::move(resized);
        }
      }
      Rng rng(seeds[i]);
      crop_or_pad(img, crop_h, crop_w, random_crop != 0, &rng,
                  out + (size_t)i * crop_h * crop_w * 3);
      ok[i] = 1;
      n_ok.fetch_add(1);
    }
  };
  int threads = n_threads > 0 ? n_threads : 1;
  if (threads > n) threads = n;
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return n_ok.load();
}

// In-memory counterpart of sed_decode_batch for the serving runtime:
// decodes n JPEG byte buffers (bufs[i], lens[i]) with the same
// resize/crop pipeline.  Same output/ok contract.
int sed_decode_mem_batch(const uint8_t** bufs, const uint64_t* lens, int n,
                         const int* target_sizes, const uint64_t* seeds,
                         int random_crop, int crop_h, int crop_w,
                         int n_threads, uint8_t* out, uint8_t* ok) {
  std::atomic<int> next(0), n_ok(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      Image img;
      ok[i] = 0;
      if (!decode_jpeg_mem(bufs[i], (size_t)lens[i], target_sizes[i], &img))
        continue;
      int target = target_sizes[i];
      if (target > 0) {
        int shorter = img.w < img.h ? img.w : img.h;
        if (shorter != target) {
          int tw, th;
          if (img.w < img.h) {
            tw = target;
            th = (int)std::lround((double)img.h * target / img.w);
          } else {
            th = target;
            tw = (int)std::lround((double)img.w * target / img.h);
          }
          Image resized;
          resize_bilinear(img, tw, th, &resized);
          img = std::move(resized);
        }
      }
      Rng rng(seeds[i]);
      crop_or_pad(img, crop_h, crop_w, random_crop != 0, &rng,
                  out + (size_t)i * crop_h * crop_w * 3);
      ok[i] = 1;
      n_ok.fetch_add(1);
    }
  };
  int threads = n_threads > 0 ? n_threads : 1;
  if (threads > n) threads = n;
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return n_ok.load();
}

}  // extern "C"
