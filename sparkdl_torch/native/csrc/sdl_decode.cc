// sdl_decode: native JPEG/PNG decode + bilinear resize for the image
// ingest path.
//
// The reference decodes and resizes images inside the executor JVM
// (SURVEY.md 2.2 — ImageUtils via java.awt, feeding TensorFrames); this is
// the same capability native to this framework: libjpeg/libpng decode with
// a threaded batch API so a partition of image files becomes one padded
// uint8 [N, H, W, 3] block without a Python-loop in the hot path. Kept as
// a separate .so from sdl_bridge so a toolchain without the image
// libraries still builds the staging ring (each loader fails independently
// and Python falls back to PIL).
//
// Resize is plain half-pixel bilinear — the same sampling as
// jax.image.resize(method="bilinear") so host-side and on-device resizes
// agree; note PIL's BILINEAR uses an adaptive triangle filter on
// downscale, which intentionally differs.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <setjmp.h>

namespace {

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool is_jpeg(const uint8_t* d, uint64_t n) {
  return n >= 3 && d[0] == 0xFF && d[1] == 0xD8 && d[2] == 0xFF;
}

bool is_png(const uint8_t* d, uint64_t n) {
  return n >= 8 && d[0] == 0x89 && d[1] == 'P' && d[2] == 'N' && d[3] == 'G';
}

// -> 0 ok, negative error codes (see sdl_decode_resize docstring python-side)
int decode_jpeg(const uint8_t* data, uint64_t len, std::vector<uint8_t>& pix,
                int32_t& h, int32_t& w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = static_cast<int32_t>(cinfo.output_width);
  h = static_cast<int32_t>(cinfo.output_height);
  pix.resize(static_cast<size_t>(h) * w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pix.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int decode_png_bytes(const uint8_t* data, uint64_t len,
                     std::vector<uint8_t>& pix, int32_t& h, int32_t& w) {
  png_image img;
  std::memset(&img, 0, sizeof img);
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&img, data, len)) return -3;
  img.format = PNG_FORMAT_RGB;
  h = static_cast<int32_t>(img.height);
  w = static_cast<int32_t>(img.width);
  pix.resize(PNG_IMAGE_SIZE(img));
  if (!png_image_finish_read(&img, nullptr, pix.data(), 0, nullptr)) {
    png_image_free(&img);
    return -4;
  }
  return 0;
}

int decode_any(const uint8_t* data, uint64_t len, std::vector<uint8_t>& pix,
               int32_t& h, int32_t& w) {
  if (is_jpeg(data, len)) return decode_jpeg(data, len, pix, h, w);
  if (is_png(data, len)) return decode_png_bytes(data, len, pix, h, w);
  return -1;  // unknown format
}

// One output coordinate's input taps for a triangle (tent) filter with
// antialiasing: on downscale the kernel stretches by the scale factor —
// the same construction as jax.image.resize(method="bilinear") and PIL's
// BILINEAR, so host-side and on-device resizes agree.
struct Taps {
  int32_t lo = 0;
  std::vector<float> w;
};

std::vector<Taps> make_taps(int32_t src_n, int32_t dst_n) {
  const float scale = static_cast<float>(src_n) / dst_n;
  const float support = std::max(scale, 1.0f);  // tent half-width in src px
  std::vector<Taps> taps(dst_n);
  for (int32_t o = 0; o < dst_n; ++o) {
    const float center = (o + 0.5f) * scale - 0.5f;
    int32_t lo = static_cast<int32_t>(std::ceil(center - support));
    int32_t hi = static_cast<int32_t>(std::floor(center + support));
    Taps& t = taps[o];
    t.lo = std::max(lo, 0);
    const int32_t hic = std::min(hi, src_n - 1);
    float sum = 0.0f;
    for (int32_t i = t.lo; i <= hic; ++i) {
      float u = std::abs((i - center) / support);
      float wgt = u < 1.0f ? 1.0f - u : 0.0f;
      t.w.push_back(wgt);
      sum += wgt;
    }
    if (sum <= 0.0f) {  // degenerate (1-px source edge): nearest
      t.lo = std::clamp(static_cast<int32_t>(std::round(center)), 0, src_n - 1);
      t.w.assign(1, 1.0f);
      sum = 1.0f;
    }
    for (float& wgt : t.w) wgt /= sum;
  }
  return taps;
}

// Separable antialiased tent resize, RGB u8 -> RGB u8 (f32 intermediate).
void resize_bilinear(const uint8_t* src, int32_t sh, int32_t sw, uint8_t* dst,
                     int32_t th, int32_t tw) {
  if (sh == th && sw == tw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * 3);
    return;
  }
  const auto tx = make_taps(sw, tw);
  const auto ty = make_taps(sh, th);
  // Pass 1: horizontal, [sh, sw, 3] -> [sh, tw, 3] f32.
  std::vector<float> mid(static_cast<size_t>(sh) * tw * 3);
  for (int32_t y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
    float* out = mid.data() + static_cast<size_t>(y) * tw * 3;
    for (int32_t x = 0; x < tw; ++x) {
      const Taps& t = tx[x];
      float acc[3] = {0, 0, 0};
      for (size_t k = 0; k < t.w.size(); ++k) {
        const uint8_t* p = row + (static_cast<size_t>(t.lo) + k) * 3;
        for (int c = 0; c < 3; ++c) acc[c] += t.w[k] * p[c];
      }
      for (int c = 0; c < 3; ++c) out[x * 3 + c] = acc[c];
    }
  }
  // Pass 2: vertical, [sh, tw, 3] -> [th, tw, 3] u8.
  for (int32_t y = 0; y < th; ++y) {
    const Taps& t = ty[y];
    uint8_t* out = dst + static_cast<size_t>(y) * tw * 3;
    for (int32_t x = 0; x < tw; ++x) {
      float acc[3] = {0, 0, 0};
      for (size_t k = 0; k < t.w.size(); ++k) {
        const float* p =
            mid.data() + ((static_cast<size_t>(t.lo) + k) * tw + x) * 3;
        for (int c = 0; c < 3; ++c) acc[c] += t.w[k] * p[c];
      }
      for (int c = 0; c < 3; ++c)
        out[x * 3 + c] =
            static_cast<uint8_t>(std::clamp(acc[c] + 0.5f, 0.0f, 255.0f));
    }
  }
}

int decode_resize_one(const uint8_t* data, uint64_t len, int32_t th,
                      int32_t tw, uint8_t* out) {
  std::vector<uint8_t> pix;
  int32_t h = 0, w = 0;
  int rc = decode_any(data, len, pix, h, w);
  if (rc != 0) return rc;
  resize_bilinear(pix.data(), h, w, out, th, tw);
  return 0;
}

}  // namespace

extern "C" {

// Header-only probe: native dimensions + source channel count (1 =
// grayscale, 3 = color, 4 = color+alpha) without a full decode.
// -> 0 ok; -1 unknown format; -2/-3 decode error.
int32_t sdl_image_info(const uint8_t* data, uint64_t len, int32_t* h,
                       int32_t* w, int32_t* channels) {
  if (is_jpeg(data, len)) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
      jpeg_destroy_decompress(&cinfo);
      return -2;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, len);
    jpeg_read_header(&cinfo, TRUE);
    *w = static_cast<int32_t>(cinfo.image_width);
    *h = static_cast<int32_t>(cinfo.image_height);
    *channels = static_cast<int32_t>(cinfo.num_components);
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  if (is_png(data, len)) {
    png_image img;
    std::memset(&img, 0, sizeof img);
    img.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_memory(&img, data, len)) return -3;
    *h = static_cast<int32_t>(img.height);
    *w = static_cast<int32_t>(img.width);
    *channels = static_cast<int32_t>(PNG_IMAGE_PIXEL_CHANNELS(img.format));
    png_image_free(&img);
    return 0;
  }
  return -1;
}

// Decode one image and bilinear-resize into out[th, tw, 3] RGB u8.
int32_t sdl_decode_resize(const uint8_t* data, uint64_t len, int32_t th,
                          int32_t tw, uint8_t* out) {
  return decode_resize_one(data, len, th, tw, out);
}

// Threaded batch: decode n images into out[n, th, tw, 3]; statuses[i] gets
// each image's return code (failed rows leave their slice zeroed).
void sdl_decode_resize_batch(uint64_t n, const uint8_t** datas,
                             const uint64_t* lens, int32_t th, int32_t tw,
                             uint8_t* out, int32_t n_threads,
                             int32_t* statuses) {
  const size_t frame = static_cast<size_t>(th) * tw * 3;
  std::memset(out, 0, frame * n);
  int32_t workers = std::max<int32_t>(
      1, std::min<int32_t>(n_threads, static_cast<int32_t>(n)));
  std::vector<std::thread> threads;
  std::atomic<uint64_t> next{0};
  auto work = [&] {
    for (uint64_t i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      statuses[i] =
          decode_resize_one(datas[i], lens[i], th, tw, out + frame * i);
    }
  };
  for (int32_t t = 1; t < workers; ++t) threads.emplace_back(work);
  work();
  for (auto& t : threads) t.join();
}

}  // extern "C"
