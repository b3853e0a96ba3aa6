// leme_data: JPEG / PNG decode, crop and bicubic resample for the input
// pipeline of lemevit_tpu_torch (data/native_decode.py loads it with
// ctypes). A copy of the JAX package's native/leme_data.cpp, code for
// code, so that both give the same bits.
//
// ctypes releases the GIL for the whole call, so the loader's producer
// threads decode in parallel. libjpeg's DCT scaling (1/2, 1/4, 1/8)
// decodes only the resolution the crop needs. Resampling is separable
// Catmull-Rom bicubic (a = -0.5) with PIL-style support widening on
// downscale, so outputs track PIL.resize(..., BICUBIC, box=...) closely
// but not bit for bit.
//
// Built at first use by data/native_decode.py:
//   g++ -O3 -std=c++17 -fPIC -Wall -Wextra -march=native -shared
//       -o _build/libleme_data_<hash>.so leme_data.cpp -ljpeg -lpng

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void on_emit(j_common_ptr, int) {}  // silence warnings

// Catmull-Rom (a = -0.5), the kernel PIL uses for BICUBIC.
inline float cubic(float x) {
  constexpr float a = -0.5f;
  x = std::fabs(x);
  if (x < 1.f) return ((a + 2.f) * x - (a + 3.f)) * x * x + 1.f;
  if (x < 2.f) return (((x - 5.f) * x + 8.f) * x - 4.f) * a;
  return 0.f;
}

// Precomputed sampling plan for one output axis: for output index i,
// weights over input taps [start[i], start[i]+k).
struct Plan {
  int k = 0;
  std::vector<int> start;
  std::vector<float> w;
};

// PIL-style plan: center mapping in box coords, support = 2 * max(1,
// in_size/out_size) (kernel widened on downscale => antialiased).
Plan make_plan(float box0, float box_len, int in_limit, int out_len) {
  Plan p;
  const float scale = box_len / static_cast<float>(out_len);
  const float filt = std::max(1.f, scale);
  const float support = 2.f * filt;
  p.k = static_cast<int>(std::ceil(support)) * 2 + 1;
  p.start.resize(out_len);
  p.w.resize(static_cast<size_t>(out_len) * p.k);
  for (int i = 0; i < out_len; ++i) {
    const float center = box0 + (i + 0.5f) * scale;
    int s0 = static_cast<int>(std::floor(center - support + 0.5f));
    float total = 0.f;
    float* wrow = &p.w[static_cast<size_t>(i) * p.k];
    for (int t = 0; t < p.k; ++t) {
      const float x = (s0 + t + 0.5f - center) / filt;
      wrow[t] = cubic(x);
      total += wrow[t];
    }
    if (total != 0.f)
      for (int t = 0; t < p.k; ++t) wrow[t] /= total;
    p.start[i] = s0;
    // clamp handled at apply time against in_limit
    (void)in_limit;
  }
  return p;
}

inline uint8_t clamp_u8(float v) {
  return static_cast<uint8_t>(std::min(255.f, std::max(0.f, v + 0.5f)));
}

// Shared crop+bicubic-resample from a decoded RGB u8 buffer (W x H x 3),
// box in the buffer's coordinate system. Writes (out_h, out_w, 3).
void resample_crop(const uint8_t* img, int W, int H, float x0, float y0,
                   float cw, float ch, int out_w, int out_h, int hflip,
                   uint8_t* out) {
  Plan px = make_plan(x0, cw, W, out_w);
  Plan py = make_plan(y0, ch, H, out_h);
  int ry0 = H, ry1 = 0;
  for (int i = 0; i < out_h; ++i) {
    ry0 = std::min(ry0, py.start[i]);
    ry1 = std::max(ry1, py.start[i] + py.k);
  }
  ry0 = std::max(0, ry0);
  ry1 = std::min(H, ry1);
  if (ry0 >= ry1) { ry0 = 0; ry1 = std::min(1, H); }
  std::vector<float> tmp(static_cast<size_t>(ry1 - ry0) * out_w * 3);
  for (int y = ry0; y < ry1; ++y) {
    const uint8_t* src = img + static_cast<size_t>(y) * W * 3;
    float* dst = tmp.data() + static_cast<size_t>(y - ry0) * out_w * 3;
    for (int i = 0; i < out_w; ++i) {
      const float* wrow = &px.w[static_cast<size_t>(i) * px.k];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
      const int s0 = px.start[i];
      for (int t = 0; t < px.k; ++t) {
        int xx = std::min(W - 1, std::max(0, s0 + t));
        const uint8_t* p = src + xx * 3;
        acc0 += wrow[t] * p[0];
        acc1 += wrow[t] * p[1];
        acc2 += wrow[t] * p[2];
      }
      dst[i * 3 + 0] = acc0;
      dst[i * 3 + 1] = acc1;
      dst[i * 3 + 2] = acc2;
    }
  }
  for (int j = 0; j < out_h; ++j) {
    const float* wrow = &py.w[static_cast<size_t>(j) * py.k];
    const int s0 = py.start[j];
    uint8_t* dst = out + static_cast<size_t>(j) * out_w * 3;
    for (int i = 0; i < out_w; ++i) {
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
      for (int t = 0; t < py.k; ++t) {
        int yy = std::min(ry1 - 1, std::max(ry0, s0 + t)) - ry0;
        const float* p = tmp.data() +
            (static_cast<size_t>(yy) * out_w + i) * 3;
        acc0 += wrow[t] * p[0];
        acc1 += wrow[t] * p[1];
        acc2 += wrow[t] * p[2];
      }
      const int oi = hflip ? (out_w - 1 - i) : i;
      dst[oi * 3 + 0] = clamp_u8(acc0);
      dst[oi * 3 + 1] = clamp_u8(acc1);
      dst[oi * 3 + 2] = clamp_u8(acc2);
    }
  }
}

}  // namespace

extern "C" {

// Header-only probe. Returns 0 and fills (w, h) on success.
int leme_jpeg_size(const uint8_t* buf, int len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = on_error;
  jerr.pub.emit_message = on_emit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode a JPEG from memory, crop the box (x0, y0, cw, ch) given in
// ORIGINAL image coordinates (floats; may be fractional after the
// caller's RRC math), bicubic-resample to (out_w x out_h) RGB u8 into
// `out` (row-major HWC), optionally mirroring horizontally. Gray JPEGs
// are expanded to RGB by libjpeg; CMYK/unsupported color spaces return
// nonzero so the caller can fall back to PIL. Returns 0 on success.
int leme_jpeg_decode_crop(const uint8_t* buf, int len, float x0, float y0,
                          float cw, float ch, int out_w, int out_h,
                          int hflip, uint8_t* out) {
  if (out_w <= 0 || out_h <= 0 || cw <= 0.f || ch <= 0.f) return 2;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = on_error;
  jerr.pub.emit_message = on_emit;
  std::vector<uint8_t> img;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  cinfo.out_color_space = JCS_RGB;  // libjpeg converts gray/YCbCr
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    return 3;  // caller falls back to PIL
  }
  // DCT scaling: largest 1/2^k with the scaled crop still >= the output
  // (no information loss for the bicubic stage).
  int denom = 1;
  while (denom < 8 && cw / (denom * 2) >= out_w && ch / (denom * 2) >= out_h)
    denom *= 2;
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  jpeg_start_decompress(&cinfo);
  const int W = cinfo.output_width, H = cinfo.output_height;
  const int C = cinfo.output_components;
  if (C != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  img.resize(static_cast<size_t>(W) * H * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = img.data() + static_cast<size_t>(cinfo.output_scanline) * W * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // crop box in scaled coords
  const float s = 1.f / static_cast<float>(denom);
  resample_crop(img.data(), W, H, x0 * s, y0 * s, cw * s, ch * s,
                out_w, out_h, hflip, out);
  return 0;
}

// PNG header probe (the CD datasets are PNG pairs).
int leme_png_size(const uint8_t* buf, int len, int* w, int* h) {
  png_image pimg;
  std::memset(&pimg, 0, sizeof(pimg));
  pimg.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&pimg, buf, len)) return 1;
  *w = pimg.width;
  *h = pimg.height;
  png_image_free(&pimg);
  return 0;
}

// PNG decode (libpng simplified API, forced RGB u8) + shared
// crop/bicubic-resample. No scaled decode (PNG has none), so large
// sources pay a full decode — still GIL-free.
int leme_png_decode_crop(const uint8_t* buf, int len, float x0, float y0,
                         float cw, float ch, int out_w, int out_h,
                         int hflip, uint8_t* out) {
  if (out_w <= 0 || out_h <= 0 || cw <= 0.f || ch <= 0.f) return 2;
  png_image pimg;
  std::memset(&pimg, 0, sizeof(pimg));
  pimg.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&pimg, buf, len)) return 1;
  pimg.format = PNG_FORMAT_RGB;
  std::vector<uint8_t> img(PNG_IMAGE_SIZE(pimg));
  if (!png_image_finish_read(&pimg, nullptr, img.data(), 0, nullptr)) {
    png_image_free(&pimg);
    return 1;
  }
  resample_crop(img.data(), pimg.width, pimg.height, x0, y0, cw, ch,
                out_w, out_h, hflip, out);
  return 0;
}

}  // extern "C"
