// Native host-side image preprocessing for clip_event_tpu_torch.
//
// The training-input hot path (the reference did this in Python/PIL inside
// the train loop, dataset_voa.py:478-544): JPEG decode (libjpeg), PIL-exact
// fixed-point bicubic resample (two passes, 22-bit coefficients, clip8 —
// bit-identical to PIL's Resample.c for 8-bit images), short-side resize,
// center crop, and CLIP mean/std normalization to float32 HWC.
//
// C ABI only; bound from Python via ctypes and built with g++ at first use
// into the package's _build/ (clip_event_tpu_torch/data/native.py). Where
// libjpeg is missing it is built with -DCE_NO_LIBJPEG: the JPEG entry points
// then return kNoLibjpeg, ce_has_libjpeg() returns 0, and the caller decodes
// with PIL and resizes here (ce_preprocess_rgb*).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <vector>

#ifndef CE_NO_LIBJPEG
#include <jpeglib.h>
#endif

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // PIL fixed-point precision
constexpr double kBicubicA = -0.5;
constexpr double kBicubicSupport = 2.0;

constexpr int kNoLibjpeg = 4;  // a JPEG entry point of a build without libjpeg

const float kClipMean[3] = {0.48145466f, 0.4578275f, 0.40821073f};
const float kClipStd[3] = {0.26862954f, 0.26130258f, 0.27577711f};

double bicubic_kernel(double x) {
  const double a = kBicubicA;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct AxisCoeffs {
  int ksize = 0;
  std::vector<int> bounds_min;    // per output pixel
  std::vector<int> bounds_count;  // taps per output pixel
  std::vector<int32_t> coeffs;    // [out, ksize] fixed point
};

// PIL precompute_coeffs + normalize_coeffs_8bpc semantics.
AxisCoeffs precompute(int in_size, int out_size) {
  AxisCoeffs c;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = kBicubicSupport * filterscale;
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds_min.resize(out_size);
  c.bounds_count.resize(out_size);
  c.coeffs.assign(static_cast<size_t>(out_size) * c.ksize, 0);
  const double inv = 1.0 / filterscale;
  std::vector<double> taps(c.ksize);

  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    const int n = xmax - xmin;
    double total = 0.0;
    for (int i = 0; i < n; ++i) {
      taps[i] = bicubic_kernel((xmin + i - center + 0.5) * inv);
      total += taps[i];
    }
    c.bounds_min[xx] = xmin;
    c.bounds_count[xx] = n;
    for (int i = 0; i < n; ++i) {
      const double w = (total != 0.0 ? taps[i] / total : taps[i]) *
                       (1 << kPrecisionBits);
      c.coeffs[static_cast<size_t>(xx) * c.ksize + i] =
          static_cast<int32_t>(w < 0 ? w - 0.5 : w + 0.5);
    }
  }
  return c;
}

inline uint8_t clip8(int64_t v) {
  v >>= kPrecisionBits;
  if (v < 0) return 0;
  if (v > 255) return 255;
  return static_cast<uint8_t>(v);
}

// One horizontal resample pass: [h, in_w, C] u8 -> [h, out_w, C] u8.
void resample_horizontal(const uint8_t* src, int h, int in_w, int channels,
                         const AxisCoeffs& c, int out_w, uint8_t* dst) {
  const int64_t half = 1LL << (kPrecisionBits - 1);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * in_w * channels;
    uint8_t* out_row = dst + static_cast<size_t>(y) * out_w * channels;
    for (int x = 0; x < out_w; ++x) {
      const int xmin = c.bounds_min[x];
      const int n = c.bounds_count[x];
      const int32_t* k = &c.coeffs[static_cast<size_t>(x) * c.ksize];
      for (int ch = 0; ch < channels; ++ch) {
        int64_t acc = half;
        const uint8_t* p = row + static_cast<size_t>(xmin) * channels + ch;
        for (int i = 0; i < n; ++i) acc += static_cast<int64_t>(k[i]) * p[i * channels];
        out_row[static_cast<size_t>(x) * channels + ch] = clip8(acc);
      }
    }
  }
}

// One vertical resample pass: [in_h, w, C] u8 -> [out_h, w, C] u8.
void resample_vertical(const uint8_t* src, int in_h, int w, int channels,
                       const AxisCoeffs& c, int out_h, uint8_t* dst) {
  const int64_t half = 1LL << (kPrecisionBits - 1);
  const size_t stride = static_cast<size_t>(w) * channels;
  for (int y = 0; y < out_h; ++y) {
    const int ymin = c.bounds_min[y];
    const int n = c.bounds_count[y];
    const int32_t* k = &c.coeffs[static_cast<size_t>(y) * c.ksize];
    uint8_t* out_row = dst + static_cast<size_t>(y) * stride;
    for (size_t xc = 0; xc < stride; ++xc) {
      int64_t acc = half;
      const uint8_t* p = src + static_cast<size_t>(ymin) * stride + xc;
      for (int i = 0; i < n; ++i) acc += static_cast<int64_t>(k[i]) * p[i * stride];
      out_row[xc] = clip8(acc);
    }
  }
}

#ifndef CE_NO_LIBJPEG
struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}
#endif

}  // namespace

extern "C" {

// 1 where the library decodes JPEG itself (libjpeg), 0 where it was built
// with -DCE_NO_LIBJPEG.
int ce_has_libjpeg() {
#ifdef CE_NO_LIBJPEG
  return 0;
#else
  return 1;
#endif
}

#ifdef CE_NO_LIBJPEG
int ce_jpeg_dims(const uint8_t*, size_t, int*, int*) { return kNoLibjpeg; }
int ce_jpeg_decode(const uint8_t*, size_t, uint8_t*, int, int) { return kNoLibjpeg; }
#else
// Decode a JPEG buffer into caller-owned RGB bytes. Two-phase: call with
// out == nullptr to get dimensions, then with a [h*w*3] buffer.
// Returns 0 on success.
int ce_jpeg_dims(const uint8_t* data, size_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int ce_jpeg_decode(const uint8_t* data, size_t len, uint8_t* out, int h, int w) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_width) != w ||
      cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}
#endif  // CE_NO_LIBJPEG

// Bit-exact PIL BICUBIC resize of an RGB u8 image.
int ce_resize_bicubic(const uint8_t* src, int in_h, int in_w, int out_h,
                      int out_w, uint8_t* dst) {
  const int channels = 3;
  std::vector<uint8_t> tmp;
  const uint8_t* cur = src;
  int cur_h = in_h, cur_w = in_w;
  if (in_w != out_w) {
    AxisCoeffs cx = precompute(in_w, out_w);
    tmp.resize(static_cast<size_t>(cur_h) * out_w * channels);
    resample_horizontal(cur, cur_h, cur_w, channels, cx, out_w, tmp.data());
    cur = tmp.data();
    cur_w = out_w;
  }
  if (in_h != out_h) {
    AxisCoeffs cy = precompute(in_h, out_h);
    if (cur == dst) return 3;
    resample_vertical(cur, cur_h, cur_w, channels, cy, out_h, dst);
  } else {
    if (cur != dst) std::memcpy(dst, cur, static_cast<size_t>(cur_h) * cur_w * channels);
  }
  return 0;
}

// CLIP preprocessing through the uint8 stages of a decoded RGB image:
// short-side resize -> center crop. out: [size,size,3] u8. This is the
// bit-exact intermediate the float path normalizes, and the representation
// the offline image cache stores (normalization is applied at read time).
int ce_preprocess_rgb_u8(const uint8_t* rgb, int h, int w, int size,
                         uint8_t* out) {
  int out_h, out_w;
  if ((h <= w && h == size) || (w <= h && w == size)) {
    out_h = h;
    out_w = w;
  } else if (h < w) {
    out_h = size;
    out_w = static_cast<int>(static_cast<int64_t>(size) * w / h);
  } else {
    out_w = size;
    out_h = static_cast<int>(static_cast<int64_t>(size) * h / w);
  }

  std::vector<uint8_t> resized(static_cast<size_t>(out_h) * out_w * 3);
  if (out_h == h && out_w == w) {
    std::memcpy(resized.data(), rgb, resized.size());
  } else {
    int rc = ce_resize_bicubic(rgb, h, w, out_h, out_w, resized.data());
    if (rc) return rc;
  }

  // torchvision CenterCrop: round-half-up offsets; pad if smaller
  std::vector<uint8_t> padded;
  const uint8_t* base = resized.data();
  int bh = out_h, bw = out_w;
  if (bh < size || bw < size) {
    const int ph = std::max(size - bh, 0), pw = std::max(size - bw, 0);
    const int nh = bh + ph, nw = bw + pw;
    padded.assign(static_cast<size_t>(nh) * nw * 3, 0);
    for (int y = 0; y < bh; ++y)
      std::memcpy(padded.data() + (static_cast<size_t>(y + ph / 2) * nw + pw / 2) * 3,
                  base + static_cast<size_t>(y) * bw * 3,
                  static_cast<size_t>(bw) * 3);
    base = padded.data();
    bh = nh;
    bw = nw;
  }
  // torchvision uses Python round() — round-half-to-even, not half-away
  const int top = static_cast<int>(std::nearbyint((bh - size) / 2.0));
  const int left = static_cast<int>(std::nearbyint((bw - size) / 2.0));

  for (int y = 0; y < size; ++y) {
    const uint8_t* row = base + (static_cast<size_t>(y + top) * bw + left) * 3;
    std::memcpy(out + static_cast<size_t>(y) * size * 3, row,
                static_cast<size_t>(size) * 3);
  }
  return 0;
}

// Full CLIP preprocessing of a decoded RGB image:
// short-side resize -> center crop -> /255 -> normalize. out: [size,size,3] f32.
int ce_preprocess_rgb(const uint8_t* rgb, int h, int w, int size, float* out) {
  std::vector<uint8_t> crop(static_cast<size_t>(size) * size * 3);
  int rc = ce_preprocess_rgb_u8(rgb, h, w, size, crop.data());
  if (rc) return rc;
  for (size_t i = 0; i < crop.size(); ++i) {
    const int ch = static_cast<int>(i % 3);
    const float v = crop[i] * (1.0f / 255.0f);
    out[i] = (v - kClipMean[ch]) / kClipStd[ch];
  }
  return 0;
}

// JPEG bytes -> preprocessed float32 [size,size,3] in one call.
int ce_preprocess_jpeg(const uint8_t* data, size_t len, int size, float* out) {
  int h, w;
  if (ce_jpeg_dims(data, len, &h, &w)) return 1;
  std::vector<uint8_t> rgb(static_cast<size_t>(h) * w * 3);
  if (ce_jpeg_decode(data, len, rgb.data(), h, w)) return 1;
  return ce_preprocess_rgb(rgb.data(), h, w, size, out);
}

// JPEG bytes -> uint8 [size,size,3] crop (pre-normalize stage) in one call.
int ce_preprocess_jpeg_u8(const uint8_t* data, size_t len, int size,
                          uint8_t* out) {
  int h, w;
  if (ce_jpeg_dims(data, len, &h, &w)) return 1;
  std::vector<uint8_t> rgb(static_cast<size_t>(h) * w * 3);
  if (ce_jpeg_decode(data, len, rgb.data(), h, w)) return 1;
  return ce_preprocess_rgb_u8(rgb.data(), h, w, size, out);
}

}  // extern "C"
