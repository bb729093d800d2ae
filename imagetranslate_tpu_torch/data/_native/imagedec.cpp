// First-party JPEG decode + fused resize/crop for the host image pipeline.
//
// Replaces the PIL path of data/images.py::load_image on JPEG inputs with a
// single C pass (reference transform: dataset.py:283-289 Resize(resize_min)
// -> CenterCrop(size), crop fused into the resize exactly like load_image's
// box= computation). Two reasons to exist beyond "C is faster than Python":
//
//  * The serving host can be decode-bound (this image's machine has ONE CPU
//    core, docs/PERF.md "single-core host decode") — this path removes the
//    PIL Image-object / convert / np.asarray overhead around the actual
//    libjpeg work and only ever materializes the scanlines the vertical
//    filter needs (jpeg_skip_scanlines above the crop, early abort below it;
//    each decoded row is horizontally resampled immediately, so the
//    full-frame RGB buffer PIL allocates never exists).
//  * ctypes calls drop the GIL for the whole decode+resize, so the decode
//    pool overlaps the consumer thread's Python dispatch even on one core.
//
// Resampling is bit-compatible with Pillow's ImagingResample (Resample.c):
// triangle (BILINEAR) filter with support scaled by the downscale factor,
// per-axis coefficient normalization in double, INT32 fixed point with
// PRECISION_BITS = 22, horizontal pass to a uint8 intermediate, then the
// vertical pass — including Pillow's clip8 rounding at both stages.
//
// Optional fast_scale: libjpeg DCT-domain prescaling (scale 1/2, 1/4, 1/8)
// when the scaled image still keeps min(w, h) >= resize_min, i.e. the
// filter resize never upsamples. DCT-domain halving is a proper low-pass,
// so quality is preserved; pixels deviate from the full-resolution decode
// (documented in docs/PARITY.md) which is why it is a flag, default on for
// throughput, off wherever strict PIL parity is asserted. (JDCT_IFAST and
// non-fancy chroma upsampling were measured on this host's libjpeg-turbo:
// ~0-2%% speed, mean 4-7/255 per-texel deviation on high-entropy content —
// rejected, docs/PERF.md.)
//
// Both resample passes run AVX2 when the CPU has it (runtime-dispatched, so
// the .so stays portable): the vertical pass is a dense 8-lane
// int32 multiply-accumulate over contiguous rows; the horizontal pass
// processes two 3-channel taps per 256-bit op. The SIMD paths reproduce the
// scalar fixed-point arithmetic bit for bit (same 22-bit precision, same
// clip8 saturation), so PIL parity is unaffected.
//
// Exported (ctypes, see data/imagedec.py):
//   itdec_decode_resize(path, size, resize_min, fast_scale, out, used_denom)
//     -> 0 ok; <0 error (caller falls back to the PIL path).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <csetjmp>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(__x86_64__) || defined(_M_X64)
#define ITDEC_X86 1
#include <immintrin.h>
#endif

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow Resample.c

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Silence libjpeg's stderr output but KEEP the warning count: libjpeg
// increments num_warnings inside the default emit_message, so a plain
// no-op override would also disable the truncation detection below
// (num_warnings > 0 -> fall back to PIL -> black image contract).
void emit_message(j_common_ptr cinfo, int msg_level) {
  if (msg_level < 0) cinfo->err->num_warnings++;
}

inline uint8_t clip8(int in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

inline double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

// Pillow's precompute_coeffs + normalize_coeffs_8bpc for the triangle
// filter: output `outSize` taps over input [in0, in1), INT32 fixed point.
// bounds[2*i] = xmin, bounds[2*i+1] = count; coeffs at kk[i*ksize ..].
int precompute_coeffs(int in_size, double in0, double in1, int out_size,
                      std::vector<int>& bounds, std::vector<int32_t>& kk) {
  double scale = (in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;  // bilinear support == 1.0
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  std::vector<double> prekk(static_cast<size_t>(out_size) * ksize, 0.0);

  double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; xx++) {
    double center = in0 + (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &prekk[static_cast<size_t>(xx) * ksize];
    double ww = 0.0;
    for (int x = 0; x < xmax; x++) {
      double w = bilinear_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    if (ww != 0.0) {
      for (int x = 0; x < xmax; x++) k[x] /= ww;
    }
    bounds[static_cast<size_t>(xx) * 2] = xmin;
    bounds[static_cast<size_t>(xx) * 2 + 1] = xmax;
  }

  kk.assign(prekk.size(), 0);
  for (size_t i = 0; i < prekk.size(); i++) {
    kk[i] = prekk[i] < 0
                ? static_cast<int32_t>(-0.5 + prekk[i] * (1 << kPrecisionBits))
                : static_cast<int32_t>(0.5 + prekk[i] * (1 << kPrecisionBits));
  }
  return ksize;
}

// ---- horizontal pass: one decoded scanline -> `size` RGB output pixels ----

void hpass_scalar(const uint8_t* row, int size, const int* hbounds,
                  const int32_t* hk, int hksize, uint8_t* dst) {
  for (int xx = 0; xx < size; xx++) {
    const int xmin = hbounds[static_cast<size_t>(xx) * 2];
    const int xcnt = hbounds[static_cast<size_t>(xx) * 2 + 1];
    const int32_t* k = &hk[static_cast<size_t>(xx) * hksize];
    int ss0 = 1 << (kPrecisionBits - 1);
    int ss1 = ss0, ss2 = ss0;
    const uint8_t* src = row + static_cast<size_t>(xmin) * 3;
    for (int x = 0; x < xcnt; x++) {
      ss0 += src[x * 3 + 0] * k[x];
      ss1 += src[x * 3 + 1] * k[x];
      ss2 += src[x * 3 + 2] * k[x];
    }
    dst[xx * 3 + 0] = clip8(ss0);
    dst[xx * 3 + 1] = clip8(ss1);
    dst[xx * 3 + 2] = clip8(ss2);
  }
}

// ---- vertical pass: the whole [size, size, 3] output from `mid` rows ----

void vpass_scalar(const uint8_t* mid, int size, const int* vbounds,
                  const int32_t* vk, int vksize, int y_first, uint8_t* out) {
  const size_t stride = static_cast<size_t>(size) * 3;
  for (int yy = 0; yy < size; yy++) {
    const int ymin = vbounds[static_cast<size_t>(yy) * 2];
    const int ycnt = vbounds[static_cast<size_t>(yy) * 2 + 1];
    const int32_t* k = &vk[static_cast<size_t>(yy) * vksize];
    uint8_t* dst = out + static_cast<size_t>(yy) * stride;
    for (size_t xx = 0; xx < stride; xx++) {
      int ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ycnt; y++) {
        ss += mid[static_cast<size_t>(ymin - y_first + y) * stride + xx] *
              k[y];
      }
      dst[xx] = clip8(ss);
    }
  }
}

#ifdef ITDEC_X86

// AVX2 variants reproduce the fixed-point arithmetic above bit for bit:
// int32 accumulators with the same 1 << (kPrecisionBits - 1) rounding term,
// and clip8 realized as srai(kPrecisionBits) + unsigned-saturating packs
// (negative -> 0, >= 2^30 -> >= 256 after shift -> 255), which is exactly
// clip8's behavior on every reachable value.

// Two 3-channel taps per 256-bit op: pixel x in lanes 0-3 (4th lane is the
// next pixel's R, discarded), pixel x+1 in lanes 4-7. The caller guarantees
// the row buffer is padded so the 4-byte loads at the last pixel are legal.
__attribute__((target("avx2"))) void hpass_avx2(const uint8_t* row, int size,
                                                const int* hbounds,
                                                const int32_t* hk, int hksize,
                                                uint8_t* dst) {
  for (int xx = 0; xx < size; xx++) {
    const int xmin = hbounds[static_cast<size_t>(xx) * 2];
    const int xcnt = hbounds[static_cast<size_t>(xx) * 2 + 1];
    const int32_t* k = &hk[static_cast<size_t>(xx) * hksize];
    const uint8_t* src = row + static_cast<size_t>(xmin) * 3;
    __m128i acc = _mm_set1_epi32(1 << (kPrecisionBits - 1));
    int x = 0;
    if (xcnt >= 2) {
      __m256i acc2 = _mm256_setzero_si256();
      for (; x + 2 <= xcnt; x += 2) {
        uint32_t w0, w1;
        std::memcpy(&w0, src + static_cast<size_t>(x) * 3, 4);
        std::memcpy(&w1, src + static_cast<size_t>(x + 1) * 3, 4);
        __m128i bytes = _mm_insert_epi32(_mm_cvtsi32_si128(
                                             static_cast<int>(w0)),
                                         static_cast<int>(w1), 1);
        __m256i pix = _mm256_cvtepu8_epi32(bytes);
        __m256i kk = _mm256_setr_epi32(k[x], k[x], k[x], k[x], k[x + 1],
                                       k[x + 1], k[x + 1], k[x + 1]);
        acc2 = _mm256_add_epi32(acc2, _mm256_mullo_epi32(pix, kk));
      }
      acc = _mm_add_epi32(acc, _mm_add_epi32(
                                   _mm256_castsi256_si128(acc2),
                                   _mm256_extracti128_si256(acc2, 1)));
    }
    for (; x < xcnt; x++) {
      uint32_t w;
      std::memcpy(&w, src + static_cast<size_t>(x) * 3, 4);
      __m128i pix =
          _mm_cvtepu8_epi32(_mm_cvtsi32_si128(static_cast<int>(w)));
      acc = _mm_add_epi32(acc,
                          _mm_mullo_epi32(pix, _mm_set1_epi32(k[x])));
    }
    __m128i shifted = _mm_srai_epi32(acc, kPrecisionBits);
    __m128i packed = _mm_packus_epi16(_mm_packus_epi32(shifted, shifted),
                                      _mm_setzero_si128());
    uint32_t rgbx = static_cast<uint32_t>(_mm_cvtsi128_si32(packed));
    dst[xx * 3 + 0] = static_cast<uint8_t>(rgbx);
    dst[xx * 3 + 1] = static_cast<uint8_t>(rgbx >> 8);
    dst[xx * 3 + 2] = static_cast<uint8_t>(rgbx >> 16);
  }
}

// 16 output bytes per iteration: two 8-lane int32 accumulators over the
// contiguous `mid` rows, then pack with lane-order fixup.
__attribute__((target("avx2"))) void vpass_avx2(const uint8_t* mid, int size,
                                                const int* vbounds,
                                                const int32_t* vk, int vksize,
                                                int y_first, uint8_t* out) {
  const size_t stride = static_cast<size_t>(size) * 3;
  const __m256i round = _mm256_set1_epi32(1 << (kPrecisionBits - 1));
  for (int yy = 0; yy < size; yy++) {
    const int ymin = vbounds[static_cast<size_t>(yy) * 2];
    const int ycnt = vbounds[static_cast<size_t>(yy) * 2 + 1];
    const int32_t* k = &vk[static_cast<size_t>(yy) * vksize];
    const uint8_t* base = mid + static_cast<size_t>(ymin - y_first) * stride;
    uint8_t* dst = out + static_cast<size_t>(yy) * stride;
    size_t xx = 0;
    for (; xx + 16 <= stride; xx += 16) {
      __m256i acc0 = round, acc1 = round;
      for (int y = 0; y < ycnt; y++) {
        const uint8_t* p = base + static_cast<size_t>(y) * stride + xx;
        __m256i kk = _mm256_set1_epi32(k[y]);
        __m256i p0 = _mm256_cvtepu8_epi32(
            _mm_loadl_epi64(reinterpret_cast<const __m128i*>(p)));
        __m256i p1 = _mm256_cvtepu8_epi32(
            _mm_loadl_epi64(reinterpret_cast<const __m128i*>(p + 8)));
        acc0 = _mm256_add_epi32(acc0, _mm256_mullo_epi32(p0, kk));
        acc1 = _mm256_add_epi32(acc1, _mm256_mullo_epi32(p1, kk));
      }
      __m256i ab = _mm256_packus_epi32(_mm256_srai_epi32(acc0, kPrecisionBits),
                                       _mm256_srai_epi32(acc1,
                                                         kPrecisionBits));
      ab = _mm256_permute4x64_epi64(ab, _MM_SHUFFLE(3, 1, 2, 0));
      __m128i bytes = _mm_packus_epi16(_mm256_castsi256_si128(ab),
                                       _mm256_extracti128_si256(ab, 1));
      _mm_storeu_si128(reinterpret_cast<__m128i*>(dst + xx), bytes);
    }
    for (; xx < stride; xx++) {
      int ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ycnt; y++) {
        ss += base[static_cast<size_t>(y) * stride + xx] * k[y];
      }
      dst[xx] = clip8(ss);
    }
  }
}

#endif  // ITDEC_X86

using HPassFn = void (*)(const uint8_t*, int, const int*, const int32_t*,
                         int, uint8_t*);
using VPassFn = void (*)(const uint8_t*, int, const int*, const int32_t*,
                         int, int, uint8_t*);

// ITDEC_FORCE_SCALAR=1 pins the scalar paths (read once at first use) so
// tests can assert SIMD/scalar bit equality across two processes.
bool force_scalar() {
  const char* v = std::getenv("ITDEC_FORCE_SCALAR");
  return v != nullptr && v[0] == '1';
}

HPassFn pick_hpass() {
#ifdef ITDEC_X86
  if (!force_scalar() && __builtin_cpu_supports("avx2")) return hpass_avx2;
#endif
  return hpass_scalar;
}

VPassFn pick_vpass() {
#ifdef ITDEC_X86
  if (!force_scalar() && __builtin_cpu_supports("avx2")) return vpass_avx2;
#endif
  return vpass_scalar;
}

// Lazy first-call resolution (thread-safe local static) rather than a
// dynamic initializer: __builtin_cpu_supports depends on libgcc's CPU-model
// constructor having run, which load-time init order does not guarantee.
HPassFn hpass() {
  static const HPassFn f = pick_hpass();
  return f;
}

VPassFn vpass() {
  static const VPassFn f = pick_vpass();
  return f;
}

}  // namespace

extern "C" {

// Decode the JPEG at `path` and emit the reference Resize(resize_min) ->
// CenterCrop(size) as [size, size, 3] uint8 RGB into `out`. fast_scale != 0
// permits DCT-domain prescaling (never below resize_min on the min side).
// used_denom (optional) reports the chosen DCT denominator. Returns 0 on
// success; negative codes on anything the caller should fall back to PIL
// for (unsupported color space, decode error, crop outside the image, ...).
int itdec_decode_resize(const char* path, int size, int resize_min,
                        int fast_scale, unsigned char* out, int* used_denom) {
  if (size <= 0 || resize_min <= 0 || out == nullptr) return -1;

  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -2;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = emit_message;

  // Everything libjpeg may longjmp out of lives below; keep C++ objects
  // whose destructors matter OUTSIDE the landing zone.
  std::vector<uint8_t> rowbuf;
  std::vector<uint8_t> mid;  // horizontally-resampled rows, uint8
  std::vector<int> hbounds, vbounds;
  std::vector<int32_t> hk, vk;

  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return -3;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return -4;
  }

  const double W = cinfo.image_width, H = cinfo.image_height;
  if (W < 1 || H < 1) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return -5;
  }

  // PIL draft("RGB") equivalent: libjpeg converts YCbCr/grayscale to RGB
  // in the decoder. CMYK/YCCK would need a second conversion — fall back.
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return -6;
  }
  cinfo.out_color_space = JCS_RGB;

  // DCT-domain prescale: largest denom in {8, 4, 2} whose scaled min side
  // still covers resize_min, so the filter stage below never upsamples.
  int denom = 1;
  if (fast_scale) {
    for (int d = 8; d >= 2; d /= 2) {
      // libjpeg scaled dims are ceil(dim / d).
      double mn = std::fmin(std::ceil(W / d), std::ceil(H / d));
      if (mn >= resize_min) {
        denom = d;
        break;
      }
    }
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = static_cast<unsigned>(denom);
  if (used_denom) *used_denom = denom;

  jpeg_calc_output_dimensions(&cinfo);
  const int dw = cinfo.output_width, dh = cinfo.output_height;
  if (dw < 1 || dh < 1 || cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return -7;
  }

  // The reference crop box, computed on the ORIGINAL geometry exactly like
  // load_image (scale to resize_min min-side, integer rounds, integer
  // center-crop), then mapped into decoded coordinates.
  const double scale = resize_min / std::fmin(W, H);
  // Python round() is round-half-to-even; nearbyint matches in the default
  // FP environment.
  const double rw = std::fmax(1.0, std::nearbyint(W * scale));
  const double rh = std::fmax(1.0, std::nearbyint(H * scale));
  const double left = std::floor((rw - size) / 2);
  const double top = std::floor((rh - size) / 2);
  if (left < 0 || top < 0) {  // size > resize_min: PIL pads — fall back
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return -8;
  }
  const double sx = static_cast<double>(dw) / W;  // original -> decoded
  const double sy = static_cast<double>(dh) / H;
  const double bx0 = left * W / rw * sx, bx1 = (left + size) * W / rw * sx;
  const double by0 = top * H / rh * sy, by1 = (top + size) * H / rh * sy;

  const int hksize = precompute_coeffs(dw, bx0, bx1, size, hbounds, hk);
  const int vksize = precompute_coeffs(dh, by0, by1, size, vbounds, vk);

  // Scanline range the vertical filter actually reads.
  int y_first = dh, y_last = 0;
  for (int yy = 0; yy < size; yy++) {
    int ymin = vbounds[static_cast<size_t>(yy) * 2];
    int ycnt = vbounds[static_cast<size_t>(yy) * 2 + 1];
    if (ymin < y_first) y_first = ymin;
    if (ymin + ycnt > y_last) y_last = ymin + ycnt;
  }
  if (y_first >= y_last) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return -9;
  }

  jpeg_start_decompress(&cinfo);
  // +8 pad: the AVX2 horizontal pass loads 4 bytes per 3-byte tap.
  rowbuf.resize(static_cast<size_t>(dw) * 3 + 8);
  mid.resize(static_cast<size_t>(y_last - y_first) * size * 3);
  const HPassFn do_hpass = hpass();

  if (y_first > 0) {
    // jpeg_skip_scanlines may stop short of the request (iMCU alignment);
    // loop until we are there.
    while (static_cast<int>(cinfo.output_scanline) < y_first) {
      JDIMENSION want = y_first - cinfo.output_scanline;
      if (jpeg_skip_scanlines(&cinfo, want) == 0) break;
    }
  }

  uint8_t* row = rowbuf.data();
  while (static_cast<int>(cinfo.output_scanline) < y_last) {
    const int y = static_cast<int>(cinfo.output_scanline);
    JSAMPROW rows[1] = {row};
    if (jpeg_read_scanlines(&cinfo, rows, 1) != 1) break;
    if (y < y_first) continue;  // skip_scanlines undershoot
    // Horizontal pass (Pillow ImagingResampleHorizontal_8bpc semantics).
    do_hpass(row, size, hbounds.data(), hk.data(), hksize,
             &mid[static_cast<size_t>(y - y_first) * size * 3]);
  }
  // Truncated/corrupt streams surface as libjpeg warnings (it fakes EOI
  // and pads gray); the reference turns corrupted images into black
  // (dataset.py:371-374) — report an error so the caller's PIL fallback
  // keeps that contract.
  const long warnings = cinfo.err->num_warnings;
  // Everything below the needed band is unread on purpose.
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  if (warnings > 0) return -10;

  // Vertical pass.
  vpass()(mid.data(), size, vbounds.data(), vk.data(), vksize, y_first, out);
  return 0;
}

}  // extern "C"
