// Threaded JPEG tile loader: decode + bilinear resize + ImageNet normalize.
//
// The raw-image MIL path (ref JPGMILDataloader / DALI pipeline,
// code/datasets/jpg_dataloader.py, dali_dataloader.py) spends its host time in
// single-threaded PIL decode. This library decodes a BATCH of jpeg tiles with
// a thread pool straight into one float32 NHWC buffer: libjpeg decompress,
// bilinear resize to tile_size, (x/255 - mean)/std per channel. Exposed via a
// plain C ABI for ctypes (see transmil_deepgraft_tpu/data/native_tiles.py).
//
// Build: make -C native libtileloader.so   (links -ljpeg)

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* mgr = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(mgr->jump, 1);
}

// target > 0 enables scaled-DCT decode: pick the largest power-of-two
// reduction (1/2, 1/4, 1/8 — supported by both classic libjpeg62 and
// libjpeg-turbo) whose output still covers `target` in BOTH dims, so the
// subsequent bilinear resize only ever downsamples by < 2x. The iDCT then
// runs on 1/4, 1/16, or 1/64 of the coefficients — decode cost drops nearly
// quadratically with the reduction. target <= 0 or source < 2*target decodes
// at full resolution (bit-identical to the pre-existing behavior).
bool decode_jpeg(const char* path, std::vector<unsigned char>& rgb, int& w, int& h,
                 int target = 0) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (target > 0) {
    unsigned denom = 1;
    while (denom < 8 &&
           cinfo.image_width / (denom * 2) >= static_cast<unsigned>(target) &&
           cinfo.image_height / (denom * 2) >= static_cast<unsigned>(target)) {
      denom *= 2;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  w = static_cast<int>(cinfo.output_width);
  h = static_cast<int>(cinfo.output_height);
  rgb.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// x-axis interpolation table (half-pixel centers, the jax.image.resize /
// OpenCV convention), hoisted out of the per-row loop: recomputing the
// clamped indices + weight per PIXEL was ~2x the cost of the decode itself
// at 224px (measured, tools/bench_decode.py)
struct XTab {
  std::vector<int> x0, x1;
  std::vector<float> wx;
};

XTab make_xtab(int w, int size) {
  XTab t;
  t.x0.resize(size);
  t.x1.resize(size);
  t.wx.resize(size);
  const float sx = static_cast<float>(w) / size;
  for (int ox = 0; ox < size; ++ox) {
    float fx = (ox + 0.5f) * sx - 0.5f;
    int x0 = fx < 0 ? 0 : static_cast<int>(fx);
    if (x0 > w - 1) x0 = w - 1;
    int x1 = x0 + 1 > w - 1 ? w - 1 : x0 + 1;
    float wx = fx - x0;
    if (wx < 0) wx = 0;
    t.x0[ox] = x0 * 3;
    t.x1[ox] = x1 * 3;
    t.wx[ox] = wx;
  }
  return t;
}

// bilinear resize from (h, w, 3) u8 to (size, size, 3) u8-range floats,
// fused with ImageNet normalization
void resize_normalize(const std::vector<unsigned char>& src, int w, int h,
                      int size, const float* mean, const float* stdev,
                      float* dst) {
  const float inv_std[3] = {1.0f / (255.0f * stdev[0]), 1.0f / (255.0f * stdev[1]),
                            1.0f / (255.0f * stdev[2])};
  const float off[3] = {mean[0] / stdev[0], mean[1] / stdev[1], mean[2] / stdev[2]};
  if (w == size && h == size) {  // exact-size tile: normalize only
    const size_t n = static_cast<size_t>(size) * size;
    for (size_t i = 0; i < n; ++i) {
      for (int c = 0; c < 3; ++c) {
        dst[i * 3 + c] = src[i * 3 + c] * inv_std[c] - off[c];
      }
    }
    return;
  }
  const XTab xt = make_xtab(w, size);
  const float sy = static_cast<float>(h) / size;
  for (int oy = 0; oy < size; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    if (y0 > h - 1) y0 = h - 1;
    int y1 = y0 + 1 > h - 1 ? h - 1 : y0 + 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    const unsigned char* r0 = src.data() + static_cast<size_t>(y0) * w * 3;
    const unsigned char* r1 = src.data() + static_cast<size_t>(y1) * w * 3;
    float* orow = dst + static_cast<size_t>(oy) * size * 3;
    for (int ox = 0; ox < size; ++ox) {
      const int x0 = xt.x0[ox], x1 = xt.x1[ox];
      const float wx = xt.wx[ox];
      for (int c = 0; c < 3; ++c) {
        float top = r0[x0 + c] * (1 - wx) + r0[x1 + c] * wx;
        float bot = r1[x0 + c] * (1 - wx) + r1[x1 + c] * wx;
        float v = top * (1 - wy) + bot * wy;
        orow[ox * 3 + c] = v * inv_std[c] - off[c];
      }
    }
  }
}

}  // namespace

namespace {

// bilinear resize to u8 (no normalization): the device-side-normalize path
// ships 4x less host->device data than normalized f32 tiles
void resize_u8(const std::vector<unsigned char>& src, int w, int h, int size,
               unsigned char* dst) {
  if (w == size && h == size) {  // exact-size tile: straight copy
    memcpy(dst, src.data(), static_cast<size_t>(size) * size * 3);
    return;
  }
  const XTab xt = make_xtab(w, size);
  const float sy = static_cast<float>(h) / size;
  for (int oy = 0; oy < size; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    if (y0 > h - 1) y0 = h - 1;
    int y1 = y0 + 1 > h - 1 ? h - 1 : y0 + 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    const unsigned char* r0 = src.data() + static_cast<size_t>(y0) * w * 3;
    const unsigned char* r1 = src.data() + static_cast<size_t>(y1) * w * 3;
    unsigned char* orow = dst + static_cast<size_t>(oy) * size * 3;
    for (int ox = 0; ox < size; ++ox) {
      const int x0 = xt.x0[ox], x1 = xt.x1[ox];
      const float wx = xt.wx[ox];
      for (int c = 0; c < 3; ++c) {
        float top = r0[x0 + c] * (1 - wx) + r0[x1 + c] * wx;
        float bot = r1[x0 + c] * (1 - wx) + r1[x1 + c] * wx;
        float v = top * (1 - wy) + bot * wy;
        orow[ox * 3 + c] = static_cast<unsigned char>(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Raw-u8 variant: decode + resize only (normalization happens on-device).
// scaled_dct != 0 decodes oversized sources at a reduced DCT scale (see
// decode_jpeg): identical output for sources < 2x `size`; for larger sources
// the 1/2-1/8 iDCT + <2x bilinear replaces a full iDCT + large downsample.
int tl_load_batch_u8(const char** paths, int n, int size, unsigned char* out,
                     int n_threads, int scaled_dct) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), ok(0);
  const size_t tile_bytes = static_cast<size_t>(size) * size * 3;
  const int target = scaled_dct ? size : 0;
  auto worker = [&]() {
    std::vector<unsigned char> rgb;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int w = 0, h = 0;
      unsigned char* dst = out + tile_bytes * i;
      if (!decode_jpeg(paths[i], rgb, w, h, target)) {
        memset(dst, 0, tile_bytes);
        continue;
      }
      resize_u8(rgb, w, h, size, dst);
      ok.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok.load();
}

// Returns the number of successfully loaded tiles; failed paths leave zeros.
// out must hold n * size * size * 3 floats.
int tl_load_batch(const char** paths, int n, int size, float* out, int n_threads,
                  const float* mean, const float* stdev, int scaled_dct) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), ok(0);
  const size_t tile_floats = static_cast<size_t>(size) * size * 3;
  const int target = scaled_dct ? size : 0;
  auto worker = [&]() {
    std::vector<unsigned char> rgb;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int w = 0, h = 0;
      float* dst = out + tile_floats * i;
      if (!decode_jpeg(paths[i], rgb, w, h, target)) {
        memset(dst, 0, tile_floats * sizeof(float));
        continue;
      }
      resize_normalize(rgb, w, h, size, mean, stdev, dst);
      ok.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok.load();
}

}  // extern "C"
