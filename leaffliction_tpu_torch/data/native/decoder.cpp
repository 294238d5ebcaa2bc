// Native JPEG decode/encode for the port's host input pipeline.
//
// Copy of leaffliction_tpu/data/native/decoder.cpp, cut to what the port
// calls: libjpeg's DCT-domain scaling (scale_num/8) decodes large sources
// near the target size before a separable bilinear resize, one image or a
// batch on the library's own thread pool; a full-size decode (the
// materialising balancer's sources) and a quality-95 encoder.
//
// C ABI (ctypes-friendly):
//   leaf_jpeg_dims(data, len, &w, &h)            -> 0 on success
//   leaf_decode_jpeg_resize(data, len, target, out[target*target*3])
//   leaf_decode_jpeg(data, len, out, cap, &w, &h) -> full-size decode
//   leaf_decode_batch_resize(paths, n, target, out, status, n_threads)
//   leaf_encode_jpeg(rgb, w, h, quality, out, cap, &out_len)
//
// Build: see build.sh (g++ -O3 -shared -fPIC decoder.cpp -ljpeg).

#include <cstddef>
#include <cstdio>
#include <cstdlib>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Separable bilinear resize (RGB interleaved). PIL pixel-center convention.
void resize_bilinear(const uint8_t* src, int sw, int sh, uint8_t* dst, int dw,
                     int dh) {
  std::vector<float> tmp(static_cast<size_t>(dw) * sh * 3);
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;

  // horizontal pass
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
    float* out = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      fx = std::max(0.0f, std::min(fx, static_cast<float>(sw - 1)));
      int x0 = static_cast<int>(fx);
      int x1 = std::min(x0 + 1, sw - 1);
      float w1 = fx - x0;
      float w0 = 1.0f - w1;
      for (int c = 0; c < 3; ++c) {
        out[x * 3 + c] = w0 * row[x0 * 3 + c] + w1 * row[x1 * 3 + c];
      }
    }
  }
  // vertical pass
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(sh - 1)));
    int y0 = static_cast<int>(fy);
    int y1 = std::min(y0 + 1, sh - 1);
    float w1 = fy - y0;
    float w0 = 1.0f - w1;
    const float* r0 = tmp.data() + static_cast<size_t>(y0) * dw * 3;
    const float* r1 = tmp.data() + static_cast<size_t>(y1) * dw * 3;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int i = 0; i < dw * 3; ++i) {
      float v = w0 * r0[i] + w1 * r1[i];
      out[i] = static_cast<uint8_t>(std::min(255.0f, std::max(0.0f, v + 0.5f)));
    }
  }
}

bool decode_common(const uint8_t* data, size_t len, int target_hint,
                   std::vector<uint8_t>* pixels, int* out_w, int* out_h) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;

  if (target_hint > 0) {
    // DCT-domain downscale: largest scale m/8 with scaled size >= 2*target
    // (leaves headroom for a quality bilinear pass, like PIL Image.draft)
    int m = 8;
    while (m > 1 &&
           (static_cast<int>(cinfo.image_width) * (m - 1)) / 8 >=
               2 * target_hint &&
           (static_cast<int>(cinfo.image_height) * (m - 1)) / 8 >=
               2 * target_hint) {
      --m;
    }
    cinfo.scale_num = m;
    cinfo.scale_denom = 8;
  }

  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const int stride = w * cinfo.output_components;
  pixels->resize(static_cast<size_t>(stride) * h);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rowp = pixels->data() +
                    static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  if (cinfo.output_components != 3) {
    // grayscale → RGB expand
    std::vector<uint8_t> rgb(static_cast<size_t>(w) * h * 3);
    for (size_t i = 0; i < static_cast<size_t>(w) * h; ++i) {
      rgb[i * 3] = rgb[i * 3 + 1] = rgb[i * 3 + 2] = (*pixels)[i];
    }
    pixels->swap(rgb);
  }
  *out_w = w;
  *out_h = h;
  return true;
}

}  // namespace

extern "C" {

int leaf_jpeg_dims(const uint8_t* data, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode + resize to target×target RGB (out must hold target*target*3).
int leaf_decode_jpeg_resize(const uint8_t* data, size_t len, int target,
                            uint8_t* out) {
  std::vector<uint8_t> pixels;
  int w = 0, h = 0;
  if (!decode_common(data, len, target, &pixels, &w, &h)) return -1;
  if (w == target && h == target) {
    std::memcpy(out, pixels.data(), static_cast<size_t>(target) * target * 3);
  } else {
    resize_bilinear(pixels.data(), w, h, out, target, target);
  }
  return 0;
}

// Full-size decode; returns -2 if cap is too small. w/h set on success.
int leaf_decode_jpeg(const uint8_t* data, size_t len, uint8_t* out,
                     size_t cap, int* w, int* h) {
  std::vector<uint8_t> pixels;
  if (!decode_common(data, len, 0, &pixels, w, h)) return -1;
  if (pixels.size() > cap) return -2;
  std::memcpy(out, pixels.data(), pixels.size());
  return 0;
}

// Batched decode+resize on the library's OWN thread pool: one ctypes call
// decodes n files into out[n*target*target*3]. Per-image status: 0 ok,
// -1 read/decode failure (caller falls back per image). n_threads<=0 picks
// hardware_concurrency. Decode state is per-call-frame, so workers are
// fully independent; the single ctypes call releases the GIL for the whole
// batch (Python thread pools pay per-image call overhead instead).
int leaf_decode_batch_resize(const char** paths, int n, int target,
                             uint8_t* out, int* status, int n_threads) {
  if (n <= 0 || target <= 0) return 0;
  int workers = n_threads > 0
                    ? n_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  workers = std::max(1, std::min(workers, n));
  std::atomic<int> next(0);
  const size_t img_bytes = static_cast<size_t>(target) * target * 3;

  auto work = [&]() {
    std::vector<uint8_t> data;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      status[i] = -1;
      FILE* f = std::fopen(paths[i], "rb");
      if (!f) continue;
      std::fseek(f, 0, SEEK_END);
      const long sz = std::ftell(f);
      std::fseek(f, 0, SEEK_SET);
      if (sz <= 0) {
        std::fclose(f);
        continue;
      }
      data.resize(static_cast<size_t>(sz));
      const size_t got = std::fread(data.data(), 1, data.size(), f);
      std::fclose(f);
      if (got != data.size()) continue;
      status[i] = leaf_decode_jpeg_resize(data.data(), data.size(), target,
                                          out + static_cast<size_t>(i) *
                                                    img_bytes);
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(workers);
  for (int t = 0; t < workers; ++t) threads.emplace_back(work);
  for (auto& t : threads) t.join();
  return 0;
}

// Encode RGB → JPEG (quality like the reference's save q=95,
// `srcs/utils/image_utils.py:60-69`). Returns 0, fills out/out_len.
int leaf_encode_jpeg(const uint8_t* rgb, int w, int h, int quality,
                     uint8_t* out, size_t cap, size_t* out_len) {
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  unsigned char* buffer = nullptr;
  unsigned long buf_len = 0;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_compress(&cinfo);
    if (buffer) free(buffer);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buffer, &buf_len);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(
        rgb + static_cast<size_t>(cinfo.next_scanline) * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  int rc = 0;
  if (buf_len > cap) {
    rc = -2;
  } else {
    std::memcpy(out, buffer, buf_len);
    *out_len = buf_len;
  }
  free(buffer);
  return rc;
}

}  // extern "C"
