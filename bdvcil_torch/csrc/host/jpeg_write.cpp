// Host code, not a kernel: write RGB uint8 frames as baseline JPEG files with
// libjpeg, over a pool of std::threads. The corpus writer
// (bdvcil_torch/data/corpus.py) uses it in place of cv2.imwrite, which the
// card's machine lacks; libjpeg's defaults give 4:2:0 chroma, as cv2.imwrite
// does, so the frames take the decoder's yuv420 and planes paths.
//
// C ABI (ctypes):
//   bdvc_write_jpeg_batch(paths, n, rgb, w, h, quality, num_threads) -> int
//     rgb holds n frames of h x w x 3 bytes back to back; returns 0, or
//     1 + the index of the first frame that could not be written.
//
// Built by bdvcil_torch/data/native.py beside the decoder:
//   g++ -O3 -march=native -funroll-loops -fPIC -shared -std=c++17 jpeg_write.cpp -ljpeg -lpthread

// jpeglib.h uses size_t and FILE without including their headers
#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<ErrorMgr*>(cinfo->err)->jump, 1);
}

bool write_one(const char* path, const uint8_t* rgb, int w, int h, int quality) {
  FILE* f = std::fopen(path, "wb");
  if (f == nullptr) return false;
  jpeg_compress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_compress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const size_t stride = static_cast<size_t>(w) * 3;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(rgb + cinfo.next_scanline * stride);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return std::fclose(f) == 0;
}

}  // namespace

extern "C" int bdvc_write_jpeg_batch(const char** paths, int n, const uint8_t* rgb, int w,
                                     int h, int quality, int num_threads) {
  if (n <= 0) return 0;
  num_threads = std::max(1, std::min(num_threads, n));
  const size_t frame = static_cast<size_t>(w) * h * 3;
  std::atomic<int> next(0);
  std::atomic<int> first_bad(n);
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      if (!write_one(paths[i], rgb + i * frame, w, h, quality)) {
        int seen = first_bad.load();
        while (i < seen && !first_bad.compare_exchange_weak(seen, i)) {
        }
      }
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  const int bad = first_bad.load();
  return bad < n ? bad + 1 : 0;
}
