// Asynchronous y4m writer for the PyTorch port (its own copy of the JAX
// package's media feeder, streamingt2v_tpu/native/media_feeder.cpp).
//
// Frames are submitted as uint8 RGB (N, H, W, 3), copied into a queue, and
// a background thread converts each to BT.601 full-range YUV 4:2:0 and
// writes it as a YUV4MPEG2 (C420jpeg) frame, so the host's encode overlaps
// whatever the caller does next.  The arithmetic is that of the port's
// Python writer (utils/media.py), operation for operation in float32, so
// the two write the same bytes:
//   Y = 0.299 R + 0.587 G + 0.114 B
//   U = -0.168736 R - 0.331264 G + 0.5 B + 128
//   V = 0.5 R - 0.418688 G - 0.081312 B + 128
// each evaluated left to right; U and V are averaged over each 2x2 block as
// (top-left + top-right) + (bottom-left + bottom-right), over 4; every
// plane rounds half to even and clips to [0, 255].  Build with
// -ffp-contract=off, so that no product and sum fuse into one rounding.
//
// C ABI (ctypes, streamingt2v_torch/native/__init__.py):
//   void* mfw_open(const char* path, int w, int h, int fps_num, int fps_den)
//   int   mfw_submit(void* h, const uint8_t* rgb, int n_frames)   // copies
//   int   mfw_pending(void* h)
//   int   mfw_close(void* h)                                       // joins

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Writer {
  FILE* file = nullptr;
  int w = 0, h = 0;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::vector<uint8_t>> queue;
  std::atomic<bool> closing{false};
  std::atomic<int> pending{0};
  std::atomic<bool> error{false};

  void encode_loop() {
    const int cw = w / 2, ch = h / 2;
    std::vector<float> u(static_cast<size_t>(w) * h), v(u.size());
    std::vector<uint8_t> y8(u.size()), u8(static_cast<size_t>(cw) * ch), v8(u8.size());
    for (;;) {
      std::vector<uint8_t> rgb;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return !queue.empty() || closing.load(); });
        if (queue.empty()) return;
        rgb = std::move(queue.front());
        queue.pop_front();
      }
      convert(rgb.data(), u.data(), v.data(), y8.data(), u8.data(), v8.data());
      if (std::fputs("FRAME\n", file) < 0 ||
          std::fwrite(y8.data(), 1, y8.size(), file) != y8.size() ||
          std::fwrite(u8.data(), 1, u8.size(), file) != u8.size() ||
          std::fwrite(v8.data(), 1, v8.size(), file) != v8.size()) {
        error.store(true);
      }
      pending.fetch_sub(1);
    }
  }

  static inline uint8_t to_u8(float x) {
    const float r = std::nearbyint(x);  // the default rounding: half to even
    return r < 0.f ? 0 : (r > 255.f ? 255 : static_cast<uint8_t>(r));
  }

  void convert(const uint8_t* p, float* u, float* v, uint8_t* y8, uint8_t* u8,
               uint8_t* v8) const {
    const size_t n = static_cast<size_t>(w) * h;
    for (size_t i = 0; i < n; ++i) {
      const float r = p[3 * i], g = p[3 * i + 1], b = p[3 * i + 2];
      y8[i] = to_u8(0.299f * r + 0.587f * g + 0.114f * b);
      u[i] = -0.168736f * r - 0.331264f * g + 0.5f * b + 128.0f;
      v[i] = 0.5f * r - 0.418688f * g - 0.081312f * b + 128.0f;
    }
    const int cw = w / 2;
    for (int row = 0; row < h / 2; ++row) {
      for (int col = 0; col < cw; ++col) {
        const size_t tl = static_cast<size_t>(2 * row) * w + 2 * col, bl = tl + w;
        u8[row * cw + col] = to_u8(((u[tl] + u[tl + 1]) + (u[bl] + u[bl + 1])) / 4.0f);
        v8[row * cw + col] = to_u8(((v[tl] + v[tl + 1]) + (v[bl] + v[bl + 1])) / 4.0f);
      }
    }
  }
};

}  // namespace

extern "C" {

void* mfw_open(const char* path, int w, int h, int fps_num, int fps_den) {
  if (w <= 0 || h <= 0 || w % 2 || h % 2) return nullptr;
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  std::fprintf(f, "YUV4MPEG2 W%d H%d F%d:%d Ip A1:1 C420jpeg\n", w, h, fps_num, fps_den);
  auto* wr = new Writer();
  wr->file = f;
  wr->w = w;
  wr->h = h;
  wr->worker = std::thread([wr] { wr->encode_loop(); });
  return wr;
}

int mfw_submit(void* handle, const uint8_t* rgb, int n_frames) {
  auto* wr = static_cast<Writer*>(handle);
  if (!wr || wr->closing.load()) return -1;
  const size_t stride = static_cast<size_t>(wr->w) * wr->h * 3;
  for (int i = 0; i < n_frames; ++i) {
    std::vector<uint8_t> frame(rgb + i * stride, rgb + (i + 1) * stride);
    {
      std::lock_guard<std::mutex> lk(wr->mu);
      wr->queue.push_back(std::move(frame));
      wr->pending.fetch_add(1);
    }
    wr->cv.notify_one();
  }
  return wr->error.load() ? -2 : 0;
}

int mfw_pending(void* handle) {
  auto* wr = static_cast<Writer*>(handle);
  return wr ? wr->pending.load() : -1;
}

int mfw_close(void* handle) {
  auto* wr = static_cast<Writer*>(handle);
  if (!wr) return -1;
  wr->closing.store(true);
  wr->cv.notify_all();
  if (wr->worker.joinable()) wr->worker.join();
  int rc = wr->error.load() ? -2 : 0;
  if (std::fclose(wr->file) != 0) rc = -2;
  delete wr;
  return rc;
}

}  // extern "C"
