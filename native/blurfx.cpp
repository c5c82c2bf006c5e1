// blurfx — native host-side runtime for blur_algorithms.
//
// XLA owns all device compute; what remains native is the host data path
// that feeds the device — exactly the roles the reference
// implements in C++ (SURVEY.md §2): planar<->interleaved layout conversion
// with +0.5 rounding (Utils.hpp:159-210), reflect-101 border padding
// (Utils.hpp:212-243), CRC-32 parity checksums (Source.cpp:15-56), and a
// block-partitioned thread pool (hybrid_loop, Utils.hpp:16-55). These run
// on the host CPU while the device computes, overlapping IO with device work.
//
// Build: make -C native   (produces libblurfx.so; ctypes-loaded by
// blur_algorithms/utils/native.py with a NumPy fallback when absent).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Block-partitioned parallel for: the reference's MYLOOP backend semantics
// (equal blocks, never more threads than items).
template <typename Fn>
void parallel_for(int64_t end, Fn&& fn) {
  const int hw = static_cast<int>(std::thread::hardware_concurrency());
  const int64_t max_threads = hw > 0 ? hw : 1;
  if (end <= 0) return;
  const int64_t block = (end + max_threads - 1) / max_threads;
  const int64_t needed = (end + block - 1) / block;
  if (needed <= 1) {
    for (int64_t i = 0; i < end; ++i) fn(i);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(needed));
  for (int64_t t = 0; t < needed; ++t) {
    const int64_t lo = t * block;
    const int64_t hi = std::min(end, lo + block);
    threads.emplace_back([lo, hi, &fn] {
      for (int64_t i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

constexpr int64_t kRowsPerTask = 64;

}  // namespace

extern "C" {

// interleaved (H, W, C) uint8 -> C planar float32 planes of (H, W),
// written contiguously into `planar` (C * H * W floats).
void blurfx_deinterleave_u8_f32(const uint8_t* interleaved, float* planar,
                                int64_t h, int64_t w, int64_t c) {
  const int64_t plane = h * w;
  const int64_t tasks = (h + kRowsPerTask - 1) / kRowsPerTask;
  parallel_for(tasks, [&](int64_t t) {
    const int64_t r0 = t * kRowsPerTask;
    const int64_t r1 = std::min(h, r0 + kRowsPerTask);
    for (int64_t y = r0; y < r1; ++y) {
      const uint8_t* src = interleaved + y * w * c;
      if (c == 3) {
        // single pass, three write streams — one read of the row, no
        // strided re-reads (the common RGB case)
        float* p0 = planar + 0 * plane + y * w;
        float* p1 = planar + 1 * plane + y * w;
        float* p2 = planar + 2 * plane + y * w;
        const uint8_t* s = src;
        for (int64_t x = 0; x < w; ++x, s += 3) {
          p0[x] = static_cast<float>(s[0]);
          p1[x] = static_cast<float>(s[1]);
          p2[x] = static_cast<float>(s[2]);
        }
        continue;
      }
      // channel-outer: contiguous plane writes, strided u8 gathers — the
      // row stays in L1/L2 across the c sweeps (channel-inner scattered
      // writes across far-apart planes measured ~2x slower than NumPy)
      for (int64_t ch = 0; ch < c; ++ch) {
        float* dst = planar + ch * plane + y * w;
        const uint8_t* s = src + ch;
        for (int64_t x = 0; x < w; ++x) {
          dst[x] = static_cast<float>(s[x * c]);
        }
      }
    }
  });
}

// C planar float32 planes -> interleaved (H, W, C) uint8 with the
// reference's +0.5 round-half-up (Utils.hpp:189), saturating.
void blurfx_interleave_f32_u8(const float* planar, uint8_t* interleaved,
                              int64_t h, int64_t w, int64_t c) {
  const int64_t plane = h * w;
  const int64_t tasks = (h + kRowsPerTask - 1) / kRowsPerTask;
  parallel_for(tasks, [&](int64_t t) {
    const int64_t r0 = t * kRowsPerTask;
    const int64_t r1 = std::min(h, r0 + kRowsPerTask);
    for (int64_t y = r0; y < r1; ++y) {
      uint8_t* dst = interleaved + y * w * c;
      if (c == 3) {
        const float* p0 = planar + 0 * plane + y * w;
        const float* p1 = planar + 1 * plane + y * w;
        const float* p2 = planar + 2 * plane + y * w;
        uint8_t* d = dst;
        auto q = [](float v) {
          v = std::floor(v + 0.5f);
          return static_cast<uint8_t>(std::min(255.0f, std::max(0.0f, v)));
        };
        for (int64_t x = 0; x < w; ++x, d += 3) {
          d[0] = q(p0[x]);
          d[1] = q(p1[x]);
          d[2] = q(p2[x]);
        }
        continue;
      }
      // channel-outer: contiguous f32 plane reads (see deinterleave)
      for (int64_t ch = 0; ch < c; ++ch) {
        const float* src = planar + ch * plane + y * w;
        uint8_t* d = dst + ch;
        for (int64_t x = 0; x < w; ++x) {
          const float v = std::floor(src[x] + 0.5f);
          d[x * c] = static_cast<uint8_t>(
              std::min(255.0f, std::max(0.0f, v)));
        }
      }
    }
  });
}

// Reflect-101 pad of an (H, W, C) uint8 image; pads clamped to dim-1
// (Utils.hpp:217-220); any excess request is zero-filled.
void blurfx_reflect101_u8(const uint8_t* input, uint8_t* output, int64_t h,
                          int64_t w, int64_t c, int64_t pad_top,
                          int64_t pad_bottom, int64_t pad_left,
                          int64_t pad_right) {
  const int64_t rt = std::min(pad_top, h - 1);
  const int64_t rb = std::min(pad_bottom, h - 1);
  const int64_t rl = std::min(pad_left, w - 1);
  const int64_t rr = std::min(pad_right, w - 1);
  const int64_t oh = h + pad_top + pad_bottom;
  const int64_t ow = w + pad_left + pad_right;
  const int64_t row_bytes = ow * c;

  parallel_for(oh, [&](int64_t i) {
    uint8_t* row = output + i * row_bytes;
    // source row index under reflect-101, or -1 for the zero-filled excess
    const int64_t rel = i - pad_top;
    int64_t src;
    if (rel < -rt || rel >= h + rb) {
      std::memset(row, 0, static_cast<size_t>(row_bytes));
      return;
    }
    if (rel < 0) {
      src = -rel;
    } else if (rel >= h) {
      src = 2 * (h - 1) - rel;
    } else {
      src = rel;
    }
    const uint8_t* in_row = input + src * w * c;
    // middle
    std::memcpy(row + pad_left * c, in_row, static_cast<size_t>(w * c));
    // left: output col j (< pad_left) mirrors input col (pad_left - j)
    for (int64_t j = 0; j < pad_left; ++j) {
      const int64_t k = pad_left - j;
      if (k <= rl) {
        std::memcpy(row + j * c, in_row + k * c, static_cast<size_t>(c));
      } else {
        std::memset(row + j * c, 0, static_cast<size_t>(c));
      }
    }
    // right: output col (pad_left + w + j) mirrors input col (w - 2 - j)
    for (int64_t j = 0; j < pad_right; ++j) {
      const int64_t k = w - 2 - j;
      if (j < rr) {
        std::memcpy(row + (pad_left + w + j) * c, in_row + k * c,
                    static_cast<size_t>(c));
      } else {
        std::memset(row + (pad_left + w + j) * c, 0, static_cast<size_t>(c));
      }
    }
  });
}

// CRC-32, polynomial 0xEDB88320 — the reference's parity checksum
// (Source.cpp:15-56), table built once.
uint32_t blurfx_crc32(const uint8_t* data, int64_t bytes, uint32_t seed_crc) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t r = i;
      for (int j = 0; j < 8; ++j)
        r = (r & 1u) ? (r >> 1) ^ 0xEDB88320u : r >> 1;
      table[i] = r;
    }
    init = true;
  }
  uint32_t crc = seed_crc ^ 0xFFFFFFFFu;
  for (int64_t i = 0; i < bytes; ++i)
    crc = table[(crc ^ data[i]) & 0xFFu] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

int blurfx_version() { return 1; }

}  // extern "C"
