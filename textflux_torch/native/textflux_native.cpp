// textflux_torch native data-path kernels (C++, ctypes ABI): a copy of the
// JAX package's native/textflux_native.cpp, kept in the port so that it
// stands alone.
//
// The training input pipeline's per-sample CPU hot path — polygon mask
// rasterization, 3x3 morphology augmentation, and [-1,1] normalization —
// implemented as vectorizable C++ (the reference leans on cv2/torch native
// code for these; see image_datasets/dataset.py:214-249).
//
// Build (textflux_torch/data/native.py does it on first use, into build/):
//   g++ -O3 -shared -fPIC textflux_native.cpp -o libtextflux_native_<hash>.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Scanline polygon fill: points are (x, y) pairs; writes 255 inside.
// Even-odd rule, matching cv2.fillPoly closely enough for axis-aligned and
// convex text quads (the dataset's polygons).
void fill_poly(uint8_t* mask, int height, int width,
               const float* pts, int n_pts, uint8_t value) {
  if (n_pts < 3) return;
  std::vector<float> xs(n_pts), ys(n_pts);
  for (int i = 0; i < n_pts; ++i) {
    xs[i] = pts[2 * i];
    ys[i] = pts[2 * i + 1];
  }
  float ymin = *std::min_element(ys.begin(), ys.end());
  float ymax = *std::max_element(ys.begin(), ys.end());
  int y0 = std::max(0, (int)ymin);
  int y1 = std::min(height - 1, (int)ymax);

  std::vector<float> nodes;
  for (int y = y0; y <= y1; ++y) {
    nodes.clear();
    float fy = (float)y + 0.5f;
    for (int i = 0, j = n_pts - 1; i < n_pts; j = i++) {
      float yi = ys[i], yj = ys[j];
      if ((yi <= fy && yj > fy) || (yj <= fy && yi > fy)) {
        float t = (fy - yi) / (yj - yi);
        nodes.push_back(xs[i] + t * (xs[j] - xs[i]));
      }
    }
    std::sort(nodes.begin(), nodes.end());
    for (size_t k = 0; k + 1 < nodes.size(); k += 2) {
      int xa = std::max(0, (int)nodes[k]);
      int xb = std::min(width - 1, (int)nodes[k + 1]);
      if (xb >= xa) memset(mask + (size_t)y * width + xa, value, xb - xa + 1);
    }
  }
}

// 3x3 max (dilate) / min (erode) morphology, `iterations` passes.
static void morph3x3(uint8_t* mask, int height, int width, int iterations,
                     bool dilate) {
  std::vector<uint8_t> tmp((size_t)height * width);
  for (int it = 0; it < iterations; ++it) {
    for (int y = 0; y < height; ++y) {
      for (int x = 0; x < width; ++x) {
        // cv2 border semantics (morphologyDefaultBorderValue): out-of-bounds
        // neighbors are +inf for erode and -inf for dilate, i.e. SKIPPED for
        // both — treating them as 0 eroded away every border-touching mask
        uint8_t m = dilate ? 0 : 255;
        for (int dy = -1; dy <= 1; ++dy) {
          int yy = y + dy;
          if (yy < 0 || yy >= height) continue;
          for (int dx = -1; dx <= 1; ++dx) {
            int xx = x + dx;
            if (xx < 0 || xx >= width) continue;
            uint8_t v = mask[(size_t)yy * width + xx];
            m = dilate ? std::max(m, v) : std::min(m, v);
          }
        }
        tmp[(size_t)y * width + x] = m;
      }
    }
    memcpy(mask, tmp.data(), tmp.size());
  }
}

void dilate3x3(uint8_t* mask, int height, int width, int iterations) {
  morph3x3(mask, height, width, iterations, true);
}

void erode3x3(uint8_t* mask, int height, int width, int iterations) {
  morph3x3(mask, height, width, iterations, false);
}

// uint8 HWC image -> float32 in [-1, 1] (x / 127.5 - 1)
void normalize_pm1(const uint8_t* src, float* dst, int64_t n) {
  constexpr float kInv = 1.0f / 127.5f;
  for (int64_t i = 0; i < n; ++i) dst[i] = (float)src[i] * kInv - 1.0f;
}

// uint8 mask -> float32 in [0, 1]
void normalize_01(const uint8_t* src, float* dst, int64_t n) {
  constexpr float kInv = 1.0f / 255.0f;
  for (int64_t i = 0; i < n; ++i) dst[i] = (float)src[i] * kInv;
}

}  // extern "C"
