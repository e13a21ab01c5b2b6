// Native disk-splatting rasterizer for the headless renderer.
//
// Headless counterpart of the reference's GPU point-sprite renderer
// (render.cpp + shaders.cpp): the simulator needs no display or GL
// stack, so frames are rasterized on the host CPU.  The hot loop — one
// bounding-box scan per disk — lives here; Python falls back to a numpy
// implementation when this library isn't built (see render/native.py).
//
// Build: make -C native   ->  libpbot_render.so

#include <cmath>
#include <cstdint>

extern "C" {

// img: (h, w, 3) uint8, row-major RGB.
// xs/ys: pixel centers; rs: pixel radii; cols: (n, 3) uint8.
void splat_disks(uint8_t *img, int h, int w, const float *xs, const float *ys,
                 const float *rs, const uint8_t *cols, int n) {
  for (int i = 0; i < n; ++i) {
    const float x = xs[i], y = ys[i], r = rs[i];
    if (r <= 0.0f)
      continue;
    int x0 = (int)std::floor(x - r), x1 = (int)std::ceil(x + r);
    int y0 = (int)std::floor(y - r), y1 = (int)std::ceil(y + r);
    if (x0 < 0)
      x0 = 0;
    if (y0 < 0)
      y0 = 0;
    if (x1 > w - 1)
      x1 = w - 1;
    if (y1 > h - 1)
      y1 = h - 1;
    const float r2 = r * r;
    const uint8_t cr = cols[i * 3 + 0], cg = cols[i * 3 + 1],
                  cb = cols[i * 3 + 2];
    for (int py = y0; py <= y1; ++py) {
      const float dy = (float)py - y;
      const float span2 = r2 - dy * dy;
      if (span2 < 0.0f)
        continue;
      const float span = std::sqrt(span2);
      int sx0 = (int)std::ceil(x - span), sx1 = (int)std::floor(x + span);
      if (sx0 < x0)
        sx0 = x0;
      if (sx1 > x1)
        sx1 = x1;
      uint8_t *row = img + ((size_t)py * w + sx0) * 3;
      for (int px = sx0; px <= sx1; ++px) {
        row[0] = cr;
        row[1] = cg;
        row[2] = cb;
        row += 3;
      }
    }
  }
}

// Convert float RGBA [0,1] colors to uint8 RGB (bulk helper).
void rgba_to_rgb8(const float *rgba, uint8_t *out, int n) {
  for (int i = 0; i < n; ++i) {
    for (int c = 0; c < 3; ++c) {
      float v = rgba[i * 4 + c];
      if (v < 0.0f)
        v = 0.0f;
      if (v > 1.0f)
        v = 1.0f;
      out[i * 3 + c] = (uint8_t)(v * 255.0f + 0.5f);
    }
  }
}

}  // extern "C"
