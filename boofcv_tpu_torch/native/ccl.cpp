// Native host-side finishers for binary-image analysis (the port's copy of
// boofcv_tpu/native/ccl.cpp: everything below this header is the
// reference's source unchanged, which tests/test_torch_binary.py checks).
//
// Reference analogs (BoofCV):
//   - connected-component labeling: main/boofcv-ip .../alg/filter/binary/
//     LinearContourLabelChang2004.java:59 (union-find labeling)
//   - external contour tracing: .../alg/filter/binary/LinearExternalContours.java
//
// These are the inherently sequential parts of the binary pipeline; the
// device path (thresholding, morphology, min-label propagation CCL) stays
// in PyTorch, and this module is the host finisher for detectors that need
// per-blob contours (fiducials, QR, calibration targets).  It is built with
// g++ at first use and loaded through ctypes
// (boofcv_tpu_torch/native/__init__.py); a failed build raises.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <functional>

extern "C" {

// Two-pass union-find connected-component labeling.
//   img:  h*w uint8 (0 = background, nonzero = foreground)
//   out:  h*w int32 labels; 0 background, components numbered 1..N in
//         raster order of their first (top-left-most) pixel.
// Returns N (number of components).
int32_t boofcv_ccl(const uint8_t* img, int32_t h, int32_t w, int32_t eight,
                   int32_t* out) {
  std::vector<int32_t> parent(1, 0);  // parent[0] unused (background)
  auto find = [&](int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  auto unite = [&](int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (a < b) parent[b] = a; else parent[a] = b;
  };

  // first pass: provisional labels from W / NW / N / NE neighbors
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const int64_t i = (int64_t)y * w + x;
      if (!img[i]) { out[i] = 0; continue; }
      int32_t lbl = 0;
      if (x > 0 && out[i - 1]) lbl = out[i - 1];
      if (y > 0) {
        const int64_t up = i - w;
        if (out[up]) { if (lbl) unite(lbl, out[up]); else lbl = out[up]; }
        if (eight) {
          if (x > 0 && out[up - 1]) {
            if (lbl) unite(lbl, out[up - 1]); else lbl = out[up - 1];
          }
          if (x + 1 < w && out[up + 1]) {
            if (lbl) unite(lbl, out[up + 1]); else lbl = out[up + 1];
          }
        }
      }
      if (!lbl) {
        lbl = (int32_t)parent.size();
        parent.push_back(lbl);
      }
      out[i] = lbl;
    }
  }

  // second pass: resolve + renumber in raster order of first appearance
  std::vector<int32_t> remap(parent.size(), 0);
  int32_t next = 0;
  for (int64_t i = 0; i < (int64_t)h * w; ++i) {
    if (!out[i]) continue;
    const int32_t r = find(out[i]);
    if (!remap[r]) remap[r] = ++next;
    out[i] = remap[r];
  }
  return next;
}

// External contour tracing (Moore neighborhood, clockwise radial sweep),
// byte-for-byte equivalent to boofcv_tpu.ip.binary.contour_external.
//   img:        h*w uint8 binary
//   out_xy:     capacity*2 int32 buffer, filled with (x, y) pairs
//   out_starts: (max_contours+1) int32; contour c is
//               out_xy[out_starts[c] .. out_starts[c+1])
//   returns number of contours, or -1 if a capacity was exceeded.
int32_t boofcv_external_contours(const uint8_t* img, int32_t h, int32_t w,
                                 int32_t* out_xy, int64_t capacity,
                                 int32_t* out_starts, int32_t max_contours) {
  const int32_t H = h + 2, W = w + 2;
  // padded foreground + per-pixel "traced" flag + per-(pixel,dir) seen bits
  std::vector<uint8_t> pad((size_t)H * W, 0);
  std::vector<uint8_t> traced((size_t)H * W, 0);
  std::vector<uint8_t> seen((size_t)H * W, 0);  // bit d set = state visited
  for (int32_t y = 0; y < h; ++y)
    for (int32_t x = 0; x < w; ++x)
      pad[(size_t)(y + 1) * W + (x + 1)] = img[(int64_t)y * w + x] != 0;

  // Moore neighborhood (dy, dx), clockwise starting from W — must match the
  // Python tracer's table exactly.
  static const int32_t DY[8] = {0, -1, -1, -1, 0, 1, 1, 1};
  static const int32_t DX[8] = {-1, -1, 0, 1, 1, 1, 0, -1};

  int64_t np_total = 0;
  int32_t nc = 0;
  for (int32_t y = 1; y <= h; ++y) {
    for (int32_t x = 1; x <= w; ++x) {
      const size_t p = (size_t)y * W + x;
      if (!pad[p] || traced[p] || pad[p - 1]) continue;
      if (nc >= max_contours) return -1;
      // first fg neighbor, searching NW,N,NE,E,SE,S,SW,W (i = 1..8 mod 8)
      int32_t first = -1;
      for (int32_t i = 1; i <= 8; ++i) {
        const int32_t dd = i % 8;
        if (pad[(size_t)(y + DY[dd]) * W + (x + DX[dd])]) { first = dd; break; }
      }
      out_starts[nc] = (int32_t)np_total;
      if (first < 0) {  // isolated pixel
        traced[p] = 1;
        if (np_total + 1 > capacity) return -1;
        out_xy[np_total * 2] = x - 1;
        out_xy[np_total * 2 + 1] = y - 1;
        ++np_total;
        ++nc;
        continue;
      }
      int32_t cy = y, cx = x, d = first;
      while (!(seen[(size_t)cy * W + cx] & (1u << d))) {
        seen[(size_t)cy * W + cx] |= (uint8_t)(1u << d);
        if (np_total + 1 > capacity) return -1;
        out_xy[np_total * 2] = cx - 1;
        out_xy[np_total * 2 + 1] = cy - 1;
        ++np_total;
        traced[(size_t)cy * W + cx] = 1;
        cy += DY[d];
        cx += DX[d];
        for (int32_t i = 0; i < 8; ++i) {
          const int32_t dd = (d + 6 + i) % 8;
          if (pad[(size_t)(cy + DY[dd]) * W + (cx + DX[dd])]) { d = dd; break; }
        }
      }
      ++nc;
    }
  }
  if (nc < max_contours + 1) out_starts[nc] = (int32_t)np_total;
  return nc;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Felzenszwalb-Huttenlocher 2004 graph segmentation (host-side finisher).
// Reference analog: boofcv-feature
//   alg/segmentation/fh04/SegmentFelzenszwalbHuttenlocher04.java:81
// The per-pixel edge weights are computed on the TPU (jnp); this routine is
// the inherently sequential sorted-edge union-find merge.
//   wr:  h*w float, weight of edge (y,x)->(y,x+1), last column ignored
//   wd:  h*w float, weight of edge (y,x)->(y+1,x), last row ignored
//   wdr/wdl: diagonal edges (y,x)->(y+1,x+1) / (y,x)->(y+1,x-1); pass
//            nullptr-equivalent (use_diag=0) for 4-connectivity
// Output: compact labels 0..N-1 in raster order of first pixel; returns N.
extern "C" int32_t boofcv_fh04(const float* wr, const float* wd,
                               const float* wdr, const float* wdl,
                               int32_t h, int32_t w, int32_t use_diag,
                               float k, int32_t min_size, int32_t* out) {
  const int64_t n = (int64_t)h * w;
  std::vector<int32_t> parent(n);
  std::vector<int32_t> size(n, 1);
  std::vector<float> thresh(n, k);
  for (int64_t i = 0; i < n; ++i) parent[i] = (int32_t)i;
  std::function<int32_t(int32_t)> find = [&](int32_t x) {
    while (parent[x] != x) { parent[x] = parent[parent[x]]; x = parent[x]; }
    return x;
  };

  struct Edge { float w; int32_t a, b; };
  std::vector<Edge> edges;
  edges.reserve((size_t)n * (use_diag ? 4 : 2));
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const int32_t i = y * w + x;
      if (x + 1 < w) edges.push_back({wr[i], i, i + 1});
      if (y + 1 < h) edges.push_back({wd[i], i, i + w});
      if (use_diag && y + 1 < h) {
        if (x + 1 < w) edges.push_back({wdr[i], i, i + w + 1});
        if (x > 0) edges.push_back({wdl[i], i, i + w - 1});
      }
    }
  }
  std::sort(edges.begin(), edges.end(),
            [](const Edge& a, const Edge& b) { return a.w < b.w; });

  for (const Edge& e : edges) {
    int32_t ra = find(e.a), rb = find(e.b);
    if (ra == rb) continue;
    if (e.w <= thresh[ra] && e.w <= thresh[rb]) {
      if (size[ra] < size[rb]) std::swap(ra, rb);
      parent[rb] = ra;
      size[ra] += size[rb];
      thresh[ra] = e.w + k / (float)size[ra];
    }
  }
  // enforce minimum region size: merge along edges in weight order
  if (min_size > 1) {
    for (const Edge& e : edges) {
      int32_t ra = find(e.a), rb = find(e.b);
      if (ra == rb) continue;
      if (size[ra] < min_size || size[rb] < min_size) {
        if (size[ra] < size[rb]) std::swap(ra, rb);
        parent[rb] = ra;
        size[ra] += size[rb];
      }
    }
  }
  // compact labels in raster order of the first pixel of each root
  std::vector<int32_t> label(n, -1);
  int32_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t r = find((int32_t)i);
    if (label[r] < 0) label[r] = next++;
    out[i] = label[r];
  }
  return next;
}


// ---------------------------------------------------------------------------
// Full Chang-2004 contour extraction: external AND internal (hole) contours,
// each tagged with its blob label — the complete LinearContourLabelChang2004
// behavior (ip/binary.contours_with_holes is the Python fallback).
//   out_xy:     capacity*2 int32 (x, y) pairs
//   out_starts: (max_contours+1) int32 offsets
//   out_meta:   max_contours*2 int32 (blob_label, kind: 0=external 1=hole)
// Returns contour count, or -1 if a capacity was exceeded.
extern "C" int32_t boofcv_contours_with_holes(
    const uint8_t* img, int32_t h, int32_t w, int32_t* out_xy,
    int64_t capacity, int32_t* out_starts, int32_t max_contours,
    int32_t* out_meta) {
  const int32_t H = h + 2, W = w + 2;
  static const int32_t DY[8] = {0, -1, -1, -1, 0, 1, 1, 1};
  static const int32_t DX[8] = {-1, -1, 0, 1, 1, 1, 0, -1};

  // blob labels (8-connected) for tagging
  std::vector<int32_t> labels((size_t)h * w);
  boofcv_ccl(img, h, w, 1, labels.data());

  std::vector<uint8_t> pad((size_t)H * W, 0);
  for (int32_t y = 0; y < h; ++y)
    for (int32_t x = 0; x < w; ++x)
      pad[(size_t)(y + 1) * W + (x + 1)] = img[(int64_t)y * w + x] != 0;
  std::vector<uint8_t> traced((size_t)H * W, 0);
  // per-(pixel, dir) trace-epoch stamps: a state terminates only its OWN
  // trace (external and hole walks of a 1-px-wide blob can share states)
  std::vector<int32_t> epoch((size_t)H * W * 8, -1);

  int64_t np_total = 0;
  int32_t nc = 0;

  // returns 0 ok, -1 capacity exceeded
  auto trace = [&](int32_t y, int32_t x, int32_t backtrack, int32_t kind,
                   uint8_t* traced_map) -> int32_t {
    if (nc >= max_contours) return -1;
    int32_t first = -1;
    for (int32_t i = 1; i <= 8; ++i) {
      const int32_t dd = (backtrack + i) % 8;
      if (pad[(size_t)(y + DY[dd]) * W + (x + DX[dd])]) { first = dd; break; }
    }
    out_starts[nc] = (int32_t)np_total;
    out_meta[nc * 2] = labels[(int64_t)(y - 1) * w + (x - 1)];
    out_meta[nc * 2 + 1] = kind;
    if (first < 0) {  // isolated pixel
      traced_map[(size_t)y * W + x] = 1;
      if (np_total + 1 > capacity) return -1;
      out_xy[np_total * 2] = x - 1;
      out_xy[np_total * 2 + 1] = y - 1;
      ++np_total;
      ++nc;
      return 0;
    }
    const int32_t my_epoch = nc;
    int32_t cy = y, cx = x, d = first;
    while (epoch[((size_t)cy * W + cx) * 8 + d] != my_epoch) {
      epoch[((size_t)cy * W + cx) * 8 + d] = my_epoch;
      if (np_total + 1 > capacity) return -1;
      out_xy[np_total * 2] = cx - 1;
      out_xy[np_total * 2 + 1] = cy - 1;
      ++np_total;
      traced_map[(size_t)cy * W + cx] = 1;
      cy += DY[d];
      cx += DX[d];
      for (int32_t i = 0; i < 8; ++i) {
        const int32_t dd = (d + 6 + i) % 8;
        if (pad[(size_t)(cy + DY[dd]) * W + (cx + DX[dd])]) { d = dd; break; }
      }
    }
    ++nc;
    return 0;
  };

  // external pass (raster entry from the west, backtrack W = index 0)
  for (int32_t y = 1; y <= h; ++y)
    for (int32_t x = 1; x <= w; ++x) {
      const size_t p = (size_t)y * W + x;
      if (!pad[p] || traced[p] || pad[p - 1]) continue;
      if (trace(y, x, 0, 0, traced.data()) < 0) return -1;
    }

  // holes: 4-connected background components not touching the border
  std::vector<uint8_t> inv((size_t)h * w);
  for (int64_t i = 0; i < (int64_t)h * w; ++i) inv[i] = img[i] == 0;
  std::vector<int32_t> bg((size_t)h * w);
  const int32_t n_bg = boofcv_ccl(inv.data(), h, w, 0, bg.data());
  std::vector<uint8_t> border((size_t)n_bg + 1, 0);
  for (int32_t x = 0; x < w; ++x) {
    if (bg[x]) border[bg[x]] = 1;
    if (bg[(int64_t)(h - 1) * w + x]) border[bg[(int64_t)(h - 1) * w + x]] = 1;
  }
  for (int32_t y = 0; y < h; ++y) {
    if (bg[(int64_t)y * w]) border[bg[(int64_t)y * w]] = 1;
    if (bg[(int64_t)y * w + w - 1]) border[bg[(int64_t)y * w + w - 1]] = 1;
  }
  // first raster pixel of each hole IS its topmost-leftmost pixel
  std::vector<uint8_t> started((size_t)n_bg + 1, 0);
  std::vector<uint8_t> hole_traced((size_t)H * W, 0);
  for (int32_t y = 0; y < h; ++y)
    for (int32_t x = 0; x < w; ++x) {
      const int32_t hid = bg[(int64_t)y * w + x];
      if (!hid || border[hid] || started[hid]) continue;
      started[hid] = 1;
      // blob pixel directly above; backtrack points south into the hole
      if (trace(y /*padded y of pixel above = (y-1)+1*/, x + 1, 6, 1,
                hole_traced.data()) < 0)
        return -1;
    }
  if (nc < max_contours + 1) out_starts[nc] = (int32_t)np_total;
  return nc;
}
