// Host-side union-find merge of mean-shift segmentation (a source of the
// port's own beside ccl.cpp, built into the same library).
//
// Reference analog: boofcv-feature alg/segmentation/ms/
// MergeRegionMeanShift; the JAX package runs this loop in Python
// (boofcv_tpu/feature/segmentation.py segment_mean_shift, with
// boofcv_tpu/utils/unionfind.py).  This is the same loop in the same
// order, so the roots, and with them the label numbering, are the
// reference's: pixels in raster order, each first joined with its right
// neighbour, then with the one below, where the similarity mask says so;
// union(a, b) points b's root at a's; find halves the path.
//   right: h*w uint8, 1 where pixel i joins i+1 (last column ignored)
//   down:  h*w uint8, 1 where pixel i joins i+w (last row ignored)
//   roots: h*w int64 out, the root id of every pixel

#include <cstdint>
#include <vector>

extern "C" void boofcv_mean_shift_merge(const uint8_t* right,
                                        const uint8_t* down, int32_t h,
                                        int32_t w, int64_t* roots) {
  const int64_t n = (int64_t)h * w;
  std::vector<int64_t> parent(n);
  for (int64_t i = 0; i < n; ++i) parent[i] = i;
  auto find = [&](int64_t a) {
    while (parent[a] != a) {
      parent[a] = parent[parent[a]];
      a = parent[a];
    }
    return a;
  };
  auto unite = [&](int64_t a, int64_t b) {
    const int64_t ra = find(a), rb = find(b);
    if (ra != rb) parent[rb] = ra;
  };
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const int64_t i = (int64_t)y * w + x;
      if (x + 1 < w && right[i]) unite(i, i + 1);
      if (y + 1 < h && down[i]) unite(i, i + w);
    }
  }
  for (int64_t i = 0; i < n; ++i) roots[i] = find(i);
}
