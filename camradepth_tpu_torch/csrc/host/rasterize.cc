// Host (CPU) code of the loader and the offline prep: the frame assembler,
// the wire encoder and the min-depth raster.
//
// The package's own copy of the raster, frame-assembly and wire sections of
// the JAX package's native/rasterize.cc, their arithmetic unchanged. Each
// assembly or wire function is one pass over a frame, written straight
// into the caller's preallocated buffer, with numpy's operation order,
// types and rounding: the outputs are bit for bit those of the numpy paths
// of data/channels.py and data/wire.py. The raster section serves the
// prep's lidar fusion (dataprep/lidar_fusion.py lidar_maps). The callers
// reach them through ctypes, which releases the interpreter lock for each
// call, so the loader's worker threads run them in parallel.
//
// Built with g++ (never nvcc) at first use by camradepth_tpu_torch/native.py:
//   g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off
// -ffp-contract=off keeps every multiply and add its own rounded operation
// on targets where FMA is baseline (aarch64); no -march=native, -ffast-math
// or -Ofast, any of which would break bit exactness with numpy.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Min-depth raster (dataprep/lidar_fusion.py lidar_maps; the reference's
// per-point z-buffer loops, fuse_radar.py:182-197, fuse_lidar.py:304-317):
// one O(N) pass, the least depth wins and of equal depths the first point.

// Min-depth-wins scatter of a flat point list.
//   pix:      [n] pixel ids (already quantized); id < 0 or >= n_pixels
//             drops the point
//   depth:    [n]
//   payload:  [n, n_channels] row-major (may be null when n_channels == 0)
//   out_depth:[n_pixels] (zero-initialized by caller)
//   out_payload: [n_pixels, n_channels]
void raster_min_depth(const int64_t* pix, const double* depth,
                      const double* payload, int64_t n, int64_t n_channels,
                      int64_t n_pixels, double* out_depth,
                      double* out_payload) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t p = pix[i];
    if (p < 0 || p >= n_pixels) continue;
    const double d = depth[i];
    const double cur = out_depth[p];
    // reference semantics: write if cell empty (0) or strictly smaller
    if (cur == 0.0 || cur > d) {
      out_depth[p] = d;
      if (n_channels > 0) {
        std::memcpy(out_payload + p * n_channels, payload + i * n_channels,
                    sizeof(double) * n_channels);
      }
    }
  }
}

// Quantize continuous full-res coords to pixel ids with the reference's
// center-aligned downsample mapping (fuse_radar.py:169-183):
//   q = round(clip((c + 0.5)/s - 0.5, 0, dim-1))
void quantize_pixels(const double* x, const double* y, const uint8_t* valid,
                     int64_t n, double scale, int64_t h_out, int64_t w_out,
                     int64_t* out_pix, double* out_xq, double* out_yq) {
  for (int64_t i = 0; i < n; ++i) {
    double xq = (x[i] + 0.5) / scale - 0.5;
    double yq = (y[i] + 0.5) / scale - 0.5;
    if (xq < 0) xq = 0;
    if (xq > w_out - 1) xq = w_out - 1;
    if (yq < 0) yq = 0;
    if (yq > h_out - 1) yq = h_out - 1;
    out_xq[i] = xq;
    out_yq[i] = yq;
    if (valid && !valid[i]) {
      out_pix[i] = -1;
    } else {
      const int64_t xi = llround(xq);
      const int64_t yi = llround(yq);
      out_pix[i] = yi * w_out + xi;
    }
  }
}

// Batched raster over F independent frames, one thread per frame chunk.
// offsets: [F+1] prefix ranges into the flat point arrays.
void raster_min_depth_batch(const int64_t* pix, const double* depth,
                            const double* payload, const int64_t* offsets,
                            int64_t n_frames, int64_t n_channels,
                            int64_t n_pixels, double* out_depth,
                            double* out_payload, int64_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  const int64_t frames_per = (n_frames + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t f0 = t * frames_per;
    const int64_t f1 = std::min(n_frames, f0 + frames_per);
    if (f0 >= f1) break;
    pool.emplace_back([=]() {
      for (int64_t f = f0; f < f1; ++f) {
        const int64_t a = offsets[f];
        const int64_t b = offsets[f + 1];
        raster_min_depth(pix + a, depth + a,
                         payload ? payload + a * n_channels : nullptr,
                         b - a, n_channels, n_pixels,
                         out_depth + f * n_pixels,
                         out_payload ? out_payload + f * n_pixels * n_channels
                                     : nullptr);
      }
    });
  }
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// Frame assembly (data/channels.py assemble_frame). Each channel group is
// written into the interleaved [H*W, C] float32 feature buffer in one pass.
// Reference semantics: dataloader.py:225-289.

void assemble_normalize_u8(const uint8_t* img, int64_t npix,
                           const float* mean, const float* stddev,
                           float* out, int64_t out_stride) {
  for (int64_t i = 0; i < npix; ++i) {
    const uint8_t* p = img + i * 3;
    float* o = out + i * out_stride;
    for (int c = 0; c < 3; ++c)
      o[c] = (static_cast<float>(p[c]) / 255.0f - mean[c]) / stddev[c];
  }
}

// Copy n_ch channels [ch0, ch0+n_ch) from a strided float32 input into the
// strided output, optionally clip to [lo, hi] then DIVIDE by div (numpy's
// `np.clip(x, lo, hi) / div` is a division — reproduce it, not a
// multiply-by-reciprocal). NaN propagates through the clip as in np.clip.
void assemble_scale_clip_f32(const float* in, int64_t npix, int64_t in_stride,
                             int64_t ch0, int64_t n_ch, int use_clip,
                             float lo, float hi, float div,
                             float* out, int64_t out_stride) {
  for (int64_t i = 0; i < npix; ++i) {
    const float* p = in + i * in_stride + ch0;
    float* o = out + i * out_stride;
    for (int64_t c = 0; c < n_ch; ++c) {
      float v = p[c];
      if (use_clip) {
        if (v < lo) v = lo;
        if (v > hi) v = hi;
      }
      o[c] = v / div;
    }
  }
}

// Same, float64 input: compute in double (numpy keeps the input dtype
// through clip/divide), cast to float32 at the store (astype).
void assemble_scale_clip_f64(const double* in, int64_t npix,
                             int64_t in_stride, int64_t ch0, int64_t n_ch,
                             int use_clip, double lo, double hi, double div,
                             float* out, int64_t out_stride) {
  for (int64_t i = 0; i < npix; ++i) {
    const double* p = in + i * in_stride + ch0;
    float* o = out + i * out_stride;
    for (int64_t c = 0; c < n_ch; ++c) {
      double v = p[c];
      if (use_clip) {
        if (v < lo) v = lo;
        if (v > hi) v = hi;
      }
      o[c] = static_cast<float>(v / div);
    }
  }
}

// GT inverse-depth encoding (dataloader.py:240-245, channels.py
// encode_inverse_depth): d = clip(depth, 0, max); out = d > 0 ?
// (max - d) / max : 0. float32 input -> float32.
void encode_inverse_depth_f32(const float* depth, int64_t npix, float maxd,
                              float* out) {
  for (int64_t i = 0; i < npix; ++i) {
    float d = depth[i];
    if (d < 0.0f) d = 0.0f;
    if (d > maxd) d = maxd;
    out[i] = (d > 0.0f) ? (maxd - d) / maxd : 0.0f;
  }
}

// float64 input: compute in double, cast at the store (numpy astype).
void encode_inverse_depth_f64(const double* depth, int64_t npix, double maxd,
                              float* out) {
  for (int64_t i = 0; i < npix; ++i) {
    double d = depth[i];
    if (d < 0.0) d = 0.0;
    if (d > maxd) d = maxd;
    out[i] = (d > 0.0) ? static_cast<float>((maxd - d) / maxd) : 0.0f;
  }
}

// Nearest-neighbor gather for the seg-label resize: row/col indices are
// precomputed in Python (skimage order-0 convention, channels.py
// resize_order0), this is just the GIL-free int gather + int32 cast.
void gather_rows_cols_i64_to_i32(const int64_t* in, int64_t w_in,
                                 const int64_t* ri, const int64_t* ci,
                                 int64_t h_out, int64_t w_out, int32_t* out) {
  for (int64_t r = 0; r < h_out; ++r) {
    const int64_t* row = in + ri[r] * w_in;
    int32_t* o = out + r * w_out;
    for (int64_t c = 0; c < w_out; ++c)
      o[c] = static_cast<int32_t>(row[ci[c]]);
  }
}

void gather_rows_cols_i32_to_i32(const int32_t* in, int64_t w_in,
                                 const int64_t* ri, const int64_t* ci,
                                 int64_t h_out, int64_t w_out, int32_t* out) {
  for (int64_t r = 0; r < h_out; ++r) {
    const int32_t* row = in + ri[r] * w_in;
    int32_t* o = out + r * w_out;
    for (int64_t c = 0; c < w_out; ++c)
      o[c] = row[ci[c]];
  }
}

// ---------------------------------------------------------------------------
// Wire encode (data/wire.py encode_frame_wire): the union-nonzero mask and
// its gathers, the fused inverse-depth encode and sparsify, and the uint8
// seg-label resize, each one pass.

// Union-nonzero over up to 4 strided rasters, ascending pixel order.
// Writes at most `cap` indices; RETURNS the true total count (callers
// detect overflow as count > cap). NaN counts as nonzero (v != 0), -0.0
// does not — numpy's `!= 0` semantics.
int64_t wire_union_nonzero_f32(const float* s0, int64_t st0,
                               const float* s1, int64_t st1,
                               const float* s2, int64_t st2,
                               const float* s3, int64_t st3,
                               int64_t npix, int32_t* out_idx,
                               int64_t cap) {
  int64_t n = 0;
  for (int64_t i = 0; i < npix; ++i) {
    bool hit = (s0 && s0[i * st0] != 0.0f) || (s1 && s1[i * st1] != 0.0f) ||
               (s2 && s2[i * st2] != 0.0f) || (s3 && s3[i * st3] != 0.0f);
    if (hit) {
      if (n < cap) out_idx[n] = static_cast<int32_t>(i);
      ++n;
    }
  }
  return n;
}

int64_t wire_union_nonzero_f64(const double* s0, int64_t st0,
                               const double* s1, int64_t st1,
                               const double* s2, int64_t st2,
                               const double* s3, int64_t st3,
                               int64_t npix, int32_t* out_idx,
                               int64_t cap) {
  int64_t n = 0;
  for (int64_t i = 0; i < npix; ++i) {
    bool hit = (s0 && s0[i * st0] != 0.0) || (s1 && s1[i * st1] != 0.0) ||
               (s2 && s2[i * st2] != 0.0) || (s3 && s3[i * st3] != 0.0);
    if (hit) {
      if (n < cap) out_idx[n] = static_cast<int32_t>(i);
      ++n;
    }
  }
  return n;
}

// Gather src[idx[i] * stride] with numpy's `np.clip(v, lo, hi) / div`
// (computed in the source dtype, cast f32 at the store; NaN propagates
// through clip and divide) into a strided output column.
void wire_gather_f32(const float* src, int64_t stride, const int32_t* idx,
                     int64_t n, int use_clip, float lo, float hi,
                     float div, float* out, int64_t out_stride) {
  for (int64_t i = 0; i < n; ++i) {
    float v = src[static_cast<int64_t>(idx[i]) * stride];
    if (use_clip) {
      if (v < lo) v = lo;
      if (v > hi) v = hi;
    }
    out[i * out_stride] = v / div;
  }
}

void wire_gather_f64(const double* src, int64_t stride, const int32_t* idx,
                     int64_t n, int use_clip, double lo, double hi,
                     double div, float* out, int64_t out_stride) {
  for (int64_t i = 0; i < n; ++i) {
    double v = src[static_cast<int64_t>(idx[i]) * stride];
    if (use_clip) {
      if (v < lo) v = lo;
      if (v > hi) v = hi;
    }
    out[i * out_stride] = static_cast<float>(v / div);
  }
}

// Fused inverse-depth encode + sparsify: emits (idx, enc) for every pixel
// whose FLOAT32 encoding is nonzero (the numpy path casts to f32 before
// flatnonzero, so d == max_depth and f32-underflow pixels are excluded
// identically). Writes at most `cap` points; returns the true count.
int64_t wire_gt_sparse_f32(const float* depth, int64_t stride, int64_t npix,
                           float maxd, int32_t* out_idx, float* out_val,
                           int64_t cap) {
  int64_t n = 0;
  for (int64_t i = 0; i < npix; ++i) {
    float d = depth[i * stride];
    if (d < 0.0f) d = 0.0f;
    if (d > maxd) d = maxd;
    const float e = (d > 0.0f) ? (maxd - d) / maxd : 0.0f;
    if (e != 0.0f) {
      if (n < cap) {
        out_idx[n] = static_cast<int32_t>(i);
        out_val[n] = e;
      }
      ++n;
    }
  }
  return n;
}

int64_t wire_gt_sparse_f64(const double* depth, int64_t stride, int64_t npix,
                           double maxd, int32_t* out_idx, float* out_val,
                           int64_t cap) {
  int64_t n = 0;
  for (int64_t i = 0; i < npix; ++i) {
    double d = depth[i * stride];
    if (d < 0.0) d = 0.0;
    if (d > maxd) d = maxd;
    const float e =
        (d > 0.0) ? static_cast<float>((maxd - d) / maxd) : 0.0f;
    if (e != 0.0f) {
      if (n < cap) {
        out_idx[n] = static_cast<int32_t>(i);
        out_val[n] = e;
      }
      ++n;
    }
  }
  return n;
}

// Nearest gather to uint8 with range validation (wire seg labels must fit
// a byte). Returns 0 on success, 1 when any gathered value is outside
// [0, 255] — callers fall back to the numpy path for the descriptive
// error.
int gather_rows_cols_i64_to_u8(const int64_t* in, int64_t w_in,
                               const int64_t* ri, const int64_t* ci,
                               int64_t h_out, int64_t w_out, uint8_t* out) {
  for (int64_t r = 0; r < h_out; ++r) {
    const int64_t* row = in + ri[r] * w_in;
    uint8_t* o = out + r * w_out;
    for (int64_t c = 0; c < w_out; ++c) {
      const int64_t v = row[ci[c]];
      if (v < 0 || v > 255) return 1;
      o[c] = static_cast<uint8_t>(v);
    }
  }
  return 0;
}

int gather_rows_cols_i32_to_u8(const int32_t* in, int64_t w_in,
                               const int64_t* ri, const int64_t* ci,
                               int64_t h_out, int64_t w_out, uint8_t* out) {
  for (int64_t r = 0; r < h_out; ++r) {
    const int32_t* row = in + ri[r] * w_in;
    uint8_t* o = out + r * w_out;
    for (int64_t c = 0; c < w_out; ++c) {
      const int32_t v = row[ci[c]];
      if (v < 0 || v > 255) return 1;
      o[c] = static_cast<uint8_t>(v);
    }
  }
  return 0;
}


}  // extern "C"
