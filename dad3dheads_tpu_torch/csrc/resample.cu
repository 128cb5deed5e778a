// Crop + resize + normalize of uint8 full frames into the network's input:
//
//   out[b, y, x, c] = scale[c] * sum_h sum_w Wy[y, h] * frame[b, h, w, c] * Wx[x, w] + bias[c]
//
// Replaces: dad3dheads_tpu/ops/preprocess_pallas.py, resample_normalize_pallas
// (its Pallas kernels _resample_kernel_single and _resample_kernel), the
// device preprocess of the frames serving path.
//
// Weights. Wy and Wx are never stored: each output row or column computes its
// own non-zero taps from the image's ten int32 scalars [y0, bh, new_h, pad_top,
// x0, bw, new_w, pad_left, use_area, use_exact_area], with the fp32 formulas of
// _axis_weights in dad3dheads_tpu/ops/preprocess_device.py, each product, sum
// and quotient rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn: no FMA
// contraction), so that tap boundaries fall where the plain version puts them:
//   - exact INTER_AREA: source pixels [floor(lo + r*f), ceil(lo + (r+1)*f)),
//     weight = overlap of [s, s+1) with the box, divided by f;
//   - cv2's generic 2-tap area fallback and INTER_LINEAR half-pixel taps: two
//     indices clamped to the crop; where both land on one pixel their weights
//     are added first, as the dense weight row does.
// Output rows and columns outside [pad, pad + new_len) have no taps and come
// out as bias[c].
//
// What bounds it on the H100: memory. It has to read the crop's uint8 bytes
// once and write the output once; the multiply-adds are a few per byte (about
// f + 2 taps per axis on a downscale), far below the fp32 rate.
//
// Design: two passes, no shared memory.
//   1. rows: one thread per (image, output row, source byte of the crop's
//      columns) sums the row taps over the source rows it needs and writes an
//      fp32 scratch row (B, S, 3 * Wmax). Source rows outside the crop are never
//      read, whatever the frame's height: there is one kernel for any Hmax.
//      Neighbouring threads read neighbouring bytes of one source row.
//   2. columns + normalize: one thread per output element (x, c) of a row sums
//      the column taps over the scratch row, applies scale and bias and stores
//      fp32 or bf16 (rounded once, at the store) in NHWC, the layout the network
//      reads.
// The source may be channel-planar (B, Hmax, 3 * Wmax), the wire format of
// pack_frames_host(planar=True), or NHWC (B, Hmax, Wmax, 3); both have rows of
// 3 * Wmax bytes, and only the byte offset of (column, channel) differs. Bytes
// are read one by one, so a ragged Wmax needs no alignment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int NSCALARS = 10;

enum Mode { AREA = 0, GEN2 = 1, LINEAR = 2 };

struct Norm {
  float scale[3];
  float bias[3];
};

// One axis of one image: crop window [crop_lo, crop_lo + crop_len) resized to
// new_len pixels placed at pad_lo.
struct Axis {
  int crop_lo, crop_len, new_len, pad_lo;
};

__device__ __forceinline__ int image_mode(const int* s) {
  return s[8] != 0 ? (s[9] != 0 ? AREA : GEN2) : LINEAR;
}

__device__ __forceinline__ float clip_index(float v, float hi) {
  return fminf(fmaxf(v, 0.0f), hi);
}

// sum over the non-zero taps s of output position r (0 <= r < new_len) of
// weight(s) * value(s), with source indices limited to [0, src_max).
template <typename Value>
__device__ __forceinline__ float sum_taps(int mode, const Axis& a, int r, int src_max,
                                          const Value& value) {
  const float rf = static_cast<float>(r);
  const float lo = static_cast<float>(a.crop_lo);
  const float f = __fdiv_rn(static_cast<float>(a.crop_len),
                            fmaxf(static_cast<float>(a.new_len), 1.0f));
  if (mode == AREA) {
    const float box_lo = __fadd_rn(lo, __fmul_rn(rf, f));
    const float box_hi = __fadd_rn(box_lo, f);
    const int s_begin = max(static_cast<int>(floorf(box_lo)), 0);
    const int s_end = min(static_cast<int>(ceilf(box_hi)), src_max);
    float acc = 0.0f;
    for (int s = s_begin; s < s_end; ++s) {
      const float sf = static_cast<float>(s);
      const float overlap = __fsub_rn(fminf(__fadd_rn(sf, 1.0f), box_hi), fmaxf(sf, box_lo));
      const float w = __fdiv_rn(fmaxf(overlap, 0.0f), f);
      acc = fmaf(w, value(s), acc);
    }
    return acc;
  }
  const float hi_idx = static_cast<float>(a.crop_len) - 1.0f;
  float p0, w1;  // first tap's position relative to the crop, second tap's weight
  if (mode == GEN2) {
    // s0 = floor(r*f); fx = (r + 1) - (s0 + 1) / f; single tap when fx <= 0
    p0 = floorf(__fmul_rn(rf, f));
    const float fx = __fsub_rn(__fadd_rn(rf, 1.0f), __fdiv_rn(__fadd_rn(p0, 1.0f), f));
    w1 = fx <= 0.0f ? 0.0f : fx;
  } else {
    // half-pixel source position r*f + 0.5*f - 0.5
    const float pos = __fsub_rn(__fadd_rn(__fmul_rn(rf, f), __fmul_rn(0.5f, f)), 0.5f);
    p0 = floorf(pos);
    w1 = __fsub_rn(pos, p0);
  }
  const float w0 = __fsub_rn(1.0f, w1);
  const int g0 = a.crop_lo + static_cast<int>(clip_index(p0, hi_idx));
  const int g1 = a.crop_lo + static_cast<int>(clip_index(__fadd_rn(p0, 1.0f), hi_idx));
  if (g0 == g1) return __fmul_rn(__fadd_rn(w0, w1), value(g0));
  return fmaf(w1, value(g1), __fmul_rn(w0, value(g0)));
}

// Source columns [x0, x0 + win) that the column taps can reach: the crop and
// one more, for an area box whose rounded end passes the crop's by an ulp.
__device__ __forceinline__ int column_window(const int* s, int Wmax) {
  return min(s[5] + 1, Wmax - s[4]);
}

template <bool PLANAR>
__global__ void __launch_bounds__(THREADS)
resample_rows_kernel(const uint8_t* __restrict__ frames, const int* __restrict__ scalars,
                     float* __restrict__ tmp, int Hmax, int Wmax, int S) {
  const int b = blockIdx.z;
  const int y = blockIdx.y;
  const int* s = scalars + b * NSCALARS;
  const Axis ay = {s[0], s[1], s[2], s[3]};
  const int r = y - ay.pad_lo;
  if (r < 0 || r >= ay.new_len) return;  // a padding row: the columns pass writes bias
  const int x0 = s[4];
  const int win = column_window(s, Wmax);
  const int k = blockIdx.x * THREADS + threadIdx.x;  // scratch index within the row
  if (k >= 3 * win) return;
  int col;  // byte offset of (column x0 + j, channel c) within a source row
  if (PLANAR) {
    const int c = k / win;
    col = c * Wmax + x0 + (k - c * win);
  } else {
    col = 3 * x0 + k;
  }
  const long long row_bytes = 3LL * Wmax;
  const uint8_t* src = frames + static_cast<long long>(b) * Hmax * row_bytes + col;
  const float v = sum_taps(image_mode(s), ay, r, Hmax, [&](int h) {
    return static_cast<float>(src[h * row_bytes]);
  });
  tmp[(static_cast<long long>(b) * S + y) * row_bytes + k] = v;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <bool PLANAR, typename Out>
__global__ void __launch_bounds__(THREADS)
resample_cols_kernel(const float* __restrict__ tmp, const int* __restrict__ scalars,
                     Out* __restrict__ out, int Wmax, int S, Norm p) {
  const int b = blockIdx.z;
  const int y = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;  // x * 3 + c within the output row
  if (i >= 3 * S) return;
  const int x = i / 3;
  const int c = i - 3 * x;
  const int* s = scalars + b * NSCALARS;
  const int ry = y - s[3];
  const Axis ax = {s[4], s[5], s[6], s[7]};
  const int rx = x - ax.pad_lo;
  float acc = 0.0f;
  if (ry >= 0 && ry < s[2] && rx >= 0 && rx < ax.new_len) {
    const int win = column_window(s, Wmax);
    const float* row = tmp + (static_cast<long long>(b) * S + y) * 3LL * Wmax;
    acc = sum_taps(image_mode(s), ax, rx, Wmax, [&](int w) {
      const int j = w - ax.crop_lo;
      return row[PLANAR ? c * win + j : 3 * j + c];
    });
  }
  const float v = __fadd_rn(__fmul_rn(acc, p.scale[c]), p.bias[c]);
  store(out + (static_cast<long long>(b) * S + y) * 3LL * S + i, v);
}

template <bool PLANAR>
void launch(const uint8_t* frames, const int* scalars, float* tmp, void* out, int B, int Hmax,
            int Wmax, int S, bool out_bf16, const Norm& p, cudaStream_t stream) {
  const dim3 rows_grid((3 * Wmax + THREADS - 1) / THREADS, S, B);
  resample_rows_kernel<PLANAR><<<rows_grid, THREADS, 0, stream>>>(frames, scalars, tmp, Hmax,
                                                                  Wmax, S);
  const dim3 cols_grid((3 * S + THREADS - 1) / THREADS, S, B);
  if (out_bf16) {
    resample_cols_kernel<PLANAR><<<cols_grid, THREADS, 0, stream>>>(
        tmp, scalars, static_cast<__nv_bfloat16*>(out), Wmax, S, p);
  } else {
    resample_cols_kernel<PLANAR><<<cols_grid, THREADS, 0, stream>>>(
        tmp, scalars, static_cast<float*>(out), Wmax, S, p);
  }
}

}  // namespace

// frames (B, Hmax, 3*Wmax) planar or (B, Hmax, Wmax, 3) uint8, scalars (B, 10)
// int32, tmp (B, S, 3*Wmax) fp32 scratch, out (B, S, S, 3) fp32 or bf16, all
// contiguous on `device`. Launches on `stream` and returns cudaGetLastError().
extern "C" int d3d_resample_normalize_u8(const uint8_t* frames, const int* scalars, float* tmp,
                                         void* out, int B, int Hmax, int Wmax, int S,
                                         int planar, int out_bf16, float s0, float s1, float s2,
                                         float b0, float b1, float b2, int device,
                                         cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || Hmax <= 0 || Wmax <= 0) return 0;
  const Norm p = {{s0, s1, s2}, {b0, b1, b2}};
  if (planar) {
    launch<true>(frames, scalars, tmp, out, B, Hmax, Wmax, S, out_bf16 != 0, p, stream);
  } else {
    launch<false>(frames, scalars, tmp, out, B, Hmax, Wmax, S, out_bf16 != 0, p, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
