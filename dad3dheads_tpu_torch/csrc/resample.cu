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
// out as bias[c], without a read of the source.
//
// What bounds it on the H100: memory. It has to read the crop's uint8 bytes
// once and write the output once; the multiply-adds are a few per byte (about
// f + 2 taps per axis on a downscale), far below the fp32 rate.
//
// Design: one pass, the row result in shared memory, no scratch in device
// memory. A block of 256 threads owns one image and a band of `band` output
// rows, all S columns.
//   1. rows: for each output row of the band that has taps, the threads walk
//      the crop's source bytes of one source row in 8-byte words (a warp reads
//      256 consecutive bytes), each thread summing the row taps over the
//      source rows for its 8 bytes at once (one tap computation for 8 bytes,
//      two source rows' words in flight), and store the fp32 sums, per
//      channel, in shared memory. Source rows outside the crop are never
//      read, whatever the frame's height: one kernel serves any Hmax.
//   2. columns + normalize: one thread per output pixel (y, x) sums the
//      column taps of its three channels over the shared row (one tap
//      computation for three channels), applies scale and bias, and stores
//      fp32 or bf16 (rounded once, at the store) in NHWC, the layout the
//      network reads.
// The sums run in the parent two-pass kernel's order, rows over source rows
// and then columns over the row sums, each tap by fmaf in ascending source
// index: the output is bit-identical to it and, in fp32, to the plain version.
// The row pass is bound by its instructions more than by its bytes, so the
// inner loop is kept short without changing a bit: a byte becomes a float
// by one byte permute and one subtraction (2^23 + b, less 2^23), and the
// weight of a source pixel wholly inside an area box, 1/f, is divided once
// per output row.
// The shared row holds 3 x Wmax floats per output row of the band, so the
// caller's plan (ops/resample.py) sizes the band from the buffer's width
// alone: it covers any crop and scale factor without reading the scalars.
// The source may be channel-planar (B, Hmax, 3 * Wmax), the wire format of
// pack_frames_host(planar=True), or NHWC (B, Hmax, Wmax, 3); both have rows of
// 3 * Wmax bytes, and only the byte offset of (column, channel) differs. Rows
// that are not a multiple of 8 bytes apart (a ragged Wmax) or a buffer that
// is not 8-byte aligned take the same kernel reading one byte per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "smem_opt_in.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NSCALARS = 10;
constexpr int AHEAD = 2;  // area taps whose values are loaded before they are summed
constexpr int MAX_SMEM = 232448;  // the H100's largest dynamic shared memory per block (227 KB)

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

// N fp32 lanes summed alike: one tap computation serves them all.
template <int N>
struct Vec {
  float v[N];
};

template <int N>
__device__ __forceinline__ Vec<N> fma_v(float w, const Vec<N>& a, const Vec<N>& acc) {
  Vec<N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = fmaf(w, a.v[i], acc.v[i]);
  return r;
}

template <int N>
__device__ __forceinline__ Vec<N> mul_v(float w, const Vec<N>& a) {
  Vec<N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = __fmul_rn(w, a.v[i]);
  return r;
}

__device__ __forceinline__ int image_mode(const int* s) {
  return s[8] != 0 ? (s[9] != 0 ? AREA : GEN2) : LINEAR;
}

__device__ __forceinline__ float clip_index(float v, float hi) {
  return fminf(fmaxf(v, 0.0f), hi);
}

// sum over the non-zero taps s of output position r (0 <= r < new_len) of
// weight(s) * value(s), with source indices limited to [0, src_max); value
// returns a Vec<N>.
template <int N, typename Value>
__device__ __forceinline__ Vec<N> sum_taps(int mode, const Axis& a, int r, int src_max, const Value& value) {
  const float rf = static_cast<float>(r);
  const float lo = static_cast<float>(a.crop_lo);
  const float f = __fdiv_rn(static_cast<float>(a.crop_len),
                            fmaxf(static_cast<float>(a.new_len), 1.0f));
  if (mode == AREA) {
    const float box_lo = __fadd_rn(lo, __fmul_rn(rf, f));
    const float box_hi = __fadd_rn(box_lo, f);
    const int s_begin = max(static_cast<int>(floorf(box_lo)), 0);
    const int s_end = min(static_cast<int>(ceilf(box_hi)), src_max);
    const float w_inner = __fdiv_rn(1.0f, f);  // the weight of a source pixel inside the box: overlap 1
    const auto weight = [&](int s) {
      const float sf = static_cast<float>(s);
      const float overlap = __fsub_rn(fminf(__fadd_rn(sf, 1.0f), box_hi), fmaxf(sf, box_lo));
      return overlap == 1.0f ? w_inner : __fdiv_rn(fmaxf(overlap, 0.0f), f);
    };
    Vec<N> acc = {};
    int s = s_begin;
    for (; s + AHEAD <= s_end; s += AHEAD) {  // AHEAD values in flight, summed in order
      Vec<N> v[AHEAD];
#pragma unroll
      for (int i = 0; i < AHEAD; ++i) v[i] = value(s + i);
#pragma unroll
      for (int i = 0; i < AHEAD; ++i) acc = fma_v(weight(s + i), v[i], acc);
    }
    for (; s < s_end; ++s) acc = fma_v(weight(s), value(s), acc);
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
  if (g0 == g1) return mul_v(__fadd_rn(w0, w1), value(g0));
  return fma_v(w1, value(g1), mul_v(w0, value(g0)));
}

// Source columns [x0, x0 + win) that the column taps can reach: the crop and
// one more, for an area box whose rounded end passes the crop's by an ulp.
__device__ __forceinline__ int column_window(const int* s, int Wmax) {
  return min(s[5] + 1, Wmax - s[4]);
}

// VEC consecutive source bytes as floats: one aligned 8-byte load (VEC = 8)
// or a single byte (VEC = 1). Byte b becomes the float 2^23 + b (bits
// 0x4b0000bb) less 2^23: exact.
template <int VEC>
__device__ __forceinline__ Vec<VEC> load_bytes(const uint8_t* p) {
  static_assert(VEC == 8 || VEC == 1, "8-byte words or single bytes");
  uint32_t words[2] = {0u, 0u};
  if constexpr (VEC == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    words[0] = w.x;
    words[1] = w.y;
  } else {
    words[0] = *p;
  }
  Vec<VEC> r;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    r.v[i] = __fsub_rn(__uint_as_float(__byte_perm(words[i / 4], 0x4b000000u, (i % 4) | 0x7440)), 8388608.0f);
  }
  return r;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int VEC, bool PLANAR, typename Out>
__global__ void __launch_bounds__(THREADS)
resample_kernel(const uint8_t* __restrict__ frames, const int* __restrict__ scalars, Out* __restrict__ out,
                int Hmax, int Wmax, int S, int band, Norm p) {
  extern __shared__ float rows[];  // [band][3][Wmax]: row sums of the crop's columns, per channel
  const int b = blockIdx.y;
  const int y_first = blockIdx.x * band;
  const int n_rows = min(band, S - y_first);
  const int* s = scalars + b * NSCALARS;
  const int mode = image_mode(s);
  const Axis ay = {s[0], s[1], s[2], s[3]};
  const Axis ax = {s[4], s[5], s[6], s[7]};
  const int x0 = ax.crop_lo;
  const int win = column_window(s, Wmax);
  const long long row_bytes = 3LL * Wmax;
  const uint8_t* frame = frames + static_cast<long long>(b) * Hmax * row_bytes;

  // 1. rows: the band's rows with taps are [r_lo, r_hi) of the band
  const int r_lo = max(0, ay.pad_lo - y_first);
  const int r_hi = min(n_rows, ay.pad_lo + ay.new_len - y_first);
  // one segment of source bytes per channel (planar) or one for all three (NHWC)
  constexpr int NSEG = PLANAR ? 3 : 1;
  const int seg_len = PLANAR ? win : 3 * win;
  const int seg0 = PLANAR ? x0 : 3 * x0;  // byte offset of segment 0 in a row; segment c adds c * Wmax
  const int first = seg0 / VEC;           // VEC divides Wmax: every segment has this alignment
  const int n_words = (seg0 + seg_len + VEC - 1) / VEC - first;
  const int n_items = max(r_hi - r_lo, 0) * NSEG * n_words;
  for (int k = threadIdx.x; k < n_items; k += THREADS) {
    const int word = k % n_words;
    const int rest = k / n_words;
    const int seg = rest % NSEG;
    const int yl = r_lo + rest / NSEG;
    const int offset = (first + word) * VEC + seg * Wmax;  // byte offset within a source row
    const Vec<VEC> acc = sum_taps<VEC>(mode, ay, y_first + yl - ay.pad_lo, Hmax, [&](int h) {
      return load_bytes<VEC>(frame + h * row_bytes + offset);
    });
    const int rel0 = (first + word) * VEC - seg0;  // the word's first byte within the segment
    // its channel and column (rel0 > -9: the divisions see no negative number)
    int c = PLANAR ? seg : (rel0 + 9) % 3, j = PLANAR ? rel0 : (rel0 + 9) / 3 - 3;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (rel0 + e >= 0 && rel0 + e < seg_len) rows[(yl * 3 + c) * Wmax + j] = acc.v[e];
      if (PLANAR) {
        ++j;
      } else if (++c == 3) {
        c = 0;
        ++j;
      }
    }
  }
  __syncthreads();

  // 2. columns + normalize, one output pixel per thread
  for (int k = threadIdx.x; k < n_rows * S; k += THREADS) {
    const int yl = k / S;
    const int x = k - yl * S;
    const int rx = x - ax.pad_lo;
    Vec<3> acc = {};
    if (yl >= r_lo && yl < r_hi && rx >= 0 && rx < ax.new_len) {
      const float* row = rows + yl * 3 * Wmax;
      acc = sum_taps<3>(mode, ax, rx, Wmax, [&](int w) {
        const int j = w - x0;
        return Vec<3>{{row[j], row[Wmax + j], row[2 * Wmax + j]}};
      });
    }
    Out* o = out + ((static_cast<long long>(b) * S + y_first + yl) * S + x) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) store(o + c, __fadd_rn(__fmul_rn(acc.v[c], p.scale[c]), p.bias[c]));
  }
}

template <int VEC, bool PLANAR, typename Out>
cudaError_t launch(const uint8_t* frames, const int* scalars, Out* out, int B, int Hmax, int Wmax, int S,
                   int band, const Norm& p, cudaStream_t stream) {
  auto kernel = resample_kernel<VEC, PLANAR, Out>;
  const long long smem = static_cast<long long>(band) * 3 * Wmax * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  static std::atomic<uint64_t> opted_in{0};  // this instantiation's devices
  const cudaError_t attr = d3d::opt_in_smem(kernel, MAX_SMEM, opted_in);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + band - 1) / band, B);
  kernel<<<grid, THREADS, static_cast<size_t>(smem), stream>>>(frames, scalars, out, Hmax, Wmax, S, band, p);
  return cudaGetLastError();
}

template <bool PLANAR, typename Out>
cudaError_t launch_aligned(const uint8_t* frames, const int* scalars, Out* out, int B, int Hmax, int Wmax, int S,
                           int band, const Norm& p, cudaStream_t stream) {
  const bool words = Wmax % 8 == 0 && reinterpret_cast<uintptr_t>(frames) % 8 == 0;
  return words ? launch<8, PLANAR>(frames, scalars, out, B, Hmax, Wmax, S, band, p, stream)
               : launch<1, PLANAR>(frames, scalars, out, B, Hmax, Wmax, S, band, p, stream);
}

template <typename Out>
cudaError_t launch_layout(const uint8_t* frames, const int* scalars, Out* out, int B, int Hmax, int Wmax, int S,
                          bool planar, int band, const Norm& p, cudaStream_t stream) {
  return planar ? launch_aligned<true>(frames, scalars, out, B, Hmax, Wmax, S, band, p, stream)
                : launch_aligned<false>(frames, scalars, out, B, Hmax, Wmax, S, band, p, stream);
}

}  // namespace

// frames (B, Hmax, 3*Wmax) planar or (B, Hmax, Wmax, 3) uint8, scalars (B, 10)
// int32, out (B, S, S, 3) fp32 or bf16, all contiguous on `device`; `band`
// output rows per block, with band * 3 * Wmax * 4 bytes of shared memory at
// most 227 KB. Launches one kernel on `stream` and returns cudaGetLastError().
extern "C" int d3d_resample_normalize_u8(const uint8_t* frames, const int* scalars, void* out, int B, int Hmax,
                                         int Wmax, int S, int planar, int out_bf16, int band, float s0, float s1,
                                         float s2, float b0, float b1, float b2, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || Hmax <= 0 || Wmax <= 0) return 0;
  if (band <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Norm p = {{s0, s1, s2}, {b0, b1, b2}};
  err = out_bf16 ? launch_layout(frames, scalars, static_cast<__nv_bfloat16*>(out), B, Hmax, Wmax, S, planar != 0,
                                 band, p, stream)
                 : launch_layout(frames, scalars, static_cast<float*>(out), B, Hmax, Wmax, S, planar != 0, band, p,
                                 stream);
  return static_cast<int>(err);
}
