// uint8 NHWC images -> normalized NHWC, fp32 or bf16: out = x * scale[c] + bias[c].
//
// Replaces: dad3dheads_tpu/ops/preprocess_pallas.py:30, normalize_images_pallas
// (its pallas_call at :50), the uint8 entry of the batch predictor. The bf16
// output is the bf16 trunk's input: the JAX package casts inside its jitted
// pipeline, where XLA fuses the cast into the normalize.
//
// What bounds it on the H100: memory. Each element is 1 byte read and 4 (fp32)
// or 2 (bf16) bytes written with no reuse, so a (256, 256, 256, 3) batch
// (50.3 M elements) moves 252 MB in fp32 (at least 75 us at 3.35 TB/s) and
// 151 MB in bf16 (45 us). Writes are 80% (fp32) or 67% (bf16) of the bytes.
//
// Design: every warp-wide memory instruction touches one contiguous run of
// bytes. A block of THREADS threads loads a chunk of 16 * THREADS input bytes
// with one 16-byte load a thread (a warp reads 512 contiguous bytes) into
// shared memory; then thread t takes the 4-byte word (fp32 output) or 8-byte
// pair of words (bf16) at t, t + THREADS, ... of the chunk and writes its 4
// floats or 8 bf16 values as one 16-byte store (a warp writes 512 contiguous
// bytes, 4 or 2 stores a thread). On an H100 SXM at 700 W, loading each
// lane's input word straight from device memory (4 in flight a thread) was 1%
// slower, and so were streaming (.cs) stores; a grid-stride loop was 5%
// slower. The channel of flat element i is i % 3: the block's phase comes
// from one 64-bit modulo, the rest is 32-bit and compile-time (16 = 4 = 1 and
// 8 = 2 (mod 3)), so each element reads its scale and bias from registers at
// a static index. The ragged tail (n not a multiple of 16), and inputs or
// outputs whose pointer is not 16-byte aligned (a batch slice), take a scalar
// kernel. The multiply and the add are rounded separately (__fmul_rn,
// __fadd_rn, no FMA contraction), so the fp32 output is bit-identical to the
// plain PyTorch version images.float() * scale + bias, and the bf16 output,
// that value rounded to nearest even (__floats2bfloat162_rn), is
// bit-identical to its .to(torch.bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // a block's chunk: 16 * THREADS input bytes

struct Affine {
  float scale[3];
  float bias[3];
};

__device__ __forceinline__ float affine(unsigned int x, float s, float b) {
  return __fadd_rn(__fmul_rn(static_cast<float>(x), s), b);
}

__device__ __forceinline__ unsigned int pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo at the lower address
  return *reinterpret_cast<const unsigned int*>(&h);
}

// One output vector per type: ELEMS input bytes (Load, read from the staged
// chunk), ELEMS values out as one 16-byte store (Store). s[j], b[j] are the
// scale and bias of the channel j places past that of the thread's first
// element; this vector's first element lies SHIFT places past it (mod 3).
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int ELEMS = 4;
  using Load = unsigned int;
  using Store = float4;
  template <int SHIFT>
  __device__ __forceinline__ static Store convert(Load w, const float (&s)[3], const float (&b)[3]) {
    return make_float4(affine(w & 0xFFu, s[SHIFT % 3], b[SHIFT % 3]),
                       affine((w >> 8) & 0xFFu, s[(SHIFT + 1) % 3], b[(SHIFT + 1) % 3]),
                       affine((w >> 16) & 0xFFu, s[(SHIFT + 2) % 3], b[(SHIFT + 2) % 3]),
                       affine(w >> 24, s[SHIFT % 3], b[SHIFT % 3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int ELEMS = 8;
  using Load = uint2;
  using Store = uint4;
  template <int SHIFT>
  __device__ __forceinline__ static Store convert(Load w, const float (&s)[3], const float (&b)[3]) {
    float r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const unsigned int word = k < 4 ? w.x : w.y;
      r[k] = affine((word >> (8 * (k % 4))) & 0xFFu, s[(SHIFT + k) % 3], b[(SHIFT + k) % 3]);
    }
    return make_uint4(pack_bf16(r[0], r[1]), pack_bf16(r[2], r[3]), pack_bf16(r[4], r[5]),
                      pack_bf16(r[6], r[7]));
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
normalize_vec_kernel(const uint4* __restrict__ in, typename Vec<T>::Store* __restrict__ out, long long n16,
                     Affine p) {
  using V = Vec<T>;
  constexpr int PER = 16 / V::ELEMS;  // output vectors per 16 input bytes: 4 (fp32) or 2 (bf16)
  __shared__ uint4 chunk[THREADS];
  const long long base = static_cast<long long>(blockIdx.x) * THREADS;  // the chunk's first 16-byte input vector
  const unsigned int n_in = static_cast<unsigned int>(min(static_cast<long long>(THREADS), n16 - base));
  const unsigned int t = threadIdx.x;
  if (t < n_in) chunk[t] = in[base + t];
  __syncthreads();

  // channel of this thread's first element, 16 * base + ELEMS * t
  const unsigned int phase = (static_cast<unsigned int>(base % 3) + V::ELEMS * t) % 3;
  float s[3], b[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const unsigned int c = phase + k;
    const int ch = c >= 3 ? c - 3 : c;
    s[k] = ch == 0 ? p.scale[0] : (ch == 1 ? p.scale[1] : p.scale[2]);
    b[k] = ch == 0 ? p.bias[0] : (ch == 1 ? p.bias[1] : p.bias[2]);
  }
  const typename V::Load* words = reinterpret_cast<const typename V::Load*>(chunk);
  out += base * PER;
  // vector u of a thread lies u * ELEMS * THREADS elements past its first
  if (t < n_in * PER) out[t] = V::template convert<0>(words[t], s, b);
  if (THREADS + t < n_in * PER)
    out[THREADS + t] = V::template convert<(V::ELEMS * THREADS) % 3>(words[THREADS + t], s, b);
  if constexpr (PER == 4) {
    if (2 * THREADS + t < n_in * PER)
      out[2 * THREADS + t] = V::template convert<(2 * V::ELEMS * THREADS) % 3>(words[2 * THREADS + t], s, b);
    if (3 * THREADS + t < n_in * PER)
      out[3 * THREADS + t] = V::template convert<(3 * V::ELEMS * THREADS) % 3>(words[3 * THREADS + t], s, b);
  }
}

__device__ __forceinline__ void store_scalar(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_scalar(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
normalize_scalar_kernel(const uint8_t* __restrict__ in, T* __restrict__ out, long long start, long long n,
                        Affine p) {
  const long long i = start + static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const int c = static_cast<int>(i % 3);
  store_scalar(out + i, affine(in[i], p.scale[c], p.bias[c]));
}

template <typename T>
int launch(const uint8_t* images, T* out, long long n, const Affine& p, cudaStream_t stream) {
  long long start = 0;
  if (reinterpret_cast<uintptr_t>(images) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    const long long n16 = n / 16;
    if (n16 > 0) {
      normalize_vec_kernel<T><<<static_cast<unsigned int>((n16 + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
          reinterpret_cast<const uint4*>(images), reinterpret_cast<typename Vec<T>::Store*>(out), n16, p);
    }
    start = n16 * 16;
  }
  if (start < n) {
    normalize_scalar_kernel<T><<<static_cast<unsigned int>((n - start + THREADS - 1) / THREADS), THREADS, 0,
                                 stream>>>(images, out, start, n, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// images (B, H, W, 3) uint8 and out (B, H, W, 3), fp32 (out_bf16 = 0) or bf16
// (out_bf16 = 1), contiguous, on `device`. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int d3d_normalize_u8(const uint8_t* images, void* out, int B, int H, int W, int out_bf16,
                                float s0, float s1, float s2, float b0, float b1, float b2,
                                int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(B) * H * W * 3;
  if (n <= 0) return 0;
  const Affine p = {{s0, s1, s2}, {b0, b1, b2}};
  return out_bf16 ? launch(images, static_cast<__nv_bfloat16*>(out), n, p, stream)
                  : launch(images, static_cast<float*>(out), n, p, stream);
}
