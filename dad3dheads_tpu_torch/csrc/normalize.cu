// uint8 NHWC images -> normalized fp32 NHWC: out = x * scale[c] + bias[c].
//
// Replaces: dad3dheads_tpu/ops/preprocess_pallas.py, normalize_images_pallas
// (its Pallas kernel _kernel), the uint8 entry of the batch predictor.
//
// What bounds it on the H100: memory. Each element is 1 byte read and 4 bytes
// written with no reuse, so a (256, 256, 256, 3) batch (50.3 M elements,
// 252 MB moved) takes at least 75 us at 3.35 TB/s.
//
// Design: each thread reads 16 bytes with one 128-bit load and writes its 16
// floats with four 128-bit stores, so the kernel issues few, wide memory
// instructions. The channel of flat element i is i % 3; since 16 = 1 (mod 3)
// a thread's first channel is its vector index % 3. The n % 16 tail, and
// inputs whose pointer is not 16-byte aligned (a batch slice), take a scalar
// kernel. The multiply and the add are rounded separately (__fmul_rn,
// __fadd_rn, no FMA contraction), so the output is bit-identical to the plain
// PyTorch version images.float() * scale + bias.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

struct Affine {
  float scale[3];
  float bias[3];
};

__global__ void __launch_bounds__(THREADS)
normalize_vec16_kernel(const uint4* __restrict__ in, float4* __restrict__ out,
                       long long n16, Affine p) {
  const long long v = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (v >= n16) return;
  const uint4 raw = in[v];

  // per-thread channel rotation, so element e below uses a static index
  const int c0 = static_cast<int>(v % 3);
  float s[3], b[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int c = (c0 + j) % 3;
    s[j] = p.scale[c];
    b[j] = p.bias[c];
  }

  const unsigned int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * q + e;
      const float x = static_cast<float>((words[q] >> (8 * e)) & 0xFFu);
      r[e] = __fadd_rn(__fmul_rn(x, s[k % 3]), b[k % 3]);
    }
    out[v * 4 + q] = make_float4(r[0], r[1], r[2], r[3]);
  }
}

__global__ void __launch_bounds__(THREADS)
normalize_scalar_kernel(const uint8_t* __restrict__ in, float* __restrict__ out,
                        long long start, long long n, Affine p) {
  const long long i = start + static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const int c = static_cast<int>(i % 3);
  out[i] = __fadd_rn(__fmul_rn(static_cast<float>(in[i]), p.scale[c]), p.bias[c]);
}

inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + THREADS - 1) / THREADS);
}

}  // namespace

// images (B, H, W, 3) uint8 and out (B, H, W, 3) fp32, contiguous, on
// `device`. Launches on `stream` and returns cudaGetLastError().
extern "C" int d3d_normalize_u8(const uint8_t* images, float* out, int B, int H, int W,
                                float s0, float s1, float s2, float b0, float b1, float b2,
                                int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(B) * H * W * 3;
  if (n <= 0) return 0;
  const Affine p = {{s0, s1, s2}, {b0, b1, b2}};

  long long start = 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(images) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned) {
    const long long n16 = n / 16;
    if (n16 > 0) {
      normalize_vec16_kernel<<<blocks_for(n16), THREADS, 0, stream>>>(
          reinterpret_cast<const uint4*>(images), reinterpret_cast<float4*>(out), n16, p);
    }
    start = n16 * 16;
  }
  if (start < n) {
    normalize_scalar_kernel<<<blocks_for(n - start), THREADS, 0, stream>>>(images, out, start,
                                                                           n, p);
  }
  return static_cast<int>(cudaGetLastError());
}
