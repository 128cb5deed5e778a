// Fused FLAME blendshape GEMM: out = betas @ shapedirs + template, exact fp32.
//
// Replaces: dad3dheads_tpu/ops/blendshapes.py, blend_shapes_fused_pallas
// (its Pallas kernel _kernel), the widest matmul of every FLAME decode.
//
// What bounds it on the H100: betas (B, 400) x shapedirs (400, 15069), fp32.
// At B = 1 the kernel is a pure read of the 24 MB shapedirs matrix (memory
// bound: >= 7 us at 3.35 TB/s). At B = 256 it is 3.1 GFLOP of fp32 FMA
// (>= 46 us at the 67 TFLOP/s non-tensor-core fp32 peak) over the same 24 MB,
// read once; the crossover is near B = 64. TF32 tensor cores are not an
// option: the geometry must stay exact fp32.
//
// Design: one 64x64 output tile per 256-thread block and a 4x4 register
// micro-tile per thread; K is stepped in 16-deep shared-memory tiles and
// accumulated with fmaf in k order (no split-K). While one K tile is being
// multiplied the next one is already loading into registers, which hides the
// global-memory latency that dominates at small B. The template add is fused
// into the single output write. Ragged B and N edges are masked instead of
// padded: the TPU kernel's 512-lane padding has no counterpart on this card.
// Tensor-core (wgmma/TMA) variants, e.g. a 3xTF32 split, are left to later
// work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;  // rows (batch) per block tile
constexpr int BN = 64;  // columns (V*3) per block tile
constexpr int BK = 16;  // depth of one shared-memory K tile
constexpr int THREADS = 256;
constexpr int TM = 4;   // micro-tile rows per thread
constexpr int TN = 4;   // micro-tile columns per thread
constexpr int A_PAD = 4;  // keeps the transposed A stores at a 2-way bank conflict

static_assert((BM / TM) * (BN / TN) == THREADS, "one micro-tile per thread");
static_assert(BM * BK == 4 * THREADS && BN * BK == 4 * THREADS, "4 loads per thread");

__global__ void __launch_bounds__(THREADS)
blend_shapes_kernel(const float* __restrict__ betas, const float* __restrict__ dirs,
                    const float* __restrict__ tmpl, float* __restrict__ out,
                    int B, int K, int N) {
  __shared__ __align__(16) float As[BK][BM + A_PAD];  // A tile, transposed: [k][m]
  __shared__ __align__(16) float Bs[BK][BN];          // B tile: [k][n]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // Loader mapping. A (betas, row-major B x K): 16 consecutive k per half
  // warp. B (dirs, row-major K x N): 64 consecutive n per two warps, so each
  // warp load instruction reads 128 contiguous bytes.
  const int a_k = tid & (BK - 1);
  const int a_m = tid >> 4;
  const int b_n = tid & (BN - 1);
  const int b_k = tid >> 6;

  // Compute mapping: thread (ty, tx) owns rows ty*4..+3, columns tx*4..+3.
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float a_reg[4];
  float b_reg[4];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + a_m + 16 * i;
      const int k = k0 + a_k;
      a_reg[i] = (m < B && k < K) ? betas[static_cast<size_t>(m) * K + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + b_k + 4 * i;
      const int n = n0 + b_n;
      b_reg[i] = (k < K && n < N) ? dirs[static_cast<size_t>(k) * N + n] : 0.f;
    }
  };

  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[a_k][a_m + 16 * i] = a_reg[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) Bs[b_k + 4 * i][b_n] = b_reg[i];
    __syncthreads();

    if (k0 + BK < K) load_tile(k0 + BK);  // in flight while this tile is multiplied

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: template add fused into the one masked write.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j] + tmpl[n];
    }
  }
}

}  // namespace

// betas (B, K), dirs (K, N), tmpl (N,), out (B, N): fp32, contiguous, on
// `device`. Launches on `stream` and returns cudaGetLastError().
extern "C" int d3d_blend_shapes_f32(const float* betas, const float* dirs, const float* tmpl,
                                    float* out, int B, int K, int N, int device,
                                    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM);
  blend_shapes_kernel<<<grid, THREADS, 0, stream>>>(betas, dirs, tmpl, out, B, K, N);
  return static_cast<int>(cudaGetLastError());
}
