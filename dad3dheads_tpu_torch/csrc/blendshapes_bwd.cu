// Backward of the fused FLAME blendshape GEMM (out = betas @ dirs + tmpl),
// exact fp32, deterministic:
//   d_betas (B, K) = g (B, N) . dirs (K, N)^T
//   d_tmpl  (N,)   = sum_b g[b, :]
//   d_dirs  (K, N) = betas (B, K)^T . g (B, N)
//
// Replaces: dad3dheads_tpu/ops/blendshapes.py, the custom VJP of
// blend_shapes_fused (_fused_flat_bwd), which the TPU runs as two
// Precision.HIGHEST matmuls and a column sum.
//
// What bounds it on the H100: in training, d_betas is 2*B*400*15069 fp32 FMA
// operations (0.77 GFLOP at B = 64: >= 11.5 us at the 67 TFLOP/s non-tensor-
// core fp32 peak) over one read of g and dirs (~28 MB: >= 8.4 us at
// 3.35 TB/s), so operations bound it, narrowly. d_dirs (only when the FLAME
// constants themselves need a gradient) is the same count of operations with
// a 24 MB write. TF32 tensor cores are not an option: exact fp32.
//
// Design. d_betas contracts over N = 15069 into a small (B, 400) output, so a
// grid over the output alone would occupy a handful of SMs. The contraction is
// split instead (split-K): block (x, y, z) computes the 64x64 output tile
// (y, x) over the z-th chunk of N into a partial buffer, and a second kernel
// sums the chunks of each output in chunk order. No fp32 atomics: the result
// is the same bits on every run. The blocks of the first column of output
// tiles also sum their g tile over its rows while it sits in shared memory,
// so d_tmpl comes from the same read of g (one partial per 64-row tile of g,
// reduced in the second kernel too). d_dirs contracts over B only, so it is
// a plain tiled GEMM over its (400, 15069) output. Both GEMMs use the
// forward kernel's scheme: 64x64 tiles, 256 threads, a 4x4 register
// micro-tile per thread, 16-deep shared-memory K tiles, the next tile loaded
// into registers while the current one is multiplied. Ragged edges are masked.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int PAD = 4;  // transposed shared-memory stores: at most 2-way bank conflicts

static_assert((BM / TM) * (BN / TN) == THREADS, "one micro-tile per thread");

// The 4x4 micro-tile product of one K tile held in shared memory as
// [k][m] and [k][n].
__device__ __forceinline__ void mma_tile(float (*As)[BM + PAD], float (*Bs)[BN + PAD],
                                         int ty, int tx, float (&acc)[TM][TN]) {
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
}

// partial[z][b][k] = sum over n in chunk z of g[b][n] * dirs[k][n];
// tmpl_partial[y][n] = sum over the rows b of tile y of g[b][n] (x == 0 only).
// Both operands are row-major with n contiguous: a half warp reads 16
// consecutive n of one row, and the tile is stored transposed as [n][row].
__global__ void __launch_bounds__(THREADS)
dbetas_partial_kernel(const float* __restrict__ g, const float* __restrict__ dirs,
                      float* __restrict__ partial, float* __restrict__ tmpl_partial,
                      int B, int K, int N, int chunk) {
  __shared__ __align__(16) float As[BK][BM + PAD];  // g tile: [n][b]
  __shared__ __align__(16) float Bs[BK][BN + PAD];  // dirs tile: [n][k]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BN;  // output columns: rows of dirs
  const int b0 = blockIdx.y * BM;  // output rows: rows of g
  const int n_begin = blockIdx.z * chunk;
  const int n_end = min(N, n_begin + chunk);
  const bool sums_tmpl = blockIdx.x == 0;

  const int l_n = tid & (BK - 1);  // loader: column within the K tile
  const int l_r = tid >> 4;        // loader: row, +16 per pass
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float a_reg[4];
  float b_reg[4];
  auto load_tile = [&](int n0) {
    const int n = n0 + l_n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + l_r + 16 * i;
      a_reg[i] = (b < B && n < n_end) ? g[static_cast<size_t>(b) * N + n] : 0.f;
      const int k = k0 + l_r + 16 * i;
      b_reg[i] = (k < K && n < n_end) ? dirs[static_cast<size_t>(k) * N + n] : 0.f;
    }
  };

  load_tile(n_begin);
  for (int n0 = n_begin; n0 < n_end; n0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[l_n][l_r + 16 * i] = a_reg[i];
      Bs[l_n][l_r + 16 * i] = b_reg[i];
    }
    __syncthreads();

    if (n0 + BK < n_end) load_tile(n0 + BK);

    if (sums_tmpl && tid < BK && n0 + tid < n_end) {
      // rows past B were loaded as zeros; the sum runs in row order
      float s = 0.f;
      for (int r = 0; r < BM; ++r) s += As[tid][r];
      tmpl_partial[static_cast<size_t>(blockIdx.y) * N + n0 + tid] = s;
    }
    mma_tile(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  float* out = partial + static_cast<size_t>(blockIdx.z) * B * K;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = b0 + ty * TM + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int k = k0 + tx * TN + j;
      if (k < K) out[static_cast<size_t>(b) * K + k] = acc[i][j];
    }
  }
}

// d_betas[i] = sum_z partial[z][i] for i < B*K, then d_tmpl[n] = sum_y
// tmpl_partial[y][n]: fixed order, so the same bits every run.
__global__ void dbetas_reduce_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ tmpl_partial,
                                     float* __restrict__ d_betas, float* __restrict__ d_tmpl,
                                     int BK_total, int chunks, int N, int b_tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < BK_total) {
    float s = 0.f;
    for (int z = 0; z < chunks; ++z) s += partial[static_cast<size_t>(z) * BK_total + i];
    d_betas[i] = s;
  } else if (i - BK_total < N) {
    const int n = i - BK_total;
    float s = 0.f;
    for (int y = 0; y < b_tiles; ++y) s += tmpl_partial[static_cast<size_t>(y) * N + n];
    d_tmpl[n] = s;
  }
}

// d_dirs[k][n] = sum_b betas[b][k] * g[b][n]. betas^T is read along k
// (contiguous), g along n (contiguous), both stored as [b][.] tiles.
__global__ void __launch_bounds__(THREADS)
ddirs_kernel(const float* __restrict__ betas, const float* __restrict__ g,
             float* __restrict__ d_dirs, int B, int K, int N) {
  __shared__ __align__(16) float As[BK][BM + PAD];  // betas tile: [b][k]
  __shared__ __align__(16) float Bs[BK][BN + PAD];  // g tile: [b][n]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;  // rows of d_dirs: k

  const int l_c = tid & 63;  // loader: contiguous column (k of betas, n of g)
  const int l_b = tid >> 6;  // loader: b within the tile, +4 per pass
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float a_reg[4];
  float b_reg[4];
  auto load_tile = [&](int bb0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = bb0 + l_b + 4 * i;
      const int k = m0 + l_c;
      const int n = n0 + l_c;
      a_reg[i] = (b < B && k < K) ? betas[static_cast<size_t>(b) * K + k] : 0.f;
      b_reg[i] = (b < B && n < N) ? g[static_cast<size_t>(b) * N + n] : 0.f;
    }
  };

  load_tile(0);
  for (int bb0 = 0; bb0 < B; bb0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[l_b + 4 * i][l_c] = a_reg[i];
      Bs[l_b + 4 * i][l_c] = b_reg[i];
    }
    __syncthreads();
    if (bb0 + BK < B) load_tile(bb0 + BK);
    mma_tile(As, Bs, ty, tx, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int k = m0 + ty * TM + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) d_dirs[static_cast<size_t>(k) * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// g (B, N), dirs (K, N), betas (B, K): fp32, contiguous, on `device`.
// partial holds chunks * B * K floats and tmpl_partial ceil(B / 64) * N;
// `chunk` (a multiple of 16) is the length of N each split-K block covers and
// chunks = ceil(N / chunk). d_dirs may be null (not computed). Launches on
// `stream` and returns cudaGetLastError().
extern "C" int d3d_blend_shapes_bwd_f32(const float* g, const float* dirs, const float* betas,
                                        float* partial, float* tmpl_partial, float* d_betas,
                                        float* d_tmpl, float* d_dirs, int B, int K, int N,
                                        int chunk, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || K <= 0 || N <= 0) return 0;
  if (chunk <= 0 || chunk % BK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (N + chunk - 1) / chunk;
  const int b_tiles = (B + BM - 1) / BM;
  const dim3 grid((K + BN - 1) / BN, b_tiles, chunks);
  dbetas_partial_kernel<<<grid, THREADS, 0, stream>>>(g, dirs, partial, tmpl_partial, B, K, N, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = B * K + N;
  dbetas_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(partial, tmpl_partial, d_betas, d_tmpl,
                                                                B * K, chunks, N, b_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || d_dirs == nullptr) return static_cast<int>(err);
  const dim3 grid_dirs((N + BN - 1) / BN, (K + BM - 1) / BM);
  ddirs_kernel<<<grid_dirs, THREADS, 0, stream>>>(betas, g, d_dirs, B, K, N);
  return static_cast<int>(cudaGetLastError());
}
