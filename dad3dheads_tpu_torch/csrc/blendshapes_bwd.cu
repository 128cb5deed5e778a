// Backward of the fused FLAME blendshape GEMM (out = betas @ dirs + tmpl),
// deterministic:
//   d_betas (B, K) = g (B, N) . dirs (K, N)^T   (3xTF32 on the tensor cores)
//   d_tmpl  (N,)   = sum_b g[b, :]               (fp32)
//   d_dirs  (K, N) = betas (B, K)^T . g (B, N)   (fp32 FMA, only on request)
//
// Replaces: dad3dheads_tpu/ops/blendshapes.py, the custom VJP of
// blend_shapes_fused (_fused_flat_bwd), which the TPU runs as two
// Precision.HIGHEST matmuls and a column sum.
//
// What bounds it on the H100: in training, d_betas contracts over
// N = 15,069. With 3xTF32 (tf32x3.cuh: three tf32 MMAs per product, about
// 20 of fp32's 24 bits of each product, fp32 accumulation) it is
// 3 * 2 * B * 400 * 15069 operations (B = 64: 2.3 GFLOP, >= 4.7 us at the
// 495 TFLOP/s tf32 peak) over one read of g and dirs (~28 MB: >= 8.4 us at
// 3.35 TB/s), so bytes bound it. The scheme's d_betas, emulated in numpy at
// B = 64 (tests/test_torch_kernels.py), lies 1.8e-8 of its sum of absolute
// products from an fp64 product (a plain fp32 product: 2.1e-8). (In fp32 outside the tensor cores the
// operations would bound it at 11.5 us.) d_dirs, which only a gradient of the
// FLAME constants needs, stays a SIMT fp32 GEMM over its (400, 15069) output.
//
// Design of d_betas. Its output is small, (B, 400), so a grid over the output
// alone would fill a handful of SMs: the contraction is split (split-K).
// Block (x, y, z) computes the 64 x 80 output tile (rows of g, rows of dirs)
// over the z-th chunk of N, in 32-deep steps through a 4-stage cp.async ring
// (83 KB, two blocks per SM); the chunk length is chosen so that the grid is
// about two blocks per SM (B = 64: 48 chunks, 240 blocks), so each chunk is
// long (320 columns at B = 64) and the partial buffer small (chunks * B *
// 400 floats: 4.9 MB at B = 64). A second kernel sums the chunks of each
// output in chunk order: no atomics, the same bits on every run. Four warps
// of 32 x 40 each (2 x 5 fragments) split every fragment element once into
// tf32 hi and lo. Both operands are read along N. The port's FLAME shapedirs has rows padded to
// 16-byte alignment (core/flame.py) and is copied 16 bytes at a time; g comes
// from autograd with rows 15,069 floats apart (60,276 bytes, 4 mod 16), so
// it is copied 4 bytes per element (cp.async.ca) rather than padded by an
// extra copy of it (the copy width is a compile-time choice per operand,
// picked at launch). The blocks of the first column of output tiles also sum
// their g tile over its rows while it sits in shared memory, one warp per 16
// rows, so d_tmpl comes from the same read of g (partials per 16 rows,
// reduced in the second kernel in order).

#include "smem_opt_in.cuh"
#include "tf32x3.cuh"

namespace {

// ---- d_betas: 3xTF32 split-K ----
constexpr int DB_BM = 64;   // rows of g per tile
constexpr int DB_BJ = 80;   // rows of dirs per tile (400 = 5 x 80)
constexpr int DB_BC = 32;   // contraction step; a chunk is a multiple of it
constexpr int DB_STAGES = 4;
constexpr int DB_WM = 32, DB_WJ = 40;  // warp tile: 2 x 5 m16n8 fragments
constexpr int DB_THREADS = (DB_BM / DB_WM) * (DB_BJ / DB_WJ) * 32;
constexpr int DB_LD = DB_BC + 4;  // [row][c]: fragment reads hit 32 banks
constexpr int DB_G_STAGE = DB_BM * DB_LD;
constexpr int DB_D_STAGE = DB_BJ * DB_LD;
constexpr size_t DB_SMEM = static_cast<size_t>(DB_STAGES) * (DB_G_STAGE + DB_D_STAGE) * sizeof(float);
constexpr int DB_TMPL_ROWS = DB_THREADS / 32;  // d_tmpl partials per tile of g: one per warp
static_assert(DB_BM == 16 * DB_TMPL_ROWS && DB_BC == 32, "a warp sums 16 rows of a 32-column step");

// partial[z][b][k] = sum over n in chunk z of g[b][n] * dirs[k][n];
// tmpl_partial[4 y + w][n] = sum over rows 16 w .. 16 w + 15 of tile y of
// g[b][n] (blocks with x == 0 only).
template <bool G_VEC, bool D_VEC>
__global__ void __launch_bounds__(DB_THREADS, 2)
dbetas_partial_kernel(const float* __restrict__ g, const float* __restrict__ dirs, float* __restrict__ partial,
                      float* __restrict__ tmpl_partial, int B, int K, int N, int ldg, int ldd, int chunk) {
  constexpr int MT = DB_WM / 16, NT = DB_WJ / 8, WARPS_J = DB_BJ / DB_WJ;
  extern __shared__ __align__(16) float smem[];
  float* Gs = smem;                            // [STAGES][BM][LD]
  float* Ds = smem + DB_STAGES * DB_G_STAGE;   // [STAGES][BJ][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm0 = (warp / WARPS_J) * DB_WM, wj0 = (warp % WARPS_J) * DB_WJ;
  const int j0 = blockIdx.x * DB_BJ, b0 = blockIdx.y * DB_BM;
  const int c_begin = blockIdx.z * chunk, c_end = min(N, c_begin + chunk);
  const int steps = (c_end - c_begin + DB_BC - 1) / DB_BC;
  const bool sums_tmpl = blockIdx.x == 0;

  auto load = [&](int step) {
    const int slot = step % DB_STAGES, c0 = c_begin + step * DB_BC;
    d3d::copy_tile_async<DB_BM, DB_BC, DB_LD, DB_THREADS, G_VEC>(Gs + slot * DB_G_STAGE, g, ldg, b0, B, c0, c_end);
    d3d::copy_tile_async<DB_BJ, DB_BC, DB_LD, DB_THREADS, D_VEC>(Ds + slot * DB_D_STAGE, dirs, ldd, j0, K, c0,
                                                                 c_end);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < DB_STAGES - 1; ++s) {
    if (s < steps) load(s);
    d3d::cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    d3d::cp_async_wait<DB_STAGES - 2>();
    __syncthreads();
    if (step + DB_STAGES - 1 < steps) load(step + DB_STAGES - 1);
    d3d::cp_async_commit();

    const float* gt = Gs + (step % DB_STAGES) * DB_G_STAGE;
    const float* dt = Ds + (step % DB_STAGES) * DB_D_STAGE;
    if (sums_tmpl) {
      // rows past B landed as zeros; each warp sums its 16 rows in order
      const int c = c_begin + step * DB_BC + lane;
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) s += gt[(16 * warp + r) * DB_LD + lane];
      if (c < c_end) tmpl_partial[static_cast<size_t>(blockIdx.y * DB_TMPL_ROWS + warp) * N + c] = s;
    }
#pragma unroll
    for (int kk = 0; kk < DB_BC; kk += 8) {
      uint32_t b_hi[NT][2], b_lo[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // B (k = contraction, n = row of dirs) is dirs^T: b0 (k = t, n = g), b1 (k = t + 4)
        const float* p = dt + (wj0 + j * 8 + gid) * DB_LD + kk + tig;
        d3d::split_tf32(p[0], b_hi[j][0], b_lo[j][0]);
        d3d::split_tf32(p[4], b_hi[j][1], b_lo[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a_hi[4], a_lo[4];
        d3d::load_a_frag(gt + (wm0 + i * 16 + gid) * DB_LD + kk + tig, DB_LD, a_hi, a_lo);
        d3d::mma_3xtf32_row(acc[i], a_hi, a_lo, b_hi, b_lo);
      }
    }
  }
  d3d::cp_async_wait<0>();

  float* out = partial + static_cast<size_t>(blockIdx.z) * B * K;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = b0 + wm0 + i * 16 + gid + 8 * h;
      if (b >= B) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int k = j0 + wj0 + j * 8 + 2 * tig;
        if (k < K) out[static_cast<size_t>(b) * K + k] = acc[i][j][2 * h];
        if (k + 1 < K) out[static_cast<size_t>(b) * K + k + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

template <bool G_VEC, bool D_VEC>
cudaError_t launch_dbetas(dim3 grid, const float* g, const float* dirs, float* partial, float* tmpl_partial, int B,
                          int K, int N, int ldg, int ldd, int chunk, cudaStream_t stream) {
  auto kernel = dbetas_partial_kernel<G_VEC, D_VEC>;
  static std::atomic<uint64_t> opted_in{0};  // this instantiation's devices
  const cudaError_t attr = d3d::opt_in_smem(kernel, static_cast<int>(DB_SMEM), opted_in);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, DB_THREADS, DB_SMEM, stream>>>(g, dirs, partial, tmpl_partial, B, K, N, ldg, ldd, chunk);
  return cudaGetLastError();
}

// d_betas[i] = sum_z partial[z][i] for i < B*K, then d_tmpl[n] = sum_p
// tmpl_partial[p][n]: fixed order, so the same bits every run.
__global__ void dbetas_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ tmpl_partial,
                                     float* __restrict__ d_betas, float* __restrict__ d_tmpl, int BK_total,
                                     int chunks, int N, int tmpl_rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < BK_total) {
    float s = 0.f;
    for (int z = 0; z < chunks; ++z) s += partial[static_cast<size_t>(z) * BK_total + i];
    d_betas[i] = s;
  } else if (i - BK_total < N) {
    const int n = i - BK_total;
    float s = 0.f;
    for (int p = 0; p < tmpl_rows; ++p) s += tmpl_partial[static_cast<size_t>(p) * N + n];
    d_tmpl[n] = s;
  }
}

// ---- d_dirs: SIMT fp32 ----
constexpr int DD_BM = 64;
constexpr int DD_BN = 64;
constexpr int DD_BK = 16;
constexpr int DD_THREADS = 256;
constexpr int DD_TM = 4;
constexpr int DD_TN = 4;
constexpr int DD_PAD = 4;  // transposed shared-memory stores: at most 2-way bank conflicts

static_assert((DD_BM / DD_TM) * (DD_BN / DD_TN) == DD_THREADS, "one micro-tile per thread");

// d_dirs[k][n] = sum_b betas[b][k] * g[b][n]: a 64x64 tile per 256-thread
// block, a 4x4 register micro-tile per thread, 16-deep shared-memory steps
// over b with the next step loaded into registers while one is multiplied.
// betas^T is read along k (contiguous), g along n (contiguous), both stored
// as [b][.] tiles.
__global__ void __launch_bounds__(DD_THREADS)
ddirs_kernel(const float* __restrict__ betas, const float* __restrict__ g, float* __restrict__ d_dirs, int B,
             int K, int N, int ldg) {
  __shared__ __align__(16) float As[DD_BK][DD_BM + DD_PAD];  // betas tile: [b][k]
  __shared__ __align__(16) float Bs[DD_BK][DD_BN + DD_PAD];  // g tile: [b][n]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * DD_BN;
  const int m0 = blockIdx.y * DD_BM;  // rows of d_dirs: k

  const int l_c = tid & 63;  // loader: contiguous column (k of betas, n of g)
  const int l_b = tid >> 6;  // loader: b within the tile, +4 per pass
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[DD_TM][DD_TN];
#pragma unroll
  for (int i = 0; i < DD_TM; ++i)
#pragma unroll
    for (int j = 0; j < DD_TN; ++j) acc[i][j] = 0.f;

  float a_reg[4];
  float b_reg[4];
  auto load_tile = [&](int bb0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = bb0 + l_b + 4 * i;
      const int k = m0 + l_c;
      const int n = n0 + l_c;
      a_reg[i] = (b < B && k < K) ? betas[static_cast<size_t>(b) * K + k] : 0.f;
      b_reg[i] = (b < B && n < N) ? g[static_cast<size_t>(b) * ldg + n] : 0.f;
    }
  };

  load_tile(0);
  for (int bb0 = 0; bb0 < B; bb0 += DD_BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[l_b + 4 * i][l_c] = a_reg[i];
      Bs[l_b + 4 * i][l_c] = b_reg[i];
    }
    __syncthreads();
    if (bb0 + DD_BK < B) load_tile(bb0 + DD_BK);
#pragma unroll
    for (int kk = 0; kk < DD_BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * DD_TM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * DD_TN]);
      const float a[DD_TM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[DD_TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < DD_TM; ++i)
#pragma unroll
        for (int j = 0; j < DD_TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < DD_TM; ++i) {
    const int k = m0 + ty * DD_TM + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < DD_TN; ++j) {
      const int n = n0 + tx * DD_TN + j;
      if (n < N) d_dirs[static_cast<size_t>(k) * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// g (B, N) with rows `ldg` floats apart, dirs (K, N) with rows `ldd` floats
// apart (both >= N, unit column stride), betas (B, K) contiguous: fp32, on
// `device`; the outputs are contiguous. partial holds chunks * B * K floats
// and tmpl_partial 4 * ceil(B / 64) * N;
// `chunk` (a multiple of 32) is the length of N each split-K block covers and
// chunks = ceil(N / chunk). d_dirs may be null (not computed). Launches on
// `stream` and returns the first CUDA error, if any.
extern "C" int d3d_blend_shapes_bwd_f32(const float* g, const float* dirs, const float* betas, float* partial,
                                        float* tmpl_partial, float* d_betas, float* d_tmpl, float* d_dirs, int B,
                                        int K, int N, int ldg, int ldd, int chunk, int device,
                                        cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || K <= 0 || N <= 0) return 0;
  if (chunk <= 0 || chunk % DB_BC != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (N + chunk - 1) / chunk;
  const int b_tiles = (B + DB_BM - 1) / DB_BM;
  const dim3 grid((K + DB_BJ - 1) / DB_BJ, b_tiles, chunks);
  const bool g_vec = d3d::rows_aligned16(g, ldg), d_vec = d3d::rows_aligned16(dirs, ldd);
  if (g_vec && d_vec) err = launch_dbetas<true, true>(grid, g, dirs, partial, tmpl_partial, B, K, N, ldg, ldd, chunk, stream);
  else if (g_vec) err = launch_dbetas<true, false>(grid, g, dirs, partial, tmpl_partial, B, K, N, ldg, ldd, chunk, stream);
  else if (d_vec) err = launch_dbetas<false, true>(grid, g, dirs, partial, tmpl_partial, B, K, N, ldg, ldd, chunk, stream);
  else err = launch_dbetas<false, false>(grid, g, dirs, partial, tmpl_partial, B, K, N, ldg, ldd, chunk, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = B * K + N;
  dbetas_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(partial, tmpl_partial, d_betas, d_tmpl, B * K,
                                                                chunks, N, DB_TMPL_ROWS * b_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || d_dirs == nullptr) return static_cast<int>(err);
  const dim3 grid_dirs((N + DD_BN - 1) / DD_BN, (K + DD_BM - 1) / DD_BM);
  ddirs_kernel<<<grid_dirs, DD_THREADS, 0, stream>>>(betas, g, d_dirs, B, K, N, ldg);
  return static_cast<int>(cudaGetLastError());
}
