// Fused FLAME blendshape GEMM: out = betas @ shapedirs + template, to fp32
// accuracy on the tensor cores (3xTF32, tf32x3.cuh: each product keeps about
// 20 of fp32's 24 bits, the sums are fp32). At B = 256 on the FLAME
// shapedirs the scheme, emulated in numpy (tests/test_torch_kernels.py), lies
// 6.2e-8 from an fp64 product (3.5e-7 of the largest output); a plain fp32
// product lies 5.6e-8 from it.
//
// Replaces: dad3dheads_tpu/ops/blendshapes.py, blend_shapes_fused_pallas
// (its Pallas kernel _kernel), the widest matmul of every FLAME decode.
//
// What bounds it on the H100: betas (B, 400) x shapedirs (400, 15069), fp32.
// 3xTF32 issues three tf32 MMAs per product: 3 * 2 * B * 400 * 15069
// operations at the 495 TFLOP/s tf32 peak (B = 256: 9.26 GFLOP, >= 18.7 us)
// against one read of the 24 MB shapedirs plus betas, template and the
// output (B = 256: 39.6 MB, >= 11.8 us at 3.35 TB/s). So operations bound it
// at B = 256 and bytes at B <= 64 (B = 1: a pure 24 MB read, >= 7.2 us). For
// comparison, the same work in fp32 outside the tensor cores is bounded at
// 46 us (B = 256, 67 TFLOP/s).
//
// Design. A block computes a BM x BN output tile over all of K in BK-deep
// steps. A ring of STAGES shared-memory stages is filled by cp.async, so
// STAGES - 1 steps are in flight while one is multiplied, with one
// __syncthreads per step. Each warp owns a WM x WN sub-tile of m16n8k8
// fragments; it reads its fragments from shared memory (padded row strides:
// no bank conflicts), splits each element once into tf32 hi and lo, and
// reuses the split B fragments over its m tiles and the A fragments over its
// n tiles. What limits mma.sync here is the work around the MMAs (fragment
// loads and splits), so the large tile gives each warp a 64 x 64 sub-tile:
// 32 split elements for every 96 MMAs. Three configurations of the one
// kernel, picked by B:
//   B > 64:       128 x 128 tile, 4 warps of 64 x 64, 16-deep steps,
//                 4 stages (76 KB), 2 blocks per SM (B = 256: 236 blocks,
//                 all resident at once);
//   16 < B <= 64: 64 x 64 tile, 4 warps of 32 x 32, 32-deep steps, 4 stages
//                 (236 blocks);
//   B <= 16:      16 x 64 tile, 4 warps of 16 x 16, 16-deep steps, 8 stages
//                 (236 blocks): memory-bound, so the deep ring keeps bytes
//                 in flight.
// Row strides: the kernel takes the row stride of shapedirs. The port's FLAME
// constants pad its rows to 15,072 floats (core/flame.py), so every row is
// 16-byte aligned and is copied 16 bytes at a time (cp.async.cg); an operand
// whose rows are not (a contiguous (400, 15069) shapedirs: 60,276 bytes
// apart, 4 mod 16) is copied 4 bytes per element (cp.async.ca), which moves
// the same bytes with four times the copy instructions. The copy width is a
// compile-time choice per operand (one instantiation each), picked at launch.
// The ragged B and N edges are zero-filled on load and masked on store; K
// needs no mask when it is a multiple of BK (400 is) and is zero-filled
// otherwise. The template add is fused into the one masked write.

#include "smem_opt_in.cuh"
#include "tf32x3.cuh"

namespace {

template <int BM, int BN, int BK, int WM, int WN, int STAGES>
struct Tile {
  static constexpr int THREADS = (BM / WM) * (BN / WN) * 32;
  static constexpr int LDA = BK + 4;  // [m][k]: fragment reads hit 32 banks
  static constexpr int LDB = BN + 8;  // [k][n]: likewise
  static constexpr int A_STAGE = BM * LDA;
  static constexpr int B_STAGE = BK * LDB;
  static constexpr size_t SMEM = static_cast<size_t>(STAGES) * (A_STAGE + B_STAGE) * sizeof(float);
  static_assert(WM % 16 == 0 && WN % 8 == 0 && BK % 8 == 0 && BM % WM == 0 && BN % WN == 0, "m16n8k8 fragments");
};

template <int BM, int BN, int BK, int WM, int WN, int STAGES, int MIN_BLOCKS, bool A_VEC, bool B_VEC>
__global__ void __launch_bounds__(Tile<BM, BN, BK, WM, WN, STAGES>::THREADS, MIN_BLOCKS)
blend_shapes_kernel(const float* __restrict__ betas, const float* __restrict__ dirs,
                    const float* __restrict__ tmpl, float* __restrict__ out, int B, int K, int N, int ldb) {
  using T = Tile<BM, BN, BK, WM, WN, STAGES>;
  constexpr int MT = WM / 16, NT = WN / 8, WARPS_N = BN / WN;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                        // [STAGES][BM][LDA]
  float* Bs = smem + STAGES * T::A_STAGE;  // [STAGES][BK][LDB]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int steps = (K + BK - 1) / BK;

  auto load = [&](int step) {
    const int slot = step % STAGES, k0 = step * BK;
    d3d::copy_tile_async<BM, BK, T::LDA, T::THREADS, A_VEC>(As + slot * T::A_STAGE, betas, K, m0, B, k0, K);
    d3d::copy_tile_async<BK, BN, T::LDB, T::THREADS, B_VEC>(Bs + slot * T::B_STAGE, dirs, ldb, k0, K, n0, N);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    d3d::cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    d3d::cp_async_wait<STAGES - 2>();  // this step's group has landed
    __syncthreads();                    // for every thread; the previous step's slot is free
    if (step + STAGES - 1 < steps) load(step + STAGES - 1);
    d3d::cp_async_commit();

    const float* a = As + (step % STAGES) * T::A_STAGE;
    const float* b = Bs + (step % STAGES) * T::B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t b_hi[NT][2], b_lo[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* p = b + (kk + tig) * T::LDB + wn0 + j * 8 + gid;  // b0 (k = t, n = g), b1 (k = t + 4)
        d3d::split_tf32(p[0], b_hi[j][0], b_lo[j][0]);
        d3d::split_tf32(p[4 * T::LDB], b_hi[j][1], b_lo[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a_hi[4], a_lo[4];
        d3d::load_a_frag(a + (wm0 + i * 16 + gid) * T::LDA + kk + tig, T::LDA, a_hi, a_lo);
        d3d::mma_3xtf32_row(acc[i], a_hi, a_lo, b_hi, b_lo);
      }
    }
  }
  d3d::cp_async_wait<0>();

  // Epilogue: the template add fused into the one masked write. Fragment
  // element r sits at row g + 8 * (r / 2), column 2 * t + r % 2.
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + wn0 + j * 8 + 2 * tig;
    const float t0 = n < N ? tmpl[n] : 0.f;
    const float t1 = n + 1 < N ? tmpl[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm0 + i * 16 + gid + 8 * h;
        if (m >= B) continue;
        float* row = out + static_cast<size_t>(m) * N;
        if (n < N) row[n] = acc[i][j][2 * h] + t0;
        if (n + 1 < N) row[n + 1] = acc[i][j][2 * h + 1] + t1;
      }
    }
  }
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES, int MIN_BLOCKS, bool A_VEC, bool B_VEC>
cudaError_t launch_as(const float* betas, const float* dirs, const float* tmpl, float* out, int B, int K, int N,
                      int ldb, cudaStream_t stream) {
  using T = Tile<BM, BN, BK, WM, WN, STAGES>;
  auto kernel = blend_shapes_kernel<BM, BN, BK, WM, WN, STAGES, MIN_BLOCKS, A_VEC, B_VEC>;
  static std::atomic<uint64_t> opted_in{0};  // this instantiation's devices
  const cudaError_t attr = d3d::opt_in_smem(kernel, static_cast<int>(T::SMEM), opted_in);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(betas, dirs, tmpl, out, B, K, N, ldb);
  return cudaGetLastError();
}

// One configuration, with the copy width of each operand picked from its alignment.
template <int BM, int BN, int BK, int WM, int WN, int STAGES, int MIN_BLOCKS>
cudaError_t launch(const float* betas, const float* dirs, const float* tmpl, float* out, int B, int K, int N,
                   int ldb, cudaStream_t stream) {
  const bool a_vec = d3d::rows_aligned16(betas, K), b_vec = d3d::rows_aligned16(dirs, ldb);
  if (a_vec && b_vec)
    return launch_as<BM, BN, BK, WM, WN, STAGES, MIN_BLOCKS, true, true>(betas, dirs, tmpl, out, B, K, N, ldb, stream);
  if (a_vec)
    return launch_as<BM, BN, BK, WM, WN, STAGES, MIN_BLOCKS, true, false>(betas, dirs, tmpl, out, B, K, N, ldb, stream);
  if (b_vec)
    return launch_as<BM, BN, BK, WM, WN, STAGES, MIN_BLOCKS, false, true>(betas, dirs, tmpl, out, B, K, N, ldb, stream);
  return launch_as<BM, BN, BK, WM, WN, STAGES, MIN_BLOCKS, false, false>(betas, dirs, tmpl, out, B, K, N, ldb, stream);
}

}  // namespace

// betas (B, K), tmpl (N,), out (B, N): fp32, contiguous; dirs (K, N): fp32
// rows `ldb` floats apart (ldb >= N), unit column stride; all on `device`.
// Launches on `stream` and returns the first CUDA error, if any.
extern "C" int d3d_blend_shapes_f32(const float* betas, const float* dirs, const float* tmpl, float* out, int B,
                                    int K, int N, int ldb, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0) return 0;
  if (B > 64) err = launch<128, 128, 16, 64, 64, 4, 2>(betas, dirs, tmpl, out, B, K, N, ldb, stream);
  else if (B > 16) err = launch<64, 64, 32, 32, 32, 4, 1>(betas, dirs, tmpl, out, B, K, N, ldb, stream);
  else err = launch<16, 64, 16, 16, 16, 8, 1>(betas, dirs, tmpl, out, B, K, N, ldb, stream);
  return static_cast<int>(err);
}
