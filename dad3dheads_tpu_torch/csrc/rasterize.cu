// Z-buffer rasterization of one mesh: per pixel, the depth, id and barycentric
// weights of the triangle with the largest interpolated z.
//
// Replaces: dad3dheads_tpu/render/rasterizer_pallas.py, rasterize_buffers_pallas
// (its Pallas kernel _kernel), the rasterizer of the PNCC and UV-texture paths.
//
// Semantics are those of the XLA rasterize_buffers in
// dad3dheads_tpu/render/rasterizer.py, which the port's plain version repeats:
// depth starts at -1e8 and id at -1; a pixel (x, y) at integer coordinates is
// inside a triangle when its three barycentric weights are >= -1e-5; triangles
// with |doubled area| <= 1e-12 are rejected; the largest z wins and, on an
// exact tie, the lowest triangle index. Each pixel scans the triangles in the
// caller's order and takes a triangle only on a strictly larger z, which gives
// that tie rule. (The TPU kernel sorts faces by tile first, which changes the
// tie order; this one does not sort.) The edge functions, the reciprocal of
// the area and the interpolated z are evaluated in the XLA expression order
// with every operation rounded on its own (__fmul_rn, __fsub_rn, __fadd_rn,
// __frcp_rn: no FMA contraction), so that the +-1e-5 inside test decides
// edge pixels as the plain version does, and so that equal-depth meshes (the
// UV layout, where z is constant) break ties on the same rounded z.
//
// What bounds it on the H100: the pixel-triangle tests. The bytes are small
// (20 bytes written per pixel, 36 read per triangle); the work per pixel is
// one edge-function evaluation per triangle whose box covers it.
//
// Design: a setup kernel gathers each triangle's corners, its reciprocal area
// and its screen box (widened by 1 px + 1e-3 of its extent, far more than the
// 1e-5 barycentric tolerance can reach past the triangle; degenerate
// triangles get an empty box) and reduces the boxes of each run of 128
// triangles, in the caller's order, to one chunk box. The raster kernel runs
// one thread per pixel in 16x16 blocks: a block skips every chunk whose box
// misses its tile, stages the others' 128 triangles in shared memory, and each
// thread tests only the triangles whose box holds its pixel. Any H and W: the
// ragged edge is masked, with no padding to a tile multiple.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CHUNK = 128;
constexpr int TILE = 16;
constexpr float ZBUF_INIT = -1e8f;
constexpr float EPS = 1e-5f;
constexpr float MIN_AREA = 1e-12f;

// One triangle, 16 floats: corners, 1/area, widened box.
struct Tri {
  float x0, y0, z0, x1, y1, z1, x2, y2, z2;
  float inv_area;
  float min_x, max_x, min_y, max_y;
  float pad0, pad1;
};
static_assert(sizeof(Tri) == 64, "Tri is staged as 16 floats");

__global__ void __launch_bounds__(CHUNK)
setup_kernel(const float* __restrict__ vertices, const int* __restrict__ faces, Tri* __restrict__ tris,
             float4* __restrict__ chunk_box, int V, int T) {
  __shared__ float s_box[4][CHUNK];
  const int i = blockIdx.x * CHUNK + threadIdx.x;
  float box[4] = {INFINITY, -INFINITY, INFINITY, -INFINITY};  // min_x, max_x, min_y, max_y
  if (i < T) {
    float c[9];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int v = min(max(faces[3 * i + k], 0), V - 1);  // a gather clamps, as XLA's does
      c[3 * k] = vertices[3 * v];
      c[3 * k + 1] = vertices[3 * v + 1];
      c[3 * k + 2] = vertices[3 * v + 2];
    }
    Tri t;
    t.x0 = c[0]; t.y0 = c[1]; t.z0 = c[2];
    t.x1 = c[3]; t.y1 = c[4]; t.z1 = c[5];
    t.x2 = c[6]; t.y2 = c[7]; t.z2 = c[8];
    // (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    const float area = __fsub_rn(__fmul_rn(__fsub_rn(t.x1, t.x0), __fsub_rn(t.y2, t.y0)),
                                 __fmul_rn(__fsub_rn(t.x2, t.x0), __fsub_rn(t.y1, t.y0)));
    const bool ok = fabsf(area) > MIN_AREA;
    t.inv_area = ok ? __frcp_rn(area) : 0.0f;
    if (ok) {
      const float lo_x = fminf(t.x0, fminf(t.x1, t.x2)), hi_x = fmaxf(t.x0, fmaxf(t.x1, t.x2));
      const float lo_y = fminf(t.y0, fminf(t.y1, t.y2)), hi_y = fmaxf(t.y0, fmaxf(t.y1, t.y2));
      const float margin = 1.0f + 1e-3f * fmaxf(hi_x - lo_x, hi_y - lo_y);
      box[0] = lo_x - margin;
      box[1] = hi_x + margin;
      box[2] = lo_y - margin;
      box[3] = hi_y + margin;
    }
    t.min_x = box[0]; t.max_x = box[1]; t.min_y = box[2]; t.max_y = box[3];
    t.pad0 = t.pad1 = 0.0f;
    tris[i] = t;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) s_box[k][threadIdx.x] = box[k];
  __syncthreads();
  for (int stride = CHUNK / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      const int o = threadIdx.x + stride;
      s_box[0][threadIdx.x] = fminf(s_box[0][threadIdx.x], s_box[0][o]);
      s_box[1][threadIdx.x] = fmaxf(s_box[1][threadIdx.x], s_box[1][o]);
      s_box[2][threadIdx.x] = fminf(s_box[2][threadIdx.x], s_box[2][o]);
      s_box[3][threadIdx.x] = fmaxf(s_box[3][threadIdx.x], s_box[3][o]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    chunk_box[blockIdx.x] = make_float4(s_box[0][0], s_box[1][0], s_box[2][0], s_box[3][0]);
  }
}

__global__ void __launch_bounds__(TILE * TILE)
raster_kernel(const Tri* __restrict__ tris, const float4* __restrict__ chunk_box, float* __restrict__ depth,
              int* __restrict__ tri_id, float* __restrict__ bary, int T, int H, int W) {
  __shared__ Tri s_tri[CHUNK];
  const int tid = threadIdx.y * TILE + threadIdx.x;
  const int x = blockIdx.x * TILE + threadIdx.x;
  const int y = blockIdx.y * TILE + threadIdx.y;
  const bool in_image = x < W && y < H;
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  const float tile_x0 = static_cast<float>(blockIdx.x * TILE);
  const float tile_y0 = static_cast<float>(blockIdx.y * TILE);
  const float tile_x1 = tile_x0 + (TILE - 1);
  const float tile_y1 = tile_y0 + (TILE - 1);

  float best_z = ZBUF_INIT;
  int best_id = -1;
  float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f;
  const int n_chunks = (T + CHUNK - 1) / CHUNK;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const float4 cb = chunk_box[ch];  // min_x, max_x, min_y, max_y: the same for the whole block
    if (cb.x > tile_x1 || cb.y < tile_x0 || cb.z > tile_y1 || cb.w < tile_y0) continue;
    const int base = ch * CHUNK;
    const int n = min(CHUNK, T - base);
    __syncthreads();  // the previous chunk's readers are done with s_tri
    const float* src = reinterpret_cast<const float*>(tris + base);
    float* dst = reinterpret_cast<float*>(s_tri);
    for (int k = tid; k < n * 16; k += TILE * TILE) dst[k] = src[k];
    __syncthreads();
    if (!in_image) continue;
    for (int t = 0; t < n; ++t) {
      const Tri& q = s_tri[t];
      if (px < q.min_x || px > q.max_x || py < q.min_y || py > q.max_y) continue;
      // w0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)) * inv_area
      const float w0 = __fmul_rn(
          __fsub_rn(__fmul_rn(__fsub_rn(q.x1, px), __fsub_rn(q.y2, py)),
                    __fmul_rn(__fsub_rn(q.x2, px), __fsub_rn(q.y1, py))),
          q.inv_area);
      // w1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)) * inv_area
      const float w1 = __fmul_rn(
          __fsub_rn(__fmul_rn(__fsub_rn(q.x2, px), __fsub_rn(q.y0, py)),
                    __fmul_rn(__fsub_rn(q.x0, px), __fsub_rn(q.y2, py))),
          q.inv_area);
      const float w2 = __fsub_rn(__fsub_rn(1.0f, w0), w1);
      if (!(w0 >= -EPS && w1 >= -EPS && w2 >= -EPS)) continue;
      // z = w0 * z0 + w1 * z1 + w2 * z2
      const float z = __fadd_rn(__fadd_rn(__fmul_rn(w0, q.z0), __fmul_rn(w1, q.z1)),
                                __fmul_rn(w2, q.z2));
      if (z > best_z) {
        best_z = z;
        best_id = base + t;
        b0 = w0;
        b1 = w1;
        b2 = w2;
      }
    }
  }
  if (in_image) {
    const long long p = static_cast<long long>(y) * W + x;
    depth[p] = best_z;
    tri_id[p] = best_id;
    bary[3 * p] = b0;
    bary[3 * p + 1] = b1;
    bary[3 * p + 2] = b2;
  }
}

}  // namespace

// vertices (V, 3) fp32, faces (T, 3) int32, scratch tris (ceil(T/128)*128, 16)
// fp32 and chunk_box (ceil(T/128), 4) fp32, outputs depth (H, W) fp32, tri_id
// (H, W) int32 and bary (H, W, 3) fp32, all contiguous on `device`. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int d3d_rasterize(const float* vertices, const int* faces, float* tris, float* chunk_box,
                             float* depth, int* tri_id, float* bary, int V, int T, int H, int W,
                             int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (H <= 0 || W <= 0) return 0;
  const int n_chunks = (T + CHUNK - 1) / CHUNK;
  if (n_chunks > 0) {
    setup_kernel<<<n_chunks, CHUNK, 0, stream>>>(vertices, faces, reinterpret_cast<Tri*>(tris),
                                                 reinterpret_cast<float4*>(chunk_box), V, T);
  }
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE);
  raster_kernel<<<grid, dim3(TILE, TILE), 0, stream>>>(
      reinterpret_cast<const Tri*>(tris), reinterpret_cast<const float4*>(chunk_box), depth, tri_id,
      bary, T, H, W);
  return static_cast<int>(cudaGetLastError());
}
