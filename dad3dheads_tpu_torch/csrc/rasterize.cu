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
// exact tie, the lowest triangle index. (The TPU kernel sorts faces by tile
// first, which changes the tie order; this one keeps the caller's.) The edge
// functions, the reciprocal of the area and the interpolated z are evaluated
// in the XLA expression order with every operation rounded on its own
// (__fmul_rn, __fsub_rn, __fadd_rn, __frcp_rn: no FMA contraction), so that
// the +-1e-5 inside test decides edge pixels as the plain version does, and
// so that equal-depth meshes (the UV layout, where z is constant) break ties
// on the same rounded z. A pixel tests a triangle only inside its widened
// box: 1 px + 1e-3 of its extent past the triangle, more for a long thin
// one, or the whole image for a sliver whose rounding could carry a pixel
// anywhere into the inside test (box_margin, which the plain version repeats
// to cull its rows by). No pixel outside the box passes the test, so kernel
// and plain agree bit for bit.
// The one departure, a NaN z: the kernel skips that triangle alone (a NaN
// never passes z > best, and the merge never takes it), as if it were not in
// the mesh. The XLA and plain versions let it void the winner of its chunk of
// 1,024 triangles of the caller's order at that pixel; the reference's Pallas
// kernel voids other chunks (128, after a sort by tile), so there is no one
// chunk rule to copy. tests/test_torch_render.py pins both rules.
//
// What bounds it on the H100: the pixel-triangle tests (26 fp32 operations
// for each pixel inside a triangle's box; at 512x640 the FLAME mesh has
// about 12 million such pairs). The bytes are small: 20 written per pixel, 36 read per
// triangle.
//
// Design: per-tile triangle lists in the caller's order, two kernels.
//   1. setup: one thread per triangle gathers its corners and computes its
//      doubled area, reciprocal and widened box (a 64-byte record), and the
//      box as integer pixel bounds clamped to the image (8 bytes; empty when
//      the triangle is degenerate, has a non-finite corner or lies off the
//      image); one thread per pixel clears its merge key, one per tile its
//      count of finished slices.
//   2. raster: one block of four warps per work item, a 32x16 tile against a
//      slice of 512 triangles of the caller's order. The block keeps the
//      slice's triangles whose pixel bounds meet the tile by a block-wide
//      prefix sum of per-thread counts (the list is ascending by
//      construction: no sort, no atomics) and stages their records in shared
//      memory 128 at a time, so that a list of any length is processed in
//      rounds. Each warp owns a 16x8 region, each lane four pixels of it (8
//      columns and 4 rows apart: four independent evaluations that share the
//      triangle's corner offsets). A warp ballots which staged triangles
//      meet its region: the box, and then the three edge functions at the
//      region's corners with a margin for the rounding (see region_outside:
//      a region wholly outside one edge holds no pixel that can pass the
//      inside test), which halves the evaluations on FLAME. It
//      walks the kept ones in ascending order, each lane keeping a strict
//      z > best per pixel, so that within a slice the lowest index wins a
//      tie. It merges each pixel's winner into a 64-bit key with atomicMax:
//      the high word z mapped to an order-preserving unsigned (with -0 folded
//      into +0, which compares equal), the low word ~id. The tile's last
//      slice to finish (a per-tile count) then writes the tile's pixels: the
//      winner's id, and its weights and z evaluated again with the same code.
// Why slices: FLAME's faces are not in spatial order, and their boxes pile up
// unevenly, so a few tiles hold far more (pixel, box) pairs than the mean
// tile, and with one block per tile the card waits on those few. Slices of
// the index range spread a busy tile over several blocks, at the cost of an
// order-free merge between slices. (A persistent cooperative kernel taking items from a queue,
// and larger or smaller slices, timed slower on the H100.)
// Why the merge is exact: max over (z, then lower id) picks the same triangle
// as the ordered strict > scan. z is computed per (pixel, triangle) pair
// whatever the order; a slice's winner is its first triangle of largest z; a
// NaN z never beats a number under either rule (a slice never takes it); z
// must exceed -1e8 to be taken (at the start id is -1 and depth -1e8, so a z
// of exactly -1e8 or below never wins), so a taken key is never 0, the
// cleared value; and ties, including -0 against +0, go to the lower id. The
// depth written is the winner's own z, evaluated again, so -0 keeps its sign.
// Boxes: a box is clamped to the image before it becomes pixel bounds, so
// huge, infinite or off-image coordinates never overflow the 16-bit bounds or
// widen a tile's list; a triangle with a non-finite corner can never pass the
// inside test (its area is inf or NaN: NaN is rejected, and for inf one of
// w0, w1 is NaN at every pixel), so its empty box drops nothing. Any H and W
// up to 32,767: ragged edge tiles are masked, with no padding.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int PIX_X = 2, PIX_Y = 2;      // pixels per lane, 8 columns and 4 rows apart
constexpr int WARPS_X = 2, WARPS_Y = 2;  // warps per tile
constexpr int SLICE = 512;               // triangles of the caller's order per work item
constexpr int BATCH = 128;               // triangle records staged at once
constexpr int WARPS = WARPS_X * WARPS_Y;
constexpr int THREADS = 32 * WARPS;
constexpr int REGION_W = 8 * PIX_X, REGION_H = 4 * PIX_Y;  // a warp's pixels: its lanes as 8x4, PIX_X x PIX_Y times
constexpr int TILE_W = REGION_W * WARPS_X, TILE_H = REGION_H * WARPS_Y;
constexpr int PER_THREAD = SLICE / THREADS;
constexpr int FLAT = 256;  // threads of a block of the per-element setup kernel
constexpr float ZBUF_INIT = -1e8f;
constexpr float EPS = 1e-5f;
constexpr float MIN_AREA = 1e-12f;
constexpr float U = 0x1p-24f;  // fp32's unit roundoff
static_assert(PER_THREAD >= 1 && PER_THREAD * THREADS == SLICE && PER_THREAD <= 32,
              "a thread's share of a slice is one mask word");

// One triangle: widened box (min_x, max_x, min_y, max_y), corners, doubled
// area and its reciprocal.
struct Tri {
  float4 box;
  float x0, y0, z0, x1;
  float y1, z1, x2, y2;
  float z2, inv_area, area, pad;
};
static_assert(sizeof(Tri) == 64, "a record is four float4");

// The barycentric weights and z of a pixel in triangle q, from the corners'
// offsets to the pixel (x_k - px, y_k - py), in the XLA expression order;
// true when the pixel is inside.
__device__ __forceinline__ bool weights(const Tri& q, float dx0, float dx1, float dx2, float dy0, float dy1,
                                        float dy2, float& w0, float& w1, float& w2, float& z) {
  // w0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)) * inv_area
  w0 = __fmul_rn(__fsub_rn(__fmul_rn(dx1, dy2), __fmul_rn(dx2, dy1)), q.inv_area);
  // w1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)) * inv_area
  w1 = __fmul_rn(__fsub_rn(__fmul_rn(dx2, dy0), __fmul_rn(dx0, dy2)), q.inv_area);
  w2 = __fsub_rn(__fsub_rn(1.0f, w0), w1);
  // z = w0 * z0 + w1 * z1 + w2 * z2
  z = __fadd_rn(__fadd_rn(__fmul_rn(w0, q.z0), __fmul_rn(w1, q.z1)), __fmul_rn(w2, q.z2));
  return w0 >= -EPS && w1 >= -EPS && w2 >= -EPS;
}

// The merge key of a taken (z > -1e8, not NaN) winner: larger z, then lower id, is larger.
__device__ __forceinline__ unsigned long long merge_key(float z, int id) {
  uint32_t u = __float_as_uint(__fadd_rn(z, 0.0f));  // -0 + 0 = +0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<uint32_t>(~id);
}

// True when no pixel of the region [rx0, rx1] x [ry0, ry1] can pass the
// inside test of triangle q, whose box meets the region: one of its edge
// functions is below its tolerance at all four corners, and so (being
// affine) everywhere in the region. Each fp32 operation errs by at most
// u = 2^-24 relative, so an edge function evaluated here at a corner, or by
// the weights at a pixel, is within 4.1u * M of the exact value, M being the
// sum of its two products' magnitudes over the region; w2 = 1 - w0 - w1 adds
// the errors of w0, w1 and the area (whose products sum to ma). The margin
// takes all of these together, times about two, plus twice the -1e-5
// tolerance: tol + 32u * (m0 + m1 + m2 + ma). An overflow or a NaN makes a
// comparison false, and a region is then kept; so is every region of a
// triangle of infinite area (inv_area 0: a weight may be 0 anywhere).
__device__ __forceinline__ float abs_max(float a, float b) { return fmaxf(fabsf(a), fabsf(b)); }

// max over the corners of s * ((xa - px) * (yb - py) - (xc - px) * (yd - py))
__device__ __forceinline__ float edge_max(float s, const float (&xa)[2], const float (&yb)[2], const float (&xc)[2],
                                          const float (&yd)[2]) {
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) m = fmaxf(m, s * __fsub_rn(__fmul_rn(xa[i], yb[j]), __fmul_rn(xc[i], yd[j])));
  }
  return m;
}

__device__ __forceinline__ bool region_outside(const Tri& q, float rx0, float rx1, float ry0, float ry1) {
  if (!(fabsf(q.area) < INFINITY)) return false;
  const float s = q.area > 0.0f ? 1.0f : -1.0f;
  const float X0[2] = {__fsub_rn(q.x0, rx0), __fsub_rn(q.x0, rx1)};
  const float X1[2] = {__fsub_rn(q.x1, rx0), __fsub_rn(q.x1, rx1)};
  const float X2[2] = {__fsub_rn(q.x2, rx0), __fsub_rn(q.x2, rx1)};
  const float Y0[2] = {__fsub_rn(q.y0, ry0), __fsub_rn(q.y0, ry1)};
  const float Y1[2] = {__fsub_rn(q.y1, ry0), __fsub_rn(q.y1, ry1)};
  const float Y2[2] = {__fsub_rn(q.y2, ry0), __fsub_rn(q.y2, ry1)};
  const float x0 = abs_max(X0[0], X0[1]), x1 = abs_max(X1[0], X1[1]), x2 = abs_max(X2[0], X2[1]);
  const float y0 = abs_max(Y0[0], Y0[1]), y1 = abs_max(Y1[0], Y1[1]), y2 = abs_max(Y2[0], Y2[1]);
  const float m0 = x1 * y2 + x2 * y1, m1 = x2 * y0 + x0 * y2, m2 = x0 * y1 + x1 * y0;  // w0's, w1's, w2's
  const float ma = fabsf((q.x1 - q.x0) * (q.y2 - q.y0)) + fabsf((q.x2 - q.x0) * (q.y1 - q.y0));  // the area's
  const float margin = 2.0f * EPS * fabsf(q.area) + 0x1p-19f * (m0 + m1 + m2 + ma);  // 0x1p-19 = 32u
  return edge_max(s, X1, Y2, X2, Y1) < -margin || edge_max(s, X2, Y0, X0, Y2) < -margin ||
         edge_max(s, X0, Y1, X1, Y0) < -margin;
}

// How far past its box a triangle is tested, so that no pixel beyond passes
// the inside test: 1 px + 1e-3 of its extent E, or the smaller root of
// d / (2E) = tol + k (E + d)^2 where that is larger, or infinity where the
// margin or the farthest pixel of the image falls outside the roots. The
// plain version's box_margin (render/rasterizer.py) computes the same and
// gives the bound: a pixel d past the box has an exact weight <= -d / (2E),
// and the right-hand side is twice what rounding and the tolerance can add.
__device__ __forceinline__ bool clear(float d, float extent, float tol, float k) {
  return d / (2.0f * extent) > tol + k * (extent + d) * (extent + d);
}

__device__ __forceinline__ float box_margin(float lo_x, float hi_x, float lo_y, float hi_y, float area, int H,
                                            int W) {
  const float extent = fmaxf(hi_x - lo_x, hi_y - lo_y);
  const float a = fabsf(area);
  const float tol = 2.0f * EPS + 16.0f * U * extent * extent / a;
  const float k = 64.0f * U / a;
  const float b = 0.5f / extent;
  const float root = (1.0f + 2.0f * tol) / (b + sqrtf(fmaxf(b * b - 4.0f * k * (0.5f + tol), 0.0f))) - extent;
  const float margin = fmaxf(1.0f + 1e-3f * extent, 1.0625f * root);
  const float coord = fmaxf(fmaxf(fabsf(lo_x), fabsf(hi_x)), fmaxf(fabsf(lo_y), fabsf(hi_y)));
  const float near = margin - 4.0f * U * (coord + margin);  // less the box's own rounding
  const float far =
      fmaxf(fmaxf(lo_x, static_cast<float>(W - 1) - hi_x), fmaxf(lo_y, static_cast<float>(H - 1) - hi_y)) + 1.0f;
  const bool sound = 16.0f * U * extent * extent <= 0.125f * a &&
                     (far <= near || (clear(near, extent, tol, k) && clear(far, extent, tol, k)));
  return sound ? margin : INFINITY;
}

// Integer pixel bounds [lo, hi] of a box edge pair, clamped to [0, n): a pixel
// p passes lo_f <= p <= hi_f exactly when lo <= p <= hi.
__device__ __forceinline__ void pixel_bounds(float lo_f, float hi_f, int n, short& lo, short& hi) {
  lo = static_cast<short>(fminf(fmaxf(ceilf(lo_f), 0.0f), static_cast<float>(n)));
  hi = static_cast<short>(fminf(fmaxf(floorf(hi_f), -1.0f), static_cast<float>(n - 1)));
}

// Triangle q against each of a lane's pixels (px0 + 8 i, py0 + 4 j): where
// the pixel lies inside the box and the triangle and its z beats the pixel's
// best (strict z > best: in the caller's order the first of equal z stays),
// the triangle becomes its best.
__device__ __forceinline__ void take(const Tri& q, int id, float px0, float py0, float (&best_z)[PIX_X][PIX_Y],
                                     int (&best_id)[PIX_X][PIX_Y]) {
  const float4 bx = q.box;
  float dx0[PIX_X], dx1[PIX_X], dx2[PIX_X], dy0[PIX_Y], dy1[PIX_Y], dy2[PIX_Y];
  bool in_x[PIX_X], in_y[PIX_Y];
#pragma unroll
  for (int i = 0; i < PIX_X; ++i) {
    const float px = px0 + 8.0f * i;
    in_x[i] = !(px < bx.x || px > bx.y);
    dx0[i] = __fsub_rn(q.x0, px);
    dx1[i] = __fsub_rn(q.x1, px);
    dx2[i] = __fsub_rn(q.x2, px);
  }
#pragma unroll
  for (int j = 0; j < PIX_Y; ++j) {
    const float py = py0 + 4.0f * j;
    in_y[j] = !(py < bx.z || py > bx.w);
    dy0[j] = __fsub_rn(q.y0, py);
    dy1[j] = __fsub_rn(q.y1, py);
    dy2[j] = __fsub_rn(q.y2, py);
  }
#pragma unroll
  for (int i = 0; i < PIX_X; ++i) {
#pragma unroll
    for (int j = 0; j < PIX_Y; ++j) {
      // evaluated for every pixel and then selected: no branch per pixel
      float w0, w1, w2, z;
      const bool inside = weights(q, dx0[i], dx1[i], dx2[i], dy0[j], dy1[j], dy2[j], w0, w1, w2, z);
      const bool t = in_x[i] && in_y[j] && inside && z > best_z[i][j];
      best_z[i][j] = t ? z : best_z[i][j];
      best_id[i][j] = t ? id : best_id[i][j];
    }
  }
}

struct Shared {
  int idx[SLICE];
  Tri tri[BATCH];
  int warp_count[WARPS];
  bool last;
};

// The pixel bounds of this thread's PER_THREAD consecutive triangles of a
// slice (empty past T).
__device__ __forceinline__ void load_bounds(const short4* __restrict__ ibox, int T, int slice,
                                            short4 (&b)[PER_THREAD]) {
  const int first = slice * SLICE + threadIdx.x * PER_THREAD;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) b[k] = first + k < T ? ibox[first + k] : make_short4(0x7fff, -1, 0x7fff, -1);
}

// One work item: the triangles of slice `slice`, whose bounds this thread
// holds in `b`, against tile (tx, ty); each pixel's winner merged into its
// key. False when no triangle of the slice meets the tile.
__device__ __forceinline__ bool raster_item(Shared& sh, const Tri* tris, const short4 (&b)[PER_THREAD],
                                            unsigned long long* keys, int H, int W, int tx, int ty, int slice) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx0 = tx * TILE_W, ty0 = ty * TILE_H;
  const int tx1 = min(tx0 + TILE_W, W) - 1, ty1 = min(ty0 + TILE_H, H) - 1;
  const int base = slice * SLICE;

  // the slice's triangles whose pixel bounds meet the tile, in order: thread
  // t owns PER_THREAD consecutive ones, and a block-wide exclusive prefix sum
  // of the counts places each thread's hits after those before it
  uint32_t hits = 0;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    if (b[k].x <= tx1 && b[k].y >= tx0 && b[k].z <= ty1 && b[k].w >= ty0) hits |= 1u << k;
  }
  if (!__syncthreads_or(hits != 0)) return false;  // the block agrees
  const int count = __popc(hits);
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) sh.warp_count[warp] = incl;
  __syncthreads();
  int pos = incl - count, total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int v = sh.warp_count[w];
    pos += w < warp ? v : 0;
    total += v;
  }
  for (uint32_t m = hits; m; m &= m - 1) sh.idx[pos++] = base + tid * PER_THREAD + __ffs(m) - 1;

  // the warp's region of the tile; lane (lx, ly) of its 8x4 grid owns the
  // pixels (x0 + lx + 8 i, y0 + ly + 4 j)
  const int rx0 = tx0 + (warp % WARPS_X) * REGION_W, ry0 = ty0 + (warp / WARPS_X) * REGION_H;
  const bool region_in_image = rx0 < W && ry0 < H;  // the warp agrees
  const float fx0 = static_cast<float>(rx0), fx1 = static_cast<float>(min(rx0 + REGION_W, W) - 1);
  const float fy0 = static_cast<float>(ry0), fy1 = static_cast<float>(min(ry0 + REGION_H, H) - 1);
  const float px0 = static_cast<float>(rx0 + lane % 8), py0 = static_cast<float>(ry0 + lane / 8);
  float best_z[PIX_X][PIX_Y];
  int best_id[PIX_X][PIX_Y];
#pragma unroll
  for (int i = 0; i < PIX_X; ++i) {
#pragma unroll
    for (int j = 0; j < PIX_Y; ++j) {
      best_z[i][j] = ZBUF_INIT;
      best_id[i][j] = -1;
    }
  }
  for (int b0 = 0; b0 < total; b0 += BATCH) {
    const int nb = min(BATCH, total - b0);
    __syncthreads();  // sh.idx is complete; the last batch's readers are done with sh.tri
    for (int k = tid; k < nb; k += THREADS) {
      const float4* src = reinterpret_cast<const float4*>(tris + sh.idx[b0 + k]);
      float4* dst = reinterpret_cast<float4*>(sh.tri + k);
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = src[e];
    }
    __syncthreads();
    if (!region_in_image) continue;
    for (int c = 0; c < nb; c += 32) {
      bool meets = false;
      if (c + lane < nb) {
        const Tri& q = sh.tri[c + lane];
        meets = q.box.x <= fx1 && q.box.y >= fx0 && q.box.z <= fy1 && q.box.w >= fy0 &&
                !region_outside(q, fx0, fx1, fy0, fy1);
      }
      // the kept triangles, in ascending order
      for (uint32_t m = __ballot_sync(0xffffffffu, meets); m; m &= m - 1) {
        const int t = c + __ffs(m) - 1;
        take(sh.tri[t], sh.idx[b0 + t], px0, py0, best_z, best_id);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PIX_X; ++i) {
#pragma unroll
    for (int j = 0; j < PIX_Y; ++j) {
      const int x = rx0 + lane % 8 + 8 * i, y = ry0 + lane / 8 + 4 * j;
      if (best_id[i][j] >= 0 && x < W && y < H) {
        atomicMax(keys + static_cast<long long>(y) * W + x, merge_key(best_z[i][j], best_id[i][j]));
      }
    }
  }
  return true;
}

// One thread per triangle: its record and pixel bounds; one per pixel: its
// merge key cleared; one per tile: its count of finished slices cleared.
__global__ void __launch_bounds__(FLAT)
setup_kernel(const float* __restrict__ vertices, const int* __restrict__ faces, Tri* __restrict__ tris,
             short4* __restrict__ ibox, unsigned long long* __restrict__ keys, int* __restrict__ done, int tiles,
             int V, int T, int H, int W) {
  const long long i = static_cast<long long>(blockIdx.x) * FLAT + threadIdx.x;
  if (i < static_cast<long long>(H) * W) keys[i] = 0;
  if (i < tiles) done[i] = 0;
  if (i >= T) return;
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
  t.pad = 0.0f;
  // (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
  const float area = __fsub_rn(__fmul_rn(__fsub_rn(t.x1, t.x0), __fsub_rn(t.y2, t.y0)),
                               __fmul_rn(__fsub_rn(t.x2, t.x0), __fsub_rn(t.y1, t.y0)));
  const bool ok = fabsf(area) > MIN_AREA;
  t.inv_area = ok ? __frcp_rn(area) : 0.0f;
  t.area = area;
  const bool finite = isfinite(t.x0) && isfinite(t.y0) && isfinite(t.x1) && isfinite(t.y1) && isfinite(t.x2) &&
                      isfinite(t.y2);
  t.box = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);  // empty
  if (ok && finite) {
    const float lo_x = fminf(t.x0, fminf(t.x1, t.x2)), hi_x = fmaxf(t.x0, fmaxf(t.x1, t.x2));
    const float lo_y = fminf(t.y0, fminf(t.y1, t.y2)), hi_y = fmaxf(t.y0, fmaxf(t.y1, t.y2));
    const float margin = box_margin(lo_x, hi_x, lo_y, hi_y, area, H, W);
    t.box = make_float4(lo_x - margin, hi_x + margin, lo_y - margin, hi_y + margin);
  }
  tris[i] = t;
  short4 b;
  pixel_bounds(t.box.x, t.box.y, W, b.x, b.y);
  pixel_bounds(t.box.z, t.box.w, H, b.z, b.w);
  ibox[i] = b;
}

// One block per work item: the triangles of slice blockIdx.z against tile
// (blockIdx.x, blockIdx.y). The tile's last slice to finish writes its
// pixels: the winner's id, and its weights and z evaluated again with the
// same code.
__global__ void __launch_bounds__(THREADS)
raster_kernel(const Tri* __restrict__ tris, const short4* __restrict__ ibox, unsigned long long* __restrict__ keys,
              int* __restrict__ done, float* __restrict__ depth, int* __restrict__ tri_id, float* __restrict__ bary,
              int T, int H, int W) {
  __shared__ Shared sh;
  short4 b[PER_THREAD];
  load_bounds(ibox, T, blockIdx.z, b);
  if (raster_item(sh, tris, b, keys, H, W, blockIdx.x, blockIdx.y, blockIdx.z)) {
    __threadfence();  // this block's merges before its count
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sh.last = atomicAdd(done + blockIdx.y * gridDim.x + blockIdx.x, 1) == static_cast<int>(gridDim.z) - 1;
  }
  __syncthreads();
  if (!sh.last) return;
  __threadfence();  // the other slices' merges before the reads
  const int tx0 = blockIdx.x * TILE_W, ty0 = blockIdx.y * TILE_H;
  for (int k = threadIdx.x; k < TILE_W * TILE_H; k += THREADS) {
    const int x = tx0 + k % TILE_W, y = ty0 + k / TILE_W;
    if (x >= W || y >= H) continue;
    const long long p = static_cast<long long>(y) * W + x;
    const unsigned long long key = __ldcg(keys + p);
    float z = ZBUF_INIT, w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
    int id = -1;
    if (key != 0) {
      id = static_cast<int>(~static_cast<uint32_t>(key));
      const Tri q = tris[id];
      const float px = static_cast<float>(x), py = static_cast<float>(y);
      weights(q, __fsub_rn(q.x0, px), __fsub_rn(q.x1, px), __fsub_rn(q.x2, px), __fsub_rn(q.y0, py),
              __fsub_rn(q.y1, py), __fsub_rn(q.y2, py), w0, w1, w2, z);
    }
    depth[p] = z;
    tri_id[p] = id;
    bary[3 * p] = w0;
    bary[3 * p + 1] = w1;
    bary[3 * p + 2] = w2;
  }
}

// Bytes of scratch for T triangles on an H x W image: a 64-byte record and 8
// bytes of pixel bounds per triangle, an 8-byte merge key per pixel, and a
// count of finished slices per tile.
long long scratch_bytes(int T, int H, int W) {
  const long long tiles = static_cast<long long>((W + TILE_W - 1) / TILE_W) * ((H + TILE_H - 1) / TILE_H);
  return 72LL * T + 8LL * H * W + 4 * tiles;
}

}  // namespace

// vertices (V, 3) fp32, faces (T, 3) int32, scratch of scratch_bytes(T, H, W)
// bytes or more (16-byte aligned), outputs depth (H, W) fp32, tri_id (H, W)
// int32 and bary (H, W, 3) fp32, all contiguous on `device`; H and W at most
// 32,767. Launches two kernels on `stream` and returns cudaGetLastError().
extern "C" int d3d_rasterize(const float* vertices, const int* faces, void* scratch, long long scratch_size,
                             float* depth, int* tri_id, float* bary, int V, int T, int H, int W, int device,
                             cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (H <= 0 || W <= 0) return 0;
  if (H > 32767 || W > 32767 || T < 0 || scratch_size < scratch_bytes(T, H, W)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long pixels = static_cast<long long>(H) * W;
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, T > 0 ? (T + SLICE - 1) / SLICE : 1);
  const int tiles = static_cast<int>(grid.x * grid.y);
  Tri* tris = static_cast<Tri*>(scratch);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(tris + T);
  short4* ibox = reinterpret_cast<short4*>(keys + pixels);
  int* done = reinterpret_cast<int*>(ibox + T);
  const long long setup_items = pixels > T ? pixels : T;
  setup_kernel<<<static_cast<unsigned>((setup_items + FLAT - 1) / FLAT), FLAT, 0, stream>>>(
      vertices, faces, tris, ibox, keys, done, tiles, V, T, H, W);
  raster_kernel<<<grid, THREADS, 0, stream>>>(tris, ibox, keys, done, depth, tri_id, bary, T, H, W);
  return static_cast<int>(cudaGetLastError());
}

// The scratch bytes d3d_rasterize needs.
extern "C" long long d3d_rasterize_scratch_bytes(int T, int H, int W) { return scratch_bytes(T, H, W); }
