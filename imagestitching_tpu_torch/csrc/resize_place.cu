// Fused resize-and-place for one placement of a stitch job, of a batch of
// jobs that share it, or of one row chunk of it, for Hopper (sm_90a).
//
// Replaces the TPU kernel imagestitching_tpu/ops/pallas_resize.py::_make_kernel
// in the three shapes it is launched in: the single-job form (batch=0, from
// resize_place_one), the batched form (batch=B, from resize_place_batch, the
// serving path of parallel/batch._batched_pallas) and the windowed form
// (_jitted_call_static from _WindowPlan.run_chunk, the banded strategy: one
// chunk of dest rows from a host-cropped, host-oriented source row window).
// All three are the one body below with other operands, so they cannot
// drift apart.  The body computes what the Pallas kernel computes: the
// EXIF-oriented source, resampled by the separable K-tap filter whose taps
// geometry.filter_taps computed on the host (f64, stored f32), quantized as
// clip(floor(x + 0.5), 0, 255) into uint8.  Banded MXU matmuls, split-bf16,
// (8, 128) padding, planar CHW staging and the v5e tile cost model were
// answers to the TPU and are left behind.
//
// What bounds it: device memory bandwidth.  Bilinear (K = 2) is 8
// multiply-adds per channel per output pixel against 3 source bytes read
// and 3 bytes written, far below the card's 295 operations per byte.  So the
// design reads each source line along the raw image's contiguous axis and
// writes the output in whole words:
//
//   * One CTA per output tile of tile_r x tile_c pixels of one job
//     (blockIdx.x the tile, blockIdx.z the job).  The tile's source
//     footprint in oriented coordinates is the rectangle its taps span
//     (min and max of its tap starts, plus K, clamped), found per CTA with
//     no assumption that taps are monotone.  The warps take output rows,
//     the lanes of a warp consecutive output or footprint columns.
//   * Orientations 1-4 (oriented rows are raw rows): the lanes read the
//     source straight from device memory, consecutive lanes on consecutive
//     bytes of a raw row.  Staging these rows in shared memory first was
//     measured slower on the H100: it adds a barrier and a copy and saves
//     no device-memory traffic, which the L1 and L2 already reuse.
//   * Orientations 5-8 (oriented rows are raw columns): the footprint is
//     staged in shared memory with loads along the raw rows, written
//     transposed into an oriented tile whose row pitch is an odd number of
//     words, so the transposing writes do not share banks.  Where the taps
//     touch fewer raw rows than the footprint spans (bilinear at a deep
//     downscale reads 2 rows of every 12), only those rows are staged.
//   * Per tile, the cheaper of two orders with the same sums: one pass,
//     acc = sum_j cw[c, j] * (sum_i rw[r, i] * s[row(r, i)][col(c, j)]),
//     K_r x K_c taps per output pixel (bilinear: 4, unrolled); or two
//     passes through shared memory, first the vertical pass tmp[r][x] =
//     sum_i rw[r, i] * s[row(r, i)][x] over the footprint's columns, then
//     the horizontal pass acc = sum_j cw[c, j] * tmp[r][col(c, j)], which
//     costs K_r per footprint column plus K_c per output pixel and wins for
//     wide filters and deep downscales (lanczos3 at 12x: K = 73).  Both sum
//     i and j in order in f32 exactly as the plain version
//     (torch_compose.resample) does, then clip(floor(acc + 0.5), 0, 255);
//     built with -fmad=false every product and sum is rounded as the plain
//     version rounds it, so the two agree bit for bit.  Tap indices are
//     clamped to the source, as in xla_compose.ktap_axis; out-of-range taps
//     carry zero weight.
//   * The uint8 output tile is staged in shared memory and stored as
//     aligned 4-byte words, with byte stores only on the ragged edges of a
//     row: the canvas offset c0 is arbitrary.  It lands straight in
//     canvas[b, r0 + r, c0 + c, :]; there is no region tensor.
//   * The host picks tile_r x tile_c from K and the scale so that the
//     expected footprint fits the shared memory it allocates.  There is no
//     K cap: a CTA whose actual footprint does not fit (a lanczos3 tap
//     window of thousands of pixels) computes its tile by direct gathers
//     from device memory, with the same arithmetic in the same order.
//   * No tensor cores.  The work is memory-bound, and wgmma in TF32 or
//     bf16 would change the rounding and the summation order, and with
//     them the bit-exact contract with the plain version.
//   * Source, canvas and job offsets are int64: a canvas that CanvasLimits
//     allows (1 << 30 pixels x 3 channels), or 64 stacked jobs of 47 MB of
//     sources, overflows int32.
//
// The windowed entry takes the placement's row taps once: the caller
// passes the chunk's slice of them and row_shift, the chunk's crop start,
// which the body subtracts from every row tap start.
//
// Each form is launched prepared: resize_place_prepare checks a launch,
// maps its orientation and picks its tile once into a PlaceArgs, and
// resize_place_run (#1, #2: the source and canvas pointers) or
// resize_place_window_run (#3: the crop pointer and the chunk's rows)
// launches it with one call's worth of host work.  The SM count and the
// shared-memory attribute are set up once per device.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>

// One launch of #1, #2 or #3: the caller fills the fields above "filled
// by resize_place_prepare", and prepare derives the rest from them.  A run
// passes only what changes from call to call.
struct PlaceArgs {
  const int32_t* ri0;       // (tap_rows,) row tap starts
  const float* rw;          // (tap_rows, k_rows)
  const int32_t* ci0;       // (n_cols,) col tap starts
  const float* cw;          // (n_cols, k_cols)
  uint8_t* canvas;          // #3: the region; #1, #2: null (given per run)
  int64_t src_h, src_w;     // raw source dims (#3: the crop's rows, width)
  int64_t src_stride;       // bytes between jobs' sources (batch > 1)
  int64_t canvas_h, canvas_w;
  int64_t canvas_stride;    // bytes between jobs' canvases (batch > 1)
  int64_t r0, c0;           // where the region lands in the canvas
  int32_t channels, orientation, batch;
  int32_t n_rows;           // rows a run writes at most, the tile's basis
  int32_t tap_rows;         // rows of the row taps (#1, #2: n_rows)
  int32_t k_rows, n_cols, k_cols;
  // filled by resize_place_prepare
  int64_t base, sy, sx;     // oriented (y, x) -> raw base + y*sy + x*sx
  int32_t m_h, m_w;         // oriented dims
  int32_t tile_r, tile_c, tiles_c;
  int32_t smem_bytes;       // dynamic shared memory of a launch
  const void* kernel;       // resize_place_kernel<channels>; null: empty
};

namespace {

constexpr int kThreads = 256;
// CTAs per SM the kernel is built for (registers: 65536 / (256 * 8) = 32
// per thread; measured on the H100, the latency hidden by full occupancy
// outweighs the few spills), and the shared memory each may then take
constexpr int kMinBlocks = 8;
constexpr int64_t kSmemFull = 26 * 1024;
// the tile picker's second target, for large tap windows: two CTAs per SM
constexpr int64_t kSmemTarget = 100 * 1024;
// dynamic shared memory a CTA may take (of the 227 KB Hopper allows)
constexpr int kSmemCap = 200 * 1024;

// Everything one launch needs, passed by value.
struct Launch {
  const uint8_t* src;       // job 0's raw HWC source
  int64_t src_stride;       // bytes between jobs
  int64_t src_h, src_w;     // raw dims
  int orientation;          // EXIF 1-8
  int64_t base, sy, sx;     // oriented (y, x) -> raw pixel base + y*sy + x*sx
  int m_h, m_w;             // oriented dims
  const int32_t* ri0;       // (n_rows,) row tap starts
  const float* rw;          // (n_rows, k_rows)
  int n_rows, k_rows, row_shift;
  const int32_t* ci0;       // (n_cols,) col tap starts
  const float* cw;          // (n_cols, k_cols)
  int n_cols, k_cols;
  uint8_t* canvas;          // job 0's canvas
  int64_t canvas_stride;    // bytes between jobs
  int64_t canvas_w, r0, c0;
  int tile_r, tile_c, tiles_c;
  int smem_bytes;           // dynamic shared memory of the launch
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__host__ __device__ __forceinline__ int64_t round_up(int64_t v, int64_t m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ uint8_t quantize(float acc) {
  return static_cast<uint8_t>(fminf(fmaxf(floorf(acc + 0.5f), 0.0f), 255.0f));
}

// Shared-memory layout of one CTA, from its footprint.
struct Layout {
  int pitch;         // bytes per staged row
  int out_pitch;     // bytes per output-tile row
  int64_t s, tmp, out, tb, xsrc, total;
};

// nr output rows of k_rows taps each; tb holds, per (row, tap), the byte
// offset of the tap's row (staged, or in device memory); nj is 0 where
// nothing is staged, and tmp is empty in the one-pass order
__host__ __device__ inline Layout layout_of(int tile_r, int tile_c, int nr,
                                           int k_rows, int nj, int nk,
                                           int channels, bool transposed,
                                           bool two_pass) {
  Layout l;
  // staged rows (transposed sources) are an odd number of words apart, so
  // the transposing writes spread over the banks
  l.pitch = 0;
  if (transposed) {
    l.pitch = static_cast<int>(round_up(static_cast<int64_t>(nk) * channels,
                                        4));
    if ((l.pitch / 4) % 2 == 0) l.pitch += 4;
  }
  l.out_pitch = static_cast<int>(round_up(tile_c * channels, 4));
  l.s = round_up(4 * (tile_r + tile_c), 16);
  l.tmp = l.s + round_up(static_cast<int64_t>(nj) * l.pitch, 16);
  l.out = l.tmp + (two_pass ? round_up(4 * static_cast<int64_t>(nr) * nk *
                                            channels, 16)
                             : 0);
  l.tb = l.out + round_up(static_cast<int64_t>(tile_r) * l.out_pitch, 16);
  l.xsrc = l.tb + 8 * static_cast<int64_t>(nr) * k_rows;
  l.total = l.xsrc + 4 * static_cast<int64_t>(nk);
  return l;
}

// One output pixel by direct gathers from device memory: the path of a
// CTA whose footprint does not fit its shared memory.  The same sums in
// the same order as the tiled orders.
template <int C>
__device__ void gather_pixel(const Launch& g, const uint8_t* src, int row0,
                             int col0, const float* wr, const float* wc,
                             uint8_t* out) {
  float acc[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
  for (int j = 0; j < g.k_cols; ++j) {
    const int x = clampi(col0 + j, 0, g.m_w - 1);
    const int64_t col_off = g.base + static_cast<int64_t>(x) * g.sx;
    float tmp[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) tmp[ch] = 0.0f;
    for (int i = 0; i < g.k_rows; ++i) {
      const int y = clampi(row0 + i, 0, g.m_h - 1);
      const uint8_t* px = src + (col_off + static_cast<int64_t>(y) * g.sy) * C;
      const float w = wr[i];
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        tmp[ch] = tmp[ch] + static_cast<float>(px[ch]) * w;
    }
    const float w = wc[j];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[ch] = acc[ch] + tmp[ch] * w;
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch) out[ch] = quantize(acc[ch]);
}

// What the one-pass order of a tile reads.
struct Tile {
  const uint8_t* vbase;   // s_src, or the job's source
  const int64_t* tb;      // per (row, tap): offset of the tap's row
  const int* s_ci;        // the tile's col tap starts
  uint8_t* s_out;         // the output tile
  const float* rw;        // the tile's first row of row weights
  const float* cw;        // the tile's first col of col weights
  int nr, nc, nk, kr, kc, lo_x, m_w, out_pitch;
  int warp, nwarps, lane, nlanes;
  bool list_x, reversed;
};

// The one-pass order: per output pixel, for j in order, tmp = sum_i
// rw[r, i] * s[row(r, i)][col(c, j)] and acc += cw[c, j] * tmp -- the
// values and order of the two passes, without the tmp buffer.  KR and KC
// are the tap counts when known at compile time (bilinear: 2), else 0.
template <int C, int KR, int KC>
__device__ __forceinline__ void fused_tile(const Tile& t) {
  const int kr = KR ? KR : t.kr;
  const int kc = KC ? KC : t.kc;
  for (int r = t.warp; r < t.nr; r += t.nwarps) {
    const int64_t* rt = t.tb + r * kr;
    const float* wr = t.rw + static_cast<int64_t>(r) * kr;
    for (int c = t.lane; c < t.nc; c += t.nlanes) {
      const float* wc = t.cw + static_cast<int64_t>(c) * kc;
      const int col0 = t.s_ci[c];
      float acc[C];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
#pragma unroll
      for (int j = 0; j < kc; ++j) {
        const int k = t.list_x ? c * kc + j
                               : clampi(col0 + j, 0, t.m_w - 1) - t.lo_x;
        const uint8_t* col = t.vbase + (t.reversed ? t.nk - 1 - k : k) * C;
        float tmp[C];
#pragma unroll
        for (int ch = 0; ch < C; ++ch) tmp[ch] = 0.0f;
#pragma unroll
        for (int i = 0; i < kr; ++i) {
          const uint8_t* px = col + rt[i];
          const float wi = wr[i];
#pragma unroll
          for (int ch = 0; ch < C; ++ch)
            tmp[ch] = tmp[ch] + static_cast<float>(px[ch]) * wi;
        }
        const float wj = wc[j];
#pragma unroll
        for (int ch = 0; ch < C; ++ch) acc[ch] = acc[ch] + tmp[ch] * wj;
      }
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        t.s_out[r * t.out_pitch + c * C + ch] = quantize(acc[ch]);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    resize_place_kernel(const Launch g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_lo_y, s_hi_y, s_lo_x, s_hi_x;

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  // loops over (row, contiguous index) run the index across the lanes of a
  // warp and the rows across the warps: no division per element
  const int nlanes = nthr < 32 ? nthr : 32;
  const int nwarps = nthr / nlanes;
  const int lane = tid % nlanes;
  const int warp = tid / nlanes;
  const int tr0 = (blockIdx.x / g.tiles_c) * g.tile_r;
  const int tc0 = (blockIdx.x % g.tiles_c) * g.tile_c;
  const int nr = min(g.tile_r, g.n_rows - tr0);
  const int nc = min(g.tile_c, g.n_cols - tc0);
  const int64_t b = blockIdx.z;
  const uint8_t* src = g.src + b * g.src_stride;
  uint8_t* canvas = g.canvas + b * g.canvas_stride;
  const int kr = g.k_rows;
  const int kc = g.k_cols;
  const bool transposed = g.orientation >= 5;

  // ---- the tile's tap starts and their range
  int* s_ri = reinterpret_cast<int*>(smem);
  int* s_ci = s_ri + g.tile_r;
  if (tid == 0) {
    s_lo_y = INT_MAX;
    s_hi_y = INT_MIN;
    s_lo_x = INT_MAX;
    s_hi_x = INT_MIN;
  }
  __syncthreads();
  for (int r = tid; r < nr; r += nthr) {
    const int v = g.ri0[tr0 + r] - g.row_shift;
    s_ri[r] = v;
    atomicMin(&s_lo_y, v);
    atomicMax(&s_hi_y, v);
  }
  for (int c = tid; c < nc; c += nthr) {
    const int v = g.ci0[tc0 + c];
    s_ci[c] = v;
    atomicMin(&s_lo_x, v);
    atomicMax(&s_hi_x, v);
  }
  __syncthreads();

  // ---- the footprint: a span; staged (transposed sources only), along
  // the raw-row axis a list of the lines the taps touch when that is
  // shorter
  const int lo_y = clampi(s_lo_y, 0, g.m_h - 1);
  const int lo_x = clampi(s_lo_x, 0, g.m_w - 1);
  const int span_y = clampi(s_hi_y + kr - 1, 0, g.m_h - 1) + 1 - lo_y;
  const int span_x = clampi(s_hi_x + kc - 1, 0, g.m_w - 1) + 1 - lo_x;
  const bool list_x = transposed && nc * kc < span_x;
  const int nk = list_x ? nc * kc : span_x;
  // The cheaper of the two orders for this tile, with the same sums: one
  // pass of K_r x K_c taps per output pixel (bilinear at a moderate scale),
  // or a vertical pass over the footprint's columns into tmp and a
  // horizontal pass of K_c taps per output pixel (wide filters, deep
  // downscales) where its tmp fits.
  const int nj = transposed ? span_y : 0;
  const Layout l2 =
      layout_of(g.tile_r, g.tile_c, nr, kr, nj, nk, C, transposed, true);
  const bool fused = static_cast<int64_t>(nc) * kr * kc <=
                         static_cast<int64_t>(nk) * kr +
                             static_cast<int64_t>(nc) * kc ||
                     l2.total > g.smem_bytes;
  const Layout l = fused ? layout_of(g.tile_r, g.tile_c, nr, kr, nj, nk, C,
                                     transposed, false)
                         : l2;

  if (l.total > g.smem_bytes) {
    for (int e = tid; e < nr * nc; e += nthr) {
      const int r = e / nc;
      const int c = e - r * nc;
      gather_pixel<C>(g, src, s_ri[r], s_ci[c],
                      g.rw + static_cast<int64_t>(tr0 + r) * kr,
                      g.cw + static_cast<int64_t>(tc0 + c) * kc,
                      canvas + ((g.r0 + tr0 + r) * g.canvas_w + g.c0 + tc0 +
                                c) * C);
    }
    return;
  }

  uint8_t* s_src = smem + l.s;
  float* s_tmp = reinterpret_cast<float*>(smem + l.tmp);
  uint8_t* s_out = smem + l.out;
  int64_t* tb = reinterpret_cast<int64_t*>(smem + l.tb);
  int* xsrc = reinterpret_cast<int*>(smem + l.xsrc);

  // raw (row, col) of oriented (y, x): orientations 1-4 keep the axes,
  // flipping the cols for 2 and 3 and the rows for 3 and 4; 5-8 swap
  // them, flipping the raw rows for 6 and 7 and the raw cols for 7 and 8
  const int o = g.orientation;
  const bool flip_a = transposed ? (o == 6 || o == 7) : (o == 3 || o == 4);
  const bool flip_b = transposed ? (o == 7 || o == 8) : (o == 2 || o == 3);
  const int64_t H = g.src_h;
  const int64_t W = g.src_w;
  // first raw col of the span along the contiguous axis
  const int64_t rc_lo = transposed ? (flip_b ? W - lo_y - nj : lo_y)
                                   : (flip_b ? W - lo_x - nk : lo_x);

  // ---- where tap i of output row r reads: a staged row of s_src, or
  // (orientations 1-4) a raw row of the source in device memory
  for (int e = tid; e < nr * kr; e += nthr) {
    const int r = e / kr;
    const int i = e - r * kr;
    const int y = clampi(s_ri[r] + i, 0, g.m_h - 1);
    const int64_t row = flip_a ? H - 1 - y : y;
    tb[e] = transposed ? static_cast<int64_t>(y - lo_y) * l.pitch
                       : (row * W + rc_lo) * C;
  }
  for (int k = tid; k < nk; k += nthr)
    xsrc[k] = list_x ? clampi(s_ci[k / kc] + k % kc, 0, g.m_w - 1) : lo_x + k;
  __syncthreads();

  // ---- stage a transposed footprint: each staged col is one raw row, its
  // bytes over the staged oriented rows contiguous in the raw row
  if (transposed) {
    const int rowlen = nj * C;
    for (int k = warp; k < nk; k += nwarps) {
      const int64_t row = flip_a ? H - 1 - xsrc[k] : xsrc[k];
      const uint8_t* in = src + (row * W + rc_lo) * C;
      for (int q = lane; q < rowlen; q += nlanes) {
        const int p = q / C;
        const int j = flip_b ? nj - 1 - p : p;
        s_src[j * l.pitch + k * C + (q - p * C)] = in[q];
      }
    }
    __syncthreads();
  }

  const bool reversed = !transposed && flip_b;
  const uint8_t* vbase = transposed ? s_src : src;
  if (fused) {
    const Tile t{vbase, tb, s_ci, s_out,
                 g.rw + static_cast<int64_t>(tr0) * kr,
                 g.cw + static_cast<int64_t>(tc0) * kc, nr, nc, nk, kr, kc,
                 lo_x, g.m_w, l.out_pitch, warp, nwarps, lane, nlanes,
                 list_x, reversed};
    if (kr == 2 && kc == 2)
      fused_tile<C, 2, 2>(t);
    else
      fused_tile<C, 0, 0>(t);
  } else {
    // vertical pass: tmp[r][k] = sum_i rw[r, i] * s[row(r, i)][k], the
    // lanes of a warp along the contiguous axis
    for (int r = warp; r < nr; r += nwarps) {
      const int64_t* rt = tb + r * kr;
      const float* w = g.rw + static_cast<int64_t>(tr0 + r) * kr;
      for (int k = lane; k < nk; k += nlanes) {
        const uint8_t* col = vbase + (reversed ? nk - 1 - k : k) * C;
        float acc[C];
#pragma unroll
        for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
        for (int i = 0; i < kr; ++i) {
          const uint8_t* px = col + rt[i];
          const float wi = w[i];
#pragma unroll
          for (int ch = 0; ch < C; ++ch)
            acc[ch] = acc[ch] + static_cast<float>(px[ch]) * wi;
        }
#pragma unroll
        for (int ch = 0; ch < C; ++ch)
          s_tmp[(r * nk + k) * C + ch] = acc[ch];
      }
    }
    __syncthreads();

    // horizontal pass: out[r][c] = sum_j cw[c, j] * tmp[r][col(c, j)]
    for (int r = warp; r < nr; r += nwarps) {
      const float* trow = s_tmp + r * nk * C;
      for (int c = lane; c < nc; c += nlanes) {
        const float* w = g.cw + static_cast<int64_t>(tc0 + c) * kc;
        const int col0 = s_ci[c];
        float acc[C];
#pragma unroll
        for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
        for (int j = 0; j < kc; ++j) {
          const int k = list_x ? c * kc + j
                               : clampi(col0 + j, 0, g.m_w - 1) - lo_x;
          const float* tp = trow + k * C;
          const float wj = w[j];
#pragma unroll
          for (int ch = 0; ch < C; ++ch) acc[ch] = acc[ch] + tp[ch] * wj;
        }
#pragma unroll
        for (int ch = 0; ch < C; ++ch)
          s_out[r * l.out_pitch + c * C + ch] = quantize(acc[ch]);
      }
    }
  }
  __syncthreads();

  // ---- store: aligned 4-byte words, bytes on the ragged edges
  const int64_t len = static_cast<int64_t>(nc) * C;
  const int words = static_cast<int>((len + 3) / 4) + 1;
  for (int r = warp; r < nr; r += nwarps) {
    uint8_t* row = canvas + ((g.r0 + tr0 + r) * g.canvas_w + g.c0 + tc0) * C;
    const uintptr_t d0 = reinterpret_cast<uintptr_t>(row);
    const uintptr_t d1 = d0 + len;
    const uint8_t* s = s_out + r * l.out_pitch;
    for (int wi = lane; wi < words; wi += nlanes) {
      const uintptr_t a = (d0 & ~static_cast<uintptr_t>(3)) + 4 * wi;
      if (a >= d1) continue;
      if (a >= d0 && a + 4 <= d1) {
        const uint8_t* p = s + (a - d0);
        *reinterpret_cast<uint32_t*>(a) =
            static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
            (static_cast<uint32_t>(p[2]) << 16) |
            (static_cast<uint32_t>(p[3]) << 24);
      } else {
        for (int t = 0; t < 4; ++t)
          if (a + t >= d0 && a + t < d1)
            *reinterpret_cast<uint8_t*>(a + t) = s[a + t - d0];
      }
    }
  }
}

// The tile (rows, cols) for a placement and the shared memory to give it.
// Taps advance by about m / n source pixels per output pixel, so t output
// pixels span at most (t - 1) * m / n + K + 2 source pixels, or, staged
// along the raw-row axis of a transposed source, t * K where a list of the
// touched rows is shorter.  Only transposed footprints are staged.  Of the
// tiles whose footprint fits kSmemFull (so that kMinBlocks CTAs share an
// SM; failing every tile of 64 pixels, kSmemTarget), the largest that still
// gives the card's sms SMs three CTAs each over the batch; else the largest
// that gives each SM one; else the one with the most CTAs.  Larger tiles
// spread each CTA's fixed cost (its taps, two barriers) over more pixels,
// which on the H100 made a 64-job launch faster, while a single chunk of
// 256 rows slowed when too few CTAs were left to fill the card.  A CTA
// whose actual footprint is larger than what it was given takes the gather
// path.
inline void pick_tile(int n_rows, int k_rows, int m_h, int n_cols,
                      int k_cols, int m_w, int channels, bool transposed,
                      int batch, int sms, int* tile_r, int* tile_c,
                      int64_t* smem) {
  static const int kRows[] = {32, 16, 8, 4, 2, 1};
  static const int kCols[] = {128, 64, 32, 16, 8, 4, 2, 1};
  const double sr = static_cast<double>(m_h) / n_rows;
  const double sc = static_cast<double>(m_w) / n_cols;
  // rank: 2 = three CTAs per SM, 1 = one, 0 = fewer; then area or count
  int best_r = 1, best_c = 1, best_rank = -1;
  int64_t best_key = -1, best_bytes = kSmemTarget;
  for (int64_t target : {kSmemFull, kSmemTarget}) {
    for (int tr : kRows) {
      for (int tc : kCols) {
        const int64_t fy = static_cast<int64_t>((tr - 1) * sr) + k_rows + 2;
        const int64_t fx = static_cast<int64_t>((tc - 1) * sc) + k_cols + 2;
        // staged: the transposed footprint, its raw rows (oriented cols)
        // listed where fewer than the span
        const int64_t lx = static_cast<int64_t>(tc) * k_cols;
        const int64_t ny = transposed ? fy : 0;
        const int64_t nx = transposed && lx < fx ? lx : fx;
        const int64_t cy = ny < m_h ? ny : m_h;
        const int64_t cx = nx < m_w ? nx : m_w;
        if (cy > INT_MAX / 4 || cx > INT_MAX / 4 ||
            static_cast<int64_t>(tr) * k_rows > INT_MAX / 8)
          continue;
        const bool two_pass = static_cast<int64_t>(tc) * k_rows * k_cols >
                              cx * k_rows + static_cast<int64_t>(tc) * k_cols;
        const Layout l =
            layout_of(tr, tc, tr, k_rows, static_cast<int>(cy),
                      static_cast<int>(cx), channels, transposed, two_pass);
        if (l.total > target) continue;
        const int64_t ctas = static_cast<int64_t>((n_rows + tr - 1) / tr) *
                             ((n_cols + tc - 1) / tc) * batch;
        const int rank = ctas >= 3 * static_cast<int64_t>(sms) ? 2
                         : ctas >= sms                           ? 1
                                                                 : 0;
        const int64_t key = rank > 0 ? static_cast<int64_t>(tr) * tc : ctas;
        if (rank > best_rank ||
            (rank == best_rank &&
             (key > best_key || (key == best_key && tc > best_c)))) {
          best_r = tr;
          best_c = tc;
          best_rank = rank;
          best_key = key;
          best_bytes = l.total;
        }
      }
    }
    if (best_rank >= 0 && static_cast<int64_t>(best_r) * best_c >= 64) break;
  }
  // room for footprints a little past the estimate
  int64_t want = round_up(best_bytes + best_bytes / 8 + 256, 128);
  if (want > kSmemCap) want = kSmemCap;
  *tile_r = best_r > n_rows ? n_rows : best_r;
  *tile_c = best_c > n_cols ? n_cols : best_c;
  *smem = want;
}

// ---------------------------------------------------------------- host side

// Raw pixel index of oriented pixel (y, x) is base + y * sy + x * sx for an
// H x W raw source (EXIF orientations 1-8; 0 is treated as 1).
bool orientation_map(int orientation, int64_t H, int64_t W, int64_t* base,
                     int64_t* sy, int64_t* sx) {
  switch (orientation) {
    case 0:
    case 1: *base = 0;                 *sy = W;  *sx = 1;  return true;
    case 2: *base = W - 1;             *sy = W;  *sx = -1; return true;
    case 3: *base = (H - 1) * W + W - 1; *sy = -W; *sx = -1; return true;
    case 4: *base = (H - 1) * W;       *sy = -W; *sx = 1;  return true;
    case 5: *base = 0;                 *sy = 1;  *sx = W;  return true;
    case 6: *base = (H - 1) * W;       *sy = 1;  *sx = -W; return true;
    case 7: *base = (H - 1) * W + W - 1; *sy = -1; *sx = -W; return true;
    case 8: *base = W - 1;             *sy = -1; *sx = W;  return true;
    default: return false;
  }
}

constexpr int kMaxDevices = 64;
std::mutex g_mu;
int g_sms[kMaxDevices];        // SM count per device, 0 until read
unsigned g_raised[kMaxDevices];  // bit C: the smem attribute of <C> raised

// The kernel a prepared launch runs, with its arguments for one call: the
// source and canvas of job 0, and the rows [row_start, row_start + n_rows)
// of the row taps with row_shift subtracted from their starts.
cudaError_t run(const PlaceArgs& a, const void* src, void* canvas,
                int row_start, int row_shift, int n_rows,
                cudaStream_t stream) {
  Launch g;
  g.src = static_cast<const uint8_t*>(src);
  g.src_stride = a.src_stride;
  g.src_h = a.src_h;
  g.src_w = a.src_w;
  g.orientation = a.orientation < 1 ? 1 : a.orientation;
  g.base = a.base;
  g.sy = a.sy;
  g.sx = a.sx;
  g.m_h = a.m_h;
  g.m_w = a.m_w;
  g.ri0 = a.ri0 + row_start;
  g.rw = a.rw + static_cast<int64_t>(row_start) * a.k_rows;
  g.n_rows = n_rows;
  g.k_rows = a.k_rows;
  g.row_shift = row_shift;
  g.ci0 = a.ci0;
  g.cw = a.cw;
  g.n_cols = a.n_cols;
  g.k_cols = a.k_cols;
  g.canvas = static_cast<uint8_t*>(canvas);
  g.canvas_stride = a.canvas_stride;
  g.canvas_w = a.canvas_w;
  g.r0 = a.r0;
  g.c0 = a.c0;
  g.tile_r = a.tile_r;
  g.tile_c = a.tile_c;
  g.tiles_c = a.tiles_c;
  g.smem_bytes = a.smem_bytes;
  // fewer rows than prepared: fewer row tiles of the prepared tile
  const int tiles = ((n_rows + a.tile_r - 1) / a.tile_r) * a.tiles_c;
  void* args[1] = {&g};
  const cudaError_t err = cudaLaunchKernel(
      a.kernel, dim3(tiles, 1, a.batch), dim3(kThreads), args,
      static_cast<size_t>(a.smem_bytes), stream);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

extern "C" {

// The run entries launch on `stream` and return the launch's cudaError_t
// (0 = the launch was accepted).  They launch on the calling thread's
// current device, which the caller sets to the device the launch was
// prepared on, which holds the tensors and `stream`; the current device is
// left as it was.  They do not synchronise and allocate
// nothing.  All arrays are contiguous uint8 HWC.

// sizeof(PlaceArgs), for the host's mirror of it
int resize_place_args_size() { return static_cast<int>(sizeof(PlaceArgs)); }

// Check a launch and fill its derived fields, on the calling thread's
// current device: the orientation map, the tile that pick_tile gives for
// n_rows rows of `batch` jobs on this device's SMs, the grid's columns and
// the dynamic shared memory.  The SM count is read, and the kernel's
// shared-memory attribute raised, once per device (and channel count).
// Returns a cudaError_t (0 = ready to run).  Launches nothing.
//
// The source is (src_h, src_w, channels), the canvas (canvas_h, canvas_w,
// channels); with batch > 1 job b's lie src_stride and canvas_stride bytes
// after job b-1's.  The n_rows x n_cols region lands at (r0, c0).
int resize_place_prepare(PlaceArgs* a) {
  a->kernel = nullptr;
  if (!orientation_map(a->orientation, a->src_h, a->src_w, &a->base, &a->sy,
                       &a->sx) ||
      (a->channels != 1 && a->channels != 3) || a->batch < 1 ||
      a->batch > 65535 || a->k_rows < 1 || a->k_cols < 1 || a->r0 < 0 ||
      a->c0 < 0 || a->src_h < 1 || a->src_w < 1 || a->src_h > INT_MAX ||
      a->src_w > INT_MAX || a->n_rows < 0 || a->n_cols < 0 ||
      a->tap_rows < 0 || a->r0 + a->n_rows > a->canvas_h ||
      a->c0 + a->n_cols > a->canvas_w)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->batch > 1 &&
      (a->src_stride < a->src_h * a->src_w * a->channels ||
       a->canvas_stride < a->canvas_h * a->canvas_w * a->channels))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool transposed = a->orientation >= 5;
  a->m_h = static_cast<int32_t>(transposed ? a->src_w : a->src_h);
  a->m_w = static_cast<int32_t>(transposed ? a->src_h : a->src_w);
  if (a->n_rows == 0 || a->n_cols == 0) return static_cast<int>(cudaSuccess);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  const void* kernel =
      a->channels == 3 ? reinterpret_cast<const void*>(resize_place_kernel<3>)
                       : reinterpret_cast<const void*>(resize_place_kernel<1>);
  int sms = 0;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (g_sms[device] == 0) {
      err = cudaDeviceGetAttribute(&g_sms[device],
                                   cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    sms = g_sms[device];
    // above the 48 KB default, once per device and instantiation
    if (!(g_raised[device] & (1u << a->channels))) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemCap);
      if (err != cudaSuccess) return static_cast<int>(err);
      g_raised[device] |= 1u << a->channels;
    }
  }
  int tile_r = 0, tile_c = 0;
  int64_t smem = 0;
  pick_tile(a->n_rows, a->k_rows, a->m_h, a->n_cols, a->k_cols, a->m_w,
            a->channels, transposed, a->batch, sms, &tile_r, &tile_c, &smem);
  const int64_t tiles_c = (a->n_cols + tile_c - 1) / tile_c;
  if ((a->n_rows + tile_r - 1) / tile_r * tiles_c > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  a->tile_r = tile_r;
  a->tile_c = tile_c;
  a->tiles_c = static_cast<int32_t>(tiles_c);
  a->smem_bytes = static_cast<int32_t>(smem);
  a->kernel = kernel;
  return static_cast<int>(cudaSuccess);
}

// #1 and #2 prepared: one launch over the `batch` jobs whose sources start
// at `src` and canvases at `canvas`, of the shapes prepared.
int resize_place_run(const PlaceArgs* a, const void* src, void* canvas,
                     void* stream) {
  if (a->kernel == nullptr)
    return static_cast<int>(a->n_rows == 0 || a->n_cols == 0
                                ? cudaSuccess
                                : cudaErrorInvalidValue);
  if (src == nullptr || canvas == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run(*a, src, canvas, 0, 0, a->n_rows,
                              static_cast<cudaStream_t>(stream)));
}

// #3 prepared: rows [row_start, row_start + n_rows) of the placement from
// `crop` (the oriented source row window of the shape prepared, whose first
// row is row `row_shift` of the oriented source) into rows [0, n_rows) of
// the prepared region, with the tile prepared for its rows.
int resize_place_window_run(const PlaceArgs* a, const void* crop,
                            int row_start, int row_shift, int n_rows,
                            void* stream) {
  if (row_start < 0 || n_rows < 0 || n_rows > a->n_rows ||
      row_start > a->tap_rows - n_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0 || a->n_cols == 0) return static_cast<int>(cudaSuccess);
  if (a->kernel == nullptr || crop == nullptr || a->canvas == nullptr ||
      a->batch != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run(*a, crop, a->canvas, row_start, row_shift,
                              n_rows, static_cast<cudaStream_t>(stream)));
}

const char* resize_place_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
