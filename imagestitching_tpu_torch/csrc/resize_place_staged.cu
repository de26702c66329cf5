// Kernel #4: one placement resampled from a ring of staged source bands,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarks/profile_bf16_stage.py:29-100
// (make_kernel, build): BASELINE config 5's slot 0, each output tile of
// the placement computed from a band of the oriented source that a 3-deep
// DMA ring staged two grid steps ahead, the band held as uint8 (cast at
// each step) or as bf16 (staged ahead at twice the bytes).  It computes
// what that kernel computes: the separable K-tap resample whose taps
// geometry.filter_taps computed on the host, quantized as
// clip(floor(x + 0.5), 0, 255) into uint8.  The split-bf16 matmuls were the
// TPU's way to reach f32 on its MXU and are left behind, with the (8, 128)
// band alignment, the planar CHW layout and the sequential grid.
//
// What bounds it: device memory bandwidth in principle (7.99 MB with uint8
// bands, 2.4 us at 3.35 TB/s; bilinear is 8 multiply-adds per channel per
// output pixel, far below the card's 295 operations per byte), and in
// practice, at config 5's slot, latency: the chain of a tile's band load,
// its taps, its compute and its store, which each CTA walks in order, and
// the launch's ramp and tail: on an H100 the slot takes several times its
// bound (PERF.md, from chip_smoke.py phase 24 and the profiler).  What the
// design does about it:
//
//   * A grid of resident CTAs.  By default the host launches as many CTAs
//     as the SMs hold at the kernel's occupancy (found once per device), at
//     most one a tile, each walking tiles t = blockIdx.x + k * gridDim.x in
//     order, so that the bands of its next two tiles are in flight while it
//     computes one.  The tile picker (staged_resize.staged_schedule) plans
//     for that occupancy: the largest tile whose ring of bf16 bands leaves
//     room for two CTAs on an SM.  On config 5's slot 0 (576 tiles of
//     16x64) an H100 holds 528 CTAs with uint8 bands, of which 480 walk one
//     tile, so that their ring overlaps nothing, and 264 with bf16 bands,
//     which walk two or three.  One CTA an SM walking four or five tiles
//     ran the slot slower (PERF.md): more resident warps hide a tile's
//     chain better than the ring does.  `ctas` forces another grid.
//   * Band loads by the Tensor Memory Accelerator.  One thread issues a
//     band as a few 2-D boxes (cp.async.bulk.tensor) of a map that the host
//     encodes over the band source as a 2-D byte array (rows of the padded
//     width, pitch bytes apart), each slot with its own mbarrier that the
//     copies complete.  TMA was chosen over the 256-thread cp.async loops
//     of the first version: the copies cost the computing threads no
//     instructions and no registers.  A box's first byte must lie on 16
//     bytes (the card refuses others with an illegal instruction), not on
//     a pixel boundary of 16 pixels: so band columns start anywhere, the
//     boxes start at the 16-byte boundary at or before the band, and a
//     band reads only the columns its taps touch plus under 16 bytes (the
//     first version's 16-pixel alignment read about 1.2x the source).  A
//     box is a whole number of 16 bytes, at most 256 bytes wide, so a band
//     row is a few boxes side by side, each starting box_step bytes after
//     the one before and overlapping the next by 16 bytes, so that no
//     pixel (at most 6 bytes) straddles two boxes.  They land box-major in
//     the slot, each box's rows box_bytes apart, at 128-byte boundaries.
//     Box rows are at most 256: a taller band is cut into equal row boxes,
//     stacked in the same column of boxes.
//   * Taps once per tile, read a tile ahead.  Each tile's clamped tap
//     offsets into the slot and their weights are staged into shared memory
//     (two buffers, by tile parity), not read from device memory per output
//     pixel; each thread reads the next tile's taps, and thread 0 the next
//     band's start, an iteration before they are needed, so that those
//     reads are off the chain (5% of the slot's busy time, PERF.md).
//   * The store does not wait for the compute.  The uint8 output tile goes
//     to one of two shared buffers; tile k - 1's is stored as aligned
//     4-byte words (bytes on the ragged edges of a row) while tile k's band
//     may still be landing.
//   * One barrier per tile.  After it, tile k's taps are visible, every
//     read of tile k - 1's slot and every write of its output buffer is
//     done; so thread 0 refills that slot with tile k + 2's band (after a
//     proxy fence), and tile k - 1 is stored.
//
// Each output pixel takes the one-pass order of resize_place.cu's
// fused_tile: acc += cw[c, j] * (sum_i rw[r, i] * band[y_i][x_j]), i inner
// and j outer, in f32, each term a separate multiply and add; built with
// -fmad=false every product and sum is rounded as the plain version
// (torch_compose.resample) rounds it, so the two agree bit for bit, and
// agree with kernel #1.  Tap indices are clamped to the source, as in
// ktap_axis, then the band's start is subtracted: the host guarantees that
// the clamped tap lies in the band.  A bf16 value is the high half of an
// f32: it is widened by a shift, exactly, as a uint8 is by a conversion.
// No tensor cores: they would change the rounding and the order of sums.
//
// Host side: resize_place_staged_prepare checks and packs a launch once
// (the grid, the shared memory, the kernel variant, the per-device
// attribute and SM count, cached); resize_place_staged_run takes only the
// band source and the stream, finds the source's tensor map in a small
// per-thread cache (encoded once per source with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so no -lcuda) and launches.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>

// The launch's fixed arguments, packed once on the host; StagedArgs in
// ops/staged_resize.py mirrors it field by field, in this order.  The host
// fills the fields up to `ctas`; resize_place_staged_prepare fills the
// rest.  The kernel takes it by value.
struct StagedArgs {
  const int32_t* ri0;          // (n_rows,) row tap starts
  const float* rw;             // (n_rows, k_rows)
  const int32_t* ci0;          // (n_cols,) col tap starts
  const float* cw;             // (n_cols, k_cols)
  const int32_t* row_starts;   // (tiles_r,) band row start per tile row
  const int32_t* col_starts;   // (tiles_c,) band col start per tile col
  uint8_t* canvas;             // (canvas_h, canvas_w, channels) uint8
  int64_t pitch;               // bytes between band source rows
  int64_t canvas_h, canvas_w, r0, c0;
  int32_t elt_bytes;           // 1: uint8 bands, 2: bf16 bands
  int32_t channels, m_h, m_w;  // band source dims
  int32_t n_rows, k_rows, n_cols, k_cols;
  int32_t band_h, band_w, tile_r, tile_c;
  int32_t ctas;                // requested grid; 0: the persistent default
  // filled by resize_place_staged_prepare
  int32_t px_bytes, tiles_c, tiles;
  int32_t box_bytes;           // box width in bytes
  int32_t box_step;            // bytes between box starts, box_bytes - 16
  int32_t boxes;               // boxes side by side in a band row
  int32_t box_rows;            // rows of a box
  int32_t row_boxes;           // boxes stacked down a band
  int32_t box_stride;          // shared bytes of one column of boxes
  int32_t slot_bytes;          // boxes * box_stride
  int32_t out_pitch;           // bytes per output-tile row
  int32_t smem_bytes;          // dynamic shared memory of a CTA
  int32_t per_sm;              // CTAs an SM holds at smem_bytes
  int32_t grid;                // CTAs launched (0: nothing to launch)
  int32_t device;
  const void* kernel;          // the variant to launch
};

namespace {

constexpr int kThreads = 256;
// ring depth: the band a CTA computes and the two ahead, as in the TPU
// kernel
constexpr int kSlots = 3;
// dynamic shared memory a CTA may take on Hopper
constexpr int kSmemCap = 227 * 1024;
// TMA: at most 256 elements (bytes here) per box dimension
constexpr int kBoxMax = 256;
// each box lands on a 128-byte boundary
constexpr int kAlign = 128;
constexpr int kMaxDevices = 64;
constexpr int kMapCache = 16;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ uint8_t quantize(float acc) {
  return static_cast<uint8_t>(fminf(fmaxf(floorf(acc + 0.5f), 0.0f), 255.0f));
}

__device__ __forceinline__ float widen(uint8_t v) {
  return static_cast<float>(v);
}

// bf16 bits: the high 16 bits of the f32 of the same value
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- the PTX of the ring: mbarriers, the proxy fence, the TMA load

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the one arrival of a slot's phase, and the bytes its copies bring
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait until the phase of the given parity has completed; a band that
// never lands (a fault) traps, and the launch fails, after some 2^26 polls
// rather than holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// order this CTA's generic-proxy accesses of shared memory before the
// async proxy's (a TMA write into a slot the threads just read)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// ---- the ring's producer: thread 0 issues a band into a slot

// band start (rows, cols) of tile t
__device__ __forceinline__ void band_start(const StagedArgs& g, int t,
                                           int& rs, int& cs) {
  const int ti = t / g.tiles_c;
  rs = g.row_starts[ti];
  cs = g.col_starts[t - ti * g.tiles_c];
}

__device__ __forceinline__ void load_band(const CUtensorMap* map,
                                          const StagedArgs& g, int rs, int cs,
                                          uint32_t slot, uint32_t bar) {
  // a box starts on 16 bytes: down to there from the band's first byte
  const int x0 = (cs * g.px_bytes) & ~15;
  mbar_expect(bar, static_cast<uint32_t>(g.boxes) * g.row_boxes *
                       g.box_rows * g.box_bytes);
  for (int b = 0; b < g.boxes; ++b)
    for (int rb = 0; rb < g.row_boxes; ++rb)
      tma_load(slot + b * g.box_stride + rb * g.box_rows * g.box_bytes, map,
               x0 + b * g.box_step, rs + rb * g.box_rows, bar);
}

// ---- a tile's taps: read from device memory an iteration before they are
// staged into shared memory, so that their latency hides behind the tile
// before

// taps per array a thread reads ahead (more, in a larger tile, are read
// when they are staged)
constexpr int kPre = 2;

// what one thread reads ahead for one tile: the band start, and the taps
// it stages, unclamped, with their weights
struct TapFetch {
  int rs, cs;
  int y[kPre];
  float wy[kPre];
  int x[kPre];
  float wx[kPre];
};

template <int KR, int KC>
__device__ __forceinline__ void fetch_taps(const StagedArgs& g, int t,
                                           TapFetch& f) {
  const int kr = KR ? KR : g.k_rows;
  const int kc = KC ? KC : g.k_cols;
  const int ti = t / g.tiles_c;
  const int tr0 = ti * g.tile_r;
  const int tc0 = (t - ti * g.tiles_c) * g.tile_c;
  const int nr = min(g.tile_r, g.n_rows - tr0);
  const int nc = min(g.tile_c, g.n_cols - tc0);
  band_start(g, t, f.rs, f.cs);
#pragma unroll
  for (int q = 0; q < kPre; ++q) {
    const int e = threadIdx.x + q * blockDim.x;
    if (e < nr * kr) {
      const int r = e / kr;
      const int i = e - r * kr;
      f.y[q] = g.ri0[tr0 + r] + i;
      f.wy[q] = g.rw[static_cast<int64_t>(tr0 + r) * kr + i];
    }
    if (e < nc * kc) {
      const int c = e / kc;
      const int j = e - c * kc;
      f.x[q] = g.ci0[tc0 + c] + j;
      f.wx[q] = g.cw[static_cast<int64_t>(tc0 + c) * kc + j];
    }
  }
}

// Stage tile t's taps into a tap buffer: row offsets (bytes into a column
// of boxes), row weights, col offsets (bytes into the slot) and col
// weights, each tap clamped to the source, then its band's start
// subtracted.
template <int KR, int KC>
__device__ __forceinline__ void stage_taps(const StagedArgs& g, int t,
                                           const TapFetch& f, int32_t* roff) {
  const int kr = KR ? KR : g.k_rows;
  const int kc = KC ? KC : g.k_cols;
  float* rwt = reinterpret_cast<float*>(roff + g.tile_r * kr);
  int32_t* coff = roff + 2 * g.tile_r * kr;
  float* cwt = reinterpret_cast<float*>(coff + g.tile_c * kc);
  const int ti = t / g.tiles_c;
  const int tr0 = ti * g.tile_r;
  const int tc0 = (t - ti * g.tiles_c) * g.tile_c;
  const int nr = min(g.tile_r, g.n_rows - tr0);
  const int nc = min(g.tile_c, g.n_cols - tc0);
  // bytes between the slot's first (16-byte aligned) and the band's
  const int lead = (f.cs * g.px_bytes) & 15;
  const auto row_off = [&](int y) {
    return (clampi(y, 0, g.m_h - 1) - f.rs) * g.box_bytes;
  };
  const auto col_off = [&](int x) {
    const int xb = (clampi(x, 0, g.m_w - 1) - f.cs) * g.px_bytes + lead;
    const int b = xb / g.box_step;
    return b * g.box_stride + (xb - b * g.box_step);
  };
#pragma unroll
  for (int q = 0; q < kPre; ++q) {
    const int e = threadIdx.x + q * blockDim.x;
    if (e < nr * kr) {
      roff[e] = row_off(f.y[q]);
      rwt[e] = f.wy[q];
    }
    if (e < nc * kc) {
      coff[e] = col_off(f.x[q]);
      cwt[e] = f.wx[q];
    }
  }
  for (int e = threadIdx.x + kPre * blockDim.x; e < nr * kr;
       e += blockDim.x) {
    const int r = e / kr;
    const int i = e - r * kr;
    roff[e] = row_off(g.ri0[tr0 + r] + i);
    rwt[e] = g.rw[static_cast<int64_t>(tr0 + r) * kr + i];
  }
  for (int e = threadIdx.x + kPre * blockDim.x; e < nc * kc;
       e += blockDim.x) {
    const int c = e / kc;
    const int j = e - c * kc;
    coff[e] = col_off(g.ci0[tc0 + c] + j);
    cwt[e] = g.cw[static_cast<int64_t>(tc0 + c) * kc + j];
  }
}

// Store tile t's output from shared memory: aligned 4-byte words, bytes on
// the ragged edges of a row; warps on rows, lanes on words.
template <int C>
__device__ __forceinline__ void store_tile(const StagedArgs& g, int t,
                                           const uint8_t* src) {
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const int ti = t / g.tiles_c;
  const int tj = t - ti * g.tiles_c;
  const int tr0 = ti * g.tile_r;
  const int tc0 = tj * g.tile_c;
  const int nr = min(g.tile_r, g.n_rows - tr0);
  const int nc = min(g.tile_c, g.n_cols - tc0);
  const int64_t len = static_cast<int64_t>(nc) * C;
  const int words = static_cast<int>((len + 3) / 4) + 1;
  for (int r = threadIdx.x / 32; r < nr; r += nwarps) {
    uint8_t* row = g.canvas + ((g.r0 + tr0 + r) * g.canvas_w + g.c0 + tc0) * C;
    const uintptr_t d0 = reinterpret_cast<uintptr_t>(row);
    const uintptr_t d1 = d0 + len;
    const uint8_t* s = src + r * g.out_pitch;
    for (int wi = lane; wi < words; wi += 32) {
      const uintptr_t a = (d0 & ~static_cast<uintptr_t>(3)) + 4 * wi;
      if (a >= d1) continue;
      if (a >= d0 && a + 4 <= d1) {
        const uint8_t* p = s + (a - d0);
        *reinterpret_cast<uint32_t*>(a) =
            static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
            (static_cast<uint32_t>(p[2]) << 16) |
            (static_cast<uint32_t>(p[3]) << 24);
      } else {
        for (int b = 0; b < 4; ++b)
          if (a + b >= d0 && a + b < d1)
            *reinterpret_cast<uint8_t*>(a + b) = s[a + b - d0];
      }
    }
  }
}

// T is the band's value type (uint8_t, or uint16_t for bf16 bits); KR and
// KC the tap counts when known at compile time (bilinear: 2), else 0.
//
// Dynamic shared memory, from a 128-byte aligned base: kSlots band slots,
// two output tiles, two tap buffers, kSlots mbarriers (staged_resize.
// smem_bytes mirrors it).
template <int C, typename T, int KR, int KC>
__global__ void __launch_bounds__(kThreads)
    staged_kernel(const __grid_constant__ CUtensorMap map,
                  const StagedArgs g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~static_cast<uintptr_t>(kAlign - 1));
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  const int kr = KR ? KR : g.k_rows;
  const int kc = KC ? KC : g.k_cols;
  const int out_bytes = g.tile_r * g.out_pitch;
  uint8_t* outs = ring + kSlots * g.slot_bytes;
  // taps of a tile: row offsets, row weights, col offsets, col weights
  const int tap_words = 2 * (g.tile_r * kr + g.tile_c * kc);
  int32_t* taps = reinterpret_cast<int32_t*>(outs + ((2 * out_bytes + 15) &
                                                     ~15));
  uint64_t* bars = reinterpret_cast<uint64_t*>(taps + 2 * tap_words);
  const uint32_t ring_s = smem_addr(ring);
  const uint32_t bars_s = smem_addr(bars);
  // the host launches at most one CTA per tile
  const int count = (g.tiles - 1 - static_cast<int>(blockIdx.x)) /
                        static_cast<int>(gridDim.x) + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(bars_s + 8 * s);
    mbar_init_fence();
  }
  TapFetch f;
  fetch_taps<KR, KC>(g, blockIdx.x, f);
  __syncthreads();
  // thread 0: the bands of this CTA's first two tiles, and the band start
  // of the next one it issues, read a tile ahead
  int next_rs = 0, next_cs = 0;
  if (threadIdx.x == 0) {
    for (int d = 0; d < kSlots - 1 && d < count; ++d) {
      int rs, cs;
      band_start(g, blockIdx.x + d * gridDim.x, rs, cs);
      load_band(&map, g, rs, cs, ring_s + d * g.slot_bytes, bars_s + 8 * d);
    }
    if (kSlots - 1 < count)
      band_start(g, blockIdx.x + (kSlots - 1) * gridDim.x, next_rs, next_cs);
  }

  for (int k = 0; k < count; ++k) {
    const int t = blockIdx.x + k * gridDim.x;
    const int ti = t / g.tiles_c;
    const int tr0 = ti * g.tile_r;
    const int tc0 = (t - ti * g.tiles_c) * g.tile_c;
    const int nr = min(g.tile_r, g.n_rows - tr0);
    const int nc = min(g.tile_c, g.n_cols - tc0);

    // tile k's taps into buffer k % 2 (its last reader, tile k - 2, was
    // done before the previous barrier), then tile k + 1's read ahead
    int32_t* roff = taps + (k & 1) * tap_words;
    const float* rwt = reinterpret_cast<const float*>(roff + g.tile_r * kr);
    const int32_t* coff = roff + 2 * g.tile_r * kr;
    const float* cwt = reinterpret_cast<const float*>(coff + g.tile_c * kc);
    stage_taps<KR, KC>(g, t, f, roff);
    if (k + 1 < count) fetch_taps<KR, KC>(g, t + gridDim.x, f);
    // the one barrier: taps visible; tile k - 1's slot read and its output
    // tile written by every thread
    __syncthreads();
    if (threadIdx.x == 0 && k + kSlots - 1 < count) {
      const int s = (k + kSlots - 1) % kSlots;
      fence_proxy_async();
      load_band(&map, g, next_rs, next_cs, ring_s + s * g.slot_bytes,
                bars_s + 8 * s);
      if (k + kSlots < count)
        band_start(g, t + kSlots * gridDim.x, next_rs, next_cs);
    }
    if (k > 0)
      store_tile<C>(g, t - gridDim.x, outs + ((k - 1) & 1) * out_bytes);
    mbar_wait(bars_s + 8 * (k % kSlots), (k / kSlots) & 1);

    const unsigned char* band = ring + (k % kSlots) * g.slot_bytes;
    uint8_t* out = outs + (k & 1) * out_bytes;
    // warps on output rows, lanes on consecutive output columns
    for (int r = warp; r < nr; r += nwarps) {
      const int32_t* ro = roff + r * kr;
      const float* wr = rwt + r * kr;
      for (int c = lane; c < nc; c += 32) {
        const int32_t* co = coff + c * kc;
        const float* wc = cwt + c * kc;
        float acc[C];
#pragma unroll
        for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
#pragma unroll
        for (int j = 0; j < kc; ++j) {
          const unsigned char* col = band + co[j];
          float tmp[C];
#pragma unroll
          for (int ch = 0; ch < C; ++ch) tmp[ch] = 0.0f;
#pragma unroll
          for (int i = 0; i < kr; ++i) {
            const T* px = reinterpret_cast<const T*>(col + ro[i]);
            const float wi = wr[i];
#pragma unroll
            for (int ch = 0; ch < C; ++ch)
              tmp[ch] = tmp[ch] + widen(px[ch]) * wi;
          }
          const float wj = wc[j];
#pragma unroll
          for (int ch = 0; ch < C; ++ch) acc[ch] = acc[ch] + tmp[ch] * wj;
        }
#pragma unroll
        for (int ch = 0; ch < C; ++ch)
          out[r * g.out_pitch + c * C + ch] = quantize(acc[ch]);
      }
    }
  }
  // the last tile's output
  __syncthreads();
  store_tile<C>(g, blockIdx.x + (count - 1) * gridDim.x,
                outs + ((count - 1) & 1) * out_bytes);
  // nothing is left in flight: every band issued was awaited
}

int64_t round_up(int64_t v, int64_t m) { return (v + m - 1) / m * m; }

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the per-device cache: SM count, and which variants have their shared
// memory attribute raised; and the driver's encoder
std::mutex g_mu;
int g_sms[kMaxDevices];
unsigned g_raised[kMaxDevices];
EncodeTiled g_encode = nullptr;

// variant index: bit 2 bf16, bit 1 three channels, bit 0 K = 2 x 2
void* const kKernels[8] = {
    reinterpret_cast<void*>(staged_kernel<1, uint8_t, 0, 0>),
    reinterpret_cast<void*>(staged_kernel<1, uint8_t, 2, 2>),
    reinterpret_cast<void*>(staged_kernel<3, uint8_t, 0, 0>),
    reinterpret_cast<void*>(staged_kernel<3, uint8_t, 2, 2>),
    reinterpret_cast<void*>(staged_kernel<1, uint16_t, 0, 0>),
    reinterpret_cast<void*>(staged_kernel<1, uint16_t, 2, 2>),
    reinterpret_cast<void*>(staged_kernel<3, uint16_t, 0, 0>),
    reinterpret_cast<void*>(staged_kernel<3, uint16_t, 2, 2>)};

cudaError_t find_encoder() {
  if (g_encode != nullptr) return cudaSuccess;
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess) return err;
  if (found != cudaDriverEntryPointSuccess || fn == nullptr)
    return cudaErrorSymbolNotFound;
  g_encode = reinterpret_cast<EncodeTiled>(fn);
  return cudaSuccess;
}

// one source's tensor map, keyed on all that it encodes
struct MapEntry {
  CUtensorMap map;
  const void* src;
  int64_t pitch, row_bytes;
  int32_t m_h, box_bytes, box_rows;
};

thread_local MapEntry t_maps[kMapCache];
thread_local int t_next = 0;

// The tensor map of `src` for the launch `a`: the band source as a 2-D
// byte array of m_h rows of its padded width, pitch bytes apart, read in
// box_bytes x box_rows boxes; bytes outside it read as zero.
cudaError_t tensor_map(const StagedArgs& a, const void* src,
                       const CUtensorMap** out) {
  const int64_t row_bytes = round_up(a.m_w, 16) * a.px_bytes;
  for (int i = 0; i < kMapCache; ++i) {
    const MapEntry& e = t_maps[i];
    if (e.src == src && e.pitch == a.pitch && e.row_bytes == row_bytes &&
        e.m_h == a.m_h && e.box_bytes == a.box_bytes &&
        e.box_rows == a.box_rows) {
      *out = &e.map;
      return cudaSuccess;
    }
  }
  MapEntry& e = t_maps[t_next];
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(row_bytes),
                              static_cast<cuuint64_t>(a.m_h)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(a.box_bytes),
                             static_cast<cuuint32_t>(a.box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  e.src = nullptr;
  const CUresult res = g_encode(
      &e.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(src), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // the driver's refusal, as the runtime's nearest code
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  e.src = src;
  e.pitch = a.pitch;
  e.row_bytes = row_bytes;
  e.m_h = a.m_h;
  e.box_bytes = a.box_bytes;
  e.box_rows = a.box_rows;
  t_next = (t_next + 1) % kMapCache;
  *out = &e.map;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// sizeof(StagedArgs), for the host's mirror of it
int resize_place_staged_args_size() {
  return static_cast<int>(sizeof(StagedArgs));
}

// Check a launch and fill its derived fields, on the calling thread's
// current device (the caller sets it to the device that holds the
// tensors).  Returns a cudaError_t (0 = the launch is ready).  Allocates
// nothing and launches nothing.
//
// The band source (given to each run) is m_h rows of m_w pixels of
// `channels` values of elt_bytes (1: uint8, 2: bf16) bytes, pitch bytes
// apart (a multiple of 16, the source 16-byte aligned), each row readable
// up to m_w rounded up to 16 pixels.  row_starts (tiles_r,) and col_starts
// (tiles_c,) are int32 band starts on the device; the host guarantees that
// every band of band_h x band_w lies in the padded source and covers the
// clamped taps of its tile.  The uint8 result goes to canvas[r0:r0+n_rows,
// c0:c0+n_cols, :] of a (canvas_h, canvas_w, channels) canvas.  ctas is the
// grid, at most the number of tiles; 0 takes the persistent default.
int resize_place_staged_prepare(StagedArgs* a) {
  a->kernel = nullptr;
  a->grid = 0;
  if ((a->elt_bytes != 1 && a->elt_bytes != 2) ||
      (a->channels != 1 && a->channels != 3) || a->m_h < 1 || a->m_w < 1 ||
      a->k_rows < 1 || a->k_cols < 1 || a->band_h < 1 || a->band_w < 1 ||
      a->band_h > a->m_h || a->band_w > round_up(a->m_w, 16) ||
      a->tile_r < 1 || a->tile_c < 1 || a->ctas < 0 || a->r0 < 0 ||
      a->c0 < 0 || a->n_rows < 0 || a->n_cols < 0 ||
      a->r0 + a->n_rows > a->canvas_h || a->c0 + a->n_cols > a->canvas_w ||
      a->pitch % 16 != 0 ||
      a->pitch < round_up(a->m_w, 16) * a->channels * a->elt_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->n_rows == 0 || a->n_cols == 0) return static_cast<int>(cudaSuccess);
  const int64_t px = static_cast<int64_t>(a->channels) * a->elt_bytes;
  const int64_t tiles_c = (a->n_cols + a->tile_c - 1) / a->tile_c;
  const int64_t tiles = (a->n_rows + a->tile_r - 1) / a->tile_r * tiles_c;
  // boxes: as few as cover a band row and the up to 15 bytes before it
  // from the 16-byte boundary where they start, their steps as even as
  // they can be and a whole number of 16 bytes, each box 16 bytes longer
  // than its step and at most 256 bytes
  const int64_t row = a->band_w * px + 15;
  const int64_t boxes = (row + kBoxMax - 16 - 1) / (kBoxMax - 16);
  const int64_t box_step = round_up((row + boxes - 1) / boxes, 16);
  const int64_t box_bytes = box_step + 16;
  const int64_t row_boxes = (a->band_h + kBoxMax - 1) / kBoxMax;
  const int64_t box_rows = (a->band_h + row_boxes - 1) / row_boxes;
  const int64_t box_stride =
      round_up(row_boxes * box_rows * box_bytes, kAlign);
  const int64_t out_pitch = round_up(static_cast<int64_t>(a->tile_c) *
                                     a->channels, 4);
  const int64_t smem =
      kAlign + kSlots * boxes * box_stride +
      round_up(2 * a->tile_r * out_pitch, 16) +
      2 * 8 * (static_cast<int64_t>(a->tile_r) * a->k_rows +
               static_cast<int64_t>(a->tile_c) * a->k_cols) +
      8 * kSlots;
  if (tiles > INT_MAX || smem > kSmemCap)
    return static_cast<int>(cudaErrorInvalidValue);
  a->px_bytes = static_cast<int32_t>(px);
  a->tiles_c = static_cast<int32_t>(tiles_c);
  a->tiles = static_cast<int32_t>(tiles);
  a->box_bytes = static_cast<int32_t>(box_bytes);
  a->box_step = static_cast<int32_t>(box_step);
  a->boxes = static_cast<int32_t>(boxes);
  a->box_rows = static_cast<int32_t>(box_rows);
  a->row_boxes = static_cast<int32_t>(row_boxes);
  a->box_stride = static_cast<int32_t>(box_stride);
  a->slot_bytes = static_cast<int32_t>(boxes * box_stride);
  a->out_pitch = static_cast<int32_t>(out_pitch);
  a->smem_bytes = static_cast<int32_t>(smem);

  const int variant = (a->elt_bytes == 2 ? 4 : 0) +
                      (a->channels == 3 ? 2 : 0) +
                      (a->k_rows == 2 && a->k_cols == 2 ? 1 : 0);
  void* kernel = kKernels[variant];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  int sms = 0;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    err = find_encoder();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (g_sms[device] == 0) {
      err = cudaDeviceGetAttribute(&g_sms[device],
                                   cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    sms = g_sms[device];
    // above the 48 KB default, once per variant and device
    if (!(g_raised[device] & (1u << variant))) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemCap);
      if (err != cudaSuccess) return static_cast<int>(err);
      g_raised[device] |= 1u << variant;
    }
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, a->smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  a->per_sm = per_sm;
  // the persistent default: as many CTAs as the SMs hold
  const int64_t grid = a->ctas ? a->ctas : static_cast<int64_t>(sms) * per_sm;
  a->grid = static_cast<int32_t>(grid < tiles ? grid : tiles);
  a->device = device;
  a->kernel = kernel;
  return static_cast<int>(cudaSuccess);
}

// Launch a prepared launch on `stream` over the band source `src` (16-byte
// aligned, of the shape, dtype and pitch it was prepared for) and return
// the launch's cudaError_t, on the calling thread's current device, which
// must be the one it was prepared on.  It does not synchronise and
// allocates nothing.
int resize_place_staged_run(const StagedArgs* a, const void* src,
                            void* stream) {
  if (a->kernel == nullptr)
    return static_cast<int>(a->n_rows == 0 || a->n_cols == 0
                                ? cudaSuccess
                                : cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(src) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMap* map = nullptr;
  cudaError_t err = tensor_map(*a, src, &map);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[2] = {const_cast<CUtensorMap*>(map),
                   const_cast<StagedArgs*>(a)};
  err = cudaLaunchKernel(a->kernel, dim3(a->grid), dim3(kThreads), args,
                         static_cast<size_t>(a->smem_bytes),
                         static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // extern "C"
