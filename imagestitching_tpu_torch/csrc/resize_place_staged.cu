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
// What bounds it: device memory bandwidth.  Bilinear (K = 2) is 8
// multiply-adds per channel per output pixel against the source read once
// (1 or 2 bytes a value) and the slot written once: 7.99 MB for the uint8
// slot, far below the card's 295 operations per byte.  What the ring does
// about it: the band copies of the next two tiles are in flight while a
// tile is computed, so a CTA does not wait on device memory between tiles.
//
//   * The host gives a band start for each tile row and each tile column
//     (band_schedule, the twin of _Schedule.ints) and one band size for
//     every tile, band_h x band_w.  Rows of the band source are padded so
//     that each band row is a whole number of 16-byte copies at 16-byte
//     aligned addresses.
//   * A CTA walks its tiles in order, t = blockIdx.x + k * gridDim.x, which
//     stands in for the TPU's sequential grid; there are fewer CTAs than
//     tiles.  It keeps 3 band slots in dynamic shared memory and issues the
//     band of tile k + 2 with cp.async.cg (16 bytes a copy, one commit group
//     per tile) before it waits on tile k's.  Two barriers per tile: one
//     after the wait, so tile k's band is complete for every thread; one
//     after the compute, before slot k % 3 is refilled at the top of the
//     next iteration (the write after read) and before the output tile is
//     stored.
//   * Each output pixel takes the one-pass order of resize_place.cu's
//     fused_tile: acc += cw[c, j] * (sum_i rw[r, i] * band[y_i][x_j]), i
//     inner and j outer, in f32, each term a separate multiply and add;
//     built with -fmad=false every product and sum is rounded as the plain
//     version (torch_compose.resample) rounds it, so the two agree bit for
//     bit, and agree with kernel #1.  Tap indices are clamped to the source,
//     as in ktap_axis, then the band's start is subtracted: the host
//     guarantees that the clamped tap lies in the band.
//   * A bf16 value is the high half of an f32: it is widened by a shift,
//     exactly, as a uint8 is by a conversion.  No tensor cores: they would
//     change the rounding and the order of the sums.
//   * The uint8 output tile is staged in shared memory after the ring and
//     stored as aligned 4-byte words, bytes on the ragged edges of a row.
//   * Source pitch and canvas offsets are int64.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 3;
// dynamic shared memory a CTA may take on Hopper
constexpr int kSmemCap = 227 * 1024;

// Everything one launch needs, passed by value.
struct Staged {
  const unsigned char* src;   // the band source, row 0
  int64_t pitch;              // bytes between its rows
  int px_bytes;               // bytes per pixel (channels x 1 or 2)
  int m_h, m_w;               // source dims
  const int32_t* ri0;         // (n_rows,) row tap starts
  const float* rw;            // (n_rows, k_rows)
  int n_rows, k_rows;
  const int32_t* ci0;         // (n_cols,) col tap starts
  const float* cw;            // (n_cols, k_cols)
  int n_cols, k_cols;
  const int32_t* row_starts;  // (tiles_r,) band row start per tile row
  const int32_t* col_starts;  // (tiles_c,) band col start per tile col
  int band_h, band_w;
  int band_row_bytes;         // band_w * px_bytes, a multiple of 16
  int slot_bytes;             // band_h * band_row_bytes
  int tile_r, tile_c, tiles_c, tiles;
  int out_pitch;              // bytes per output-tile row
  uint8_t* canvas;
  int64_t canvas_w, r0, c0;
};

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of tile t's band into `slot`: consecutive threads on
// consecutive 16-byte pieces of a band row.
__device__ __forceinline__ void fill(const Staged& g, int t,
                                     unsigned char* slot) {
  const int rs = g.row_starts[t / g.tiles_c];
  const int cs = g.col_starts[t % g.tiles_c];
  const unsigned char* src = g.src + static_cast<int64_t>(rs) * g.pitch +
                             static_cast<int64_t>(cs) * g.px_bytes;
  const int pieces = g.band_row_bytes / 16;
  for (int e = threadIdx.x; e < g.band_h * pieces; e += blockDim.x) {
    const int r = e / pieces;
    const int q = e - r * pieces;
    cp_async16(slot + r * g.band_row_bytes + q * 16,
               src + static_cast<int64_t>(r) * g.pitch + q * 16);
  }
}

// T is the band's value type (uint8_t, or uint16_t for bf16 bits); KR and
// KC the tap counts when known at compile time (bilinear: 2), else 0.
template <int C, typename T, int KR, int KC>
__global__ void __launch_bounds__(kThreads)
    staged_kernel(const Staged g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  const int kr = KR ? KR : g.k_rows;
  const int kc = KC ? KC : g.k_cols;
  // the host launches at most one CTA per tile
  const int count = (g.tiles - 1 - static_cast<int>(blockIdx.x)) /
                        static_cast<int>(gridDim.x) + 1;
  uint8_t* s_out = smem + kSlots * g.slot_bytes;

  // the bands of this CTA's first two tiles
  for (int d = 0; d < kSlots - 1; ++d) {
    if (d < count)
      fill(g, blockIdx.x + d * gridDim.x, smem + d * g.slot_bytes);
    cp_async_commit();
  }

  for (int k = 0; k < count; ++k) {
    // the band two tiles ahead, into the slot tile k - 1 read (barrier 2
    // of iteration k - 1 saw every read of it); a group is committed even
    // when empty, so that group k is always the (k + 1)-th
    if (k + kSlots - 1 < count)
      fill(g, blockIdx.x + (k + kSlots - 1) * gridDim.x,
           smem + ((k + kSlots - 1) % kSlots) * g.slot_bytes);
    cp_async_commit();
    // this thread's copies of tile k's band have landed; the two bands
    // ahead may still be in flight
    cp_async_wait<kSlots - 1>();
    // barrier 1: every thread's copies of tile k's band have landed
    __syncthreads();

    const int t = blockIdx.x + k * gridDim.x;
    const int ti = t / g.tiles_c;
    const int tj = t - ti * g.tiles_c;
    const int tr0 = ti * g.tile_r;
    const int tc0 = tj * g.tile_c;
    const int nr = min(g.tile_r, g.n_rows - tr0);
    const int nc = min(g.tile_c, g.n_cols - tc0);
    const int rs = g.row_starts[ti];
    const int cs = g.col_starts[tj];
    const T* band = reinterpret_cast<const T*>(smem + (k % kSlots) *
                                               g.slot_bytes);
    const int bpitch = g.band_w * C;   // values per band row

    // warps on output rows, lanes on consecutive output columns
    for (int r = warp; r < nr; r += nwarps) {
      const int y0 = g.ri0[tr0 + r];
      const float* wr = g.rw + static_cast<int64_t>(tr0 + r) * kr;
      for (int c = lane; c < nc; c += 32) {
        const int x0 = g.ci0[tc0 + c];
        const float* wc = g.cw + static_cast<int64_t>(tc0 + c) * kc;
        float acc[C];
#pragma unroll
        for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
#pragma unroll
        for (int j = 0; j < kc; ++j) {
          const T* col = band + (clampi(x0 + j, 0, g.m_w - 1) - cs) * C;
          float tmp[C];
#pragma unroll
          for (int ch = 0; ch < C; ++ch) tmp[ch] = 0.0f;
#pragma unroll
          for (int i = 0; i < kr; ++i) {
            const T* px = col + (clampi(y0 + i, 0, g.m_h - 1) - rs) * bpitch;
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
          s_out[r * g.out_pitch + c * C + ch] = quantize(acc[ch]);
      }
    }
    // barrier 2: no thread reads slot k % 3 any more, so the next
    // iteration may refill it, and the output tile is complete
    __syncthreads();

    // store: aligned 4-byte words, bytes on the ragged edges
    const int64_t len = static_cast<int64_t>(nc) * C;
    const int words = static_cast<int>((len + 3) / 4) + 1;
    for (int r = warp; r < nr; r += nwarps) {
      uint8_t* row =
          g.canvas + ((g.r0 + tr0 + r) * g.canvas_w + g.c0 + tc0) * C;
      const uintptr_t d0 = reinterpret_cast<uintptr_t>(row);
      const uintptr_t d1 = d0 + len;
      const uint8_t* s = s_out + r * g.out_pitch;
      for (int wi = lane; wi < words; wi += 32) {
        const uintptr_t a = (d0 & ~static_cast<uintptr_t>(3)) + 4 * wi;
        if (a >= d1) continue;
        if (a >= d0 && a + 4 <= d1) {
          const uint8_t* p = s + (a - d0);
          *reinterpret_cast<uint32_t*>(a) =
              static_cast<uint32_t>(p[0]) |
              (static_cast<uint32_t>(p[1]) << 8) |
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
  // nothing is left in flight: the last groups committed were empty
}

template <int C, typename T>
cudaError_t start(const Staged& g, int ctas, int smem, cudaStream_t s) {
  void (*kernel)(const Staged) = g.k_rows == 2 && g.k_cols == 2
                                     ? staged_kernel<C, T, 2, 2>
                                     : staged_kernel<C, T, 0, 0>;
  // above the 48 KB default, on the current device
  const cudaError_t attr = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
  if (attr != cudaSuccess) return attr;
  kernel<<<ctas, kThreads, smem, s>>>(g);
  return cudaGetLastError();
}

int64_t round_up(int64_t v, int64_t m) { return (v + m - 1) / m * m; }

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's cudaError_t (0 = the launch
// was accepted), on the calling thread's current device, which the caller
// sets to the device that holds the tensors and `stream`.  It does not
// synchronise and allocates nothing.
//
// src is the band source: m_h rows of m_w pixels of `channels` values of
// elt_bytes (1: uint8, 2: bf16) bytes, pitch bytes apart (a multiple of
// 16, src 16-byte aligned), each row readable up to m_w rounded up to 16
// pixels.  row_starts (tiles_r,) and col_starts (tiles_c,) are int32 band
// starts on the device, band_w a multiple of 16 pixels; the host
// guarantees that every band lies in the padded source and covers the
// clamped taps of its tile.  The uint8 result goes to canvas[r0:r0+n_rows,
// c0:c0+n_cols, :] of a (canvas_h, canvas_w, channels) canvas.  ctas is
// the grid, at most the number of tiles; 0 takes min(tiles, 2 x SMs).
int resize_place_staged_launch(
    const void* src, int elt_bytes, int64_t pitch, int64_t m_h, int64_t m_w,
    int channels, const void* ri0, const void* rw, int n_rows, int k_rows,
    const void* ci0, const void* cw, int n_cols, int k_cols,
    const void* row_starts, const void* col_starts, int band_h, int band_w,
    int tile_r, int tile_c, void* canvas, int64_t canvas_h,
    int64_t canvas_w, int64_t r0, int64_t c0, int ctas, void* stream) {
  if ((elt_bytes != 1 && elt_bytes != 2) || (channels != 1 && channels != 3) ||
      m_h < 1 || m_w < 1 || m_h > INT_MAX || m_w > INT_MAX || k_rows < 1 ||
      k_cols < 1 || band_h < 1 || band_w < 1 || band_h > m_h ||
      band_w % 16 != 0 || band_w > round_up(m_w, 16) || tile_r < 1 ||
      tile_c < 1 || ctas < 0 || r0 < 0 || c0 < 0 || n_rows < 0 ||
      n_cols < 0 || r0 + n_rows > canvas_h || c0 + n_cols > canvas_w ||
      pitch % 16 != 0 || reinterpret_cast<uintptr_t>(src) % 16 != 0 ||
      pitch < round_up(m_w, 16) * channels * elt_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0 || n_cols == 0) return static_cast<int>(cudaSuccess);
  Staged g;
  g.src = static_cast<const unsigned char*>(src);
  g.pitch = pitch;
  g.px_bytes = channels * elt_bytes;
  g.m_h = static_cast<int>(m_h);
  g.m_w = static_cast<int>(m_w);
  g.ri0 = static_cast<const int32_t*>(ri0);
  g.rw = static_cast<const float*>(rw);
  g.n_rows = n_rows;
  g.k_rows = k_rows;
  g.ci0 = static_cast<const int32_t*>(ci0);
  g.cw = static_cast<const float*>(cw);
  g.n_cols = n_cols;
  g.k_cols = k_cols;
  g.row_starts = static_cast<const int32_t*>(row_starts);
  g.col_starts = static_cast<const int32_t*>(col_starts);
  g.band_h = band_h;
  g.band_w = band_w;
  g.tile_r = tile_r;
  g.tile_c = tile_c;
  g.tiles_c = (n_cols + tile_c - 1) / tile_c;
  const int64_t tiles =
      static_cast<int64_t>((n_rows + tile_r - 1) / tile_r) * g.tiles_c;
  const int64_t row_bytes = static_cast<int64_t>(band_w) * g.px_bytes;
  const int64_t out_pitch = round_up(static_cast<int64_t>(tile_c) * channels,
                                     4);
  const int64_t smem = kSlots * band_h * row_bytes + tile_r * out_pitch;
  if (tiles > INT_MAX || smem > kSmemCap)
    return static_cast<int>(cudaErrorInvalidValue);
  g.tiles = static_cast<int>(tiles);
  g.band_row_bytes = static_cast<int>(row_bytes);
  g.slot_bytes = static_cast<int>(band_h * row_bytes);
  g.out_pitch = static_cast<int>(out_pitch);
  g.canvas = static_cast<uint8_t*>(canvas);
  g.canvas_w = canvas_w;
  g.r0 = r0;
  g.c0 = c0;
  if (ctas == 0) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return static_cast<int>(err);
    ctas = static_cast<int>(tiles < 2 * sms ? tiles : 2 * sms);
  }
  if (ctas > tiles) ctas = g.tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bytes = static_cast<int>(smem);
  cudaError_t err;
  if (elt_bytes == 1)
    err = channels == 3 ? start<3, uint8_t>(g, ctas, bytes, s)
                        : start<1, uint8_t>(g, ctas, bytes, s);
  else
    err = channels == 3 ? start<3, uint16_t>(g, ctas, bytes, s)
                        : start<1, uint16_t>(g, ctas, bytes, s);
  return static_cast<int>(err);
}

}  // extern "C"
