// Fused resize-and-place for one placement of a stitch job, of a batch of
// jobs that share it, or of one row chunk of it, for Hopper (sm_90a).
//
// Replaces the TPU kernel imagestitching_tpu/ops/pallas_resize.py::_make_kernel
// in the three shapes it is launched in: the single-job form (batch=0, from
// resize_place_one), the batched form (batch=B, from resize_place_batch, the
// serving path of parallel/batch._batched_pallas) and the windowed form
// (_jitted_call_static from _WindowPlan.run_chunk, the banded strategy: one
// chunk of dest rows from a host-cropped, host-oriented source row window,
// with row taps rebased to the window).  All three are the one body below
// with other operands, so they cannot drift apart.  The body computes what
// the Pallas kernel computes: the EXIF-oriented source, resampled by the
// separable K-tap filter whose taps geometry.filter_taps computed on the host
// (f64, stored f32), quantized as clip(floor(x + 0.5), 0, 255) into uint8.  It
// is not a block-by-block copy of the Pallas kernel: banded MXU matmuls,
// split-bf16, (8, 128) padding, planar CHW staging, band DMA and the v5e tile
// cost model were answers to the TPU and are left behind.
//
// Design:
//   * One thread computes one output pixel, all C channels, of one job, and
//     stores it straight into canvas[b, r0 + r, c0 + c, :] (uint8 HWC per
//     job).  There is no region tensor and no concat pass: that is the
//     "place" half of the kernel.
//   * blockIdx.z is the job.  B stacked jobs share one placement's taps and
//     run in one launch per placement, whatever B is; the per-job source and
//     canvas strides are arguments.  A single job is the B = 1 case of the
//     same body.  Each thread reads its row and column taps once, and they
//     are the same across z, so the B jobs of a launch read the same tap
//     words (from L1/L2 after the first).
//   * Orientation is folded into the source index math: oriented pixel (y, x)
//     lives at raw pixel base + y * sy + x * sx, the twin of
//     geometry.orient_array / xla_compose.orient_jnp.  Orientations 5-8 swap
//     the display dims, so no transpose pass is needed.
//   * Tap indices are clamped to [0, m - 1] as in xla_compose.ktap_axis.
//     Out-of-range taps carry zero weight and never read out of bounds.
//   * The sum runs in float32 in the plain version's order (rows pass, then
//     cols pass, k in order): out = sum_j cw[j] * (sum_i rw[i] * src[..]).
//     Built with -fmad=false, every product and sum is rounded as the plain
//     PyTorch version rounds it, so the two agree bit for bit.
//   * Source, canvas and job offsets are int64: a canvas that CanvasLimits
//     allows (1 << 30 pixels x 3 channels), or 64 stacked jobs of 47 MB of
//     sources, overflows int32.
//
// What bounds it: device memory bandwidth.  Bilinear (K = 2) costs about 4
// source loads and 8 multiply-adds per channel per output pixel, and one
// store.  Because this is a gather and not a band held in fast memory, it has
// no shared-memory cap: the TPU's K <= 64 tap cap and VMEM band caps were
// capacity limits of the TPU design and have no twin here.  Per output pixel
// the work is Kr * Kc taps, which for the antialiasing filters is bounded by
// about 4x the source pixels the output pixel covers.
//
// The first version is simple on purpose.  Shared-memory source tiles, TMA,
// vector stores and one launch per job are for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int C>
__global__ void resize_place_kernel(
    const uint8_t* __restrict__ src, int64_t src_stride, int64_t base,
    int64_t sy, int64_t sx, int m_h, int m_w,
    const int32_t* __restrict__ ri0, const float* __restrict__ rw, int n_rows,
    int k_rows,
    const int32_t* __restrict__ ci0, const float* __restrict__ cw, int n_cols,
    int k_cols,
    uint8_t* __restrict__ canvas, int64_t canvas_stride, int64_t canvas_w,
    int64_t r0, int64_t c0) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= n_rows || c >= n_cols) return;
  const int64_t b = blockIdx.z;
  const uint8_t* job_src = src + b * src_stride;

  const int row0 = ri0[r];
  const int col0 = ci0[c];
  const float* wr = rw + static_cast<int64_t>(r) * k_rows;
  const float* wc = cw + static_cast<int64_t>(c) * k_cols;

  float acc[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;

  for (int j = 0; j < k_cols; ++j) {
    const int x = min(max(col0 + j, 0), m_w - 1);
    const int64_t col_off = base + static_cast<int64_t>(x) * sx;
    float tmp[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) tmp[ch] = 0.0f;
    for (int i = 0; i < k_rows; ++i) {
      const int y = min(max(row0 + i, 0), m_h - 1);
      const uint8_t* px = job_src + (col_off + static_cast<int64_t>(y) * sy) * C;
      const float w = wr[i];
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        tmp[ch] = tmp[ch] + static_cast<float>(px[ch]) * w;
    }
    const float w = wc[j];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[ch] = acc[ch] + tmp[ch] * w;
  }

  uint8_t* out =
      canvas + b * canvas_stride + ((r0 + r) * canvas_w + (c0 + c)) * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const float q = fminf(fmaxf(floorf(acc[ch] + 0.5f), 0.0f), 255.0f);
    out[ch] = static_cast<uint8_t>(q);
  }
}

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

// The one launcher behind the three C entries.  Strides are in bytes (uint8
// elements) between consecutive jobs; with batch == 1 they are not read.
int launch(const void* src, int batch, int64_t src_stride, int64_t src_h,
           int64_t src_w, int channels, int orientation, const void* ri0,
           const void* rw, int n_rows, int k_rows, const void* ci0,
           const void* cw, int n_cols, int k_cols, void* canvas,
           int64_t canvas_stride, int64_t canvas_h, int64_t canvas_w,
           int64_t r0, int64_t c0, void* stream) {
  int64_t base, sy, sx;
  if (!orientation_map(orientation, src_h, src_w, &base, &sy, &sx) ||
      (channels != 1 && channels != 3) || batch < 1 || batch > 65535 ||
      k_rows < 1 || k_cols < 1 || r0 < 0 || c0 < 0 ||
      r0 + n_rows > canvas_h || c0 + n_cols > canvas_w)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 1 && (src_stride < src_h * src_w * channels ||
                    canvas_stride < canvas_h * canvas_w * channels))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0 || n_cols <= 0) return static_cast<int>(cudaSuccess);
  const bool transposed = orientation >= 5;
  const int m_h = static_cast<int>(transposed ? src_w : src_h);
  const int m_w = static_cast<int>(transposed ? src_h : src_w);

  const dim3 block(32, 8);
  const dim3 grid((n_cols + block.x - 1) / block.x,
                  (n_rows + block.y - 1) / block.y, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src8 = static_cast<const uint8_t*>(src);
  uint8_t* canvas8 = static_cast<uint8_t*>(canvas);
  const int32_t* ri = static_cast<const int32_t*>(ri0);
  const int32_t* ci = static_cast<const int32_t*>(ci0);
  const float* wr = static_cast<const float*>(rw);
  const float* wc = static_cast<const float*>(cw);
  if (channels == 3) {
    resize_place_kernel<3><<<grid, block, 0, s>>>(
        src8, src_stride, base, sy, sx, m_h, m_w, ri, wr, n_rows, k_rows, ci,
        wc, n_cols, k_cols, canvas8, canvas_stride, canvas_w, r0, c0);
  } else {
    resize_place_kernel<1><<<grid, block, 0, s>>>(
        src8, src_stride, base, sy, sx, m_h, m_w, ri, wr, n_rows, k_rows, ci,
        wc, n_cols, k_cols, canvas8, canvas_stride, canvas_w, r0, c0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The entries launch on `stream` and return cudaGetLastError() (0 = the
// launch was accepted).  They launch on the calling thread's current device,
// which the caller sets to the device that holds the tensors and `stream`;
// the current device is left as it was.  They do not synchronise and
// allocate nothing.

// All entries take contiguous uint8 HWC arrays.
//
// One job: src is (src_h, src_w, channels), canvas (canvas_h, canvas_w,
// channels).
int resize_place_launch(const void* src, int64_t src_h,
                        int64_t src_w, int channels, int orientation,
                        const void* ri0, const void* rw, int n_rows,
                        int k_rows, const void* ci0, const void* cw,
                        int n_cols, int k_cols, void* canvas,
                        int64_t canvas_h, int64_t canvas_w, int64_t r0,
                        int64_t c0, void* stream) {
  return launch(src, 1, 0, src_h, src_w, channels, orientation, ri0, rw,
                n_rows, k_rows, ci0, cw, n_cols, k_cols, canvas, 0, canvas_h,
                canvas_w, r0, c0, stream);
}

// `batch` jobs (1 <= batch <= 65535, the grid's z limit) sharing one
// placement's taps: job b's source starts src_stride bytes after job b-1's,
// its canvas canvas_stride bytes after.  One launch for the whole batch.
int resize_place_batch_launch(const void* src, int batch, int64_t src_stride,
                              int64_t src_h, int64_t src_w, int channels,
                              int orientation, const void* ri0,
                              const void* rw, int n_rows, int k_rows,
                              const void* ci0, const void* cw, int n_cols,
                              int k_cols, void* canvas,
                              int64_t canvas_stride, int64_t canvas_h,
                              int64_t canvas_w, int64_t r0, int64_t c0,
                              void* stream) {
  return launch(src, batch, src_stride, src_h, src_w, channels, orientation,
                ri0, rw, n_rows, k_rows, ci0, cw, n_cols, k_cols, canvas,
                canvas_stride, canvas_h, canvas_w, r0, c0, stream);
}

// One chunk of one placement (the banded strategy): crop is the oriented
// source row window (crop_rows, width, channels), orientation already
// applied; the n_rows x n_cols result goes to rows [0, n_rows) of region
// (region_rows, n_cols, channels).  Taps are clamped to the crop, which the
// caller sizes to cover every tap of the chunk.
int resize_place_window_launch(const void* crop, int64_t crop_rows,
                               int64_t width, int channels, const void* ri0,
                               const void* rw, int n_rows, int k_rows,
                               const void* ci0, const void* cw, int n_cols,
                               int k_cols, void* region, int64_t region_rows,
                               void* stream) {
  return launch(crop, 1, 0, crop_rows, width, channels, 1, ri0, rw, n_rows,
                k_rows, ci0, cw, n_cols, k_cols, region, 0, region_rows,
                n_cols, 0, 0, stream);
}

const char* resize_place_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
