// Per-label statistics and per-pixel label lookup.
//
// hf_label_stats replaces the TPU kernel hiprfish_tpu/ops/segstats_pallas.py::
// stats_pallas (body _stats_kernel). For every pixel p with label id
// l = clip(labels[p], 0, num_segments - 1) != 0 it adds, into row l of a
// zeroed (num_segments, ncols) float32 table, the columns of
// hiprfish_tpu/ops/segstats.py::_label_stats_windowed in their order:
//   [count, border (row 0 / h-1, col 0 / w-1), moments r, c, r^2, c^2, rc?,
//    channel sums of an f32 or bf16 (n, C) image (times the mask if given),
//    aux histogram over [0, aux_classes)?, mask count?].
// Label 0 never accumulates, so row 0 stays zero (the windowed path never
// sees unlabeled pixels); an aux value outside [0, aux_classes) adds to no
// histogram column (the windowed path's one-hot has no column for it).
//
// Bound on the H100: HBM reads of the label image and of the image rows of
// labelled pixels (the (2000^2, 63) bf16 cube is 504 MB; background pixels
// skip their row). Design: each warp reads 32 consecutive labels
// (coalesced); the lane of a labelled pixel adds its per-pixel columns, then
// the warp walks its labelled pixels and spreads each pixel's contiguous
// channel row over its lanes, so the image reads coalesce and no background
// row is read. Sums go through float atomicAdd into the table, so
// counts are exact (integers below 2^24) and sums round in a run-dependent
// order. Cells are ~200 px with raster-local ids, so a warp-level
// pre-reduction of equal neighbouring ids is the next step.
//
// hf_stats_cm replaces hiprfish_tpu/ops/segstats_pallas.py::stats_cm_pallas
// (body _stats_cm_kernel), the streamed 3D measurement's per-label
// [count, C channel sums] of a CHANNELS-MAJOR (C, n) f32 or bf16 image into
// a zeroed (num_segments, 1 + C) float32 table. Ids outside
// [1, num_segments) add nothing (label 0 is background; the reference's
// window drops ids past the table). Bound on the H100: HBM reads of the
// image, 1 GB per (63, 2, 2020, 2020) bf16 z-chunk, of which only labelled
// pixels' sectors are read. Design: a warp takes 32 consecutive pixels and
// skips them at once when all are background; a channel row c*n + p is
// contiguous over the lanes, so each lane reads its label once and loops
// over the channels with coalesced reads. Neighbouring voxels almost always
// share a label, so the lanes first find the runs of equal ids (ballot of
// run heads), sum each channel over its run with a segmented shuffle scan,
// and only the run's last lane issues the atomicAdd: one atomic per run
// and channel instead of one per voxel and channel. Counts are integers
// (exact below 2^24); sums round in a run-dependent order. Offsets are
// 64-bit (c * n passes 2^31 once a z-chunk holds more than 4 planes).
//
// hf_label_lookup replaces hiprfish_tpu/ops/segstats_pallas.py::
// lookup_pallas (body _lookup_kernel): out[p] = table[clip(l, 0, n - 1)] as
// float32, and 0.0 where l <= 0 (the windowed one-hot holds only positive
// ids). Bound by HBM (4 B read + 4 B written per pixel); the 64 KB table is
// read through the read-only cache. One thread per pixel.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

template <bool BF16>
__device__ __forceinline__ float load_px(const void* image, long long i) {
  if (BF16) {
    return __bfloat162float(
        reinterpret_cast<const __nv_bfloat16*>(image)[i]);
  } else {
    return __ldg(reinterpret_cast<const float*>(image) + i);
  }
}

template <bool BF16>
__global__ void label_stats_kernel(
    const int* __restrict__ labels, const void* __restrict__ image,
    const int* __restrict__ aux, const float* __restrict__ mask,
    float* __restrict__ acc, long long n, int h, int w, int nchan,
    int num_segments, int aux_classes, int moments, int has_mask,
    int ncols) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = (gridDim.x * (long long)blockDim.x) >> 5;
  const int nmom = moments ? 5 : 0;
  for (long long base = warp * 32; base < n; base += nwarps * 32) {
    const long long p = base + lane;
    int id = 0;
    float m = 1.f;
    if (p < n) {
      id = hf_clampi(__ldg(labels + p), 0, num_segments - 1);
      if (has_mask) m = __ldg(mask + p);
    }
    if (id != 0) {
      // per-pixel columns, by the pixel's own lane
      float* row = acc + (long long)id * ncols;
      const int r = (int)(p / w);
      const int col = (int)(p - (long long)r * w);
      atomicAdd(row, 1.f);
      if (r == 0 || r == h - 1 || col == 0 || col == w - 1) {
        atomicAdd(row + 1, 1.f);
      }
      if (moments) {
        const float rf = (float)r;
        const float cf = (float)col;
        atomicAdd(row + 2, rf);
        atomicAdd(row + 3, cf);
        atomicAdd(row + 4, rf * rf);
        atomicAdd(row + 5, cf * cf);
        atomicAdd(row + 6, rf * cf);
      }
      if (aux_classes > 0) {
        const int a = __ldg(aux + p);
        if (a >= 0 && a < aux_classes) {
          atomicAdd(row + 2 + nmom + nchan + a, 1.f);
        }
      }
      if (has_mask) atomicAdd(row + ncols - 1, m);
    }
    if (nchan == 0) continue;
    // channel sums: the warp walks its labelled pixels one by one, the
    // lanes spread over the pixel's contiguous channel row
    unsigned live = __ballot_sync(0xffffffffu, id != 0);
    while (live) {
      const int src = __ffs(live) - 1;
      live &= live - 1;
      const int sid = __shfl_sync(0xffffffffu, id, src);
      const float sm = __shfl_sync(0xffffffffu, m, src);
      const long long px = (base + src) * nchan;
      float* row = acc + (long long)sid * ncols + 2 + nmom;
      for (int c = lane; c < nchan; c += 32) {
        atomicAdd(row + c, load_px<BF16>(image, px + c) * sm);
      }
    }
  }
}

template <bool BF16>
__global__ void stats_cm_kernel(const int* __restrict__ labels,
                                const void* __restrict__ image,
                                float* __restrict__ acc, long long n,
                                int nchan, int num_segments) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = (gridDim.x * (long long)blockDim.x) >> 5;
  const long long ncols = nchan + 1;
  for (long long base = warp * 32; base < n; base += nwarps * 32) {
    const long long p = base + lane;
    int id = 0;
    if (p < n) {
      const int l = __ldg(labels + p);
      id = (l > 0 && l < num_segments) ? l : 0;
    }
    if (__ballot_sync(kFull, id != 0) == 0) continue;  // all background
    // runs of equal ids over consecutive lanes: start = the run's first
    // lane (the highest head at or below this lane), tail = its last lane
    const int prev = __shfl_up_sync(kFull, id, 1);
    const int next = __shfl_down_sync(kFull, id, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != id);
    const int start = 31 - __clz(heads & (kFull >> (31 - lane)));
    const bool issue = id != 0 && (lane == 31 || next != id);
    float* row = acc + id * ncols;
    if (issue) atomicAdd(row, (float)(lane - start + 1));
#pragma unroll 4
    for (int c = 0; c < nchan; ++c) {
      float v = id != 0 ? load_px<BF16>(image, c * n + p) : 0.f;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float o = __shfl_up_sync(kFull, v, d);
        if (lane - d >= start) v += o;
      }
      if (issue) atomicAdd(row + 1 + c, v);
    }
  }
}

__global__ void label_lookup_kernel(const int* __restrict__ labels,
                                    const float* __restrict__ table,
                                    float* __restrict__ out, long long n,
                                    int num_segments) {
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < n;
       p += (long long)gridDim.x * blockDim.x) {
    const int l = __ldg(labels + p);
    out[p] = l <= 0 ? 0.f : __ldg(table + min(l, num_segments - 1));
  }
}

unsigned grid_for(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  const long long cap = 132LL * 64;  // grid-stride beyond 64 blocks per SM
  if (blocks > cap) blocks = cap;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace

HF_EXPORT int hf_label_stats(const int* labels, const void* image,
                             int image_is_bf16, const int* aux,
                             const float* mask, float* acc, long long n,
                             int h, int w, int nchan, int num_segments,
                             int aux_classes, int moments, int has_mask,
                             int ncols, cudaStream_t stream) {
  const int threads = 256;
  const unsigned grid = grid_for(n, threads);
  if (image_is_bf16) {
    label_stats_kernel<true><<<grid, threads, 0, stream>>>(
        labels, image, aux, mask, acc, n, h, w, nchan, num_segments,
        aux_classes, moments, has_mask, ncols);
  } else {
    label_stats_kernel<false><<<grid, threads, 0, stream>>>(
        labels, image, aux, mask, acc, n, h, w, nchan, num_segments,
        aux_classes, moments, has_mask, ncols);
  }
  return (int)cudaGetLastError();
}

HF_EXPORT int hf_stats_cm(const int* labels, const void* image,
                          int image_is_bf16, float* acc, long long n,
                          int nchan, int num_segments, cudaStream_t stream) {
  const int threads = 256;
  const unsigned grid = grid_for(n, threads);
  if (image_is_bf16) {
    stats_cm_kernel<true><<<grid, threads, 0, stream>>>(
        labels, image, acc, n, nchan, num_segments);
  } else {
    stats_cm_kernel<false><<<grid, threads, 0, stream>>>(
        labels, image, acc, n, nchan, num_segments);
  }
  return (int)cudaGetLastError();
}

HF_EXPORT int hf_label_lookup(const int* labels, const float* table,
                              float* out, long long n, int num_segments,
                              cudaStream_t stream) {
  const int threads = 256;
  label_lookup_kernel<<<grid_for(n, threads), threads, 0, stream>>>(
      labels, table, out, n, num_segments);
  return (int)cudaGetLastError();
}

HF_EXPORT const char* hf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
