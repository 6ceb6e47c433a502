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
// Every column whose terms are integers comes out exact and the same in
// every run: count, border, aux histogram and a 0/1 mask's count are
// integers below 2^24 added as f32 (exact in any order); the moments are
// summed in a zeroed (num_segments, 5) int64 scratch and rounded once to
// f32 (round to nearest) by a second launch, so the table no longer depends
// on the order of the atomics (f32 sums of r^2 ~ 4e6 per pixel did, by
// several ulps, and mu20 = E[r^2] - E[r]^2 cancels ~1e6 against ~1e6).
// Channel sums and a general f32 mask add in run order.
//
// Bound on the H100: HBM reads of the label image and of the image rows of
// labelled pixels (the (2000^2, 63) bf16 cube is 504 MB; background pixels
// skip their row). Design: a warp loads the labels of 4 x 32 consecutive
// pixels at once (four loads in flight per warp; with one, the loop was
// bound by load latency) and skips them when all are background; each
// labelled 32-pixel chunk is split into runs of equal ids that never cross
// an image row (ballot of heads where the id or the row changes). A run of
// k pixels of row r from column c0 has every integer column in closed form
// (k; the border count; k r; k c0 + k(k-1)/2; k r^2; sum (c0+i)^2;
// r sum c), issued once by the run's last lane; the aux classes take runs
// of equal (id, class) the same way (an erosion depth changes slowly along
// a row), the run's last lane adding its length. For
// channel sums the lanes own channels and loop over the run's pixels,
// whose k C values are contiguous (coalesced reads), and the run issues one
// atomic per channel: one per run and column instead of one per pixel
// and column (~23 M for the 10-bit set). (One pass over the chunk's 32
// pixels that flushes at each run's end, and 4 channels per lane loaded
// together, were both slower on the card.) A table without channel sums
// (counts, border, aux) takes an instance with that code compiled out,
// which needs fewer registers.
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
// read through the read-only cache, only for positive ids. Design: four
// pixels per thread with 16-byte accesses (int4 label loads, float4
// streaming stores), a grid of a few waves of the 132 SMs striding over
// the image; a scalar head (until the labels are 16-byte aligned) and tail
// (n % 4) in the same kernel, and scalar stores when the output's alignment
// differs from the labels' (a contiguous view with a storage offset).

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

constexpr unsigned kFull = 0xffffffffu;

// 32-pixel chunks a warp takes per step, their labels loaded together
constexpr int CHUNKS = 4;

// CHAN: 0 = no channel sums, 1 = f32 image, 2 = bf16 image
template <int CHAN>
__global__ void label_stats_kernel(
    const int* __restrict__ labels, const void* __restrict__ image,
    const int* __restrict__ aux, const float* __restrict__ mask,
    float* __restrict__ acc, unsigned long long* __restrict__ mom,
    long long n, int h, int w, int nchan, int num_segments, int aux_classes,
    int has_mask, int ncols) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = (gridDim.x * (long long)blockDim.x) >> 5;
  const int cbase = 2 + (mom != nullptr ? 5 : 0);  // first channel column
  const int abase = cbase + nchan;                  // first aux column
  const unsigned below = kFull >> (31 - lane);      // lanes 0..lane
  auto label_at = [&](long long p) {
    return p < n ? hf_clampi(__ldg(labels + p), 0, num_segments - 1) : 0;
  };
  for (long long step = warp * 32 * CHUNKS; step < n;
       step += nwarps * 32 * CHUNKS) {
    int next0 = label_at(step + lane);
    int next1 = label_at(step + 32 + lane);
    int next2 = label_at(step + 64 + lane);
    int next3 = label_at(step + 96 + lane);
    if (__ballot_sync(kFull, (next0 | next1 | next2 | next3) != 0) == 0) {
      continue;  // all background
    }
    const long long srow = step / w;
    const int scol = (int)(step - srow * w);
#pragma unroll 1
    for (int j = 0; j < CHUNKS; ++j) {
      // the chunk's labels, rotated through registers (no local array)
      const int id = next0;
      next0 = next1;
      next1 = next2;
      next2 = next3;
      if (__ballot_sync(kFull, id != 0) == 0) continue;
      const long long base = step + 32 * j;
      const long long p = base + lane;
      float m = 1.f;
      if (has_mask && p < n) m = __ldg(mask + p);
      // this lane's row and column (w may be below 128: several wraps)
      int col = scol + 32 * j + lane;
      int row = (int)srow;
      while (col >= w) {
        col -= w;
        ++row;
      }
      // runs of equal ids within one image row: start = the run's first
      // lane, tail = its last
      const int prev = __shfl_up_sync(kFull, id, 1);
      const unsigned heads =
          __ballot_sync(kFull, lane == 0 || col == 0 || prev != id);
      const int start = 31 - __clz(heads & below);
      const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
      float msum = 0.f;
      if (has_mask) {
        // the mask's sum over the run, a segmented inclusive scan
        msum = m;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const float o = __shfl_up_sync(kFull, msum, d);
          if (lane - d >= start) msum += o;
        }
      }
      if (tail && id != 0) {
        float* trow = acc + (long long)id * ncols;
        const int k = lane - start + 1;
        const int c0 = col - k + 1;
        atomicAdd(trow, (float)k);
        // row 0 or h - 1: every pixel; else the run's ends on columns 0
        // and w - 1 (one pixel when w == 1)
        const int b = (row == 0 || row == h - 1)
                          ? k
                          : min(k, (c0 == 0) + (col == w - 1));
        if (b) atomicAdd(trow + 1, (float)b);
        if (mom != nullptr) {
          const long long kk = k, r = row, c = c0;
          const long long sc = kk * c + kk * (kk - 1) / 2;
          const long long sc2 = kk * c * c + c * kk * (kk - 1) +
                                (kk - 1) * kk * (2 * kk - 1) / 6;
          unsigned long long* mrow = mom + (long long)id * 5;
          atomicAdd(mrow + 0, (unsigned long long)(kk * r));
          atomicAdd(mrow + 1, (unsigned long long)sc);
          atomicAdd(mrow + 2, (unsigned long long)(kk * r * r));
          atomicAdd(mrow + 3, (unsigned long long)sc2);
          atomicAdd(mrow + 4, (unsigned long long)(r * sc));
        }
        if (has_mask) atomicAdd(trow + ncols - 1, msum);
      }
      if (aux_classes > 0) {
        // runs of equal (id, class) inside the id runs: the run's last
        // lane adds its length to the class's column
        const int a = p < n ? __ldg(aux + p) : -1;
        const int aprev = __shfl_up_sync(kFull, a, 1);
        const unsigned aheads = __ballot_sync(
            kFull, lane == 0 || col == 0 || prev != id || aprev != a);
        const bool atail = lane == 31 || ((aheads >> (lane + 1)) & 1u);
        if (atail && id != 0 && a >= 0 && a < aux_classes) {
          const int k = lane - (31 - __clz(aheads & below)) + 1;
          atomicAdd(acc + (long long)id * ncols + abase + a, (float)k);
        }
      }
      if (CHAN == 0) continue;
      // channel sums, run by run: the lanes own channels and loop over the
      // run's pixels (contiguous rows), then one atomic per channel
      unsigned runs = __ballot_sync(kFull, id != 0 && lane == start);
      while (runs) {
        const int s = __ffs(runs) - 1;
        runs &= runs - 1;
        const unsigned above = s == 31 ? 0u : heads & (kFull << (s + 1));
        const int k = (above ? __ffs(above) - 1 : 32) - s;
        const int sid = __shfl_sync(kFull, id, s);
        float* trow = acc + (long long)sid * ncols + cbase;
        const long long px = (base + s) * nchan;
        for (int c0 = 0; c0 < nchan; c0 += 32) {
          const int c = c0 + lane;
          float v = 0.f;
          if (has_mask) {
            for (int i = 0; i < k; ++i) {
              const float mi = __shfl_sync(kFull, m, s + i);
              if (c < nchan) {
                v += load_px<CHAN == 2>(image, px + (long long)i * nchan + c)
                     * mi;
              }
            }
          } else if (c < nchan) {
#pragma unroll 4
            for (int i = 0; i < k; ++i) {
              v += load_px<CHAN == 2>(image, px + (long long)i * nchan + c);
            }
          }
          if (c < nchan) atomicAdd(trow + c, v);
        }
      }
    }
  }
}

// The moments' int64 sums, rounded once to f32 into their table columns.
__global__ void moments_to_table(const unsigned long long* __restrict__ mom,
                                 float* __restrict__ acc, int num_segments,
                                 int ncols) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_segments * 5) return;
  const int seg = i / 5;
  acc[(long long)seg * ncols + 2 + (i - seg * 5)] =
      __ll2float_rn((long long)mom[i]);
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

__device__ __forceinline__ float lookup_one(const float* __restrict__ table,
                                            int l, int num_segments) {
  return l <= 0 ? 0.f : __ldg(table + min(l, num_segments - 1));
}

// `head` leading pixels (until labels + head is 16-byte aligned) and the
// n % 4 trailing ones go one per thread; the rest four per thread, stored
// as one float4 when out + head is 16-byte aligned too (`vec_out`).
__global__ void label_lookup_kernel(const int* __restrict__ labels,
                                    const float* __restrict__ table,
                                    float* __restrict__ out, long long n,
                                    int num_segments, int head, int vec_out) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long nt = (long long)gridDim.x * blockDim.x;
  const long long nvec = (n - head) / 4;
  const long long rest = head + 4 * nvec;
  if (t < head) out[t] = lookup_one(table, __ldg(labels + t), num_segments);
  if (t < n - rest) {
    out[rest + t] = lookup_one(table, __ldg(labels + rest + t), num_segments);
  }
  const int4* lv = reinterpret_cast<const int4*>(labels + head);
  float* ov = out + head;
  for (long long g = t; g < nvec; g += nt) {
    const int4 l = __ldcs(lv + g);
    const float4 o = make_float4(lookup_one(table, l.x, num_segments),
                                 lookup_one(table, l.y, num_segments),
                                 lookup_one(table, l.z, num_segments),
                                 lookup_one(table, l.w, num_segments));
    if (vec_out) {
      __stcs(reinterpret_cast<float4*>(ov) + g, o);
    } else {
      __stcs(ov + 4 * g, o.x);
      __stcs(ov + 4 * g + 1, o.y);
      __stcs(ov + 4 * g + 2, o.z);
      __stcs(ov + 4 * g + 3, o.w);
    }
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
                             const float* mask, float* acc,
                             unsigned long long* mom, long long n, int h,
                             int w, int nchan, int num_segments,
                             int aux_classes, int has_mask, int ncols,
                             cudaStream_t stream) {
  // `mom`: a zeroed (num_segments, 5) int64 scratch when the table has the
  // moment columns, else null
  if (n < 0 || h < 0 || w < 0 || (long long)h * w != n ||
      num_segments <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned grid = grid_for((n + CHUNKS - 1) / CHUNKS, threads);
  if (nchan == 0) {
    label_stats_kernel<0><<<grid, threads, 0, stream>>>(
        labels, image, aux, mask, acc, mom, n, h, w, nchan, num_segments,
        aux_classes, has_mask, ncols);
  } else if (image_is_bf16) {
    label_stats_kernel<2><<<grid, threads, 0, stream>>>(
        labels, image, aux, mask, acc, mom, n, h, w, nchan, num_segments,
        aux_classes, has_mask, ncols);
  } else {
    label_stats_kernel<1><<<grid, threads, 0, stream>>>(
        labels, image, aux, mask, acc, mom, n, h, w, nchan, num_segments,
        aux_classes, has_mask, ncols);
  }
  if (mom != nullptr) {
    const int cells = num_segments * 5;
    moments_to_table<<<(cells + threads - 1) / threads, threads, 0,
                       stream>>>(mom, acc, num_segments, ncols);
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
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned long long la = (unsigned long long)labels;
  long long head = (long long)((16 - (la & 15)) & 15) / 4;
  if (head > n) head = n;
  const int vec_out = ((unsigned long long)(out + head) & 15) == 0;
  long long blocks = ((n - head) / 4 + threads - 1) / threads;
  const long long cap = 132LL * 8;  // a few waves of full occupancy
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  label_lookup_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      labels, table, out, n, num_segments, (int)head, vec_out);
  return (int)cudaGetLastError();
}

HF_EXPORT const char* hf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
