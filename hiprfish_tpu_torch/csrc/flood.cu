// One round of the fixpoint floods of hiprfish_tpu_torch/ops/labeling.py:
// the min round (_min_round_plain, behind label and segstats.rank_labels;
// int32 state) and the reach round (_reach_round_plain, behind
// flood_reach; bool state), bitwise.
//
// Replaces no TPU kernel: the JAX package's rounds are XLA ops in
// hiprfish_tpu/ops/labeling.py. The plain round is a 3^ndim window and six
// Hillis-Steele scans, each ~7 whole-array torch passes a doubling step:
// over 200 passes a round on a 488x170x2020 tile. It computes, per voxel:
//   1. the neighbour pass: the reduce (min, or OR) of cur over a set of
//      offsets read whatever their mask, _INF / false outside the array,
//      kept on the mask, _INF / false off it;
//   2. per axis, in order: each mask voxel takes the reduce over the
//      voxels within W of it along the axis inside its unbroken mask run,
//      W = 2^ceil(log2 min(n, max_run)) - 1; voxels off the mask keep
//      their value.
// Bound on the H100: HBM bytes; there is no arithmetic to speak of. A pass
// reads the state and the mask once and writes the state once.
//
// flood_neighbor_kernel: a block owns a 16 x 32 (axis 1, axis 2) column
// of the (n0, n1, n2) view and walks axis 0, staging each plane with a
// one-voxel halo in shared memory. A plane x gives two in-plane reduces,
// one over the centre and the in-plane offsets the set takes (plane x's
// own share) and one over the in-plane offsets that planes x - 1 and x + 1
// take from it (|o|_1 one higher there); three planes' values, in
// registers, give a voxel its result. The offset set is passed as bits by
// in-plane class (centre, 4 axial, 4 diagonal).
//
// flood_runs_kernel: the run window of one axis (lines of n voxels at
// stride ``inner``). A block stages 32 lines in shared memory: whole, when
// they fit, else a chunk of nb blocks of B = W + 1 voxels and one block of
// halo each side. A warp loads a row of the 32 lines (strided lines) or
// runs along one line (contiguous lines), so the loads coalesce, 8 in
// flight a thread. Each thread then walks one block of one line: the
// prefix and suffix reduce inside the block, reset at run breaks (van Herk
// / Gil-Werman), and the ends of the block's first and last runs. A window
// [p - W, p + W] spans at most the blocks either side of p's, and with the
// runs' ends the part in each is one prefix or suffix value: O(1) work a
// voxel whatever W is. A window longer than one block fits (W > 63 for
// int32, 255 for bytes) is split by the caller into passes whose radii sum
// to it: windows over one run compose.

#include <stdint.h>

#include "common.cuh"

namespace {

// labeling._INF
constexpr int kInf = 1 << 30;

template <typename T>
struct Red;

template <>
struct Red<int> {
  static __device__ __forceinline__ int ident() { return kInf; }
  static __device__ __forceinline__ int op(int a, int b) { return min(a, b); }
};

template <>
struct Red<unsigned char> {
  static __device__ __forceinline__ unsigned char ident() { return 0; }
  static __device__ __forceinline__ unsigned char op(unsigned char a,
                                                     unsigned char b) {
    return a | b;
  }
};

constexpr int kNbY = 32;   // block width along axis 2 (contiguous)
constexpr int kNbZ = 16;   // block height along axis 1
constexpr int kNbX = 64;   // planes of axis 0 a block walks
constexpr int kNbTile = (kNbZ + 2) * (kNbY + 2);
constexpr int kNbLoads = (kNbTile + kNbY * kNbZ - 1) / (kNbY * kNbZ);

// side: bit d set when planes x - 1 and x + 1 contribute their in-plane
// class d (d = 0 centre, 1 axial, 2 diagonal); mid: bit d (d = 1, 2) when
// plane x contributes its class d besides the centre. The next plane's
// halo tile is loaded into registers while the current one is reduced
// (two tiles in shared memory, one barrier a plane).
template <typename T>
__global__ void __launch_bounds__(kNbY * kNbZ) flood_neighbor_kernel(
    const T* __restrict__ cur, const unsigned char* __restrict__ mask,
    T* __restrict__ out, int n0, int n1, int n2, int side, int mid) {
  __shared__ T tile[2][kNbZ + 2][kNbY + 2];
  using R = Red<T>;
  const int ty = threadIdx.x, tz = threadIdx.y;
  const int tid = tz * kNbY + ty;
  const int yb = blockIdx.x * kNbY, zb = blockIdx.y * kNbZ;
  const int y = yb + ty, z = zb + tz;
  const int x0 = blockIdx.z * kNbX, x1 = min(n0, x0 + kNbX);
  const long long plane = (long long)n1 * n2;
  const T id = R::ident();
  const bool inside = y < n2 && z < n1;
  // this thread's elements of a halo tile: offsets in a plane, -1 outside
  long long offs[kNbLoads];
#pragma unroll
  for (int k = 0; k < kNbLoads; ++k) {
    const int e = tid + k * kNbY * kNbZ;
    const int rz = e / (kNbY + 2), ry = e - rz * (kNbY + 2);
    const int gz = zb + rz - 1, gy = yb + ry - 1;
    offs[k] = (e < kNbTile && gz >= 0 && gz < n1 && gy >= 0 && gy < n2)
                  ? (long long)gz * n2 + gy
                  : -1;
  }
  T regs[kNbLoads];
  auto fetch = [&](int x) {
    const bool need = x >= 0 && x < n0;
#pragma unroll
    for (int k = 0; k < kNbLoads; ++k)
      regs[k] = (need && offs[k] >= 0) ? __ldg(cur + x * plane + offs[k])
                                        : id;
  };
  T a_prev = id, a_cur = id, b_cur = id;
  fetch(x0 - 1);
  int buf = 0;
  for (int x = x0 - 1; x <= x1; ++x) {
    T a = id, b = id;
    const bool need = x >= 0 && x < n0;  // uniform over the block
    if (need) {
#pragma unroll
      for (int k = 0; k < kNbLoads; ++k) {
        const int e = tid + k * kNbY * kNbZ;
        if (e < kNbTile) (&tile[buf][0][0])[e] = regs[k];
      }
      __syncthreads();
    }
    if (x < x1) fetch(x + 1);
    if (need) {
      const T(*t)[kNbY + 2] = tile[buf];
      const T c = t[tz + 1][ty + 1];
      const T r1 = R::op(R::op(t[tz][ty + 1], t[tz + 2][ty + 1]),
                         R::op(t[tz + 1][ty], t[tz + 1][ty + 2]));
      const T r2 = R::op(R::op(t[tz][ty], t[tz][ty + 2]),
                         R::op(t[tz + 2][ty], t[tz + 2][ty + 2]));
      if (side & 1) a = R::op(a, c);
      if (side & 2) a = R::op(a, r1);
      if (side & 4) a = R::op(a, r2);
      b = c;
      if (mid & 2) b = R::op(b, r1);
      if (mid & 4) b = R::op(b, r2);
      buf ^= 1;
    }
    // plane x - 1 has its three planes' values now
    if (x - 1 >= x0 && inside) {
      const long long i = (long long)(x - 1) * plane + (long long)z * n2 + y;
      const T v = R::op(b_cur, R::op(a_prev, a));
      out[i] = __ldg(mask + i) ? v : id;
    }
    a_prev = a_cur;
    a_cur = a;
    b_cur = b;
  }
}

constexpr int kLines = 32;               // lines a run-window block stages
constexpr int kMaxBlocks = 1024 / kLines;  // blocks a chunk stages, halos in
constexpr size_t kRunSmem = 96 * 1024;   // two thread blocks an SM
constexpr int kLoads = 8;                // loads in flight a thread

// Shared bytes of a chunk of ``nloc`` blocks and ``rows`` staged rows.
template <typename T>
size_t runs_smem(int nloc, int rows) {
  return 2 * (size_t)nloc * kLines * sizeof(int) +
         (size_t)rows * (kLines + 1) * (2 * sizeof(T) + 1);
}

// Lines [32 g, 32 g + 32) of the view (line l starts at (l / inner) * n *
// inner + l % inner and steps by inner), g = blockIdx.x / nchunks; chunk c
// = blockIdx.x % nchunks writes the axis blocks [c nb, c nb + nb) of B =
// blk = W + 1 <= n voxels and stages them with the block before and the
// block after, where the line has them (``cap`` rows of shared memory at
// most). fold: take cur off the mask as the identity first (the
// neighbour pass of connectivity 1).
template <typename T>
__global__ void __launch_bounds__(1024) flood_runs_kernel(
    const T* __restrict__ in, const unsigned char* __restrict__ mask,
    T* __restrict__ out, long long lines, int n, long long inner, int blk,
    int nb, int nchunks, int cap, int fold) {
  extern __shared__ __align__(16) unsigned char smem[];
  using R = Red<T>;
  constexpr int ld = kLines + 1;
  const int nblk = (n + blk - 1) / blk;
  const long long group = blockIdx.x / nchunks;
  const int chunk = blockIdx.x - (int)(group * nchunks);
  const int lb = chunk > 0;                    // a block of halo before
  const int c0 = chunk * nb, c1 = min(nblk, c0 + nb);
  const int nloc = lb + (c1 - c0) + (c1 < nblk);
  const int pos0 = (c0 - lb) * blk;            // line position of row 0
  const int rows = min(nloc * blk, n - pos0);
  int* first_end = reinterpret_cast<int*>(smem);   // [nloc][32]
  int* last_start = first_end + nloc * kLines;
  T* P = reinterpret_cast<T*>(last_start + nloc * kLines);
  T* S = P + (size_t)cap * ld;
  unsigned char* M = reinterpret_cast<unsigned char*>(S + (size_t)cap * ld);
  const T id = R::ident();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const long long l0 = group * kLines;
  auto line_base = [&](int col) -> long long {
    const long long l = l0 + col;
    return l < lines ? (l / inner) * n * inner + l % inner + pos0 * inner
                     : -1;
  };

  // stage the chunk, kLoads elements a thread in flight: a warp takes a
  // row of the 32 lines (strided lines), or a line's rows (contiguous)
  auto stage = [&](long long b, int col, int row0, int step) {
    T v[kLoads];
    unsigned char m[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int row = row0 + k * step;
      v[k] = id;
      m[k] = 0;
      if (b >= 0 && row < rows) {
        const long long off = b + (long long)row * inner;
        m[k] = __ldg(mask + off);
        v[k] = __ldg(in + off);
      }
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int row = row0 + k * step;
      if (row < rows) {
        P[row * ld + col] = (fold && !m[k]) ? id : v[k];
        M[row * ld + col] = m[k];
      }
    }
  };
  if (inner > 1) {
    const long long b = line_base(lane);
    for (int row0 = warp; row0 < rows; row0 += kLoads * nwarps)
      stage(b, lane, row0, nwarps);
  } else {
    for (int col = warp; col < kLines; col += nwarps) {
      const long long b = line_base(col);
      for (int row0 = lane; row0 < rows; row0 += kLoads * 32)
        stage(b, col, row0, 32);
    }
  }
  __syncthreads();

  // one thread a (block, line): suffix and prefix reduces reset at breaks,
  // the first run's last index (-1: the block starts off the mask) and the
  // last run's first index (blk: the block ends off the mask); a block cut
  // by the line's end is its last
  const int col = lane, bi = warp;
  if (bi < nloc) {
    const int q0 = bi * blk, len = min(blk, rows - q0);
    T acc = id;
    int last = blk;
    bool lead = len == blk;
#pragma unroll 8
    for (int r = len - 1; r >= 0; --r) {
      const int q = (q0 + r) * ld + col;
      const unsigned char m = M[q];
      const T v = P[q];
      acc = m ? R::op(acc, v) : id;
      S[q] = m ? acc : v;
      if (lead) {
        if (m) last = r; else lead = false;
      }
    }
    acc = id;
    int first = -1;
    lead = true;
#pragma unroll 8
    for (int r = 0; r < len; ++r) {
      const int q = (q0 + r) * ld + col;
      const unsigned char m = M[q];
      const T v = P[q];
      acc = m ? R::op(acc, v) : id;
      P[q] = m ? acc : v;
      if (lead) {
        if (m) first = r; else lead = false;
      }
    }
    first_end[bi * kLines + col] = first;
    last_start[bi * kLines + col] = last;
  }
  __syncthreads();
  // the left part: a voxel r of block bi in the block's first run, which
  // the previous block's last run continues, takes the suffix from
  // max(r + 1, that run's start) (p - W lies at r + 1 there)
  const int bi0 = lb, bi1 = lb + (c1 - c0);  // the blocks written
  const bool written = bi >= bi0 && bi < bi1;
  if (written && bi >= 1) {
    const int prev = last_start[(bi - 1) * kLines + col];
    if (prev < blk) {
      const int lim = min(first_end[bi * kLines + col], blk - 2);
      for (int r = 0; r <= lim; ++r) {
        const int q = (bi * blk + r) * ld + col;
        P[q] = R::op(P[q], S[((bi - 1) * blk + max(r + 1, prev)) * ld + col]);
      }
    }
  }
  __syncthreads();
  // the right part: a voxel r >= 1 in the block's last run, which the next
  // block's first run continues, takes the next block's prefix to
  // min(r - 1, that run's end) (p + W lies at r - 1 there); a prefix that
  // the left part widened holds only voxels of p's window and run
  if (written && bi + 1 < nloc) {
    const int next = first_end[(bi + 1) * kLines + col];
    if (next >= 0) {
      for (int r = max(last_start[bi * kLines + col], 1); r < blk; ++r) {
        const int q = (bi * blk + r) * ld + col;
        S[q] = R::op(S[q], P[((bi + 1) * blk + min(r - 1, next)) * ld + col]);
      }
    }
  }
  __syncthreads();

  const int r0 = bi0 * blk, r1 = min(rows, bi1 * blk);
  auto emit = [&](long long b, int c, int row) {
    if (b >= 0 && row < r1) {
      const int q = row * ld + c;
      out[b + (long long)row * inner] = M[q] ? R::op(P[q], S[q]) : P[q];
    }
  };
  if (inner > 1) {
    const long long b = line_base(lane);
    for (int row = r0 + warp; row < r1; row += nwarps) emit(b, lane, row);
  } else {
    for (int c = warp; c < kLines; c += nwarps) {
      const long long b = line_base(c);
      for (int row = r0 + lane; row < r1; row += 32) emit(b, c, row);
    }
  }
}

template <typename T>
int launch_neighbor(const void* cur, const unsigned char* mask, void* out,
                    int n0, int n1, int n2, int side, int mid,
                    cudaStream_t stream) {
  const dim3 block(kNbY, kNbZ);
  const dim3 grid((n2 + kNbY - 1) / kNbY, (n1 + kNbZ - 1) / kNbZ,
                  (n0 + kNbX - 1) / kNbX);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  flood_neighbor_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(cur), mask, static_cast<T*>(out), n0, n1, n2,
      side, mid);
  return (int)cudaGetLastError();
}

// A line whose blocks fit one thread block's shared memory is staged
// whole; a longer one in chunks of nb blocks and their halo blocks, as
// many blocks as fit, balanced over the chunks.
template <typename T>
int launch_runs(const void* in, const unsigned char* mask, void* out,
                long long lines, int n, long long inner, int radius, int fold,
                cudaStream_t stream) {
  // set once, outside any graph capture (a round's first launch of a
  // key runs before its capture)
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        flood_runs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kRunSmem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int blk = radius + 1;
  const int nblk = (n + blk - 1) / blk;
  int nb, nchunks, nloc, cap;
  if (nblk <= kMaxBlocks && runs_smem<T>(nblk, n) <= kRunSmem) {
    nb = nloc = nblk;
    nchunks = 1;
    cap = n;
  } else {
    int nb_max = kMaxBlocks - 2;
    while (nb_max > 1 && runs_smem<T>(nb_max + 2, (nb_max + 2) * blk) >
                             kRunSmem)
      --nb_max;
    nchunks = (nblk + nb_max - 1) / nb_max;
    nb = (nblk + nchunks - 1) / nchunks;
    nloc = nb + 2;
    cap = nloc * blk;
  }
  const size_t smem = runs_smem<T>(nloc, cap);
  if (smem > kRunSmem) return (int)cudaErrorInvalidValue;
  const long long groups = (lines + kLines - 1) / kLines;
  const long long grid = groups * nchunks;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flood_runs_kernel<T><<<(unsigned)grid, kLines * nloc, smem, stream>>>(
      static_cast<const T*>(in), mask, static_cast<T*>(out), lines, n, inner,
      blk, nb, nchunks, cap, fold);
  return (int)cudaGetLastError();
}

}  // namespace

// The neighbour pass over an (n0, n1, n2) contiguous array of int32
// (elem_bytes 4, min) or bytes (1, OR).
HF_EXPORT int hf_flood_neighbor(const void* cur, const unsigned char* mask,
                                void* out, int elem_bytes, int n0, int n1,
                                int n2, int side, int mid,
                                cudaStream_t stream) {
  if (n0 <= 0 || n1 <= 0 || n2 <= 0 || side < 0 || side > 7 || mid < 0 ||
      mid > 6 || (mid & 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (elem_bytes == 4)
    return launch_neighbor<int>(cur, mask, out, n0, n1, n2, side, mid,
                                stream);
  if (elem_bytes == 1)
    return launch_neighbor<unsigned char>(cur, mask, out, n0, n1, n2, side,
                                          mid, stream);
  return (int)cudaErrorInvalidValue;
}

// The run window of radius 1 <= radius < n along one axis: ``lines`` lines
// of n voxels at stride ``inner``.
HF_EXPORT int hf_flood_runs(const void* in, const unsigned char* mask,
                            void* out, int elem_bytes, long long lines, int n,
                            long long inner, int radius, int fold,
                            cudaStream_t stream) {
  if (lines <= 0 || n <= 1 || inner <= 0 || radius < 1 || radius >= n) {
    return (int)cudaErrorInvalidValue;
  }
  if (elem_bytes == 4)
    return launch_runs<int>(in, mask, out, lines, n, inner, radius, fold,
                            stream);
  if (elem_bytes == 1)
    return launch_runs<unsigned char>(in, mask, out, lines, n, inner, radius,
                                      fold, stream);
  return (int)cudaErrorInvalidValue;
}
