// Fast-mode non-local means of an (H, W) float32 image.
//
// Replaces the TPU kernel hiprfish_tpu/ops/nlm_pallas.py::
// denoise_nl_means_pallas (body _nlm_kernel_groups). Its semantics are those
// of the XLA formulation hiprfish_tpu/ops/denoise.py::denoise_nl_means over
// the whole frame, border included:
//   * P is the image reflect-padded by pd (frame Hp x Wp);
//   * for each half-window offset o = (dy, dx) > (0, 0), in the XLA scan's
//     order, D_o(r) = (P(r) - P(wrap(r - o)))^2 where wrap is the roll
//     wrap-around inside the frame, and d2_o(x) is the 7x7 box mean of D_o
//     over frame positions clamped to the frame (the edge padding of the
//     box filter), the box sum divided by the area;
//   * w_o(x) = exp(-max(d2_o(x), 0) / h^2); pixel q takes the +o term
//     w_o(q) * P(q - o) and the mirrored -o term w_o(q + o) * P(q + o);
//   * the self weight is 1 and the output is sum(w P) / max(sum(w), 1e-12).
//
// Bound on the H100: operations. Per pixel and offset: the squared
// difference (2), the box sum as running column and row sums (4), the
// weight (clamp, multiply by the folded constant below, exp2: 3) and two
// accumulations (3 each): 15 ops, 1.58e10 for a 2000^2 image with pd = 11
// (264 offsets), 0.236 ms at 67 TFLOP/s; HBM traffic is one read and one
// write per pixel (32 MB).
// Design, for one block per 64 x 64 output tile (8 warps) when
// pd + patch / 2 <= 16, as on the main path, else per 32 x 32 tile (up to
// pd + patch / 2 <= 72, so that the block fits in shared memory):
//   * the block's window of P (the tile grown by pd + patch / 2 on every
//     side) lives in shared memory; its positions outside the frame hold
//     the roll's wrapped values, so the frame-border wrap reads need no
//     global load and no branch;
//   * one weight field per offset: w_o is computed once over the union of
//     the tile and the tile shifted by o ((64 + dy) x (64 + |dx|)), and the
//     -o term at q reads w_o(q + o) from it;
//   * box sums as sliding sums: each warp owns a band of at most
//     ceil((64 + pd) / 8) = 10 rows of that field (13 for the 32 x 32 tile
//     at pd = 72), and each lane 3 (6) adjacent columns; the lane keeps
//     their running 7-row column sums in registers (restarted by a direct
//     sum at the band's top, so a running sum spans at most one band) and
//     takes the 7-column row sums from one warp-private shared row, one
//     direct sum then sliding over its columns. Window and field rows have
//     compile-time strides (a template on the geometry), so a row step is
//     a pointer step and every load an immediate offset; no integer
//     divide, mod or clamp in the inner loops: rows and columns are clamped
//     to the frame only in blocks whose field reaches the frame's edge (a
//     block-uniform branch);
//   * the weight is exp2(-max(box sum, 0) * log2(e) / (area * h^2)): one
//     multiply and one exp2 in place of two IEEE divisions and expf;
//   * one block barrier per offset: the weight field is double-buffered,
//     and the band's rows need only __syncwarp.
// The running sums and the folded constant round differently from the XLA
// path's cumulative-sum differences and divisions, amplified by 1/h^2
// (tolerance stated in chip_smoke.py).

#include "common.cuh"

namespace {

constexpr int NWARP = 8;
constexpr int NT = 32 * NWARP;

// Block geometry for T x T output tiles and pd + patch / 2 <= P.
template <int T, int P>
struct Geom {
  static constexpr int TH = T;           // output tile rows
  static constexpr int TW = T;           // output tile columns
  static constexpr int PMAX = P;         // largest pd + patch / 2 it takes
  static constexpr int OR = TH / NWARP;  // output rows per thread
  static constexpr int OC = TW / 32;     // output columns per thread
  static constexpr int WW = TW + 2 * P;  // window row stride
  static constexpr int WS = TW + P;      // weight-field row stride and rows
  // adjacent field columns per lane: a row of column sums per warp
  static constexpr int KV = (TW + 2 * P + 31) / 32;
  static_assert(TH % NWARP == 0 && TW % 32 == 0, "tile");
};
// pd + patch / 2 <= 16 (the main path's 11 + 3): 89,600 B of shared memory
// at (11, 7), two blocks per SM. Up to 72, 32 x 32 tiles keep the block
// within 227 KB (216,576 B at 72).
using GeomSmall = Geom<64, 16>;
using GeomLarge = Geom<32, 72>;

__device__ __forceinline__ int reflect_idx(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i);
}

__device__ __forceinline__ int mod_idx(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

struct Field {
  const float* win;  // window of P; (0, 0) at frame (qr0 - pd - pr, wc0)
  float* wf;         // weight field; (0, 0) at frame (qr0, qc0 + cm)
  float* vrow;       // this warp's row of column sums
  int doff;          // window index offset of o
  int pr, patch;
  float k2;          // log2(e) / (area * h^2)
};

// Weights of field row i from the warp's row of column sums: lane l owns
// columns KV * l + k < nw; one direct row sum, then sliding.
template <class G>
__device__ __forceinline__ void row_weights(const Field& f, int lane, int i,
                                            int nw) {
  constexpr int KV = G::KV, WS = G::WS;
  if (KV * lane >= nw) return;
  const float* vs = f.vrow + KV * lane;
  float* wout = f.wf + i * WS + KV * lane;
  float s = 0.f;
#pragma unroll 7
  for (int b = 0; b < f.patch; ++b) s += vs[b];
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    if (KV * lane + k >= nw) break;
    if (k > 0) s = s + vs[k - 1 + f.patch] - vs[k - 1];
    wout[k] = exp2f(-fmaxf(s, 0.f) * f.k2);
  }
}

// Rows [ra, rb) of the weight field of one offset, by one warp, in a block
// whose field stays inside the frame: lane l's column sums are the KV
// adjacent window columns from `c0` + KV * l, and each row's entering and
// leaving rows are a constant stride on.
template <class G>
__device__ __forceinline__ void weight_rows(const Field& f, int lane, int ra,
                                            int rb, int c0, int pd, int nv,
                                            int nw) {
  constexpr int KV = G::KV, WW = G::WW;
  const bool vlane = KV * lane < nv;
  // window row of field row i: i + pd + pr
  const float* p0 = f.win + (ra + pd) * WW + c0 + KV * lane;
  float v[KV];
#pragma unroll
  for (int k = 0; k < KV; ++k) v[k] = 0.f;
  if (vlane) {
    for (int a = 0; a < f.patch; ++a) {
      const float* p = p0 + a * WW;
#pragma unroll
      for (int k = 0; k < KV; ++k) {
        const float d = p[k] - p[k - f.doff];
        v[k] += d * d;
      }
    }
  }
  const float* pin = p0 + f.patch * WW;  // entering row of field row ra + 1
  const int span = f.patch * WW;         // leaving row = entering - span
  for (int i = ra; i < rb; ++i) {
    if (vlane) {
      if (i > ra) {
        const float* pout = pin - span;
#pragma unroll
        for (int k = 0; k < KV; ++k) {
          const float d_in = pin[k] - pin[k - f.doff];
          const float d_out = pout[k] - pout[k - f.doff];
          v[k] = v[k] + d_in * d_in - d_out * d_out;
        }
        pin += WW;
      }
#pragma unroll
      for (int k = 0; k < KV; ++k) f.vrow[KV * lane + k] = v[k];
    }
    __syncwarp();
    row_weights<G>(f, lane, i, nw);
    __syncwarp();
  }
}

// The same for a block whose field reaches the frame's edge: rows and
// columns are clamped to the frame (the box filter's edge padding).
template <class G>
__device__ __forceinline__ void weight_rows_edge(const Field& f, int lane,
                                                 int ra, int rb, int qr0,
                                                 int qc0, int cm, int pd,
                                                 int hp, int wp, int nv,
                                                 int nw) {
  constexpr int KV = G::KV, WW = G::WW;
  const int wc0 = qc0 - pd - f.pr;
  int col[KV];
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const int s = min(KV * lane + k, nv - 1);
    col[k] = hf_clampi(qc0 + cm - f.pr + s, 0, wp - 1) - wc0;
  }
  // window row of frame row qr0 + i, clamped to the frame
  auto wrow = [&](int i) {
    return hf_clampi(qr0 + i, 0, hp - 1) - (qr0 - pd - f.pr);
  };
  auto dsq = [&](int row, int c) {
    const float* p = f.win + row * WW + c;
    const float d = p[0] - p[-f.doff];
    return d * d;
  };
  const bool vlane = KV * lane < nv;
  float v[KV];
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    v[k] = 0.f;
    if (vlane) {
      for (int a = -f.pr; a <= f.pr; ++a) v[k] += dsq(wrow(ra + a), col[k]);
    }
  }
  for (int i = ra; i < rb; ++i) {
    if (vlane) {
      if (i > ra) {
        const int rin = wrow(i + f.pr);
        const int rout = wrow(i - 1 - f.pr);
#pragma unroll
        for (int k = 0; k < KV; ++k) {
          v[k] = v[k] + dsq(rin, col[k]) - dsq(rout, col[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < KV; ++k) f.vrow[KV * lane + k] = v[k];
    }
    __syncwarp();
    row_weights<G>(f, lane, i, nw);
    __syncwarp();
  }
}

template <class G>
__global__ void __launch_bounds__(NT, 2)
nlm_kernel(const float* __restrict__ img, float* __restrict__ out, int h,
           int w, int pd, int patch, float k2) {
  constexpr int TH = G::TH, TW = G::TW, OR = G::OR, OC = G::OC;
  constexpr int WW = G::WW, WS = G::WS, KV = G::KV;
  extern __shared__ float smem[];
  const int pr = patch / 2;
  const int hp = h + 2 * pd;
  const int wp = w + 2 * pd;
  const int WH = TH + 2 * (pd + pr);  // window rows
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* win = smem;                  // WH x WW
  float* wbuf = win + WH * WW;        // 2 x WS x WS
  float* vrow = wbuf + 2 * WS * WS + warp * 32 * KV;

  const int qr0 = pd + blockIdx.y * TH;  // frame coords of the tile origin
  const int qc0 = pd + blockIdx.x * TW;
  const int wr0 = qr0 - pd - pr;         // frame coords of the window origin
  const int wc0 = qc0 - pd - pr;
  // The window; its positions outside the frame hold P at the wrapped
  // position (only the D field's P(r - o) term reads them).
  for (int e = threadIdx.x; e < WH * WW; e += NT) {
    const int a = e / WW;
    const int b = e - a * WW;
    const int vr = mod_idx(wr0 + a, hp);
    const int vc = mod_idx(wc0 + b, wp);
    win[e] = __ldg(img + (size_t)reflect_idx(vr - pd, h) * w +
                   reflect_idx(vc - pd, w));
  }
  __syncthreads();

  // window index of this thread's first output pixel (row warp, col lane)
  const int q0 = (warp + pd + pr) * WW + lane + pd + pr;
  float acc[OR][OC], wacc[OR][OC];
#pragma unroll
  for (int m = 0; m < OR; ++m) {
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      acc[m][c] = win[q0 + NWARP * m * WW + 32 * c];
      wacc[m][c] = 1.f;
    }
  }

  Field f;
  f.win = win;
  f.vrow = vrow;
  f.pr = pr;
  f.patch = patch;
  f.k2 = k2;
  // does the field of some offset reach rows or columns outside the frame
  // (frame rows qr0 - pr .. qr0 + TH + pd + pr - 1, columns
  // qc0 - pd - pr .. qc0 + TW + pd + pr - 1)?
  const bool edge = qr0 - pr < 0 || qr0 + TH + pd + pr > hp ||
                    qc0 - pd - pr < 0 || qc0 + TW + pd + pr > wp;
  int parity = 0;
  for (int dy = 0; dy <= pd; ++dy) {
    for (int dx = -pd; dx <= pd; ++dx) {
      if (dy == 0 && dx <= 0) continue;
      const int cm = min(dx, 0);  // field column origin: frame qc0 + cm
      const int nrow = TH + dy;
      const int nw = TW + abs(dx);
      const int nv = nw + 2 * pr;
      f.wf = wbuf + parity * WS * WS;
      parity ^= 1;
      f.doff = dy * WW + dx;
      // phase A: this warp's band of the weight field
      const int band = (nrow + NWARP - 1) / NWARP;
      const int ra = warp * band;
      const int rb = min(nrow, ra + band);
      if (edge) {
        weight_rows_edge<G>(f, lane, ra, rb, qr0, qc0, cm, pd, hp, wp, nv, nw);
      } else {
        // window column of field column sum 0: frame qc0 + cm - pr
        weight_rows<G>(f, lane, ra, rb, cm + pd, pd, nv, nw);
      }
      __syncthreads();
      // phase B: +o term at q, -o term from q + o
      const float* wq = f.wf + warp * WS + lane - cm;
      const float* wqo = wq + dy * WS + dx;
      const float* pm = win + q0 - f.doff;
      const float* pp = win + q0 + f.doff;
#pragma unroll
      for (int m = 0; m < OR; ++m) {
#pragma unroll
        for (int c = 0; c < OC; ++c) {
          const int fo = NWARP * m * WS + 32 * c;
          const int po = NWARP * m * WW + 32 * c;
          const float w_plus = wq[fo];
          const float w_minus = wqo[fo];
          acc[m][c] = acc[m][c] + w_plus * pm[po];
          wacc[m][c] = wacc[m][c] + w_plus;
          acc[m][c] = acc[m][c] + w_minus * pp[po];
          wacc[m][c] = wacc[m][c] + w_minus;
        }
      }
      // the next offset writes the other buffer; the one after it writes
      // this one only after the next barrier
    }
  }

#pragma unroll
  for (int m = 0; m < OR; ++m) {
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int oi = qr0 - pd + warp + NWARP * m;
      const int oj = qc0 - pd + lane + 32 * c;
      if (oi < h && oj < w) {
        out[(size_t)oi * w + oj] = acc[m][c] / fmaxf(wacc[m][c], 1e-12f);
      }
    }
  }
}

// Dynamic shared memory of one block for (pd, patch): 89,600 B at (11, 7).
template <class G>
int nlm_smem_bytes(int pd, int patch) {
  const int WH = G::TH + 2 * (pd + patch / 2);
  return (int)sizeof(float) *
         (WH * G::WW + 2 * G::WS * G::WS + NWARP * 32 * G::KV);
}

template <class G>
int nlm_launch(const float* img, float* out, int h, int w, int pd, int patch,
               float k2, cudaStream_t stream) {
  const int smem = nlm_smem_bytes<G>(pd, patch);
  cudaError_t err = cudaFuncSetAttribute(
      nlm_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + G::TW - 1) / G::TW, (h + G::TH - 1) / G::TH);
  nlm_kernel<G><<<grid, NT, smem, stream>>>(img, out, h, w, pd, patch, k2);
  return (int)cudaGetLastError();
}

}  // namespace

HF_EXPORT int hf_nlm_f32(const float* img, float* out, int h, int w, int pd,
                         int patch, float h2, cudaStream_t stream) {
  // the window, the weight field and a row of column sums are sized for
  // pd + patch / 2 <= GeomLarge::PMAX
  if (pd <= 0 || patch <= 0 || patch % 2 == 0 || pd >= h || pd >= w ||
      pd + patch / 2 > GeomLarge::PMAX) {
    return (int)cudaErrorInvalidValue;
  }
  // exp(-d2 / h^2) = exp2(-box_sum * log2(e) / (area * h^2))
  const float k2 =
      (float)(1.4426950408889634 / ((double)patch * patch * (double)h2));
  return pd + patch / 2 <= GeomSmall::PMAX
             ? nlm_launch<GeomSmall>(img, out, h, w, pd, patch, k2, stream)
             : nlm_launch<GeomLarge>(img, out, h, w, pd, patch, k2, stream);
}
