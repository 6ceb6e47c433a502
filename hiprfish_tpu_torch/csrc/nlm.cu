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
//     box filter);
//   * w_o(x) = exp(-max(d2_o(x), 0) / h^2); pixel q takes the +o term
//     w_o(q) * P(q - o) and the mirrored -o term w_o(q + o) * P(q + o);
//   * the self weight is 1 and the output is sum(w P) / max(sum(w), 1e-12).
//
// Bound on the H100: arithmetic and shared-memory traffic, 264 offsets x
// two 7x7 box sums per pixel (~100 B/px of HBM traffic in total, so memory
// is not the limit). Design: one block per 32x32 output tile keeps its
// reflect-padded source window (halo pd+3 rows, 2*pd+3 columns) in shared
// memory and walks all offsets inside the block. Each offset computes the
// squared-difference field on the tile and on the tile shifted by o (each
// with a 3-px box halo), then the box sums separably (columns, then rows).
// Only the rare frame-border reads whose roll wraps to the far side of the
// frame go to global memory. The box sum is a direct 49-term sum, not the
// XLA path's cumulative-sum difference, so the two agree to float32
// rounding amplified by 1/h^2 (tolerance stated in chip_smoke.py).

#include "common.cuh"

namespace {

constexpr int TY = 32;
constexpr int TX = 32;
constexpr int NTX = 32;
constexpr int NTY = 8;

__device__ __forceinline__ int reflect_idx(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i);
}

__device__ __forceinline__ int wrap_idx(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// P at frame coordinate (vr, vc), both inside the frame.
__device__ __forceinline__ float frame_at(const float* __restrict__ img,
                                          int vr, int vc, int h, int w,
                                          int pd) {
  return __ldg(img + (size_t)reflect_idx(vr - pd, h) * w +
               reflect_idx(vc - pd, w));
}

__global__ void __launch_bounds__(NTX * NTY)
nlm_kernel(const float* __restrict__ img, float* __restrict__ out, int h,
           int w, int pd, int patch, float h2) {
  extern __shared__ float smem[];
  const int pr = patch / 2;
  const int hp = h + 2 * pd;
  const int wp = w + 2 * pd;
  const int PR = TY + 2 * (pd + pr);
  const int PC = TX + 2 * (2 * pd + pr);
  const int DR = TY + 2 * pr;
  const int DC = TX + 2 * pr;
  float* ptile = smem;                 // PR x PC
  float* dfield = ptile + PR * PC;     // 2 x DR x DC
  float* vsum = dfield + 2 * DR * DC;  // 2 x TY x DC

  const int tid = threadIdx.y * NTX + threadIdx.x;
  const int nthreads = NTX * NTY;
  const int qr0 = pd + blockIdx.y * TY;  // frame coords of the tile origin
  const int qc0 = pd + blockIdx.x * TX;
  const int wr0 = qr0 - pd - pr;         // frame coords of the window origin
  const int wc0 = qc0 - 2 * pd - pr;

  for (int e = tid; e < PR * PC; e += nthreads) {
    const int vr = wr0 + e / PC;
    const int vc = wc0 + e % PC;
    ptile[e] = (vr >= 0 && vr < hp && vc >= 0 && vc < wp)
                   ? frame_at(img, vr, vc, h, w, pd)
                   : 0.f;
  }
  __syncthreads();

  constexpr int PER = TY / NTY;
  float acc[PER], wacc[PER];
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int i = threadIdx.y + NTY * m;
    acc[m] = ptile[(i + pd + pr) * PC + threadIdx.x + 2 * pd + pr];
    wacc[m] = 1.f;
  }
  // d2 = box_sum / area (a division, as the XLA path computes it)
  const float area = (float)(patch * patch);

  for (int dy = 0; dy <= pd; ++dy) {
    for (int dx = -pd; dx <= pd; ++dx) {
      if (dy == 0 && dx <= 0) continue;
      // Phase 1: squared differences on both regions (tile, tile + o),
      // each with a pr-pixel box halo, at frame-clamped positions.
      for (int e = tid; e < 2 * DR * DC; e += nthreads) {
        const int g = e / (DR * DC);
        const int rem = e - g * DR * DC;
        const int a = rem / DC;
        const int b = rem - a * DC;
        const int rr = hf_clampi(qr0 + g * dy - pr + a, 0, hp - 1);
        const int rc = hf_clampi(qc0 + g * dx - pr + b, 0, wp - 1);
        const float pv = ptile[(rr - wr0) * PC + (rc - wc0)];
        const int sr = rr - dy;
        const int sc = rc - dx;
        float sv;
        if (sr >= 0 && sr < hp && sc >= 0 && sc < wp) {
          sv = ptile[(sr - wr0) * PC + (sc - wc0)];
        } else {
          sv = frame_at(img, wrap_idx(sr, hp), wrap_idx(sc, wp), h, w, pd);
        }
        const float d = pv - sv;
        dfield[e] = d * d;
      }
      __syncthreads();
      // Phase 2: column sums over the patch rows.
      for (int e = tid; e < 2 * TY * DC; e += nthreads) {
        const int g = e / (TY * DC);
        const int rem = e - g * TY * DC;
        const int i = rem / DC;
        const int j = rem - i * DC;
        const float* col = dfield + g * DR * DC + i * DC + j;
        float s = 0.f;
        for (int k = 0; k < patch; ++k) s += col[k * DC];
        vsum[e] = s;
      }
      __syncthreads();
      // Phase 3: row sums -> weights -> accumulate (+o at q, -o from q+o).
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int i = threadIdx.y + NTY * m;
        const int j = threadIdx.x;
        float wgt[2];
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const float* row = vsum + g * TY * DC + i * DC + j;
          float s = 0.f;
          for (int k = 0; k < patch; ++k) s += row[k];
          wgt[g] = expf(-fmaxf(s / area, 0.f) / h2);
        }
        const float p_minus =
            ptile[(i - dy + pd + pr) * PC + (j - dx + 2 * pd + pr)];
        const float p_plus =
            ptile[(i + dy + pd + pr) * PC + (j + dx + 2 * pd + pr)];
        acc[m] = acc[m] + wgt[0] * p_minus;
        wacc[m] = wacc[m] + wgt[0];
        acc[m] = acc[m] + wgt[1] * p_plus;
        wacc[m] = wacc[m] + wgt[1];
      }
      // vsum is rewritten only after the next phase-1 barrier.
    }
  }

#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int oi = qr0 - pd + threadIdx.y + NTY * m;
    const int oj = qc0 - pd + threadIdx.x;
    if (oi < h && oj < w) {
      out[(size_t)oi * w + oj] = acc[m] / fmaxf(wacc[m], 1e-12f);
    }
  }
}

}  // namespace

// Dynamic shared memory of one block for (pd, patch): 41 KB at (11, 7).
static int nlm_smem_bytes(int pd, int patch) {
  const int pr = patch / 2;
  const int PR = TY + 2 * (pd + pr);
  const int PC = TX + 2 * (2 * pd + pr);
  const int DR = TY + 2 * pr;
  const int DC = TX + 2 * pr;
  return (int)sizeof(float) * (PR * PC + 2 * DR * DC + 2 * TY * DC);
}

HF_EXPORT int hf_nlm_f32(const float* img, float* out, int h, int w, int pd,
                         int patch, float h2, cudaStream_t stream) {
  const int smem = nlm_smem_bytes(pd, patch);
  cudaError_t err = cudaFuncSetAttribute(
      nlm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 block(NTX, NTY);
  dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY);
  nlm_kernel<<<grid, block, smem, stream>>>(img, out, h, w, pd, patch, h2);
  return (int)cudaGetLastError();
}
