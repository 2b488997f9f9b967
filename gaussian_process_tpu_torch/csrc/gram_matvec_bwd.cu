// K4's full backward sweep: its staging pass, its launcher and its
// interpreted instantiations. The kernel, its bound and its design are in
// gram_matvec_bwd.cuh; the compiled leaves' instantiations are in
// gram_matvec_bwd_rbf.cu and gram_matvec_bwd_matern{12,32,52}.cu.

#include "gram_matvec_bwd.cuh"

namespace {

// x's width in registers: X_SLICED for the sliced layout; else 4 for a
// compiled leaf at d <= 4 (0 above: no such instantiation), 0 (a loop over
// d, x2 staged at width d) for the interpreter.
int bf_x_width(int leaf, int d, int sliced) {
  return sliced ? X_SLICED : leaf != 0 && d <= 4 ? 4 : 0;
}

bool bf_width_ok(int mma, int width) {
  if (mma) return width == 8 || width == 16 || width == 24 || width == 32 || width == 48 ||
                  width == 72;
  return width == 1 || width == 2 || width == 4;
}

BwdFullFn bf_route(const BwdFullPlan& p) {
  if (p.D == X_SLICED) {
    switch (p.leaf) {
      case 0: return gm_bwd_full_pick_sliced(p);
      case OP_RBF: return gm_bwd_full_pick_sliced_rbf(p);
      default: return gm_bwd_full_pick_sliced_matern(p);
    }
  }
  switch (p.leaf) {
    case 0: return bf_pick<0>(p);
    case OP_RBF: return gm_bwd_full_pick_rbf(p);
    case OP_MATERN12: return gm_bwd_full_pick_matern12(p);
    case OP_MATERN32: return gm_bwd_full_pick_matern32(p);
    case OP_MATERN52: return gm_bwd_full_pick_matern52(p);
    default: return nullptr;
  }
}

// The staging pass: x2s (m_pad x dx) = x2 times the compiled leaf's x scale,
// zero past m and past d; vs = V's columns of each pass, zero past m and
// past r: on the MMA route split into TF32 hi and lo in the sweep's
// B-fragment order (per pass p, 8-row tile jt of x2, k-step s and lane l,
// the float4 hi(c), hi(c + 4), lo(c), lo(c + 4) of row 8 jt + l / 4 and
// column p width + 8 s + l % 4), else rows of width floats.
__global__ void __launch_bounds__(THREADS)
    bwd_full_stage_kernel(const float* __restrict__ x2, const float* __restrict__ v,
                          const int* __restrict__ prog, const float* __restrict__ coef, int leaf,
                          float* __restrict__ x2s, float* __restrict__ vs, int m, int m_pad,
                          int d, int dx, int r, int mma, int width, int passes) {
  float xs = 1.0f;  // the compiled leaf's x scale, as the sweep's leaf_scales
  if (leaf == OP_RBF)
    xs = leaf_x_scale<OP_RBF>(coef[prog[1] + 1]);
  else if (leaf != 0)  // every Matern scales x by its c1
    xs = leaf_x_scale<OP_MATERN12>(coef[prog[1] + 1]);
  const size_t step = (size_t)gridDim.x * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (size_t e = first; e < (size_t)m_pad * dx; e += step) {
    const int row = (int)(e / dx), k = (int)(e % dx);
    x2s[e] = (row < m && k < d) ? xs * x2[(size_t)row * d + k] : 0.0f;
  }
  if (mma) {
    const int ks = width / 8;
    const size_t tiles = (size_t)m_pad / 8;
    float4* out = reinterpret_cast<float4*>(vs);
    for (size_t e = first; e < (size_t)passes * tiles * ks * 32; e += step) {
      const int lane = (int)(e % 32);
      size_t f = e / 32;
      const int s = (int)(f % ks);
      f /= ks;
      const size_t jt = f % tiles;
      const int p = (int)(f / tiles);
      const size_t row = 8 * jt + lane / 4;
      const int col = p * width + 8 * s + lane % 4;
      unsigned hl[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float val = (row < (size_t)m && col + 4 * h < r) ? v[row * r + col + 4 * h] : 0.0f;
        tf32_split(val, hl[h], hl[2 + h]);
      }
      out[e] = make_float4(__uint_as_float(hl[0]), __uint_as_float(hl[1]),
                           __uint_as_float(hl[2]), __uint_as_float(hl[3]));
    }
  } else {
    for (size_t e = first; e < (size_t)passes * m_pad * width; e += step) {
      const int c = (int)(e % width);
      const size_t row = (e / width) % m_pad;
      const int col = (int)(e / ((size_t)width * m_pad)) * width + c;
      vs[e] = (row < (size_t)m && col < r) ? v[row * r + col] : 0.0f;
    }
  }
}

}  // namespace

extern "C" {

// The width of the sweep's staged x2 (the caller's x2s scratch is m_pad rows
// of it, and in the sliced layout its x1s scratch is n rounded up to 128
// rows of it) on a route (leaf: 0 for the interpreter, else the compiled
// leaf's opcode) at d, in the sliced layout (sliced = 1) or not.
int gm_bwd_full_x_width(int leaf, int d, int sliced) {
  const int D = bf_x_width(leaf, d, sliced);
  return D > 0 ? D : D == 0 ? d : slice_width(d);
}

// The blocks of a plan's instantiation that the card holds at once, or a
// negative cudaError_t. The wrapper splits the x2 stages by it
// (kernel_ops.bwd_full_split).
int gm_bwd_full_resident(int leaf, int mma, int width, int d, int want_dx, int sliced) {
  const BwdFullPlan p{leaf, mma, width, bf_x_width(leaf, d, sliced), want_dx};
  const BwdFullFn fn = bf_width_ok(mma, width) ? bf_route(p) : nullptr;
  if (fn == nullptr || d < 1) return -(int)cudaErrorInvalidValue;
  BwdFullArgs a{};
  a.d = d;
  int resident = 0;
  const cudaError_t err = fn(a, dim3(1), nullptr, &resident);
  return err == cudaSuccess ? resident : -(int)err;
}

// For L = <ct, K(x1, x2) v>: part ((passes x splits x ceil(n / 128)) x sums,
// float64) receives one partial per pass, split, 128-row block and sum (the
// caller sums them): S0 and S1 of gram_matvec_bwd.cuh for a compiled leaf
// (leaf = its opcode, RBF or a Matern), dL/dcoef_k for k < MAX_BWD_COEF for
// the postfix interpreter (leaf = 0; rows past n_coef are zero); pdx
// ((passes x splits) x n x d fp32), when want_dx != 0, one partial of
// dL/dx1 per pass and split before its scale (kernel_ops.
// gram_bwd_dx_scale). mma and width: the pass (kernel_ops.bwd_full_passes);
// splits: the x2 stages' split (kernel_ops.bwd_full_split), at most
// m_pad / 64. x1 (n x d), x2 (m x d), v (m x r), ct (n x r): contiguous fp32
// on the device. sliced: 1 for the sliced layout (any d), 0 for x2 staged
// at full width (a compiled leaf at d <= 4, the interpreter). Scratch from the caller: x2s (m_pad x gm_bwd_full_x_width
// floats), vs (passes x m_pad x width floats, twice that with mma), m_pad
// = m rounded up to a multiple of 64, and with sliced x1s (n rounded up to
// 128 rows x gm_bwd_full_x_width floats), else null. Two launches, three
// when sliced: the staging pass (and x1's prescaled copy), then the sweep.
// Returns the first launch error, else cudaGetLastError().
int gm_matvec_bwd(const float* x1, const float* x2, const float* v, const float* ct,
                  float* x1s, float* x2s, float* vs, double* part, float* pdx, const int* prog,
                  int n_instr, const float* coef, int n_coef, int leaf, int mma, int width,
                  int passes, int splits, int n, int m, int m_pad, int d, int r, int need_l2,
                  int want_dx, int sliced, void* stream) {
  if (n_instr < 1 || n_instr > MAX_BWD_INSTR || n_coef < 1 || n_coef > MAX_BWD_COEF ||
      n < 1 || m < 1 || d < 1 || r < 1 || passes < 1 || passes > 65535 || splits < 1 ||
      m_pad < m || m_pad % BF_STAGE != 0 || splits > m_pad / BF_STAGE ||
      (long long)passes * width < r || !bf_width_ok(mma, width) ||
      (leaf != 0 && n_instr != 1) || (want_dx != 0) != (pdx != nullptr) ||
      (sliced != 0) != (x1s != nullptr))
    return (int)cudaErrorInvalidValue;
  const int D = bf_x_width(leaf, d, sliced), dx = gm_bwd_full_x_width(leaf, d, sliced);
  const BwdFullFn fn = bf_route(BwdFullPlan{leaf, mma, width, D, want_dx});
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sliced) {
    const cudaError_t e = prescale_rows(x1, prog, coef, leaf, x1s, n,
                                        (n + BF_ROWS - 1) / BF_ROWS * BF_ROWS, d, st);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t items = (size_t)passes * m_pad * width * (mma ? 2 : 1) / (mma ? 4 : 1);
  const size_t want = (items + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(want < 132 * 8 ? (want > 0 ? want : 1) : 132 * 8);
  bwd_full_stage_kernel<<<blocks, THREADS, 0, st>>>(x2, v, prog, coef, leaf, x2s, vs, m, m_pad,
                                                    d, dx, r, mma, width, passes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const BwdFullArgs a{sliced ? x1s : x1, x2s, vs, ct, part, pdx, prog, n_instr, coef, n_coef,
                      n, m_pad, d, dx, r, need_l2};
  const dim3 grid((unsigned)((n + BF_ROWS - 1) / BF_ROWS), (unsigned)splits, (unsigned)passes);
  return (int)fn(a, grid, st, nullptr);
}

}  // extern "C"
