// K2, the full sweep out = K(x1, x2) @ V for NVIDIA Hopper (sm_90a), without
// ever materialising K: gm_matvec_full_tc, which replaces _matvec_fwd_impl of
// the JAX package's ops/pallas/kernel_ops.py (:303). The JAX kernel has two
// output products under the caller's dot_mode: "split3", a 3-pass bf16
// split product on the MXU that stops at about 1.5e-5, and "highest", full
// fp32. Here both modes take one product, 3xTF32 on the tensor cores, which
// is within a few 1e-6 of float64 at n = 102400: more precise than fp32
// FMAs over the same sweep, so "highest" needs no route of its own. This
// file holds the staging pass and the launcher; the sweep, its bound and
// its design are in gram_matvec_full.cuh. The same-set sweep K3
// (_matvec_fwd_sym_impl) is gram_matvec_sym.cu.

#include "gram_matvec_full.cuh"

namespace {

// The sweep's x width: X_SLICED for the sliced layout; else d padded to 4
// or 8 in registers for a compiled leaf (0 past d = 8: no such
// instantiation), 0 (a loop over d, x2 staged at width d) for the
// interpreter.
int full_x_width(int leaf, int d, int sliced) {
  if (sliced) return X_SLICED;
  if (leaf == 0) return 0;
  return d <= 4 ? 4 : d <= 8 ? 8 : 0;
}

// The staging pass of the sweep: x2s (m_pad x dx) = x2 times the
// compiled leaf's x scale, zero past m and past d; vf = V split into TF32
// hi and lo in the B-fragment order of the sweep (gram_matvec_full.cuh):
// for pass p, k-step s, 8-column tile j and lane l, the float4
// (hi(k), hi(k + 4), lo(k), lo(k + 4)) of row k = 8 s + l % 4 and column
// p 8 nt + 8 j + l / 4, zero past m and past r (tf32_split: lo is 0 where
// hi is infinite, so an infinite V entry stays infinite rather than NaN).
__global__ void __launch_bounds__(THREADS)
    full_stage_kernel(const float* __restrict__ x2, const float* __restrict__ v,
                      const int* __restrict__ prog, const float* __restrict__ coef, int leaf,
                      float* __restrict__ x2s, float4* __restrict__ vf, int m, int m_pad, int d,
                      int dx, int r, int nt, int passes) {
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
  const size_t steps = (size_t)m_pad / 8;
  for (size_t e = first; e < (size_t)passes * steps * nt * 32; e += step) {
    const int lane = (int)(e % 32);
    size_t f = e / 32;
    const int j = (int)(f % nt);
    f /= nt;
    const int s = (int)(f % steps), p = (int)(f / steps);
    const int k = 8 * s + (lane & 3), col = 8 * (p * nt + j) + (lane >> 2);
    float hl[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = k + 4 * h;
      const float val = (row < m && col < r) ? v[(size_t)row * r + col] : 0.0f;
      unsigned hi, lo;
      tf32_split(val, hi, lo);
      hl[h] = __uint_as_float(hi);
      hl[2 + h] = __uint_as_float(lo);
    }
    vf[e] = make_float4(hl[0], hl[1], hl[2], hl[3]);
  }
}

}  // namespace

extern "C" {

// The width of the sweep's staged x2 (the caller's x2s scratch is m_pad
// rows of it, and in the sliced layout its x1s scratch n rounded up to 128
// rows of it) on a route (leaf as in gm_matvec_full_tc) at d, in the sliced
// layout (sliced = 1) or not.
int gm_full_tc_x_width(int leaf, int d, int sliced) {
  const int D = full_x_width(leaf, d, sliced);
  return D > 0 ? D : D == 0 ? d : slice_width(d);
}

// out (n x r) = K(x1, x2) @ v by K2 under both dot_modes; x1 (n x d), x2 (m x d),
// v (m x r), all contiguous fp32 on the device. leaf: 0 for the postfix
// interpreter, else the opcode of the tree's one leaf (RBF or a Matern);
// passes of nt tiles of 8 columns (kernel_ops.full_passes); sliced: 1 for
// the sliced layout (any d), 0 for x at full width (a compiled leaf at
// d <= 8, the interpreter); all chosen by the wrapper. Scratch from the
// caller: x2s (m_pad x gm_full_tc_x_width floats), vf (passes x m_pad x
// 16 nt floats), m_pad = m rounded up to a multiple of 64, and when sliced
// x1s (n rounded up to 128 rows x gm_full_tc_x_width floats), else null.
// Two launches, three sliced: x1's prescaled copy, the staging pass, then
// the sweep. Returns the first launch error, else cudaGetLastError().
int gm_matvec_full_tc(const float* x1, const float* x2, const float* v, float* out,
                      float* x1s, float* x2s, float* vf, const int* prog, int n_instr,
                      const float* coef, int n_coef, int leaf, int passes, int nt, int n, int m,
                      int m_pad, int d, int r, int need_l2, int sliced, void* stream) {
  const int D = full_x_width(leaf, d, sliced), dx = gm_full_tc_x_width(leaf, d, sliced);
  if (bad_program(n_instr, n_coef) || n < 1 || m < 1 || d < 1 || r < 1 || passes < 1 ||
      nt < 1 || nt > 16 || passes * nt * 8 < r || m_pad < m || m_pad % FULL_M_ALIGN != 0 ||
      (leaf != 0 && n_instr != 1) || (sliced != 0) != (x1s != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sliced) {
    const cudaError_t e = prescale_rows(x1, prog, coef, leaf, x1s, n,
                                        (n + FULL_ROWS - 1) / FULL_ROWS * FULL_ROWS, d, st);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t quads = (size_t)passes * (m_pad / 8) * nt * 32;
  const size_t want = (quads + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(want < 132 * 8 ? want : 132 * 8);
  full_stage_kernel<<<blocks, THREADS, 0, st>>>(x2, v, prog, coef, leaf, x2s,
                                                reinterpret_cast<float4*>(vf), m, m_pad, d,
                                                dx, r, nt, passes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const FullArgs a{sliced ? x1s : x1, x2s, vf, out, prog, n_instr, coef, n_coef, n, m_pad, d,
                   dx, r, nt, need_l2};
  if (sliced) return (int)gm_full_launch_sliced(a, leaf, passes, st);
  switch (leaf) {
    case 0:
      err = full_launch_d<0, 0>(a, passes, st);
      break;
    case OP_RBF:
      err = full_launch_leaf<OP_RBF>(a, passes, D, st);
      break;
    case OP_MATERN12:
    case OP_MATERN32:
    case OP_MATERN52:
      err = gm_full_launch_matern(a, leaf, passes, D, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
