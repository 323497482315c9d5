// Flash-attention dQ for Hopper (sm_90a): dq_kernel.
//
// Replaces the Pallas TPU kernel _dq_kernel of
// ray_tpu/ops/flash_attention.py:174 (pallas_call :258 in _flash_backward).
//
// What bounds it on an H100: at the GPT-2 pretraining shape (B*H = 192,
// T = 1024, causal) a call does ~39 GFLOP of bf16 products (~39 us at
// 989 TFLOP/s) against ~127 MB of bytes: it is bound by the tensor cores.
// What the design does about it: the [T, T] score and probability
// matrices never reach HBM; each block keeps a 64-row slice of them in
// registers and feeds it straight back into the next product (the C
// fragment of one mma.sync is the A fragment of the next).
//
// Design (the first, simple version; the forward and dK/dV kernels have
// moved to wgmma and TMA, this one follows):
//   - mma.sync.m16n8k16 bf16 -> fp32 on 16-row warp slices, 4 warps per
//     block, 64 x 64 tiles staged through shared memory with 144-byte
//     rows so every fragment load is free of bank conflicts.
//   - One block per (b*h, q tile) loops over kv tiles up to the diagonal;
//     no carry between blocks and no atomics.
//   - The recurrence and casts follow the Pallas kernel: scores in fp32
//     scaled after the product, masked to -1e30, dS cast to bf16 before
//     its product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int TILE = 64;     // rows of every q and kv tile
constexpr int WARPS = 4;     // each warp owns 16 rows of the block's tile
constexpr int THREADS = 32 * WARPS;
constexpr int LDS = D + 8;   // shared-memory row stride in bf16 elements

struct BwdArgs {
  const uint16_t *q, *k, *v, *dout;
  const float *lse, *delta;
  uint16_t *grad;            // dQ
  View vq, vk, vv, vdo, vg;
  int H, T, causal;
  float scale;
};

__device__ __forceinline__ const uint16_t *head(const uint16_t *p, View v,
                                                int bh, int H) {
  return p + head_offset(v, bh, H);
}

// Rows [row0, row0 + TILE) of one head -> row-major shared tile.
__device__ __forceinline__ void load_tile(uint16_t *s, const uint16_t *g,
                                          long long st, int row0) {
  for (int c = threadIdx.x; c < TILE * (D / 8); c += THREADS) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    *reinterpret_cast<uint4 *>(s + r * LDS + col) =
        *reinterpret_cast<const uint4 *>(g + (long long)(row0 + r) * st + col);
  }
}

// Elements (r, c) and (r, c + 1) of a shared tile, packed low-first.
__device__ __forceinline__ uint32_t ld_pair(const uint16_t *s, int r, int c) {
  return *reinterpret_cast<const uint32_t *>(s + r * LDS + c);
}

// Elements (r, c) and (r + 1, c) of a shared tile, packed low-first.
__device__ __forceinline__ uint32_t ld_col_pair(const uint16_t *s, int r,
                                                int c) {
  return (uint32_t)s[r * LDS + c] | ((uint32_t)s[(r + 1) * LDS + c] << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t *>(&v);
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of rows m0..m0+15 (all 64 columns, 4 k-steps) of a shared
// tile.  Lane (g = lane / 4, t = lane % 4) holds rows g and g + 8.
__device__ __forceinline__ void load_a(uint32_t a[4][4], const uint16_t *s,
                                       int m0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = ld_pair(s, m0 + g, kk * 16 + 2 * t);
    a[kk][1] = ld_pair(s, m0 + g + 8, kk * 16 + 2 * t);
    a[kk][2] = ld_pair(s, m0 + g, kk * 16 + 8 + 2 * t);
    a[kk][3] = ld_pair(s, m0 + g + 8, kk * 16 + 8 + 2 * t);
  }
}

// c (16 x 64) += a (16 x 64) * X^T, X a row-major [64 n][64 k] shared tile.
__device__ __forceinline__ void mm_abt(float c[8][4], const uint32_t a[4][4],
                                       const uint16_t *x, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma(c[nt], a[kk], ld_pair(x, nt * 8 + g, kk * 16 + 2 * t),
          ld_pair(x, nt * 8 + g, kk * 16 + 8 + 2 * t));
}

// c (16 x 64) += a (16 x 64) * X, X a row-major [64 k][64 n] shared tile.
__device__ __forceinline__ void mm_ab(float c[8][4], const uint32_t a[4][4],
                                      const uint16_t *x, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma(c[nt], a[kk], ld_col_pair(x, kk * 16 + 2 * t, nt * 8 + g),
          ld_col_pair(x, kk * 16 + 8 + 2 * t, nt * 8 + g));
}

// fp32 C fragments of a 16 x 64 tile -> bf16 A fragments of the same
// tile as the left operand of the next product.
__device__ __forceinline__ void c_to_a(uint32_t a[4][4], const float c[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ void zero(float c[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
}

// Row (within the 64-row tile) and column (within the 64-column tile) of
// element e of n-tile nt of a lane's C fragment.
__device__ __forceinline__ int c_row(int m0, int g, int e) {
  return m0 + g + 8 * (e >> 1);
}
__device__ __forceinline__ int c_col(int nt, int t, int e) {
  return nt * 8 + 2 * t + (e & 1);
}

// Store a 16 x 64 fp32 fragment tile, times `mul`, as bf16 rows.
__device__ __forceinline__ void store_rows(uint16_t *g, long long st,
                                           int row0, const float c[8][4],
                                           float mul0, float mul1, int gq,
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mul = r ? mul1 : mul0;
    uint16_t *row = g + (long long)(row0 + gq + 8 * r) * st;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t *>(row + nt * 8 + 2 * t) =
          pack_bf16(c[nt][2 * r] * mul, c[nt][2 * r + 1] * mul);
  }
}

// ------------------------------------------------------------------- dQ
// One block per (q tile, b*h); loops over kv tiles 0..diagonal.
__global__ void __launch_bounds__(THREADS) dq_kernel(BwdArgs p) {
  __shared__ __align__(16) uint16_t Qs[TILE * LDS];
  __shared__ __align__(16) uint16_t Ds[TILE * LDS];
  __shared__ __align__(16) uint16_t Ks[TILE * LDS];
  __shared__ __align__(16) uint16_t Vs[TILE * LDS];
  const int nq = p.T / TILE;
  const int qt = nq - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, m0 = warp * 16;
  const uint16_t *qh = head(p.q, p.vq, bh, p.H);
  const uint16_t *kh = head(p.k, p.vk, bh, p.H);
  const uint16_t *vh = head(p.v, p.vv, bh, p.H);
  const uint16_t *dh = head(p.dout, p.vdo, bh, p.H);

  load_tile(Qs, qh, p.vq.t, qt * TILE);
  load_tile(Ds, dh, p.vdo.t, qt * TILE);
  __syncthreads();
  uint32_t qa[4][4], da[4][4];
  load_a(qa, Qs, m0, g, t);
  load_a(da, Ds, m0, g, t);
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = (long long)bh * p.T + qt * TILE + m0 + g + 8 * r;
    lse[r] = p.lse[row];
    delta[r] = p.delta[row];
  }

  float dq[8][4];
  zero(dq);
  const int nk = p.causal ? qt + 1 : nq;
  for (int j = 0; j < nk; ++j) {
    __syncthreads();
    load_tile(Ks, kh, p.vk.t, j * TILE);
    load_tile(Vs, vh, p.vv.t, j * TILE);
    __syncthreads();
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mm_abt(s, qa, Ks, g, t);            // S = Q K^T
    mm_abt(dp, da, Vs, g, t);           // dP = dO V^T
    const bool diag = p.causal && j == qt;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale;
        if (diag && c_col(nt, t, e) > c_row(m0, g, e)) x = NEG_INF;
        const float pe = expf(x - lse[e >> 1]);
        s[nt][e] = pe * (dp[nt][e] - delta[e >> 1]);   // dS
      }
    uint32_t sa[4][4];
    c_to_a(sa, s);
    mm_ab(dq, sa, Ks, g, t);            // dQ += dS K
  }
  uint16_t *dqh = p.grad + (bh / p.H) * p.vg.b + (bh % p.H) * p.vg.h;
  store_rows(dqh, p.vg.t, qt * TILE + m0, dq, p.scale, p.scale, g, t);
}

}  // namespace

// Launcher: plain C interface for ctypes.  `strides` holds the (b, t, h)
// element strides of q, k, v, dO and dQ in order; `stream` is a
// cudaStream_t.  Returns cudaGetLastError() after the launch.
extern "C" int flash_dq(const void *q, const void *k, const void *v,
                        const void *dout, const void *lse, const void *delta,
                        void *dq, const long long *strides, int B, int H,
                        int T, int causal, float scale, void *stream) {
  BwdArgs a;
  a.q = static_cast<const uint16_t *>(q);
  a.k = static_cast<const uint16_t *>(k);
  a.v = static_cast<const uint16_t *>(v);
  a.dout = static_cast<const uint16_t *>(dout);
  a.lse = static_cast<const float *>(lse);
  a.delta = static_cast<const float *>(delta);
  a.grad = static_cast<uint16_t *>(dq);
  a.vq = view(strides);
  a.vk = view(strides + 3);
  a.vv = view(strides + 6);
  a.vdo = view(strides + 9);
  a.vg = view(strides + 12);
  a.H = H;
  a.T = T;
  a.causal = causal;
  a.scale = scale;
  dq_kernel<<<dim3(T / TILE, B * H), THREADS, 0,
              static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// dq_kernel uses static shared memory only.
extern "C" int flash_dq_smem(void) { return 0; }
