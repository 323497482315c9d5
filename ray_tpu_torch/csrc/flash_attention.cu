// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels.
//
// Replaces the three Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   fwd_kernel  <- _fwd_kernel (:45-90, pallas_call in _flash_forward :99)
//   dkv_kernel  <- _dkv_kernel (:128-171, pallas_call in _flash_backward :229)
//   dq_kernel   <- _dq_kernel  (:174-208, pallas_call in _flash_backward :258)
//
// Tensors are bf16 [B, T, H, D] with D = 64, addressed through element
// strides (b, t, h) with a unit d stride, so q/k/v can be the three
// column slices of the fused qkv projection without a copy.  lse and
// delta are fp32 [B*H, T] (not the TPU's sublane-replicated (BH, 8, T)).
//
// What bounds them on an H100: at the GPT-2 pretraining shape (B*H = 192,
// T = 1024, causal) each kernel needs 26-52 GFLOP of bf16 matrix products
// against 101-153 MB of HBM traffic, so all three sit near the ridge
// point: the forward is bounded by bytes (~30 us at 3.35 TB/s), dK/dV and
// dQ by tensor-core operations (~52 us and ~39 us at 989 TFLOP/s).  What
// the design does
// about it: the [T, T] score and probability matrices never reach HBM;
// each block keeps a 64-row slice of them in registers and feeds it
// straight back into the next product (the C fragment of one mma.sync is
// the A fragment of the next), so HBM sees only the [T, D] operands.
//
// Design (a first, simple version; wgmma, TMA and pipelining are later
// work):
//   - mma.sync.m16n8k16 bf16 -> fp32 on 16-row warp slices, 4 warps per
//     block, 64 x 64 tiles staged through shared memory with 144-byte
//     rows so every fragment load is free of bank conflicts.
//   - No carry between blocks and no atomics: the TPU kernels carry the
//     running (m, l, acc) across a sequential grid axis; here one block
//     per (b*h, q tile) loops over kv tiles up to the diagonal (forward,
//     dQ) and one block per (b*h, kv tile) loops over q tiles from the
//     diagonal (dK/dV).
//   - The recurrence and casts follow the Pallas kernels: scores in fp32
//     scaled after the product, masked to -1e30, P cast to bf16 before
//     P.V and before P^T.dO, dS cast to bf16 before its products, the
//     l > 0 guard and lse = m + log(max(l, 1e-30)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;        // head width
constexpr int TILE = 64;     // rows of every q and kv tile
constexpr int WARPS = 4;     // each warp owns 16 rows of the block's tile
constexpr int THREADS = 32 * WARPS;
constexpr int LDS = D + 8;   // shared-memory row stride in bf16 elements
constexpr float NEG_INF = -1e30f;

struct View {                // element strides of a [B, T, H, D] tensor
  long long b, t, h;
};

struct FwdArgs {
  const uint16_t *q, *k, *v;
  uint16_t *o;
  float *lse;
  View vq, vk, vv, vo;
  int H, T, causal;
  float scale;
};

struct BwdArgs {
  const uint16_t *q, *k, *v, *dout;
  const float *lse, *delta;
  uint16_t *grad;            // dQ for dq_kernel; dK for dkv_kernel
  uint16_t *grad2;           // dV for dkv_kernel
  View vq, vk, vv, vdo, vg, vg2;
  int H, T, causal;
  float scale;
};

__device__ __forceinline__ const uint16_t *head(const uint16_t *p, View v,
                                                int bh, int H) {
  return p + (bh / H) * v.b + (bh % H) * v.h;
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

// ------------------------------------------------------------- forward
// One block per (q tile, b*h); loops over kv tiles 0..diagonal with the
// online-softmax recurrence.
__global__ void __launch_bounds__(THREADS) fwd_kernel(FwdArgs p) {
  __shared__ __align__(16) uint16_t Qs[TILE * LDS];
  __shared__ __align__(16) uint16_t Ks[TILE * LDS];
  __shared__ __align__(16) uint16_t Vs[TILE * LDS];
  const int nq = p.T / TILE;
  const int qt = nq - 1 - blockIdx.x;   // longest causal rows start first
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, m0 = warp * 16;
  const uint16_t *qh = head(p.q, p.vq, bh, p.H);
  const uint16_t *kh = head(p.k, p.vk, bh, p.H);
  const uint16_t *vh = head(p.v, p.vv, bh, p.H);

  load_tile(Qs, qh, p.vq.t, qt * TILE);
  __syncthreads();
  uint32_t qa[4][4];
  load_a(qa, Qs, m0, g, t);

  float acc[8][4];
  zero(acc);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int nk = p.causal ? qt + 1 : nq;
  for (int j = 0; j < nk; ++j) {
    __syncthreads();                    // all warps are done with tile j-1
    load_tile(Ks, kh, p.vk.t, j * TILE);
    load_tile(Vs, vh, p.vv.t, j * TILE);
    __syncthreads();
    float s[8][4];
    zero(s);
    mm_abt(s, qa, Ks, g, t);            // S = Q K^T
    const bool diag = p.causal && j == qt;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale;
        if (diag && c_col(nt, t, e) > c_row(m0, g, e)) x = NEG_INF;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {       // a row lives in the 4 lanes of a quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];                 // lane-partial row sums
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = pe;
        l[e >> 1] += pe;
        acc[nt][e] *= alpha[e >> 1];
      }
    uint32_t pa[4][4];
    c_to_a(pa, s);                      // P -> bf16
    mm_ab(acc, pa, Vs, g, t);           // acc += P V
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    if (t == 0)
      p.lse[(long long)bh * p.T + qt * TILE + m0 + g + 8 * r] =
          m[r] + logf(fmaxf(l[r], 1e-30f));
  }
  uint16_t *oh = p.o + (bh / p.H) * p.vo.b + (bh % p.H) * p.vo.h;
  store_rows(oh, p.vo.t, qt * TILE + m0, acc, inv[0], inv[1], g, t);
}

// ---------------------------------------------------------------- dK/dV
// One block per (kv tile, b*h); loops over q tiles diagonal..end.  Each
// warp keeps its 16 rows of K and V as A fragments and computes the
// transposed products S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T
// come out as A fragments for dV += P^T dO and dK += dS^T Q.
__global__ void __launch_bounds__(THREADS) dkv_kernel(BwdArgs p) {
  __shared__ __align__(16) uint16_t Ks[TILE * LDS];
  __shared__ __align__(16) uint16_t Vs[TILE * LDS];
  __shared__ __align__(16) uint16_t Qs[TILE * LDS];
  __shared__ __align__(16) uint16_t Ds[TILE * LDS];
  __shared__ float lse_s[TILE], delta_s[TILE];
  const int nq = p.T / TILE;
  const int kt = blockIdx.x;            // kt = 0 has the most q tiles
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, m0 = warp * 16;
  const uint16_t *qh = head(p.q, p.vq, bh, p.H);
  const uint16_t *kh = head(p.k, p.vk, bh, p.H);
  const uint16_t *vh = head(p.v, p.vv, bh, p.H);
  const uint16_t *dh = head(p.dout, p.vdo, bh, p.H);
  const float *lse_h = p.lse + (long long)bh * p.T;
  const float *delta_h = p.delta + (long long)bh * p.T;

  load_tile(Ks, kh, p.vk.t, kt * TILE);
  load_tile(Vs, vh, p.vv.t, kt * TILE);
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
  load_a(ka, Ks, m0, g, t);
  load_a(va, Vs, m0, g, t);

  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  for (int i = p.causal ? kt : 0; i < nq; ++i) {
    __syncthreads();
    load_tile(Qs, qh, p.vq.t, i * TILE);
    load_tile(Ds, dh, p.vdo.t, i * TILE);
    if (threadIdx.x < TILE) {
      lse_s[threadIdx.x] = lse_h[i * TILE + threadIdx.x];
      delta_s[threadIdx.x] = delta_h[i * TILE + threadIdx.x];
    }
    __syncthreads();
    float s[8][4];
    zero(s);
    mm_abt(s, ka, Qs, g, t);            // S^T: rows kv, columns q
    const bool diag = p.causal && i == kt;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c_col(nt, t, e);
        float x = s[nt][e] * p.scale;
        if (diag && col < c_row(m0, g, e)) x = NEG_INF;
        s[nt][e] = expf(x - lse_s[col]); // P^T
      }
    uint32_t pa[4][4];
    c_to_a(pa, s);
    mm_ab(dv, pa, Ds, g, t);            // dV += P^T dO
    float dp[8][4];
    zero(dp);
    mm_abt(dp, va, Ds, g, t);           // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] *= dp[nt][e] - delta_s[c_col(nt, t, e)];  // dS^T
    c_to_a(pa, s);
    mm_ab(dk, pa, Qs, g, t);            // dK += dS^T Q
  }
  uint16_t *dkh = p.grad + (bh / p.H) * p.vg.b + (bh % p.H) * p.vg.h;
  uint16_t *dvh = p.grad2 + (bh / p.H) * p.vg2.b + (bh % p.H) * p.vg2.h;
  store_rows(dkh, p.vg.t, kt * TILE + m0, dk, p.scale, p.scale, g, t);
  store_rows(dvh, p.vg2.t, kt * TILE + m0, dv, 1.f, 1.f, g, t);
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

View view(const long long *s) { return View{s[0], s[1], s[2]}; }

}  // namespace

// Launchers: plain C interface for ctypes.  `strides` holds (b, t, h)
// element strides for each tensor argument in order; `stream` is a
// cudaStream_t.  Each returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void *q, const void *k, const void *v,
                         void *o, void *lse, const long long *strides,
                         int B, int H, int T, int causal, float scale,
                         void *stream) {
  FwdArgs a;
  a.q = static_cast<const uint16_t *>(q);
  a.k = static_cast<const uint16_t *>(k);
  a.v = static_cast<const uint16_t *>(v);
  a.o = static_cast<uint16_t *>(o);
  a.lse = static_cast<float *>(lse);
  a.vq = view(strides);
  a.vk = view(strides + 3);
  a.vv = view(strides + 6);
  a.vo = view(strides + 9);
  a.H = H;
  a.T = T;
  a.causal = causal;
  a.scale = scale;
  fwd_kernel<<<dim3(T / TILE, B * H), THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

static BwdArgs bwd_args(const void *q, const void *k, const void *v,
                        const void *dout, const void *lse,
                        const void *delta, void *grad, void *grad2,
                        const long long *strides, int n_grads, int H, int T,
                        int causal, float scale) {
  BwdArgs a;
  a.q = static_cast<const uint16_t *>(q);
  a.k = static_cast<const uint16_t *>(k);
  a.v = static_cast<const uint16_t *>(v);
  a.dout = static_cast<const uint16_t *>(dout);
  a.lse = static_cast<const float *>(lse);
  a.delta = static_cast<const float *>(delta);
  a.grad = static_cast<uint16_t *>(grad);
  a.grad2 = static_cast<uint16_t *>(grad2);
  a.vq = view(strides);
  a.vk = view(strides + 3);
  a.vv = view(strides + 6);
  a.vdo = view(strides + 9);
  a.vg = view(strides + 12);
  a.vg2 = n_grads > 1 ? view(strides + 15) : a.vg;
  a.H = H;
  a.T = T;
  a.causal = causal;
  a.scale = scale;
  return a;
}

extern "C" int flash_dkv(const void *q, const void *k, const void *v,
                         const void *dout, const void *lse,
                         const void *delta, void *dk, void *dv,
                         const long long *strides, int B, int H, int T,
                         int causal, float scale, void *stream) {
  BwdArgs a = bwd_args(q, k, v, dout, lse, delta, dk, dv, strides, 2, H, T,
                       causal, scale);
  dkv_kernel<<<dim3(T / TILE, B * H), THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int flash_dq(const void *q, const void *k, const void *v,
                        const void *dout, const void *lse, const void *delta,
                        void *dq, const long long *strides, int B, int H,
                        int T, int causal, float scale, void *stream) {
  BwdArgs a = bwd_args(q, k, v, dout, lse, delta, dq, nullptr, strides, 1,
                       H, T, causal, scale);
  dq_kernel<<<dim3(T / TILE, B * H), THREADS, 0,
              static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
