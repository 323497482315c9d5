// Flash-attention forward for Hopper (sm_90a): fwd_kernel.
//
// Replaces the Pallas TPU kernel _fwd_kernel of
// ray_tpu/ops/flash_attention.py:45 (pallas_call :99 in _flash_forward).
//
// What bounds it on an H100: at the GPT-2 pretraining shape (B*H = 192,
// T = 1024, causal) a call reads q, k, v and writes o and lse, ~101 MB
// (~30 us at 3.35 TB/s), and does ~26 GFLOP of bf16 products (~26 us at
// 989 TFLOP/s); the ~100 M exponentials of the online softmax, on the
// special-function units (16 a clock per SM), take about as long again.
// So the kernel sits at the ridge, and what it must avoid is waiting: on
// its loads, on the tensor cores, and on the softmax between products.
//
// What the design does about that:
//   - Persistent blocks, one per SM, each with two consumer warpgroups
//     (64 query rows each) and one producer warp; setmaxnreg moves
//     registers from the producer warpgroup (24) to the consumers (240).
//     A work item is 128 query rows of one head.  Items go longest causal
//     rows first and are dealt to the blocks in snake order, which evens
//     out the causal work; the producer loads the next item's tiles while
//     the consumers finish the current one.
//   - Copies are TMA tile loads over tensor maps of the strided
//     [B, T, H, 64] views (no copy of the qkv slices), with the 128-byte
//     swizzle that wgmma reads without bank conflicts.  The Q tile of an
//     item is loaded once (two buffers, for this item and the next); K
//     and V tiles of 128 rows go through a ring of STAGES stages, each
//     with its own full barriers (K and V apart, so S = Q K^T starts
//     before V lands) and an empty barrier the consumers release.
//   - S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//     (K-major).  The softmax runs on the fp32 accumulator in registers,
//     with ex2.approx and the scale * log2(e) folded into one FMA; only
//     the diagonal tile (and a last tile that reaches past T) is masked.
//     On the diagonal the first warpgroup's rows see only the first 64
//     keys, so it runs that tile at half width (m64n64).  P is packed to
//     bf16 in registers (the accumulator layout is the A-operand layout)
//     and O += P V is wgmma m64n64k16 with A from registers and V
//     MN-major (transpose flag).
//   - Numerics as the Pallas kernel: fp32 scores, -1e30 masking, P cast to
//     bf16 before P V, the l > 0 guard and lse = m + log(max(l, 1e-30)),
//     stored in natural log.
//   - T % 128 = 64: the last item's second warpgroup and the last kv
//     tile's second half lie past T.  TMA fills them with zeros, keys at
//     or past T are masked, and rows at or past T are not stored.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

using namespace flash;
using namespace sm90;

constexpr int BM = 128;                   // q rows of a work item
constexpr int BN = 128;                   // kv rows of a ring stage
constexpr int STAGES = 3;
constexpr int THREADS = 384;              // 2 consumer + 1 producer warpgroup
constexpr int Q_BYTES = BM * D * 2;
constexpr int KV_BYTES = BN * D * 2;
// Two Q buffers, then the K stages, then the V stages.
constexpr int SMEM_BYTES = 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 1024;

struct Params {
  uint16_t *o;
  float *lse;
  View vo;
  int H, BH, T, causal;
  float scale_log2;                       // scale * log2(e)
};

// One kv tile for one consumer warpgroup: S = Q K^T over the first N of
// the tile's 128 keys, online softmax, O += P V.  m and l are the running
// row max (log2 domain) and lane-partial row sums.  If q_release is set,
// the Q buffer is released once this tile's S is done.
template <int N>
__device__ __forceinline__ void fwd_tile(
    float (&o)[32], float (&m)[2], float (&l)[2], uint64_t qdesc,
    const uint16_t *kt, const uint16_t *vt, uint64_t *k_full,
    uint64_t *v_full, uint32_t phase, uint64_t *q_release, bool masked,
    int col0, int row0, int lane, const Params &p) {
  float sc[N / 2];
  mbar_wait(k_full, phase);
  const uint64_t kdesc = desc_sw128(kt);
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    if constexpr (N == 128)
      wgmma_ss_n128(sc, qdesc + 2 * k, kdesc + 2 * k, k);
    else
      wgmma_ss_n64(sc, qdesc + 2 * k, kdesc + 2 * k, k);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  if (q_release != nullptr && (threadIdx.x % 128) == 0)
    mbar_arrive(q_release);

  if (masked) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int col = col0 + acc_col(i, lane);
      const int row = row0 + acc_row(i, lane);
      if ((p.causal && col > row) || col >= p.T) sc[i] = NEG_INF;
    }
  }
  // Online softmax in the log2 domain: x = s * scale * log2(e).
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {           // a row lives in 4 lanes of a quad
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * p.scale_log2);
    alpha[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = exp2_approx(fmaf(sc[i], p.scale_log2, -m[r]));
    l[r] += sc[i];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
  uint32_t pa[N / 16][4];                 // P -> bf16 A operand
#pragma unroll
  for (int k = 0; k < N / 16; ++k) a_frag(pa[k], sc, k);

  mbar_wait(v_full, phase);
  const uint64_t vdesc = desc_sw128(vt);
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < N / 16; ++k) wgmma_rs_n64_mn(o, pa[k], vdesc + 128 * k);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);
}

__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full[2], q_empty[2];
  __shared__ uint64_t k_full[STAGES], v_full[STAGES], empty[STAGES];
  uint8_t *smem = align1024(smem_raw);
  auto qs = [&](int n) {
    return reinterpret_cast<uint16_t *>(smem + n * Q_BYTES);
  };
  auto ks = [&](int s) {
    return reinterpret_cast<uint16_t *>(smem + 2 * Q_BYTES + s * KV_BYTES);
  };
  auto vs = [&](int s) {
    return reinterpret_cast<uint16_t *>(smem + 2 * Q_BYTES +
                                        (STAGES + s) * KV_BYTES);
  };

  // Work item u = 0 .. nb * BH - 1 is q block nb - 1 - u / BH of head
  // u % BH: the longest causal rows come first.
  const int nb = (p.T + BM - 1) / BM;
  const int items = nb * p.BH;

  if (threadIdx.x == 0) {
    for (int n = 0; n < 2; ++n) {
      mbar_init(&q_full[n], 1);
      mbar_init(&q_empty[n], 2);          // one arrival per consumer group
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------------- producer
    regs_dec<24>();
    if (threadIdx.x == 256) {
      int it = 0;                         // kv tiles issued so far
      for (int n = 0;; ++n) {
        const int u = snake_item(n, blockIdx.x, gridDim.x);
        if (u >= items) break;
        const int qb = nb - 1 - u / p.BH, bh = u % p.BH;
        const int b = bh / p.H, h = bh % p.H;
        const int nk = p.causal ? qb + 1 : nb;
        mbar_wait(&q_empty[n & 1], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&q_full[n & 1], Q_BYTES);
        tma_load_4d(qs(n & 1), &tq, &q_full[n & 1], 0, h, qb * BM, b);
        for (int j = 0; j < nk; ++j, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&k_full[s], KV_BYTES);
          tma_load_4d(ks(s), &tk, &k_full[s], 0, h, j * BN, b);
          mbar_expect_tx(&v_full[s], KV_BYTES);
          tma_load_4d(vs(s), &tv, &v_full[s], 0, h, j * BN, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    regs_inc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    int it = 0;                           // kv tiles consumed so far
    for (int n = 0;; ++n) {
      const int u = snake_item(n, blockIdx.x, gridDim.x);
      if (u >= items) break;
      const int qb = nb - 1 - u / p.BH, bh = u % p.BH;
      const int nk = p.causal ? qb + 1 : nb;
      const int row0 = qb * BM + wg * 64 + warp * 16;  // + acc_row(i, lane)
      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

      mbar_wait(&q_full[n & 1], (n >> 1) & 1);
      const uint64_t qdesc = desc_sw128(qs(n & 1) + wg * 64 * D);
      for (int j = 0; j < nk; ++j, ++it) {
        const int s = it % STAGES;
        const uint32_t phase = (it / STAGES) & 1;
        uint64_t *q_release = j == nk - 1 ? &q_empty[n & 1] : nullptr;
        const bool diag = p.causal && j == qb;
        const bool masked = diag || (j + 1) * BN > p.T;
        if (diag && wg == 0)
          fwd_tile<64>(o, m, l, qdesc, ks(s), vs(s), &k_full[s], &v_full[s],
                       phase, q_release, masked, j * BN, row0, lane, p);
        else
          fwd_tile<128>(o, m, l, qdesc, ks(s), vs(s), &k_full[s],
                        &v_full[s], phase, q_release, masked, j * BN, row0,
                        lane, p);
        if (tid == 0) mbar_arrive(&empty[s]);
      }

      uint16_t *oh = p.o + head_offset(p.vo, bh, p.H);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = row0 + (lane >> 2) + 8 * r;
        if (row >= p.T) continue;
        const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
        if ((lane & 3) == 0)
          p.lse[(long long)bh * p.T + row] =
              (m[r] + log2f(fmaxf(l[r], 1e-30f))) * LN2;
        uint16_t *orow = oh + (long long)row * p.vo.t;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
          *reinterpret_cast<uint32_t *>(orow + nt * 8 + 2 * (lane & 3)) =
              pack_bf16(o[4 * nt + 2 * r] * inv, o[4 * nt + 2 * r + 1] * inv);
      }
    }
  }
}

}  // namespace

// Plain C interface for ctypes.  `strides` holds the (b, t, h) element
// strides of q, k, v and o in order; `stream` is a cudaStream_t.  Returns
// 0, or the CUDA error of the set-up (shared-memory limit, device query,
// tensor-map encoding) or of the launch.
extern "C" int flash_fwd(const void *q, const void *k, const void *v,
                         void *o, void *lse, const long long *strides,
                         int B, int H, int T, int causal, float scale,
                         void *stream) {
  CUtensorMap tq, tk, tv;
  int rc, dev, sms;
  if ((rc = cudaFuncSetAttribute(fwd_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES)) ||
      (rc = cudaGetDevice(&dev)) ||
      (rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev)) ||
      (rc = encode_bthd(&tq, q, B, T, H, strides, BM)) ||
      (rc = encode_bthd(&tk, k, B, T, H, strides + 3, BN)) ||
      (rc = encode_bthd(&tv, v, B, T, H, strides + 6, BN)))
    return rc;
  Params p;
  p.o = static_cast<uint16_t *>(o);
  p.lse = static_cast<float *>(lse);
  p.vo = view(strides + 9);
  p.H = H;
  p.BH = B * H;
  p.T = T;
  p.causal = causal;
  p.scale_log2 = scale * LOG2E;
  const int items = (T + BM - 1) / BM * B * H;
  fwd_kernel<<<items < sms ? items : sms, THREADS, SMEM_BYTES,
               static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one fwd_kernel block, in bytes.
extern "C" int flash_fwd_smem(void) { return SMEM_BYTES; }
