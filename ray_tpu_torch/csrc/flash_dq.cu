// Flash-attention dQ for Hopper (sm_90a): dq_kernel.
//
// Replaces the Pallas TPU kernel _dq_kernel of
// ray_tpu/ops/flash_attention.py:174 (pallas_call :258 in _flash_backward).
//
// What bounds it on an H100: at the GPT-2 pretraining shape (B*H = 192,
// T = 1024, causal) a call does ~39 GFLOP of bf16 products (three per
// visible (q, k) pair: S, dP and dQ; ~39 us at 989 TFLOP/s) against
// ~127 MB of bytes (~38 us at 3.35 TB/s), plus ~100 M exponentials on the
// special-function units.  The two bounds nearly meet, the tensor cores'
// by a hair, so the design keeps both busy at once: loads overlap
// products, and the softmax recomputation overlaps the second product of
// each tile.
//
// What the design does about that:
//   - Persistent blocks, one per SM, each with two consumer warpgroups
//     (64 query rows each) and one producer warp; setmaxnreg moves
//     registers from the producer warpgroup (24) to the consumers (240).
//     A work item is 128 query rows of one head.  Items with the most kv
//     tiles (the last q block, under the causal mask) go first and are
//     dealt to the blocks in snake order, which evens out the causal work.
//   - Copies are TMA tile loads over tensor maps of the strided
//     [B, T, H, 64] views, with the 128-byte swizzle that wgmma reads
//     without bank conflicts.  The Q and dO tiles of an item are loaded
//     once (two buffers each, for this item and the next); K and V tiles
//     of 128 rows go through a ring of 3 stages, each with its own
//     full barriers (K and V apart, so S = Q K^T starts before V lands)
//     and an empty barrier both consumer warpgroups release.
//   - Per stage and warpgroup, all products on wgmma: S = Q K^T and
//     dP = dO V^T with both operands K-major in shared memory, committed
//     as two groups; the exponentials P = exp2(S scale log2(e) - lse
//     log2(e)) (one FMA into ex2.approx) run while dP is still in flight.
//     Then dS = P (dP - delta) in registers, packed to bf16 as the A
//     operand of dQ += dS K, whose B operand is the same K tile read
//     MN-major (transpose flag).  Scores have rows along q, so dS comes
//     out of the accumulator in the A-operand layout: nothing goes through
//     shared memory.
//   - dQ (32 fp32 a thread) stays in registers for the whole item and is
//     stored once, times scale, for rows < T.  Each block writes only its
//     own rows: no atomics, deterministic.
//   - Causal: a warpgroup only visits the keys up to its last row.  Its
//     diagonal tile is masked, and the first warpgroup runs it at half
//     width (m64n64), as the forward does.  A warpgroup that needs nothing
//     of a stage still waits for it to land and releases it, so the ring
//     never deadlocks.
//   - Numerics as the Pallas kernel: fp32 scores scaled after the product,
//     masked probabilities exactly 0, dS cast to bf16 before dS K, fp32
//     accumulation and one cast to bf16 at the store.
//   - T % 128 = 64: the last item's second warpgroup lies past T and skips
//     every stage; lse and delta are read only for rows < T; TMA fills
//     rows past T with zeros, keys at or past T are masked.

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
constexpr int STAGES = 3;                 // depth of the K/V ring
constexpr int THREADS = 384;              // 2 consumer + 1 producer warpgroup
constexpr int Q_BYTES = BM * D * 2;
constexpr int KV_BYTES = BN * D * 2;
// Two Q buffers, two dO buffers, then the K stages, then the V stages.
constexpr int SMEM_BYTES = 4 * Q_BYTES + 2 * STAGES * KV_BYTES + 1024;

struct Params {
  const float *lse, *delta;
  uint16_t *dq;
  View vdq;
  int H, BH, T, causal;
  float scale, scale_log2;                // scale, scale * log2(e)
};

// One kv stage for one consumer warpgroup, over the first N of its keys:
// S = Q K^T, dP = dO V^T, P and dS in registers, dQ += dS K.  lse2 is the
// row lse times log2(e); delta the row delta (two rows a thread).
template <int N>
__device__ __forceinline__ void dq_tile(
    float (&dq)[32], uint64_t qdesc, uint64_t dodesc, const uint16_t *kt,
    const uint16_t *vt, uint64_t *k_full, uint64_t *v_full, uint32_t phase,
    bool masked, int col0, int row0, int lane, const float (&lse2)[2],
    const float (&delta)[2], const Params &p) {
  float sc[N / 2], dp[N / 2];
  const uint64_t kdesc = desc_sw128(kt), vdesc = desc_sw128(vt);
  mbar_wait(k_full, phase);
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
  mbar_wait(v_full, phase);
  fence_regs(dp);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    if constexpr (N == 128)
      wgmma_ss_n128(dp, dodesc + 2 * k, vdesc + 2 * k, k);
    else
      wgmma_ss_n64(dp, dodesc + 2 * k, vdesc + 2 * k, k);
  }
  wgmma_commit();

  // S is done (dP may still run): P = exp(S * scale - lse), masked to 0.
  wgmma_wait<1>();
  fence_regs(sc);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    float pe = exp2_approx(fmaf(sc[i], p.scale_log2, -lse2[(i >> 1) & 1]));
    if (masked) {
      const int col = col0 + acc_col(i, lane);
      const int row = row0 + acc_row(i, lane);
      if ((p.causal && col > row) || col >= p.T) pe = 0.f;
    }
    sc[i] = pe;
  }
  wgmma_wait<0>();
  fence_regs(dp);
  uint32_t sa[N / 16][4];                 // dS -> bf16 A operand
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    dp[i] = sc[i] * (dp[i] - delta[(i >> 1) & 1]);
#pragma unroll
  for (int k = 0; k < N / 16; ++k) a_frag(sa[k], dp, k);

  fence_regs(dq);
  fence_regs(sa);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < N / 16; ++k) wgmma_rs_n64_mn(dq, sa[k], kdesc + 128 * k);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq);
  fence_regs(sa);
}

__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full[2], q_empty[2];
  __shared__ uint64_t k_full[STAGES], v_full[STAGES], empty[STAGES];
  uint8_t *smem = align1024(smem_raw);
  auto qs = [&](int n) {
    return reinterpret_cast<uint16_t *>(smem + n * Q_BYTES);
  };
  auto dos = [&](int n) {
    return reinterpret_cast<uint16_t *>(smem + (2 + n) * Q_BYTES);
  };
  auto ks = [&](int s) {
    return reinterpret_cast<uint16_t *>(smem + 4 * Q_BYTES + s * KV_BYTES);
  };
  auto vs = [&](int s) {
    return reinterpret_cast<uint16_t *>(smem + 4 * Q_BYTES +
                                        (STAGES + s) * KV_BYTES);
  };

  // Work item u = 0 .. nb * BH - 1 is q block nb - 1 - u / BH of head
  // u % BH: the longest causal rows come first.  It needs the kv tiles
  // below min(T, end of the block) (causal) or below T.
  const int nb = (p.T + BM - 1) / BM;
  const int items = nb * p.BH;
  auto kv_tiles = [&](int qb) {
    const int kmax = p.causal ? min(p.T, (qb + 1) * BM) : p.T;
    return (kmax + BN - 1) / BN;
  };

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
        const int nk = kv_tiles(qb);
        mbar_wait(&q_empty[n & 1], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&q_full[n & 1], 2 * Q_BYTES);
        tma_load_4d(qs(n & 1), &tq, &q_full[n & 1], 0, h, qb * BM, b);
        tma_load_4d(dos(n & 1), &tdo, &q_full[n & 1], 0, h, qb * BM, b);
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
      const int nk = kv_tiles(qb);
      const int r0 = qb * BM + wg * 64;   // this warpgroup's first row
      const int row0 = r0 + warp * 16;    // + acc_row(i, lane)
      // Keys this warpgroup needs: [0, kend).  Rows and T are multiples
      // of 64, so a group lies wholly before T or wholly past it.
      const int kend = r0 >= p.T ? 0 : p.causal ? r0 + 64 : p.T;
      float lse2[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + (lane >> 2) + 8 * r;
        if (row < p.T) {                  // never read past [B*H, T]
          lse2[r] = p.lse[(long long)bh * p.T + row] * LOG2E;
          delta[r] = p.delta[(long long)bh * p.T + row];
        }
      }
      float dq[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] = 0.f;

      mbar_wait(&q_full[n & 1], (n >> 1) & 1);
      const uint64_t qdesc = desc_sw128(qs(n & 1) + wg * 64 * D);
      const uint64_t dodesc = desc_sw128(dos(n & 1) + wg * 64 * D);
      for (int j = 0; j < nk; ++j, ++it) {
        const int s = it % STAGES;
        const uint32_t phase = (it / STAGES) & 1;
        const int width = kend - j * BN;  // keys of this stage to visit
        if (width <= 0) {
          // Nothing of this stage is visible to this group: wait for it
          // to land (so the release counts in its own phase), release it.
          mbar_wait(&k_full[s], phase);
          mbar_wait(&v_full[s], phase);
          if (tid == 0) mbar_arrive(&empty[s]);
          continue;
        }
        const int nkeys = width < BN ? width : BN;
        const bool masked = (p.causal && j * BN + nkeys - 1 > r0) ||
                            j * BN + nkeys > p.T;
        // Half width: the first group's diagonal, or the last 64 keys
        // when T % 128 = 64.
        if (nkeys == 64)
          dq_tile<64>(dq, qdesc, dodesc, ks(s), vs(s), &k_full[s],
                      &v_full[s], phase, masked, j * BN, row0, lane, lse2,
                      delta, p);
        else
          dq_tile<BN>(dq, qdesc, dodesc, ks(s), vs(s), &k_full[s],
                      &v_full[s], phase, masked, j * BN, row0, lane, lse2,
                      delta, p);
        if (tid == 0) mbar_arrive(&empty[s]);
      }
      if (tid == 0) mbar_arrive(&q_empty[n & 1]);

      uint16_t *dqh = p.dq + head_offset(p.vdq, bh, p.H);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + (lane >> 2) + 8 * r;
        if (row >= p.T) continue;
        uint16_t *dqr = dqh + (long long)row * p.vdq.t;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
          *reinterpret_cast<uint32_t *>(dqr + nt * 8 + 2 * (lane & 3)) =
              pack_bf16(dq[4 * nt + 2 * r] * p.scale,
                        dq[4 * nt + 2 * r + 1] * p.scale);
      }
    }
  }
}

}  // namespace

// Plain C interface for ctypes.  `strides` holds the (b, t, h) element
// strides of q, k, v, dO and dQ in order; lse and delta are fp32
// [B*H, T]; `stream` is a cudaStream_t.  Returns 0, or the CUDA error of
// the set-up (shared-memory limit, device query, tensor-map encoding) or
// of the launch.
extern "C" int flash_dq(const void *q, const void *k, const void *v,
                        const void *dout, const void *lse, const void *delta,
                        void *dq, const long long *strides, int B, int H,
                        int T, int causal, float scale, void *stream) {
  CUtensorMap tq, tk, tv, tdo;
  int rc, dev, sms;
  if ((rc = cudaFuncSetAttribute(dq_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES)) ||
      (rc = cudaGetDevice(&dev)) ||
      (rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev)) ||
      (rc = encode_bthd(&tq, q, B, T, H, strides, BM)) ||
      (rc = encode_bthd(&tk, k, B, T, H, strides + 3, BN)) ||
      (rc = encode_bthd(&tv, v, B, T, H, strides + 6, BN)) ||
      (rc = encode_bthd(&tdo, dout, B, T, H, strides + 9, BM)))
    return rc;
  Params p;
  p.lse = static_cast<const float *>(lse);
  p.delta = static_cast<const float *>(delta);
  p.dq = static_cast<uint16_t *>(dq);
  p.vdq = view(strides + 12);
  p.H = H;
  p.BH = B * H;
  p.T = T;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  const int items = (T + BM - 1) / BM * B * H;
  dq_kernel<<<items < sms ? items : sms, THREADS, SMEM_BYTES,
              static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, tdo, p);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one dq_kernel block, in bytes.
extern "C" int flash_dq_smem(void) { return SMEM_BYTES; }
