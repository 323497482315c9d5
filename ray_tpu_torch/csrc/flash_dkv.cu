// Flash-attention dK/dV for Hopper (sm_90a): dkv_kernel.
//
// Replaces the Pallas TPU kernel _dkv_kernel of
// ray_tpu/ops/flash_attention.py:128 (pallas_call :229 in _flash_backward).
//
// What bounds it on an H100: at the GPT-2 pretraining shape (B*H = 192,
// T = 1024, causal) a call does ~52 GFLOP of bf16 products (four per
// visible (q, k) pair; ~52 us at 989 TFLOP/s) against ~152 MB of bytes
// (~45 us at 3.35 TB/s): it is bound by the tensor cores, so the design
// keeps them fed and spends no operation twice.
//
// What the design does about that:
//   - Persistent blocks, one per SM, each with two consumer warpgroups
//     (64 kv rows each) and one producer warp; setmaxnreg moves registers
//     from the producer warpgroup (24) to the consumers (240).  A work
//     item is 128 kv rows of one head; items with the most q tiles go
//     first and are dealt to the blocks in snake order, which evens out
//     the causal work.  K and V of an item are loaded once (two buffers,
//     for this item and the next).
//   - The item loops over 64-row q tiles, from the first that reaches its
//     diagonal to the end (causal) or over all of them.  Each q tile (Q,
//     dO by TMA with the 128-byte swizzle; the lse and delta slices by
//     bulk copies) goes through a ring of STAGES stages with full and
//     empty barriers, so the next tiles load while this one is computed.
//   - Per q tile and warpgroup, all on the tensor cores through wgmma:
//     S^T = K Q^T and dP^T = V dO^T (m64n64k16, both operands in shared
//     memory, K-major), then in registers P^T = exp2(S^T scale log2(e) -
//     lse log2(e)) (one FMA into ex2.approx) and dS^T = P^T (dP^T -
//     delta), then dV += P^T dO and dK += dS^T Q (A = P^T or dS^T as bf16
//     from registers, B = dO or Q MN-major).  Computing the transposed
//     scores makes P^T and dS^T come out in the A-operand layout, so
//     nothing is moved through shared memory.
//   - dK and dV stay in registers and are stored once (dK times scale).
//     Each block writes only its own rows: no atomics, deterministic.
//   - Numerics as the Pallas kernel: fp32 scores, masked probabilities 0
//     (exp of -1e30), P cast to bf16 before P^T dO, dS cast to bf16 before
//     dS^T Q.  The 128-row kv tile's diagonal spans two q tiles; both are
//     masked, and the second warpgroup skips the first of them, which is
//     all masked for its rows.  T % 128 = 64: the last item's second
//     warpgroup lies past T (TMA reads zeros there) and stores nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

using namespace flash;
using namespace sm90;

constexpr int BN = 128;                   // kv rows of a block
constexpr int BQ = 64;                    // q rows of a ring stage
constexpr int STAGES = 3;
constexpr int THREADS = 384;              // 2 consumer + 1 producer warpgroup
constexpr int KV_BYTES = BN * D * 2;
constexpr int Q_BYTES = BQ * D * 2;
constexpr int ROW_BYTES = BQ * 4;         // one fp32 lse or delta slice
// K, V, then per stage Q and dO tiles, then per stage lse and delta.
constexpr int OFF_Q = 4 * KV_BYTES;
constexpr int OFF_DO = OFF_Q + STAGES * Q_BYTES;
constexpr int OFF_ROWS = OFF_DO + STAGES * Q_BYTES;
constexpr int SMEM_BYTES = OFF_ROWS + STAGES * 2 * ROW_BYTES + 1024;
constexpr uint32_t STAGE_TX = 2 * Q_BYTES + 2 * ROW_BYTES;

struct Params {
  const float *lse, *delta;
  uint16_t *dk, *dv;
  View vdk, vdv;
  int H, BH, T, causal;
  float scale, scale_log2;                // scale, scale * log2(e)
};

__global__ void __launch_bounds__(THREADS, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t kv_full[2], kv_empty[2], full[STAGES], empty[STAGES];
  uint8_t *smem = align1024(smem_raw);
  auto ks = [&](int n) {
    return reinterpret_cast<uint16_t *>(smem + n * KV_BYTES);
  };
  auto vs = [&](int n) {
    return reinterpret_cast<uint16_t *>(smem + (2 + n) * KV_BYTES);
  };
  auto qs = [&](int s) {
    return reinterpret_cast<uint16_t *>(smem + OFF_Q + s * Q_BYTES);
  };
  auto dos = [&](int s) {
    return reinterpret_cast<uint16_t *>(smem + OFF_DO + s * Q_BYTES);
  };
  auto lse_s = [&](int s) {
    return reinterpret_cast<float *>(smem + OFF_ROWS + s * 2 * ROW_BYTES);
  };
  auto delta_s = [&](int s) {
    return reinterpret_cast<float *>(smem + OFF_ROWS +
                                     (s * 2 + 1) * ROW_BYTES);
  };

  // Work items u = 0 .. nb * BH - 1, kv block kb = u / BH (kb = 0 has the
  // most q tiles, so it goes first); block c takes c, c + gridDim.x, ...
  const int nb = (p.T + BN - 1) / BN, nq = p.T / BQ;
  const int items = nb * p.BH;

  if (threadIdx.x == 0) {
    for (int n = 0; n < 2; ++n) {
      mbar_init(&kv_full[n], 1);
      mbar_init(&kv_empty[n], 2);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);            // one arrival per consumer group
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------------- producer
    regs_dec<24>();
    if (threadIdx.x == 256) {
      int it = 0;                         // q tiles issued so far
      for (int n = 0;; ++n) {
        const int u = snake_item(n, blockIdx.x, gridDim.x);
        if (u >= items) break;
        const int kb = u / p.BH, bh = u % p.BH;
        const int b = bh / p.H, h = bh % p.H;
        mbar_wait(&kv_empty[n & 1], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&kv_full[n & 1], 2 * KV_BYTES);
        tma_load_4d(ks(n & 1), &tk, &kv_full[n & 1], 0, h, kb * BN, b);
        tma_load_4d(vs(n & 1), &tv, &kv_full[n & 1], 0, h, kb * BN, b);
        const long long rows = (long long)bh * p.T;
        for (int i = p.causal ? kb * (BN / BQ) : 0; i < nq; ++i, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], STAGE_TX);
          tma_load_4d(qs(s), &tq, &full[s], 0, h, i * BQ, b);
          tma_load_4d(dos(s), &tdo, &full[s], 0, h, i * BQ, b);
          bulk_load(lse_s(s), p.lse + rows + i * BQ, ROW_BYTES, &full[s]);
          bulk_load(delta_s(s), p.delta + rows + i * BQ, ROW_BYTES,
                    &full[s]);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    regs_inc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    int it = 0;                           // q tiles consumed so far
    for (int n = 0;; ++n) {
      const int u = snake_item(n, blockIdx.x, gridDim.x);
      if (u >= items) break;
      const int kb = u / p.BH, bh = u % p.BH;
      const int q0 = p.causal ? kb * (BN / BQ) : 0;
      const int row0 = kb * BN + wg * 64 + warp * 16;  // + acc_row(i, lane)
      float dk[32], dv[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

      mbar_wait(&kv_full[n & 1], (n >> 1) & 1);
      const uint64_t kdesc = desc_sw128(ks(n & 1) + wg * 64 * D);
      const uint64_t vdesc = desc_sw128(vs(n & 1) + wg * 64 * D);
      for (int i = q0; i < nq; ++i, ++it) {
        const int s = it % STAGES;
        float st[32], dpt[32];            // S^T, dP^T: rows kv, columns q
        mbar_wait(&full[s], (it / STAGES) & 1);
        if (p.causal && wg == 1 && i == q0) {
          // Every q row of the diagonal's first tile precedes every kv
          // row of this group: all of P^T is masked, nothing to add.
          if (tid == 0) {
            if (i == nq - 1) mbar_arrive(&kv_empty[n & 1]);
            mbar_arrive(&empty[s]);
          }
          continue;
        }
        const uint64_t qdesc = desc_sw128(qs(s));
        const uint64_t dodesc = desc_sw128(dos(s));
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          wgmma_ss_n64(st, kdesc + 2 * k, qdesc + 2 * k, k);
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          wgmma_ss_n64(dpt, vdesc + 2 * k, dodesc + 2 * k, k);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        if (i == nq - 1 && tid == 0) mbar_arrive(&kv_empty[n & 1]);

        const float *lse = lse_s(s), *delta = delta_s(s);
        const bool diag = p.causal && i * BQ < kb * BN + BN;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int col = acc_col(e, lane);
          float pt =
              exp2_approx(fmaf(st[e], p.scale_log2, -lse[col] * LOG2E));
          if (diag && i * BQ + col < row0 + acc_row(e, lane)) pt = 0.f;
          st[e] = pt;                              // P^T
          dpt[e] = pt * (dpt[e] - delta[col]);     // dS^T
        }
        uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
        for (int k = 0; k < BQ / 16; ++k) {
          a_frag(pa[k], st, k);
          a_frag(sa[k], dpt, k);
        }
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(sa);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BQ / 16; ++k)
          wgmma_rs_n64_mn(dv, pa[k], dodesc + 128 * k);
#pragma unroll
        for (int k = 0; k < BQ / 16; ++k)
          wgmma_rs_n64_mn(dk, sa[k], qdesc + 128 * k);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(sa);
        if (tid == 0) mbar_arrive(&empty[s]);
      }

      uint16_t *dkh = p.dk + head_offset(p.vdk, bh, p.H);
      uint16_t *dvh = p.dv + head_offset(p.vdv, bh, p.H);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + (lane >> 2) + 8 * r;
        if (row >= p.T) continue;
        uint16_t *dkr = dkh + (long long)row * p.vdk.t;
        uint16_t *dvr = dvh + (long long)row * p.vdv.t;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          const int c = nt * 8 + 2 * (lane & 3), e = 4 * nt + 2 * r;
          *reinterpret_cast<uint32_t *>(dkr + c) =
              pack_bf16(dk[e] * p.scale, dk[e + 1] * p.scale);
          *reinterpret_cast<uint32_t *>(dvr + c) =
              pack_bf16(dv[e], dv[e + 1]);
        }
      }
    }
  }
}

}  // namespace

// Plain C interface for ctypes.  `strides` holds the (b, t, h) element
// strides of q, k, v, dO, dK and dV in order; lse and delta are fp32
// [B*H, T]; `stream` is a cudaStream_t.  Returns 0, or the CUDA error of
// the tensor-map encoding or of the launch.
extern "C" int flash_dkv(const void *q, const void *k, const void *v,
                         const void *dout, const void *lse,
                         const void *delta, void *dk, void *dv,
                         const long long *strides, int B, int H, int T,
                         int causal, float scale, void *stream) {
  CUtensorMap tq, tk, tv, tdo;
  int rc;
  if ((rc = cudaFuncSetAttribute(dkv_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES)) ||
      (rc = encode_bthd(&tq, q, B, T, H, strides, BQ)) ||
      (rc = encode_bthd(&tk, k, B, T, H, strides + 3, BN)) ||
      (rc = encode_bthd(&tv, v, B, T, H, strides + 6, BN)) ||
      (rc = encode_bthd(&tdo, dout, B, T, H, strides + 9, BQ)))
    return rc;
  Params p;
  p.lse = static_cast<const float *>(lse);
  p.delta = static_cast<const float *>(delta);
  p.dk = static_cast<uint16_t *>(dk);
  p.dv = static_cast<uint16_t *>(dv);
  p.vdk = view(strides + 12);
  p.vdv = view(strides + 15);
  p.H = H;
  p.BH = B * H;
  p.T = T;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  int dev, sms;
  if ((rc = cudaGetDevice(&dev)) ||
      (rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return rc;
  const int items = (T + BN - 1) / BN * B * H;
  dkv_kernel<<<items < sms ? items : sms, THREADS, SMEM_BYTES,
               static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, tdo, p);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one dkv_kernel block, in bytes.
extern "C" int flash_dkv_smem(void) { return SMEM_BYTES; }
