// What the three flash-attention kernels share: the head width, the
// masking value, and the strided [B, T, H, D] views they address.
//
// Tensors are bf16 [B, T, H, D] with D = 64, addressed through element
// strides (b, t, h) with a unit d stride, so q/k/v can be the three
// column slices of the fused qkv projection without a copy.  lse and
// delta are fp32 [B*H, T] (not the TPU's sublane-replicated (BH, 8, T)).

#pragma once

#include <stdint.h>

namespace flash {

constexpr int D = 64;                 // head width
constexpr float NEG_INF = -1e30f;     // the Pallas kernels' mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct View {                         // element strides of [B, T, H, D]
  long long b, t, h;
};

inline View view(const long long *s) { return View{s[0], s[1], s[2]}; }

// Element offset of head bh = b * H + h in a view.
__host__ __device__ __forceinline__ long long head_offset(View v, int bh,
                                                          int H) {
  return (bh / H) * v.b + (bh % H) * v.h;
}

// The k-th work item of persistent block c of g: rounds of g items, dealt
// forwards and backwards in turn.  With items sorted by decreasing work
// this evens out the work of the blocks (the causal kernels' items differ
// by up to T / 128 times).
__device__ __forceinline__ int snake_item(int k, int c, int g) {
  return k * g + ((k & 1) ? g - 1 - c : c);
}

}  // namespace flash
