// Length-aware split-KV decode attention over the seq-major KV cache (Hopper).
//
// Replaces the TPU kernel msd_tpu/ops/pallas/decode_attention.py
// (decode_attention, body _kernel, block picker _pick_block_s): per head,
//   out = softmax(q k^T / sqrt(D) + bias) v
// over keys [0, kv_len) of a cache k, v [S, Hkv, D]; keys at or past kv_len
// are never read. q [T, Hq, D] is regrouped per kv head into G*T rows
// (row = g*T + t, query head = kv_head*G + g), bias is [T, S] fp32.
//
// Bound: the kernel must read the live K and V once. At LLaVA-1.5-7B width
// (Hkv = 32, D = 128, bf16) that is 32*128*2*2 = 16 KB per cached position,
// so 10-14 MB at kv_len 640-895: about 3-4.5 us at 3.35 TB/s. q, bias and
// the output are a few KB. The work is far below the card's
// operations-per-byte ridge, so bytes are the bound.
//
// What the design does about it:
// - Split-KV: grid (Hkv * row groups, splits). Each block streams one
//   kChunk-key share of one kv head, so a T=1 step at kv_len ~700 puts ~700
//   blocks on the 132 SMs instead of 32; a second kernel merges the splits.
//   A block's work is one pass: each of its warps issues the K and V reads
//   of its kUnroll keys (16 rows of 256 bytes in flight per warp) together
//   with the q and bias reads before any arithmetic, so the block's time is
//   about one memory round trip, not one per key.
// - kv_len is read from device memory (no host value, so the launch can be
//   captured in a CUDA graph). Blocks whose share starts at or past kv_len
//   exit before any load; the combine pass reads only the live splits.
// - 32 lanes x 4 elements cover D = 128, so a key's K (and V) row of one
//   head is one coalesced 256-byte (bf16) read. Scores reduce by
//   interleaved warp shuffles; max, sum and the output accumulator stay in
//   fp32 registers (streaming softmax).
// - Rows per block is a template parameter: 1 for the AR row (no registers
//   spent on absent rows), 4 otherwise, where up to 4 grouped query rows
//   (a GQA group, or the T rows of a wider call) share each K/V read. The
//   row groups of a wider call re-read K/V: right for the verify shape, not
//   fast for it (the main path sends verify rows to the window-canonical
//   attention, not here).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC  (plain C interface, loaded with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;       // head dim
constexpr int kWarps = 4;     // warps per block (kWarps * 32 == kD)
constexpr int kUnroll = 8;    // keys per warp
constexpr int kChunk = kWarps * kUnroll;  // keys per split (one pass)
constexpr float kNegInf = -1e30f;  // the engine's finite mask value

__host__ __device__ constexpr int rows_for(int gt) { return gt == 1 ? 1 : 4; }

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

// One block: kv head h, row group rg (R rows), key share
// [split * kChunk, +kChunk) clipped to kv_len. Writes the share's partial
// (m, l, acc) for each of its rows.
template <typename T, int R>
__global__ void __launch_bounds__(kWarps * 32)
partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ bias,
               const int* __restrict__ kv_len_ptr,
               float* __restrict__ part_m, float* __restrict__ part_l,
               float* __restrict__ part_acc, int n_t, int hq, int hkv,
               int s, int n_splits, int n_rg, float scale) {
  const int hb = blockIdx.x;
  const int h = hb / n_rg;
  const int rg = hb % n_rg;
  const int split = blockIdx.y;
  const int g = hq / hkv;
  const int gt = g * n_t;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int start = split * kChunk;

  // q rows load alongside kv_len (independent addresses)
  float qr[R][4];
  int row_t[R];
  int n_rows = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = rg * R + r;
    row_t[r] = 0;
    qr[r][0] = qr[r][1] = qr[r][2] = qr[r][3] = 0.f;
    if (row < gt) {
      const int gi = row / n_t;
      const int ti = row % n_t;
      row_t[r] = ti;
      const float4 x = load4(q + ((size_t)ti * hq + (size_t)h * g + gi) * kD +
                             lane * 4);
      qr[r][0] = x.x; qr[r][1] = x.y; qr[r][2] = x.z; qr[r][3] = x.w;
      n_rows = r + 1;
    }
  }
  const int kv_len = min(*kv_len_ptr, s);
  if (start >= kv_len) return;  // dead share: never loaded, never merged
  const int end = min(start + kChunk, kv_len);

  // all of this warp's K, V and bias reads first
  const int base = start + warp * kUnroll;
  float4 kk[kUnroll], vv[kUnroll];
  float bs[R][kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = base + u;
    if (j < end) {
      const size_t off = ((size_t)j * hkv + h) * kD + lane * 4;
      kk[u] = load4(k + off);
      vv[u] = load4(v + off);
    } else {
      kk[u] = vv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      bs[r][u] = (j < end && r < n_rows) ? bias[(size_t)row_t[r] * s + j]
                                         : 0.f;
  }

  float m[R], l[R], acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    if (r >= n_rows) continue;
    float sc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      sc[u] = qr[r][0] * kk[u].x + qr[r][1] * kk[u].y + qr[r][2] * kk[u].z +
              qr[r][3] * kk[u].w;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o);
    }
    float mm = kNegInf;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // keys past this share carry no weight (and were never loaded)
      sc[u] = base + u < end ? sc[u] * scale + bs[r][u] : -CUDART_INF_F;
      mm = fmaxf(mm, sc[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = expf(sc[u] - mm);
      l[r] += p;
      acc[r][0] += p * vv[u].x;
      acc[r][1] += p * vv[u].y;
      acc[r][2] += p * vv[u].z;
      acc[r][3] += p * vv[u].w;
    }
    m[r] = mm;
  }

  // merge the warps' states; thread d owns output column d
  __shared__ float sm_m[kWarps][R];
  __shared__ float sm_l[kWarps][R];
  __shared__ float sm_acc[kWarps][R][kD];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sm_acc[warp][r][lane * 4 + i] = acc[r][i];
  }
  __syncthreads();

  const int d = threadIdx.x;
  const size_t pbase = ((size_t)hb * n_splits + split) * R;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= n_rows) break;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][r]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][r] - mm);
      ll += sm_l[w][r] * f;
      aa += sm_acc[w][r][d] * f;
    }
    part_acc[(pbase + r) * kD + d] = aa;
    if (d == 0) {
      part_m[pbase + r] = mm;
      part_l[pbase + r] = ll;
    }
  }
}

// One block per (kv head, row group): merge the live splits, normalise,
// cast to the output dtype and write out[t, kv_head*G + g, :].
template <typename T, int R>
__global__ void __launch_bounds__(kD)
combine_kernel(const float* __restrict__ part_m,
               const float* __restrict__ part_l,
               const float* __restrict__ part_acc,
               const int* __restrict__ kv_len_ptr, T* __restrict__ out,
               int n_t, int hq, int hkv, int s, int n_splits, int n_rg) {
  const int hb = blockIdx.x;
  const int h = hb / n_rg;
  const int rg = hb % n_rg;
  const int g = hq / hkv;
  const int gt = g * n_t;
  const int d = threadIdx.x;
  const int kv_len = min(*kv_len_ptr, s);
  const int n_live = kv_len > 0 ? (kv_len + kChunk - 1) / kChunk : 0;
  for (int r = 0; r < R; ++r) {
    const int row = rg * R + r;
    if (row >= gt) break;
    const size_t p0 = (size_t)hb * n_splits * R + r;
    float mm = kNegInf;
#pragma unroll 8
    for (int sp = 0; sp < n_live; ++sp)
      mm = fmaxf(mm, part_m[p0 + (size_t)sp * R]);
    float ll = 0.f, aa = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < n_live; ++sp) {
      const size_t p = p0 + (size_t)sp * R;
      const float f = expf(part_m[p] - mm);
      ll += part_l[p] * f;
      aa += part_acc[p * kD + d] * f;
    }
    const int gi = row / n_t;
    const int ti = row % n_t;
    store1(out + ((size_t)ti * hq + (size_t)h * g + gi) * kD + d,
           aa / fmaxf(ll, 1e-20f));
  }
}

template <typename T, int R>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* kv_len, void* part_m, void* part_l, void* part_acc,
           void* out, int n_t, int hq, int hkv, int s, float scale,
           cudaStream_t stream) {
  const int n_rg = ((hq / hkv) * n_t + R - 1) / R;
  const int n_splits = (s + kChunk - 1) / kChunk;
  dim3 grid(hkv * n_rg, n_splits);
  partial_kernel<T, R><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(kv_len), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), n_t, hq,
      hkv, s, n_splits, n_rg, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<T, R><<<hkv * n_rg, kD, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<const int*>(kv_len),
      static_cast<T*>(out), n_t, hq, hkv, s, n_splits, n_rg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const void* q, const void* k, const void* v, const void* bias,
                const void* kv_len, void* part_m, void* part_l,
                void* part_acc, void* out, int n_t, int hq, int hkv, int s,
                float scale, cudaStream_t stream) {
  if (rows_for((hq / hkv) * n_t) == 1)
    return launch<T, 1>(q, k, v, bias, kv_len, part_m, part_l, part_acc, out,
                        n_t, hq, hkv, s, scale, stream);
  return launch<T, 4>(q, k, v, bias, kv_len, part_m, part_l, part_acc, out,
                      n_t, hq, hkv, s, scale, stream);
}

}  // namespace

extern "C" {

// Scratch the caller allocates: part_m and part_l hold this many floats
// each, part_acc this many times the head dim.
long long decode_attention_partials(int n_t, int hq, int hkv, int s) {
  const long long gt = (long long)(hq / hkv) * n_t;
  const long long r = rows_for((int)gt);
  const long long n_rg = (gt + r - 1) / r;
  const long long n_splits = (s + kChunk - 1) / kChunk;
  return (long long)hkv * n_rg * n_splits * r;
}

int decode_attention_head_dim() { return kD; }

// dtype: 0 = bf16, 1 = fp32 (q, k, v and out share it). Returns the CUDA
// error code of the launches (0 = launched).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* bias, const void* kv_len,
                            void* part_m, void* part_l, void* part_acc,
                            void* out, int n_t, int hq, int hkv, int s,
                            int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rows<__nv_bfloat16>(q, k, v, bias, kv_len, part_m, part_l,
                                      part_acc, out, n_t, hq, hkv, s, scale,
                                      st);
  if (dtype == 1)
    return launch_rows<float>(q, k, v, bias, kv_len, part_m, part_l,
                              part_acc, out, n_t, hq, hkv, s, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
