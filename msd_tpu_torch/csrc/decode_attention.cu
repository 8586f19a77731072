// Length-aware decode attention over the seq-major KV cache (Hopper), one
// launch per call.
//
// Replaces the TPU kernel msd_tpu/ops/pallas/decode_attention.py
// (decode_attention, body _kernel, block picker _pick_block_s): per head,
//   out = softmax(q k^T / sqrt(D) + bias) v
// over keys [0, kv_len) of a cache k, v [S, Hkv, D]; keys at or past kv_len
// are never read. q [T, Hq, D] is regrouped per kv head into G*T rows
// (row = g*T + t, query head = kv_head*G + g), bias is [T, S] fp32. The
// softmax state (max, sum, accumulator) and the probabilities stay fp32:
// the Pallas kernel's VPU regime, which the AR decode row takes.
//
// Bound: the kernel must read the live K and V once. At the AR shape of
// LLaVA-1.5-7B (T = 1, Hq = Hkv = 32, D = 128, bf16) that is 16 KB per
// cached position: 11.0 MB at kv_len 672, 3.29 us at 3.35 TB/s. q, bias
// and the output are a few KB; the work is far below the card's
// operations-per-byte ridge, so bytes are the bound.
//
// The first version (two kernels: one-pass 32-key blocks, then a combine
// pass) reached a fifth of that bound. Its three faults, and what this
// design does about each:
// 1. Two launches and a serial combine on 32 of 132 SMs, each thread
//    walking ~21 splits by dependent global loads. Here the splits of one
//    (kv head, row group) merge inside the same launch, in one round
//    trip: they form a thread-block cluster, every block stores its fp32
//    state (m, l, acc[D]) into rank 0's shared memory (distributed shared
//    memory) and arrives at one cluster barrier, and rank 0 merges in
//    split order, so the same inputs give bitwise the same output
//    whatever order the blocks finish in. No global scratch, no counters:
//    a merge through global scratch and an arrival counter measured
//    0.4-0.6 us slower on the H100.
// 2. Blocks that made one memory round trip and exited. Here each block
//    streams its key range through a ring of kStages shared-memory stages
//    of kStageKeys keys (K rows, V rows and the bias of each row) filled
//    by 16-byte cp.async copies: while stage i is scored and accumulated,
//    stages i+1 .. i+kStages-1 are in flight. That is 16 KB of K/V ahead
//    per block (bf16), ~3.6 MB across the card at the AR shape, about
//    what 3.35 TB/s times ~1 us of latency needs; deeper rings (4 and 6
//    stages) and other stage sizes (8 and 32 keys) measured no faster
//    on the H100.
// 3. A grid sized by S, most of whose blocks read kv_len and exited. Here
//    the grid is (n_split, Hkv * row groups) with n_split chosen by the
//    caller from the SM count (about 1.7 blocks per SM, at most 8, the
//    portable cluster size); block `split` takes keys
//    [split*c, min((split+1)*c, kv_len)) with c = ceil(kv_len / n_split),
//    from the device kv_len. The load is even at every kv_len; a block
//    whose range is empty (kv_len < n_split) keeps the neutral state
//    (m = -1e30, l = 0) and the merge weighs it zero.
//
// kv_len is read from device memory and no host value derived from it
// sizes anything, so a launch can be captured in a CUDA graph and
// replayed at another kv_len. Keys past a block's range are zero-filled
// by the copies (never read) and carry no weight.
//
// Rows per block is a template parameter: 1 for the AR row (no registers
// spent on absent rows), 4 otherwise, where up to 4 grouped query rows (a
// GQA group, or T <= 4) share each K/V stage. A wider call (G*T > 4: the
// verify-shaped and fp32 checks) runs as row groups of 4 that re-read
// K/V, correct but not fast for it; a tensor-core regime for wide rows
// (the Pallas MXU regime) is open.
//
// Each block is 4 warps; a stage's 16 keys go 4 to a warp, and 32 lanes x
// 4 elements cover D = 128, so a warp scores a key by one 256-byte (bf16)
// shared-memory row read and an interleaved shuffle reduction. The warps
// of a block merge through shared memory, in warp order, before the
// splits merge.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC  (plain C interface, loaded with ctypes; no
//             TMA tensor maps, so no -lcuda).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kD = 128;         // head dim
constexpr int kWarps = 4;       // warps per block (kWarps * 32 == kD)
constexpr int kThreads = kWarps * 32;
constexpr int kStageKeys = 16;  // keys per pipeline stage
constexpr int kKeysPerWarp = kStageKeys / kWarps;
constexpr int kStages = 3;      // ring depth: kStages - 1 stages in flight
constexpr int kMaxSplits = 8;   // portable thread-block-cluster size
constexpr float kNegInf = -1e30f;  // the engine's finite mask value

// One stage of the ring: K rows, V rows, then the bias of each row.
template <typename T, int R>
struct Stage {
  static constexpr int kRowBytes = kD * (int)sizeof(T);
  static constexpr int kKVBytes = kStageKeys * kRowBytes;  // K or V
  static constexpr int kBytes = 2 * kKVBytes + R * kStageKeys * 4;
  static constexpr int kRingBytes = kStages * kBytes;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// Issue the copies of the stage whose first key is key0 into `slot`: every
// thread takes an equal share of the K and V 16-byte chunks; keys at or
// past `end` are zero-filled without a read.
template <typename T, int R>
__device__ __forceinline__ void issue_stage(char* slot, const T* k,
                                            const T* v, const float* bias,
                                            int key0, int end, int h,
                                            int hkv, int s, int n_t, int row0,
                                            int n_rows) {
  using St = Stage<T, R>;
  constexpr int kChunksPerRow = St::kRowBytes / 16;
  constexpr int kChunks = kStageKeys * kChunksPerRow;
  static_assert(kChunks % kThreads == 0, "chunks split evenly");
  const int tid = threadIdx.x;
  const char* kb = reinterpret_cast<const char*>(k);
  const char* vb = reinterpret_cast<const char*>(v);
#pragma unroll
  for (int u = 0; u < kChunks / kThreads; ++u) {
    const int c = tid + u * kThreads;
    const int j = key0 + c / kChunksPerRow;
    const bool ok = j < end;
    const size_t off =
        ok ? ((size_t)j * hkv + h) * St::kRowBytes + (c % kChunksPerRow) * 16
           : 0;
    cp_async16(slot + c * 16, kb + off, ok);
    cp_async16(slot + St::kKVBytes + c * 16, vb + off, ok);
  }
  if (tid < R * kStageKeys) {
    const int r = tid / kStageKeys;
    const int j = key0 + tid % kStageKeys;
    const bool ok = j < end && r < n_rows;
    const float* src =
        ok ? bias + (size_t)((row0 + r) % n_t) * s + j : bias;
    cp_async4(slot + 2 * St::kKVBytes + tid * 4, src, ok);
  }
}

// One block: split `blockIdx.x` of the key range of kv head h, row group
// rg (R rows). Streams its keys through the ring and merges its warps;
// rank 0 of the cluster of (h, rg) merges the n_split blocks and writes
// out[t, h*G + g, :] in the output dtype.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ bias,
              const int* __restrict__ kv_len_ptr, T* __restrict__ out,
              int n_t, int hq, int hkv, int s, int n_split, float scale) {
  using St = Stage<T, R>;
  extern __shared__ __align__(16) char ring[];
  __shared__ float w_m[kWarps][R], w_l[kWarps][R], w_acc[kWarps][R][kD];

  const int split = blockIdx.x;
  const int hb = blockIdx.y;
  const int g = hq / hkv;
  const int gt = g * n_t;
  const int n_rg = (gt + R - 1) / R;
  const int h = hb / n_rg;
  const int row0 = (hb % n_rg) * R;
  const int n_rows = min(R, gt - row0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // matched by the wait before the stores into rank 0's shared memory
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // the q rows load alongside kv_len (independent addresses)
  float qr[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    qr[r][0] = qr[r][1] = qr[r][2] = qr[r][3] = 0.f;
    if (r < n_rows) {
      const int row = row0 + r;
      const float4 x = load4(q + ((size_t)(row % n_t) * hq +
                                  (size_t)h * g + row / n_t) * kD +
                             lane * 4);
      qr[r][0] = x.x; qr[r][1] = x.y; qr[r][2] = x.z; qr[r][3] = x.w;
    }
  }
  const int kv_len = max(0, min(*kv_len_ptr, s));
  const int c = (kv_len + n_split - 1) / n_split;
  const int start = min(split * c, kv_len);
  const int end = min(start + c, kv_len);
  const int n_st = (end - start + kStageKeys - 1) / kStageKeys;

  // prologue: the first kStages - 1 stages in flight (empty groups keep
  // the group count uniform)
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_st)
      issue_stage<T, R>(ring + i * St::kBytes, k, v, bias,
                        start + i * kStageKeys, end, h, hkv, s, n_t, row0,
                        n_rows);
    cp_async_commit();
  }

  float m[R], l[R], acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }

  for (int i = 0; i < n_st; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage i landed
    __syncthreads();               // everyone's have; slot i-1 is free
    const int nx = i + kStages - 1;
    if (nx < n_st)
      issue_stage<T, R>(ring + (nx % kStages) * St::kBytes, k, v, bias,
                        start + nx * kStageKeys, end, h, hkv, s, n_t, row0,
                        n_rows);
    cp_async_commit();

    const char* st = ring + (i % kStages) * St::kBytes;
    const T* ks = reinterpret_cast<const T*>(st);
    const T* vs = reinterpret_cast<const T*>(st + St::kKVBytes);
    const float* bs = reinterpret_cast<const float*>(st + 2 * St::kKVBytes);
    const int kw = warp * kKeysPerWarp;  // this warp's keys in the stage
    const int key0 = start + i * kStageKeys + kw;
    float4 kk[kKeysPerWarp], vv[kKeysPerWarp];
#pragma unroll
    for (int u = 0; u < kKeysPerWarp; ++u) {
      kk[u] = load4(ks + (kw + u) * kD + lane * 4);
      vv[u] = load4(vs + (kw + u) * kD + lane * 4);
    }
    float sc[R][kKeysPerWarp];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int u = 0; u < kKeysPerWarp; ++u)
        sc[r][u] = qr[r][0] * kk[u].x + qr[r][1] * kk[u].y +
                   qr[r][2] * kk[u].z + qr[r][3] * kk[u].w;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int u = 0; u < kKeysPerWarp; ++u)
          sc[r][u] += __shfl_xor_sync(0xffffffffu, sc[r][u], o);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= n_rows) break;
      float mm = m[r];
#pragma unroll
      for (int u = 0; u < kKeysPerWarp; ++u) {
        // keys past the range carry no weight (their rows are zeros)
        sc[r][u] = key0 + u < end
                       ? sc[r][u] * scale + bs[r * kStageKeys + kw + u]
                       : -CUDART_INF_F;
        mm = fmaxf(mm, sc[r][u]);
      }
      const float corr = expf(m[r] - mm);
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] *= corr;
#pragma unroll
      for (int u = 0; u < kKeysPerWarp; ++u) {
        const float p = expf(sc[r][u] - mm);
        l[r] += p;
        acc[r][0] += p * vv[u].x;
        acc[r][1] += p * vv[u].y;
        acc[r][2] += p * vv[u].z;
        acc[r][3] += p * vv[u].w;
      }
      m[r] = mm;
    }
  }
  cp_async_wait<0>();

  // merge the warps in warp order; thread d owns output column d and
  // holds this block's state (bm, bl, ba) of each row
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      w_m[warp][r] = m[r];
      w_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) w_acc[warp][r][lane * 4 + e] = acc[r][e];
  }
  __syncthreads();
  const int d = threadIdx.x;
  float bm[R], bl[R], ba[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bm[r] = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) bm[r] = fmaxf(bm[r], w_m[w][r]);
    bl[r] = ba[r] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(w_m[w][r] - bm[r]);
      bl[r] += w_l[w][r] * f;
      ba[r] += w_acc[w][r][d] * f;
    }
  }

  // the cluster is the n_split blocks of (h, rg), rank == split: every
  // block stores its state into slot `split` of rank 0's shared memory
  // and arrives (release); only rank 0 waits (acquire), merges in split
  // order and writes. No block reads another's shared memory, so the
  // others exit.
  __shared__ float c_m[R][kMaxSplits], c_l[R][kMaxSplits];
  __shared__ float c_acc[R][kMaxSplits][kD];
  cg::cluster_group cluster = cg::this_cluster();
  // every block of the cluster has started (arrived at the top), so rank
  // 0's shared memory exists
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= n_rows) break;
    *cluster.map_shared_rank(&c_acc[r][split][d], 0) = ba[r];
    if (d == 0) {
      *cluster.map_shared_rank(&c_m[r][split], 0) = bm[r];
      *cluster.map_shared_rank(&c_l[r][split], 0) = bl[r];
    }
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (split != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= n_rows) break;
    float mm = kNegInf;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < n_split) mm = fmaxf(mm, c_m[r][sp]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      if (sp < n_split) {
        const float f = expf(c_m[r][sp] - mm);
        ll += c_l[r][sp] * f;
        aa += c_acc[r][sp][d] * f;
      }
    }
    const int row = row0 + r;
    store1(out + ((size_t)(row % n_t) * hq + (size_t)h * g + row / n_t) * kD +
               d,
           aa / fmaxf(ll, 1e-20f));
  }
}

template <typename T, int R>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* kv_len, void* out, int n_t, int hq, int hkv, int s,
           int n_split, float scale, cudaStream_t stream) {
  auto kern = decode_kernel<T, R>;
  constexpr int smem = Stage<T, R>::kRingBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_rg = ((hq / hkv) * n_t + R - 1) / R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, hkv * n_rg, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(kv_len), static_cast<T*>(out), n_t, hq, hkv, s,
      n_split, scale);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it; the caller raises
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(int rows, const void* q, const void* k, const void* v,
                const void* bias, const void* kv_len, void* out, int n_t,
                int hq, int hkv, int s, int n_split, float scale,
                cudaStream_t stream) {
  if (rows == 1)
    return launch<T, 1>(q, k, v, bias, kv_len, out, n_t, hq, hkv, s, n_split,
                        scale, stream);
  return launch<T, 4>(q, k, v, bias, kv_len, out, n_t, hq, hkv, s, n_split,
                      scale, stream);
}

}  // namespace

extern "C" {

int decode_attention_head_dim() { return kD; }

// Dynamic shared memory of one block (the stage ring), in bytes.
int decode_attention_smem_bytes(int dtype, int rows) {
  if (dtype == 0)
    return rows == 1 ? Stage<__nv_bfloat16, 1>::kRingBytes
                     : Stage<__nv_bfloat16, 4>::kRingBytes;
  return rows == 1 ? Stage<float, 1>::kRingBytes : Stage<float, 4>::kRingBytes;
}

// dtype: 0 = bf16, 1 = fp32 (q, k, v and out share it). rows: 1 (only
// when G*T == 1) or 4. n_split: 1..kMaxSplits, the cluster size. Returns
// the CUDA error code of the launch (0 = launched).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* bias, const void* kv_len, void* out,
                            int n_t, int hq, int hkv, int s, int rows,
                            int n_split, int dtype, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((rows != 1 && rows != 4) || (rows == 1 && (hq / hkv) * n_t != 1) ||
      n_split < 1 || n_split > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_rows<__nv_bfloat16>(rows, q, k, v, bias, kv_len, out, n_t,
                                      hq, hkv, s, n_split, scale, st);
  if (dtype == 1)
    return launch_rows<float>(rows, q, k, v, bias, kv_len, out, n_t, hq, hkv,
                              s, n_split, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
