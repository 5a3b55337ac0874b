// PyTorch binding of the port's CUDA kernels.  The kernels themselves live in
// the .cu files behind plain C entry points, so only this small file includes
// PyTorch's headers.  Shapes, dtypes, devices and contiguity are checked by
// the Python wrappers (repro_torch/kernels/*/kernel.py) before these run.
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>

extern "C" cudaError_t pair_scores_launch(const float* a, const float* b,
                                          float* scores, int* counts, int n,
                                          int m, int d, int m_valid, float tau,
                                          cudaStream_t stream);

extern "C" cudaError_t pair_scores_compact_launch(
    const float* a, const float* b, const int* ida, const int* idb,
    unsigned long long* status, int* rows, int* cols, float* scores,
    int* n_total, int T, int bn, int bm, int d, float tau, int capacity,
    cudaStream_t stream);

extern "C" cudaError_t union_deduce_launch(
    const int* parent0, const int* u, const int* v, const uint8_t* pos,
    const int* neg_keys, int* roots, int* deduced, int* conflict, int* error,
    int* scratch, int B, int n, int P, int pair_slice, int table_size,
    int stride, int smem, int max_trips, cudaStream_t stream);

extern "C" cudaError_t union_deduce_wide_launch(
    const int* parent0, const int* u, const int* v, const uint8_t* pos,
    const long long* neg_keys, int* roots, int* deduced, int* conflict,
    int* error, int* scratch, int B, int n, int P, int pair_slice,
    int table_size, int stride, int max_trips, cudaStream_t stream);

extern "C" cudaError_t union_deduce_max_clusters(int smem, int wide,
                                                int* count);

extern "C" cudaError_t flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int K, int d, const long long* strides, float scale, cudaStream_t stream);

extern "C" cudaError_t flash_attention_bf16_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int K, int d, const long long* strides, float scale, cudaStream_t stream);

extern "C" int decode_attention_plan(int kv_dtype, int B, int S, int H,
                                     int K, int d, int* splits, int* chunk);

extern "C" cudaError_t decode_attention_launch(
    const void* q, const void* kc, const void* vc, const void* ks,
    const void* vs, const int* length, void* o, float* ws, int* counters,
    long long n_counters, int q_dtype, int kv_dtype, int B, int S, int H,
    int K, int d, const long long* strides, float scale,
    cudaStream_t stream);

namespace {

// 0 = f32, 1 = bf16, 2 = int8 (decode_attention's int8 cache).
int dtype_code(const torch::Tensor& x) {
  if (x.scalar_type() == torch::kChar) return 2;
  return x.scalar_type() == torch::kBFloat16 ? 1 : 0;
}

void pair_scores(const torch::Tensor& a, const torch::Tensor& b,
                 const torch::Tensor& scores,
                 const torch::Tensor& counts, int64_t m_valid,
                 double tau) {
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream();
  C10_CUDA_CHECK(pair_scores_launch(
      a.data_ptr<float>(), b.data_ptr<float>(), scores.data_ptr<float>(),
      counts.data_ptr<int>(), static_cast<int>(a.size(0)),
      static_cast<int>(b.size(0)), static_cast<int>(a.size(1)),
      static_cast<int>(m_valid), static_cast<float>(tau), stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void pair_scores_compact(const torch::Tensor& a_g, const torch::Tensor& b_g,
                         const torch::Tensor& ida, const torch::Tensor& idb,
                         const torch::Tensor& status,
                         const torch::Tensor& rows, const torch::Tensor& cols,
                         const torch::Tensor& scores,
                         const torch::Tensor& n_total, int64_t bn, int64_t bm,
                         double tau, int64_t capacity) {
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream();
  C10_CUDA_CHECK(pair_scores_compact_launch(
      a_g.data_ptr<float>(), b_g.data_ptr<float>(), ida.data_ptr<int>(),
      idb.data_ptr<int>(),
      reinterpret_cast<unsigned long long*>(status.data_ptr<int64_t>()),
      rows.data_ptr<int>(), cols.data_ptr<int>(), scores.data_ptr<float>(),
      n_total.data_ptr<int>(), static_cast<int>(status.size(0) - 1),
      static_cast<int>(bn), static_cast<int>(bm), static_cast<int>(a_g.size(1)),
      static_cast<float>(tau), static_cast<int>(capacity), stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// One launch of B clusters of 16 blocks; the plan's figures come from
// repro_torch/kernels/union_deduce/kernel.py::plan.
void union_deduce(const torch::Tensor& parent0, const torch::Tensor& u,
                  const torch::Tensor& v, const torch::Tensor& pos,
                  const torch::Tensor& neg_keys, const torch::Tensor& roots,
                  const torch::Tensor& deduced, const torch::Tensor& conflict,
                  const torch::Tensor& error, const torch::Tensor& scratch,
                  int64_t pair_slice, int64_t table_size, int64_t smem,
                  int64_t max_trips) {
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream();
  C10_CUDA_CHECK(union_deduce_launch(
      parent0.data_ptr<int>(), u.data_ptr<int>(), v.data_ptr<int>(),
      pos.data_ptr<uint8_t>(), neg_keys.data_ptr<int>(), roots.data_ptr<int>(),
      deduced.data_ptr<int>(), conflict.data_ptr<int>(), error.data_ptr<int>(),
      scratch.data_ptr<int>(), static_cast<int>(parent0.size(0)),
      static_cast<int>(parent0.size(1)), static_cast<int>(u.size(1)),
      static_cast<int>(pair_slice),
      static_cast<int>(table_size), static_cast<int>(scratch.size(1)),
      static_cast<int>(smem), static_cast<int>(max_trips), stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The wide kernel (n > 46340, int64 keys): one launch of B clusters of 16
// blocks, no dynamic shared memory.
void union_deduce_wide(const torch::Tensor& parent0, const torch::Tensor& u,
                       const torch::Tensor& v, const torch::Tensor& pos,
                       const torch::Tensor& neg_keys,
                       const torch::Tensor& roots,
                       const torch::Tensor& deduced,
                       const torch::Tensor& conflict,
                       const torch::Tensor& error,
                       const torch::Tensor& scratch, int64_t pair_slice,
                       int64_t table_size, int64_t max_trips) {
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream();
  C10_CUDA_CHECK(union_deduce_wide_launch(
      parent0.data_ptr<int>(), u.data_ptr<int>(), v.data_ptr<int>(),
      pos.data_ptr<uint8_t>(),
      reinterpret_cast<const long long*>(neg_keys.data_ptr<int64_t>()),
      roots.data_ptr<int>(), deduced.data_ptr<int>(),
      conflict.data_ptr<int>(), error.data_ptr<int>(),
      scratch.data_ptr<int>(), static_cast<int>(parent0.size(0)),
      static_cast<int>(parent0.size(1)), static_cast<int>(u.size(1)),
      static_cast<int>(pair_slice), static_cast<int>(table_size),
      static_cast<int>(scratch.size(1)), static_cast<int>(max_trips),
      stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Clusters of union_deduce blocks with `smem` bytes of dynamic shared
// memory each (of the wide kernel's, with `wide`) that the current device
// can hold at once; sets the kernel's attributes on the device first.
int64_t union_deduce_clusters(int64_t smem, bool wide) {
  int count = 0;
  C10_CUDA_CHECK(union_deduce_max_clusters(static_cast<int>(smem),
                                           wide ? 1 : 0, &count));
  return count;
}

// Both flash kernels take (q, k, v, o, B, S, H, K, d, 12 element strides
// of q, k, v, o, scale, stream); the Python wrapper picks one by dtype.
using FlashLaunch = cudaError_t (*)(const void*, const void*, const void*,
                                    void*, int, int, int, int, int,
                                    const long long*, float, cudaStream_t);

void flash(FlashLaunch launch, const torch::Tensor& q,
           const torch::Tensor& k, const torch::Tensor& v,
           const torch::Tensor& o, double scale) {
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream();
  const long long strides[12] = {
      q.stride(0), q.stride(1), q.stride(2), k.stride(0),
      k.stride(1), k.stride(2), v.stride(0), v.stride(1),
      v.stride(2), o.stride(0), o.stride(1), o.stride(2)};
  C10_CUDA_CHECK(launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
      static_cast<int>(q.size(0)), static_cast<int>(q.size(1)),
      static_cast<int>(q.size(2)), static_cast<int>(k.size(2)),
      static_cast<int>(q.size(3)), strides, static_cast<float>(scale),
      stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// f32: the SIMT kernel of flash_attention.cu.
void flash_attention_f32(const torch::Tensor& q, const torch::Tensor& k,
                         const torch::Tensor& v, const torch::Tensor& o,
                         double scale) {
  flash(flash_attention_launch, q, k, v, o, scale);
}

// bf16: the tensor-core kernel of flash_attention_wgmma.cu.
void flash_attention_bf16(const torch::Tensor& q, const torch::Tensor& k,
                          const torch::Tensor& v, const torch::Tensor& o,
                          double scale) {
  flash(flash_attention_bf16_launch, q, k, v, o, scale);
}

// (splits, chunk) of decode_attention's launch for these shapes.
std::vector<int64_t> decode_attention_split(const torch::Tensor& q,
                                            const torch::Tensor& k_cache) {
  int splits = 0, chunk = 0;
  TORCH_CHECK(decode_attention_plan(
                  dtype_code(k_cache), static_cast<int>(q.size(0)),
                  static_cast<int>(k_cache.size(1)),
                  static_cast<int>(q.size(1)),
                  static_cast<int>(k_cache.size(2)),
                  static_cast<int>(q.size(2)), &splits, &chunk),
              "decode_attention: no launch plan for this shape");
  return {splits, chunk};
}

// The launch over any cache: k_scale and v_scale are defined for an int8
// cache and undefined tensors otherwise.
void decode(const torch::Tensor& q, const torch::Tensor& k_cache,
            const torch::Tensor& v_cache, const torch::Tensor& k_scale,
            const torch::Tensor& v_scale, const torch::Tensor& length,
            const torch::Tensor& o, const torch::Tensor& counters,
            double scale) {
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream();
  const int64_t splits = decode_attention_split(q, k_cache)[0];
  // the splits' partials (m, l, acc[d]), written and read inside the launch
  const torch::Tensor ws = torch::empty(
      {q.size(0) * q.size(1) * splits * (q.size(2) + 2)},
      q.options().dtype(torch::kFloat32));
  const bool q8 = k_scale.defined();
  auto st = [q8](const torch::Tensor& t, int i) -> long long {
    return q8 ? t.stride(i) : 0;
  };
  const long long strides[16] = {
      q.stride(0),       q.stride(1),       k_cache.stride(0),
      k_cache.stride(1), k_cache.stride(2), v_cache.stride(0),
      v_cache.stride(1), v_cache.stride(2), o.stride(0),
      o.stride(1),       st(k_scale, 0),    st(k_scale, 1),
      st(k_scale, 2),    st(v_scale, 0),    st(v_scale, 1),
      st(v_scale, 2)};
  C10_CUDA_CHECK(decode_attention_launch(
      q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
      q8 ? k_scale.data_ptr() : nullptr, q8 ? v_scale.data_ptr() : nullptr,
      length.data_ptr<int>(), o.data_ptr(), ws.data_ptr<float>(),
      counters.data_ptr<int>(), counters.numel(), dtype_code(q),
      dtype_code(k_cache), static_cast<int>(q.size(0)),
      static_cast<int>(k_cache.size(1)), static_cast<int>(q.size(1)),
      static_cast<int>(k_cache.size(2)), static_cast<int>(q.size(2)),
      strides, static_cast<float>(scale), stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void decode_attention(const torch::Tensor& q, const torch::Tensor& k_cache,
                      const torch::Tensor& v_cache,
                      const torch::Tensor& length, const torch::Tensor& o,
                      const torch::Tensor& counters, double scale) {
  decode(q, k_cache, v_cache, torch::Tensor(), torch::Tensor(), length, o,
         counters, scale);
}

// An int8 cache with its bf16 scales (B, S, K), dequantized in the kernel.
void decode_attention_int8(const torch::Tensor& q,
                           const torch::Tensor& k_cache,
                           const torch::Tensor& v_cache,
                           const torch::Tensor& k_scale,
                           const torch::Tensor& v_scale,
                           const torch::Tensor& length,
                           const torch::Tensor& o,
                           const torch::Tensor& counters, double scale) {
  decode(q, k_cache, v_cache, k_scale, v_scale, length, o, counters, scale);
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("pair_scores", &pair_scores, "thresholded pair scores (CUDA)");
  m.def("pair_scores_compact", &pair_scores_compact,
        "thresholded pair scores compacted over gathered tiles (CUDA)");
  m.def("union_deduce", &union_deduce,
        "fused union + deduce, a cluster of blocks a lane (CUDA)");
  m.def("union_deduce_wide", &union_deduce_wide,
        "fused union + deduce past 46340 objects, int64 keys (CUDA)");
  m.def("union_deduce_max_clusters", &union_deduce_clusters,
        "union_deduce clusters the device can hold at once");
  m.def("flash_attention_f32", &flash_attention_f32,
        "causal GQA flash attention, f32, SIMT (CUDA)");
  m.def("flash_attention_bf16", &flash_attention_bf16,
        "causal GQA flash attention, bf16, TMA + wgmma (CUDA)");
  m.def("decode_attention", &decode_attention,
        "one-token attention over a KV cache, split across it (CUDA)");
  m.def("decode_attention_int8", &decode_attention_int8,
        "one-token attention over an int8 KV cache with bf16 scales (CUDA)");
  m.def("decode_attention_split", &decode_attention_split,
        "(splits, chunk) of decode_attention's launch");
}
