// The CUDA implementation of every resnetc:: op: the port's kernel launches
// as torch custom ops, for a Python process and for the serving binary
// (native/aoti_serve.cpp), which runs an AOTInductor package with no Python
// in the process.
//
// A Python process defines the ops (ops/cuda/_build.kernel_op: schema, CPU
// implementation = the plain version, fake) when it imports the wrappers,
// and loads this library before its first launch: it then adds only the
// CUDA implementations below.  The serving binary has defined nothing, so
// the library defines the schemas too (define_schemas), string for string
// those of the Python registrations (tests/test_torch_export.py holds the
// two lists equal), so a graph exported from Python calls these
// implementations by name.  Each implementation derives the geometry from
// the shapes, allocates the output and the kernel's scratch (no op writes
// to an input), launches the extern "C" entry of csrc/<name>.cu on the
// current stream and checks its cudaError_t.  The Python wrappers check
// dtypes and shapes before they call an op; the checks here are those a
// launch needs: the device, dense operands, 4-byte aligned int8 operands.
//
// The extern "C" entries are looked up in the kernel libraries of the same
// build (RESNETC_KERNEL_DIR/lib<source>.so), each opened on its own with
// RTLD_LOCAL: every library links its own static CUDA runtime, and
// libraries loaded into one symbol scope would let one library's runtime
// symbols serve another's kernels (the launches then fail with
// cudaErrorMissingConfiguration).  Built at first use by
// ops/cuda/_build.build_all() with g++ against the torch wheel's headers,
// in parallel with the kernel libraries.

#include <cuda_runtime_api.h>
#include <dlfcn.h>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <cstdint>
#include <optional>
#include <string>
#include <utility>

#ifndef RESNETC_KERNEL_DIR
#error "build with -DRESNETC_KERNEL_DIR=\"<the kernel libraries' directory>\""
#endif

// The launchers' signatures (csrc/*.cu); only their types are used here.
extern "C" {
int chain_block_int8(const int8_t* x, int B, int h, int w, int hp, int wp, int cin, int c,
                     int c4, const int8_t* w1_nk, const float* sw1, const float* b1,
                     const int8_t* w2p_nk, const float* sw2p, const float* b2,
                     const int8_t* w3_nk, const float* sw3, const float* b3,
                     const float* scales, int unit_y, const int8_t* wd_nk, const float* swd,
                     const float* bd, int8_t* z1, int8_t* z2, float* y, int out_kind, void* out,
                     float inv_hw, cudaStream_t stream);
int chain_run_int8(const int8_t* x, int n_blocks, int B, int h, int w, int hp, int wp, int cin,
                   int c, int c4, const int8_t* w1s, const int8_t* w10, const float* sw1s,
                   const float* b1s, const int8_t* w2ps, const float* sw2ps, const float* b2s,
                   const int8_t* w3s, const float* sw3s, const float* b3s,
                   const float* scales_s, const int8_t* wd, const float* swd, const float* bd,
                   int8_t* z1, int8_t* z2, int8_t* act0, int8_t* act1, int last_bf16,
                   void* out, cudaStream_t stream);
int ds_block_s2_int8(const int8_t* x, int B, int h, int w, int hp, int wp, int cin, int c,
                     int c4, int oh, int ow, int hp2, int wp2, const int8_t* w1_nk,
                     const float* sw1, const float* b1, const int8_t* w2_nk, const float* sw2,
                     const float* b2, const int8_t* w3_nk, const float* sw3, const float* b3,
                     const int8_t* wd_nk, const float* swd, const float* bd,
                     const float* scales, int unit_y, int8_t* z1, int8_t* z2, int out_kind,
                     void* out, cudaStream_t stream);
int basic_block_int8(const int8_t* x, int B, int h, int w, int hp, int wp, int c,
                     const int8_t* w1_nk, const float* sw1p, const float* b1,
                     const int8_t* w2_nk, const float* sw2p, const float* b2,
                     const float* scales, int unit_y, int8_t* z1, int out_kind, void* out,
                     cudaStream_t stream);
int basic_run_int8(const int8_t* x, int n_blocks, int B, int h, int w, int hp, int wp, int c,
                   const int8_t* w1s_nk, const float* sw1ps, const float* b1s,
                   const int8_t* w2s_nk, const float* sw2ps, const float* b2s,
                   const float* scales_s, int8_t* z1, int8_t* act0, int8_t* act1,
                   int last_bf16, void* out, cudaStream_t stream);
int basic_ds_block_s2_int8(const int8_t* x, int B, int h, int w, int hp, int wp, int cin, int c,
                           int oh, int ow, int hp2, int wp2, const int8_t* w1_nk,
                           const float* sw1, const float* b1, const int8_t* w2_nk,
                           const float* sw2p, const float* b2, const int8_t* wd_nk,
                           const float* swd, const float* bd, const float* scales, int unit_y,
                           int8_t* z1, int out_kind, void* out, cudaStream_t stream);
int pp_block_int8(const int8_t* x, int B, int h, int w, int hp, int wp, int cin2, int c2,
                  int c4p, const int8_t* w1_nk, const float* sw1, const float* b1,
                  const int8_t* w2_nk, const float* sw2, const float* b2, const int8_t* w3_nk,
                  const float* sw3, const float* b3, const float* scales, int folded,
                  int unit_y, const int8_t* wd_nk, const float* swd, const float* bd,
                  int8_t* z1, int8_t* z2, int out_kind, void* out, cudaStream_t stream);
int pp_run_int8(const int8_t* x, int n_blocks, int B, int h, int w, int hp, int wp, int cin2,
                int c2, int c4p, const int8_t* w1s_nk, const int8_t* w10_nk, const float* sw1s,
                const float* b1s, const int8_t* w2s_nk, const float* sw2s, const float* b2s,
                const int8_t* w3s_nk, const float* sw3s, const float* b3s,
                const float* scales_s, int folded, const int8_t* wd_nk, const float* swd,
                const float* bd, int8_t* z1, int8_t* z2, int8_t* act0, int8_t* act1,
                int last_bf16, void* out, cudaStream_t stream);
int grouped_block_int8(const int8_t* x, int B, int h, int w, int hp, int wp, int cin, int c,
                       int c4, const int8_t* w1_nk, const float* sw1, const float* b1,
                       const int8_t* w2g_nk, int k2, const float* sw2, const float* b2,
                       const int8_t* w3_nk, const float* sw3, const float* b3,
                       const float* scales, int unit_y, const int8_t* wd_nk, const float* swd,
                       const float* bd, int8_t* z1, int8_t* z2, int out_kind, void* out,
                       cudaStream_t stream);
int grouped_ds_block_s2_int8(const int8_t* x, int B, int h, int w, int hp, int wp, int cin,
                             int c, int c4, int oh, int ow, int hp2, int wp2,
                             const int8_t* w1_nk, const float* sw1, const float* b1,
                             const int8_t* w2g_nk, int k2, const float* sw2, const float* b2,
                             const int8_t* w3_nk, const float* sw3, const float* b3,
                             const int8_t* wd_nk, const float* swd, const float* bd,
                             const float* scales, int unit_y, int8_t* z1, int8_t* z2,
                             int out_kind, void* out, cudaStream_t stream);
int pp_basic_block_int8(const int8_t* x, int B, int h, int w, int hp, int wp, int c2,
                        const int8_t* w1_nk, const float* a1, const float* c1,
                        const int8_t* w2_nk, const float* a2, const float* c2v,
                        const float* s_res, int8_t* z1, int out_kind, void* out,
                        cudaStream_t stream);
int pp_basic_run_int8(const int8_t* x, int n_blocks, int B, int h, int w, int hp, int wp,
                      int c2, const int8_t* w1s_nk, const float* a1s, const float* c1s,
                      const int8_t* w2s_nk, const float* a2s, const float* c2s,
                      const float* s_res, int8_t* z1, int8_t* act0, int8_t* act1,
                      int last_bf16, void* out, cudaStream_t stream);
long long gemm_workspace_floats(int M, int N, int K, int in_bf16);
int gemm_f32acc(const void* x, const void* w, const float* w_nk, const float* bias,
                const void* res, void* out, float* ws, int in_bf16, int res_kind, int out_bf16,
                int M, int N, int K, int relu, cudaStream_t stream);
long long int8_gemm_workspace_ints(int M, int N, int K);
int int8_gemm(const int8_t* x, const int8_t* w_nk, const float* sx, const float* sw,
              const float* bias, const void* res, void* out, int* ws, int res_kind,
              int out_bf16, int M, int N, int K, int relu, cudaStream_t stream);
int conv_fused(const void* x, const void* w, const float* w_nk, const float* bias,
               const void* res, void* out, int in_kind, int res_kind, int out_bf16, int B, int H,
               int W, int Cin, int OH, int OW, int Cout, int k, int stride, int relu,
               cudaStream_t stream);
int max_pool2d_nhwc(const void* x, void* out, int kind, int vec, int B, int H, int W, int C,
                    int OH, int OW, int k, int s, int p, cudaStream_t stream);
int avg_pool2d_nhwc(const void* x, void* out, int kind, int vec, int B, int H, int W, int C,
                    int OH, int OW, int k, int s, int p, float inv, cudaStream_t stream);
int stem_pool_int8(const void* y, const float* bias, const float* s_in, int8_t* out, int kind,
                   int B, int H1, int W1, int C, int H2, int W2, int hp, int wp,
                   cudaStream_t stream);
int fp_block(const void* x, const void* w1, const float* w1_nk, const float* b1, const void* w2,
             const float* w2_nk, const float* b2, const void* w3, const float* w3_nk,
             const float* b3, void* z1, void* z2, void* out, int kind, int chain, int B, int h,
             int w, int hp, int wp, int c, int c4, cudaStream_t stream);
int elementwise(int op, int kind, const void* a, const void* b, void* out, long long n,
                cudaStream_t stream);
}

namespace {

using at::Tensor;
using OptTensor = std::optional<Tensor>;

cudaStream_t stream() { return c10::cuda::getCurrentCUDAStream(); }

// The entry ``fn`` of RESNETC_KERNEL_DIR/lib<lib>.so, opened RTLD_LOCAL.
void* kernel_entry(const char* lib, const char* fn) {
  const std::string path = std::string(RESNETC_KERNEL_DIR) + "/lib" + lib + ".so";
  void* handle = dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
  TORCH_CHECK(handle != nullptr, "cannot load ", path, ": ", dlerror());
  void* sym = dlsym(handle, fn);
  TORCH_CHECK(sym != nullptr, "no ", fn, " in ", path);
  return sym;
}

// A pointer to launcher ``fn`` of library ``lib``, looked up once per call site.
#define LAUNCHER(lib, fn)                                                     \
  ([] {                                                                       \
    static auto* f = reinterpret_cast<decltype(&fn)>(kernel_entry(lib, #fn)); \
    return f;                                                                 \
  }())

void check(int rc, const char* what) {
  TORCH_CHECK(rc == 0, what, ": CUDA launch failed with cudaError_t ", rc);
}

void on_card(const Tensor& x, const char* what) {
  TORCH_CHECK(x.is_cuda() && x.is_contiguous(), what, ": x must be a contiguous CUDA tensor");
}

// The kernels read every operand as a dense array.
void dense(const char* what, const Tensor& t) {
  TORCH_CHECK(t.is_contiguous(), what, ": an operand is not contiguous");
}
void dense(const char* what, const OptTensor& t) {
  if (t.has_value()) dense(what, *t);
}
template <class... T>
void dense(const char* what, const T&... ts) {
  (dense(what, ts), ...);
}

// The int8 kernels read their operands as 32-bit words.
void aligned(const char* what, const Tensor& t) {
  TORCH_CHECK(reinterpret_cast<uintptr_t>(t.data_ptr()) % 4 == 0, what,
              ": an int8 operand is not 4-byte aligned");
}
void aligned(const char* what, const OptTensor& t) {
  if (t.has_value()) aligned(what, *t);
}
template <class... T>
void aligned(const char* what, const T&... ts) {
  (aligned(what, ts), ...);
}

template <class T>
const T* p(const Tensor& t) {
  return static_cast<const T*>(t.data_ptr());
}

template <class T>
const T* p(const OptTensor& t) {
  return t.has_value() ? static_cast<const T*>(t->data_ptr()) : nullptr;
}

template <class T>
T* m(const Tensor& t) {
  return static_cast<T*>(t.data_ptr());
}

int i(int64_t v) { return static_cast<int>(v); }

Tensor empty(at::IntArrayRef shape, at::ScalarType dtype, const Tensor& like) {
  return at::empty(shape, like.options().dtype(dtype));
}

// ops/cuda/block.py chain_meta: (hp, wp) of the chained padded-row layout.
std::pair<int64_t, int64_t> chain_meta(int64_t h, int64_t w) {
  const int64_t wp = (w + 1) % 8 == 0 ? w + 1 : (w + 2 + 7) / 8 * 8;
  return {h + 2, wp};
}

// 0 int8, 1 bf16, 2 fp32 (block._out_dtype).
at::ScalarType out_dtype(int64_t kind) {
  return kind == 0 ? at::kChar : kind == 1 ? at::kBFloat16 : at::kFloat;
}

// The float kinds of gemm.cu / conv.cu / fp_block.cu / elementwise.cu / pool.cu.
int kind_of(const Tensor& t) {
  switch (t.scalar_type()) {
    case at::kBFloat16: return 1;
    case at::kFloat: return 2;
    case at::kChar: return 3;
    default: TORCH_CHECK(false, "dtype ", t.scalar_type(), " is not taken by the kernels");
  }
}

int res_kind(const OptTensor& r) { return r.has_value() ? kind_of(*r) : 0; }

// --- csrc/chain_block.cu ---------------------------------------------------

Tensor chain_block_int8_op(const Tensor& x, const Tensor& w1_nk, const Tensor& sw1,
                           const Tensor& b1, const Tensor& w2p_nk, const Tensor& sw2p,
                           const Tensor& b2, const Tensor& w3_nk, const Tensor& sw3,
                           const Tensor& b3, const Tensor& scales, const OptTensor& wd_nk,
                           const OptTensor& swd, const OptTensor& bd, int64_t h, int64_t w,
                           int64_t out_kind, double inv_hw) {
  on_card(x, "chain_block_int8");
  dense("chain_block_int8", x, w1_nk, sw1, b1, w2p_nk, sw2p, b2, w3_nk, sw3, b3, scales, wd_nk, swd,
        bd);
  aligned("chain_block_int8", x, w1_nk, w2p_nk, w3_nk, wd_nk);
  auto [hp, wp] = chain_meta(h, w);
  const int64_t rows = x.size(0), cin = x.size(1), b = rows / (hp * wp);
  const int64_t c = w1_nk.size(0), c4 = w3_nk.size(0);
  Tensor z1 = empty({rows, c}, at::kChar, x), z2 = empty({rows, c}, at::kChar, x);
  Tensor yscr, out;
  if (out_kind == 2) {
    out = empty({b, c4}, at::kFloat, x);
    yscr = empty({rows, c4}, at::kFloat, x);
  } else {
    out = empty({rows, c4}, out_dtype(out_kind), x);
  }
  const auto launch = LAUNCHER("chain_block", chain_block_int8);
  check(launch(p<int8_t>(x), i(b), i(h), i(w), i(hp), i(wp), i(cin), i(c), i(c4), p<int8_t>(w1_nk),
        p<float>(sw1), p<float>(b1), p<int8_t>(w2p_nk), p<float>(sw2p), p<float>(b2),
        p<int8_t>(w3_nk), p<float>(sw3), p<float>(b3), p<float>(scales), out_kind != 0,
        p<int8_t>(wd_nk), p<float>(swd), p<float>(bd), m<int8_t>(z1), m<int8_t>(z2),
        yscr.defined() ? m<float>(yscr) : nullptr, i(out_kind), out.data_ptr(),
        static_cast<float>(inv_hw), stream()), "chain_block_int8");
  return out;
}

Tensor chain_run_int8_op(const Tensor& x, const Tensor& w1s_nk, const OptTensor& w10_nk,
                         const Tensor& sw1s, const Tensor& b1s, const Tensor& w2ps_nk,
                         const Tensor& sw2ps, const Tensor& b2s, const Tensor& w3s_nk,
                         const Tensor& sw3s, const Tensor& b3s, const Tensor& scales_s,
                         const OptTensor& wd_nk, const OptTensor& swd, const OptTensor& bd,
                         int64_t h, int64_t w, bool last_bf16) {
  on_card(x, "chain_run_int8");
  dense("chain_run_int8", x, w1s_nk, w10_nk, sw1s, b1s, w2ps_nk, sw2ps, b2s, w3s_nk, sw3s, b3s,
        scales_s, wd_nk, swd, bd);
  aligned("chain_run_int8", x, w1s_nk, w10_nk, w2ps_nk, w3s_nk, wd_nk);
  auto [hp, wp] = chain_meta(h, w);
  const int64_t rows = x.size(0), cin = x.size(1), b = rows / (hp * wp);
  const int64_t n_blocks = w3s_nk.size(0), c4 = w3s_nk.size(1), c = w3s_nk.size(2);
  Tensor z1 = empty({rows, c}, at::kChar, x), z2 = empty({rows, c}, at::kChar, x);
  Tensor act = empty({2, rows, c4}, at::kChar, x);
  Tensor out = empty({rows, c4}, last_bf16 ? at::kBFloat16 : at::kChar, x);
  const auto launch = LAUNCHER("chain_block", chain_run_int8);
  check(launch(p<int8_t>(x), i(n_blocks), i(b), i(h), i(w), i(hp), i(wp), i(cin), i(c), i(c4),
        p<int8_t>(w1s_nk), p<int8_t>(w10_nk), p<float>(sw1s), p<float>(b1s), p<int8_t>(w2ps_nk),
        p<float>(sw2ps), p<float>(b2s), p<int8_t>(w3s_nk), p<float>(sw3s), p<float>(b3s),
        p<float>(scales_s), p<int8_t>(wd_nk), p<float>(swd), p<float>(bd), m<int8_t>(z1),
        m<int8_t>(z2), m<int8_t>(act[0]), m<int8_t>(act[1]), last_bf16, out.data_ptr(), stream()),
        "chain_run_int8");
  return out;
}

Tensor ds_block_s2_int8_op(const Tensor& x, const Tensor& w1_nk, const Tensor& sw1,
                           const Tensor& b1, const Tensor& w2_nk, const Tensor& sw2,
                           const Tensor& b2, const Tensor& w3_nk, const Tensor& sw3,
                           const Tensor& b3, const Tensor& wd_nk, const Tensor& swd,
                           const Tensor& bd, const Tensor& scales, int64_t h, int64_t w,
                           int64_t out_kind) {
  on_card(x, "ds_block_s2_int8");
  dense("ds_block_s2_int8", x, w1_nk, sw1, b1, w2_nk, sw2, b2, w3_nk, sw3, b3, wd_nk, swd, bd,
        scales);
  aligned("ds_block_s2_int8", x, w1_nk, w2_nk, w3_nk, wd_nk);
  auto [hp, wp] = chain_meta(h, w);
  const int64_t oh = (h + 1) / 2, ow = (w + 1) / 2;
  auto [hp2, wp2] = chain_meta(oh, ow);
  const int64_t cin = x.size(1), b = x.size(0) / (hp * wp);
  const int64_t c = w1_nk.size(0), c4 = w3_nk.size(0);
  Tensor z1 = empty({b * hp * wp, c}, at::kChar, x);
  Tensor z2 = empty({b * hp2 * wp2, c}, at::kChar, x);
  Tensor out = empty({b * hp2 * wp2, c4}, out_dtype(out_kind), x);
  const auto launch = LAUNCHER("chain_block", ds_block_s2_int8);
  check(launch(p<int8_t>(x), i(b), i(h), i(w), i(hp), i(wp), i(cin), i(c), i(c4), i(oh), i(ow),
        i(hp2), i(wp2), p<int8_t>(w1_nk), p<float>(sw1), p<float>(b1), p<int8_t>(w2_nk),
        p<float>(sw2), p<float>(b2), p<int8_t>(w3_nk), p<float>(sw3), p<float>(b3),
        p<int8_t>(wd_nk), p<float>(swd), p<float>(bd), p<float>(scales), out_kind != 0,
        m<int8_t>(z1), m<int8_t>(z2), i(out_kind), out.data_ptr(), stream()), "ds_block_s2_int8");
  return out;
}

// --- csrc/grouped_block.cu -------------------------------------------------

Tensor grouped_block_int8_op(const Tensor& x, const Tensor& w1_nk, const Tensor& sw1,
                             const Tensor& b1, const Tensor& w2g_nk, const Tensor& sw2,
                             const Tensor& b2, const Tensor& w3_nk, const Tensor& sw3,
                             const Tensor& b3, const Tensor& scales, const OptTensor& wd_nk,
                             const OptTensor& swd, const OptTensor& bd, int64_t h, int64_t w,
                             int64_t out_kind) {
  on_card(x, "grouped_block_int8");
  dense("grouped_block_int8", x, w1_nk, sw1, b1, w2g_nk, sw2, b2, w3_nk, sw3, b3, scales, wd_nk,
        swd, bd);
  aligned("grouped_block_int8", x, w1_nk, w2g_nk, w3_nk, wd_nk);
  auto [hp, wp] = chain_meta(h, w);
  const int64_t rows = x.size(0), cin = x.size(1), b = rows / (hp * wp);
  const int64_t c = w1_nk.size(0), c4 = w3_nk.size(0);
  Tensor z1 = empty({rows, c}, at::kChar, x), z2 = empty({rows, c}, at::kChar, x);
  Tensor out = empty({rows, c4}, out_dtype(out_kind), x);
  const auto launch = LAUNCHER("grouped_block", grouped_block_int8);
  check(launch(p<int8_t>(x), i(b), i(h), i(w), i(hp), i(wp), i(cin), i(c), i(c4),
        p<int8_t>(w1_nk), p<float>(sw1), p<float>(b1), p<int8_t>(w2g_nk), i(w2g_nk.size(1)),
        p<float>(sw2), p<float>(b2), p<int8_t>(w3_nk), p<float>(sw3), p<float>(b3),
        p<float>(scales), out_kind != 0, p<int8_t>(wd_nk), p<float>(swd), p<float>(bd),
        m<int8_t>(z1), m<int8_t>(z2), i(out_kind), out.data_ptr(), stream()),
        "grouped_block_int8");
  return out;
}

Tensor grouped_ds_block_s2_int8_op(const Tensor& x, const Tensor& w1_nk, const Tensor& sw1,
                                   const Tensor& b1, const Tensor& w2g_nk, const Tensor& sw2,
                                   const Tensor& b2, const Tensor& w3_nk, const Tensor& sw3,
                                   const Tensor& b3, const Tensor& wd_nk, const Tensor& swd,
                                   const Tensor& bd, const Tensor& scales, int64_t h, int64_t w,
                                   int64_t out_kind) {
  on_card(x, "grouped_ds_block_s2_int8");
  dense("grouped_ds_block_s2_int8", x, w1_nk, sw1, b1, w2g_nk, sw2, b2, w3_nk, sw3, b3, wd_nk,
        swd, bd, scales);
  aligned("grouped_ds_block_s2_int8", x, w1_nk, w2g_nk, w3_nk, wd_nk);
  auto [hp, wp] = chain_meta(h, w);
  const int64_t oh = (h + 1) / 2, ow = (w + 1) / 2;
  auto [hp2, wp2] = chain_meta(oh, ow);
  const int64_t cin = x.size(1), b = x.size(0) / (hp * wp);
  const int64_t c = w1_nk.size(0), c4 = w3_nk.size(0);
  Tensor z1 = empty({b * hp * wp, c}, at::kChar, x);
  Tensor z2 = empty({b * hp2 * wp2, c}, at::kChar, x);
  Tensor out = empty({b * hp2 * wp2, c4}, out_dtype(out_kind), x);
  const auto launch = LAUNCHER("grouped_block", grouped_ds_block_s2_int8);
  check(launch(p<int8_t>(x), i(b), i(h), i(w), i(hp), i(wp), i(cin), i(c), i(c4), i(oh), i(ow),
        i(hp2), i(wp2), p<int8_t>(w1_nk), p<float>(sw1), p<float>(b1), p<int8_t>(w2g_nk),
        i(w2g_nk.size(1)), p<float>(sw2), p<float>(b2), p<int8_t>(w3_nk), p<float>(sw3),
        p<float>(b3), p<int8_t>(wd_nk), p<float>(swd), p<float>(bd), p<float>(scales),
        out_kind != 0, m<int8_t>(z1), m<int8_t>(z2), i(out_kind), out.data_ptr(), stream()),
        "grouped_ds_block_s2_int8");
  return out;
}

// --- csrc/basic_block.cu ---------------------------------------------------

Tensor basic_block_int8_op(const Tensor& x, const Tensor& w1_nk, const Tensor& sw1p,
                           const Tensor& b1, const Tensor& w2_nk, const Tensor& sw2p,
                           const Tensor& b2, const Tensor& scales, int64_t h, int64_t w,
                           int64_t out_kind) {
  on_card(x, "basic_block_int8");
  dense("basic_block_int8", x, w1_nk, sw1p, b1, w2_nk, sw2p, b2, scales);
  aligned("basic_block_int8", x, w1_nk, w2_nk);
  auto [hp, wp] = chain_meta(h, w);
  const int64_t rows = x.size(0), c = x.size(1);
  Tensor z1 = empty({rows, c}, at::kChar, x);
  Tensor out = empty({rows, c}, out_dtype(out_kind), x);
  const auto launch = LAUNCHER("basic_block", basic_block_int8);
  check(launch(p<int8_t>(x), i(rows / (hp * wp)), i(h), i(w), i(hp), i(wp), i(c), p<int8_t>(w1_nk),
        p<float>(sw1p), p<float>(b1), p<int8_t>(w2_nk), p<float>(sw2p), p<float>(b2),
        p<float>(scales), out_kind != 0, m<int8_t>(z1), i(out_kind), out.data_ptr(), stream()),
        "basic_block_int8");
  return out;
}

Tensor basic_run_int8_op(const Tensor& x, const Tensor& w1s_nk, const Tensor& sw1ps,
                         const Tensor& b1s, const Tensor& w2s_nk, const Tensor& sw2ps,
                         const Tensor& b2s, const Tensor& scales_s, int64_t h, int64_t w,
                         bool last_bf16) {
  on_card(x, "basic_run_int8");
  dense("basic_run_int8", x, w1s_nk, sw1ps, b1s, w2s_nk, sw2ps, b2s, scales_s);
  aligned("basic_run_int8", x, w1s_nk, w2s_nk);
  auto [hp, wp] = chain_meta(h, w);
  const int64_t rows = x.size(0), c = x.size(1);
  Tensor z1 = empty({rows, c}, at::kChar, x);
  Tensor act = empty({2, rows, c}, at::kChar, x);
  Tensor out = empty({rows, c}, last_bf16 ? at::kBFloat16 : at::kChar, x);
  const auto launch = LAUNCHER("basic_block", basic_run_int8);
  check(launch(p<int8_t>(x), i(w1s_nk.size(0)), i(rows / (hp * wp)), i(h), i(w), i(hp), i(wp),
        i(c), p<int8_t>(w1s_nk), p<float>(sw1ps), p<float>(b1s), p<int8_t>(w2s_nk),
        p<float>(sw2ps), p<float>(b2s), p<float>(scales_s), m<int8_t>(z1), m<int8_t>(act[0]),
        m<int8_t>(act[1]), last_bf16, out.data_ptr(), stream()), "basic_run_int8");
  return out;
}

Tensor basic_ds_block_s2_int8_op(const Tensor& x, const Tensor& w1_nk, const Tensor& sw1,
                                 const Tensor& b1, const Tensor& w2_nk, const Tensor& sw2p,
                                 const Tensor& b2, const Tensor& wd_nk, const Tensor& swd,
                                 const Tensor& bd, const Tensor& scales, int64_t h, int64_t w,
                                 int64_t out_kind) {
  on_card(x, "basic_ds_block_s2_int8");
  dense("basic_ds_block_s2_int8", x, w1_nk, sw1, b1, w2_nk, sw2p, b2, wd_nk, swd, bd, scales);
  aligned("basic_ds_block_s2_int8", x, w1_nk, w2_nk, wd_nk);
  auto [hp, wp] = chain_meta(h, w);
  const int64_t oh = (h + 1) / 2, ow = (w + 1) / 2;
  auto [hp2, wp2] = chain_meta(oh, ow);
  const int64_t cin = x.size(1), b = x.size(0) / (hp * wp), c = sw1.size(0);
  Tensor z1 = empty({b * hp2 * wp2, c}, at::kChar, x);
  Tensor out = empty({b * hp2 * wp2, c}, out_dtype(out_kind), x);
  const auto launch = LAUNCHER("basic_block", basic_ds_block_s2_int8);
  check(launch(p<int8_t>(x), i(b), i(h), i(w), i(hp), i(wp), i(cin), i(c), i(oh), i(ow), i(hp2),
        i(wp2), p<int8_t>(w1_nk), p<float>(sw1), p<float>(b1), p<int8_t>(w2_nk), p<float>(sw2p),
        p<float>(b2), p<int8_t>(wd_nk), p<float>(swd), p<float>(bd), p<float>(scales),
        out_kind != 0, m<int8_t>(z1), i(out_kind), out.data_ptr(), stream()),
        "basic_ds_block_s2_int8");
  return out;
}

// --- csrc/pp_block.cu ------------------------------------------------------

Tensor pp_block_int8_op(const Tensor& x, const Tensor& w1_nk, const Tensor& sw1,
                        const Tensor& b1, const Tensor& w2_nk, const Tensor& sw2,
                        const Tensor& b2, const Tensor& w3_nk, const Tensor& sw3,
                        const Tensor& b3, const Tensor& scales, bool folded,
                        const OptTensor& wd_nk, const OptTensor& swd, const OptTensor& bd,
                        int64_t h, int64_t w, int64_t out_kind) {
  on_card(x, "pp_block_int8");
  dense("pp_block_int8", x, w1_nk, sw1, b1, w2_nk, sw2, b2, w3_nk, sw3, b3, scales, wd_nk, swd, bd);
  aligned("pp_block_int8", x, w1_nk, w2_nk, w3_nk, wd_nk);
  auto [hp, wp] = chain_meta(h, w);
  const int64_t rows2 = x.size(0), cin2 = x.size(1), b = 2 * rows2 / (hp * wp);
  const int64_t c4p = w3_nk.size(0), cw = w3_nk.size(1);
  Tensor z1 = empty({rows2, cw}, at::kChar, x), z2 = empty({rows2, cw}, at::kChar, x);
  Tensor out = empty({rows2, c4p}, out_dtype(out_kind), x);
  const auto launch = LAUNCHER("pp_block", pp_block_int8);
  check(launch(p<int8_t>(x), i(b), i(h), i(w), i(hp), i(wp), i(cin2), i(cw), i(c4p),
        p<int8_t>(w1_nk), p<float>(sw1), p<float>(b1), p<int8_t>(w2_nk), p<float>(sw2),
        p<float>(b2), p<int8_t>(w3_nk), p<float>(sw3), p<float>(b3), p<float>(scales), folded,
        !folded && out_kind == 1, p<int8_t>(wd_nk), p<float>(swd), p<float>(bd), m<int8_t>(z1),
        m<int8_t>(z2), i(out_kind), out.data_ptr(), stream()), "pp_block_int8");
  return out;
}

Tensor pp_run_int8_op(const Tensor& x, const Tensor& w1s_nk, const OptTensor& w10_nk,
                      const Tensor& sw1, const Tensor& b1, const Tensor& w2s_nk,
                      const Tensor& sw2, const Tensor& b2, const Tensor& w3s_nk,
                      const Tensor& sw3, const Tensor& b3, const Tensor& scales, bool folded,
                      const OptTensor& wd_nk, const OptTensor& swd, const OptTensor& bd,
                      int64_t h, int64_t w, bool last_bf16) {
  on_card(x, "pp_run_int8");
  dense("pp_run_int8", x, w1s_nk, w10_nk, sw1, b1, w2s_nk, sw2, b2, w3s_nk, sw3, b3, scales, wd_nk,
        swd, bd);
  aligned("pp_run_int8", x, w1s_nk, w10_nk, w2s_nk, w3s_nk, wd_nk);
  auto [hp, wp] = chain_meta(h, w);
  const int64_t rows2 = x.size(0), cin2 = x.size(1), b = 2 * rows2 / (hp * wp);
  const int64_t n_blocks = w2s_nk.size(0), c4p = w3s_nk.size(1), cw = w3s_nk.size(2);
  Tensor z1 = empty({rows2, cw}, at::kChar, x), z2 = empty({rows2, cw}, at::kChar, x);
  Tensor act = empty({2, rows2, c4p}, at::kChar, x);
  Tensor out = empty({rows2, c4p}, last_bf16 ? at::kBFloat16 : at::kChar, x);
  const auto launch = LAUNCHER("pp_block", pp_run_int8);
  check(launch(p<int8_t>(x), i(n_blocks), i(b), i(h), i(w), i(hp), i(wp), i(cin2), i(cw), i(c4p),
        p<int8_t>(w1s_nk), p<int8_t>(w10_nk), p<float>(sw1), p<float>(b1), p<int8_t>(w2s_nk),
        p<float>(sw2), p<float>(b2), p<int8_t>(w3s_nk), p<float>(sw3), p<float>(b3),
        p<float>(scales), folded, p<int8_t>(wd_nk), p<float>(swd), p<float>(bd), m<int8_t>(z1),
        m<int8_t>(z2), m<int8_t>(act[0]), m<int8_t>(act[1]), last_bf16, out.data_ptr(), stream()),
        "pp_run_int8");
  return out;
}

Tensor pp_basic_block_int8_op(const Tensor& x, const Tensor& w1_nk, const Tensor& a1,
                              const Tensor& c1, const Tensor& w2_nk, const Tensor& a2,
                              const Tensor& c2, const Tensor& s_res, int64_t h, int64_t w,
                              int64_t out_kind) {
  on_card(x, "pp_basic_block_int8");
  dense("pp_basic_block_int8", x, w1_nk, a1, c1, w2_nk, a2, c2, s_res);
  aligned("pp_basic_block_int8", x, w1_nk, w2_nk);
  auto [hp, wp] = chain_meta(h, w);
  const int64_t rows2 = x.size(0), cp = x.size(1);
  Tensor z1 = empty({rows2, cp}, at::kChar, x);
  Tensor out = empty({rows2, cp}, out_dtype(out_kind), x);
  const auto launch = LAUNCHER("pp_block", pp_basic_block_int8);
  check(launch(p<int8_t>(x), i(2 * rows2 / (hp * wp)), i(h), i(w), i(hp), i(wp), i(cp),
        p<int8_t>(w1_nk), p<float>(a1), p<float>(c1), p<int8_t>(w2_nk), p<float>(a2), p<float>(c2),
        p<float>(s_res), m<int8_t>(z1), i(out_kind), out.data_ptr(), stream()),
        "pp_basic_block_int8");
  return out;
}

Tensor pp_basic_run_int8_op(const Tensor& x, const Tensor& w1s_nk, const Tensor& a1s,
                            const Tensor& c1s, const Tensor& w2s_nk, const Tensor& a2s,
                            const Tensor& c2s, const Tensor& s_res, int64_t h, int64_t w,
                            bool last_bf16) {
  on_card(x, "pp_basic_run_int8");
  dense("pp_basic_run_int8", x, w1s_nk, a1s, c1s, w2s_nk, a2s, c2s, s_res);
  aligned("pp_basic_run_int8", x, w1s_nk, w2s_nk);
  auto [hp, wp] = chain_meta(h, w);
  const int64_t rows2 = x.size(0), cp = x.size(1);
  Tensor z1 = empty({rows2, cp}, at::kChar, x);
  Tensor act = empty({2, rows2, cp}, at::kChar, x);
  Tensor out = empty({rows2, cp}, last_bf16 ? at::kBFloat16 : at::kChar, x);
  const auto launch = LAUNCHER("pp_block", pp_basic_run_int8);
  check(launch(p<int8_t>(x), i(w1s_nk.size(0)), i(2 * rows2 / (hp * wp)), i(h), i(w), i(hp), i(wp),
        i(cp), p<int8_t>(w1s_nk), p<float>(a1s), p<float>(c1s), p<int8_t>(w2s_nk), p<float>(a2s),
        p<float>(c2s), p<float>(s_res), m<int8_t>(z1), m<int8_t>(act[0]), m<int8_t>(act[1]),
        last_bf16, out.data_ptr(), stream()), "pp_basic_run_int8");
  return out;
}

// --- csrc/gemm.cu, int8_gemm.cu, conv.cu, pool.cu, fp_block.cu, elementwise.cu

// What the fp32 tile reads in place of w: w_nk, the TF32 heads and tails of
// its (N, K) copy (an HWIO conv weight's as (Cout, k*k*Cin)), (2, N, K),
// made by the wrapper (ops/cuda/gemm.py pack_nk).
Tensor checked_w_nk(const Tensor& w, const OptTensor& w_nk) {
  TORCH_CHECK(w_nk.has_value(), "an fp32 weight needs w_nk (ops/cuda/gemm.py pack_nk)");
  const int64_t n = w.size(w.dim() - 1), k = w.numel() / n;
  TORCH_CHECK(w_nk->scalar_type() == at::kFloat && w_nk->is_cuda() && w_nk->dim() == 3 &&
                  w_nk->size(0) == 2 && w_nk->size(1) == n && w_nk->size(2) == k,
              "w_nk: an fp32 CUDA tensor of shape (2, N, K)");
  return *w_nk;
}

Tensor gemm_f32acc_op(const Tensor& x, const Tensor& w, const OptTensor& w_nk,
                      const OptTensor& bias, const OptTensor& residual, bool relu,
                      bool out_bf16) {
  on_card(x, "gemm_f32acc");
  const int64_t m_ = x.size(0), k = x.size(1), n = w.size(1);
  const int in_bf16 = x.scalar_type() == at::kBFloat16;
  const Tensor wt = in_bf16 ? Tensor() : checked_w_nk(w, w_nk);
  dense("gemm_f32acc", x, w, bias, residual);
  if (!in_bf16) dense("gemm_f32acc", wt);
  const long long ws_floats = LAUNCHER("gemm", gemm_workspace_floats)(i(m_), i(n), i(k), in_bf16);
  Tensor ws = ws_floats ? empty({ws_floats}, at::kFloat, x) : Tensor();
  Tensor out = empty({m_, n}, out_bf16 ? at::kBFloat16 : at::kFloat, x);
  const auto launch = LAUNCHER("gemm", gemm_f32acc);
  check(launch(x.data_ptr(), w.data_ptr(), in_bf16 ? nullptr : p<float>(wt), p<float>(bias),
        residual.has_value() ? residual->data_ptr() : nullptr, out.data_ptr(),
        ws.defined() ? m<float>(ws) : nullptr, in_bf16, res_kind(residual), out_bf16, i(m_), i(n),
        i(k), relu, stream()), "gemm_f32acc");
  return out;
}

Tensor int8_gemm_op(const Tensor& x, const Tensor& w_nk, const Tensor& scale_x,
                    const Tensor& scale_w, const OptTensor& bias, const OptTensor& residual,
                    bool relu, bool out_bf16) {
  on_card(x, "int8_gemm");
  dense("int8_gemm", x, w_nk, scale_x, scale_w, bias, residual);
  const int64_t m_ = x.size(0), k = x.size(1), n = w_nk.size(0);
  const long long ws_ints = LAUNCHER("int8_gemm", int8_gemm_workspace_ints)(i(m_), i(n), i(k));
  Tensor ws = ws_ints ? empty({ws_ints}, at::kInt, x) : Tensor();
  Tensor out = empty({m_, n}, out_bf16 ? at::kBFloat16 : at::kFloat, x);
  const auto launch = LAUNCHER("int8_gemm", int8_gemm);
  check(launch(p<int8_t>(x), p<int8_t>(w_nk), p<float>(scale_x), p<float>(scale_w), p<float>(bias),
        residual.has_value() ? residual->data_ptr() : nullptr, out.data_ptr(),
        ws.defined() ? m<int>(ws) : nullptr, res_kind(residual), out_bf16, i(m_), i(n), i(k), relu,
        stream()), "int8_gemm");
  return out;
}

Tensor conv_fused_op(const Tensor& x, const Tensor& w, const OptTensor& w_nk,
                     const OptTensor& bias, const OptTensor& residual, int64_t stride, bool relu,
                     bool out_bf16) {
  on_card(x, "conv_fused");
  const bool in_bf16 = x.scalar_type() == at::kBFloat16;
  const Tensor wt = in_bf16 ? Tensor() : checked_w_nk(w, w_nk);
  dense("conv_fused", x, w, bias, residual);
  if (!in_bf16) dense("conv_fused", wt);
  const int64_t b = x.size(0), h = x.size(1), ws = x.size(2), cin = x.size(3);
  const int64_t k = w.size(0), cout = w.size(3), pad = k / 2;
  const int64_t oh = (h + 2 * pad - k) / stride + 1, ow = (ws + 2 * pad - k) / stride + 1;
  Tensor out = empty({b, oh, ow, cout}, out_bf16 ? at::kBFloat16 : at::kFloat, x);
  const auto launch = LAUNCHER("conv", conv_fused);
  check(launch(x.data_ptr(), w.data_ptr(), in_bf16 ? nullptr : p<float>(wt), p<float>(bias),
        residual.has_value() ? residual->data_ptr() : nullptr, out.data_ptr(), kind_of(x),
        res_kind(residual), out_bf16, i(b), i(h), i(ws), i(cin), i(oh), i(ow), i(cout), i(k),
        i(stride), relu, stream()), "conv_fused");
  return out;
}

// 1 when each pixel's channel row is whole 16-byte groups and both tensors
// are 16-byte aligned: the pool kernels then move 16 bytes a thread.
int vec(const Tensor& x, const Tensor& out) {
  const auto a = reinterpret_cast<uintptr_t>(x.data_ptr());
  const auto b = reinterpret_cast<uintptr_t>(out.data_ptr());
  return x.size(3) * x.element_size() % 16 == 0 && a % 16 == 0 && b % 16 == 0;
}

Tensor pool_out(const Tensor& x, int64_t k, int64_t s, int64_t pad) {
  const int64_t oh = (x.size(1) + 2 * pad - k) / s + 1, ow = (x.size(2) + 2 * pad - k) / s + 1;
  return empty({x.size(0), oh, ow, x.size(3)}, x.scalar_type(), x);
}

Tensor max_pool2d_nhwc_op(const Tensor& x, int64_t k, int64_t s, int64_t pad) {
  on_card(x, "max_pool2d_nhwc");
  dense("max_pool2d_nhwc", x);
  Tensor out = pool_out(x, k, s, pad);
  const auto launch = LAUNCHER("pool", max_pool2d_nhwc);
  check(launch(x.data_ptr(), out.data_ptr(), kind_of(x), vec(x, out), i(x.size(0)), i(x.size(1)),
        i(x.size(2)), i(x.size(3)), i(out.size(1)), i(out.size(2)), i(k), i(s), i(pad), stream()),
        "max_pool2d_nhwc");
  return out;
}

Tensor avg_pool2d_nhwc_op(const Tensor& x, int64_t k, int64_t s, int64_t pad) {
  on_card(x, "avg_pool2d_nhwc");
  dense("avg_pool2d_nhwc", x);
  Tensor out = pool_out(x, k, s, pad);
  const float inv = static_cast<float>(1.0 / static_cast<double>(k * k));
  const auto launch = LAUNCHER("pool", avg_pool2d_nhwc);
  check(launch(x.data_ptr(), out.data_ptr(), kind_of(x), vec(x, out), i(x.size(0)), i(x.size(1)),
        i(x.size(2)), i(x.size(3)), i(out.size(1)), i(out.size(2)), i(k), i(s), i(pad), inv,
        stream()), "avg_pool2d_nhwc");
  return out;
}

// The int8_chain stem's tail: bias, relu, quantize at s_in, the 3x3/2 max
// pool and the chain pad of the stem convolution's output y, into the
// pooled map's zero-ring chain rows (every byte written by the kernel).
Tensor stem_pool_int8_op(const Tensor& y, const Tensor& bias, const Tensor& s_in) {
  on_card(y, "stem_pool_int8");
  dense("stem_pool_int8", bias, s_in);
  TORCH_CHECK(bias.is_cuda() && s_in.is_cuda() && bias.scalar_type() == at::kFloat &&
              s_in.scalar_type() == at::kFloat && s_in.numel() == 1,
              "stem_pool_int8: bias and s_in must be fp32 on the card, s_in one value");
  TORCH_CHECK(y.dim() == 4 && y.size(3) % 16 == 0 && bias.numel() == y.size(3),
              "stem_pool_int8: y must be (B, H, W, C), C a multiple of 16, bias (C,)");
  TORCH_CHECK(y.scalar_type() == at::kBFloat16 || y.scalar_type() == at::kFloat,
              "stem_pool_int8: y must be bf16 or fp32");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(y.data_ptr()) % 16 == 0,
              "stem_pool_int8: y is not 16-byte aligned");
  TORCH_CHECK(y.size(0) <= 65535, "stem_pool_int8: at most 65535 images a launch");
  const int64_t b = y.size(0), h1 = y.size(1), w1 = y.size(2), c = y.size(3);
  const int64_t h2 = (h1 - 1) / 2 + 1, w2 = (w1 - 1) / 2 + 1;
  const auto [hp, wp] = chain_meta(h2, w2);
  Tensor out = empty({b * hp * wp, c}, at::kChar, y);
  const auto launch = LAUNCHER("pool", stem_pool_int8);
  check(launch(y.data_ptr(), p<float>(bias), p<float>(s_in), m<int8_t>(out), kind_of(y), i(b),
        i(h1), i(w1), i(c), i(h2), i(w2), i(hp), i(wp), stream()), "stem_pool_int8");
  return out;
}

Tensor fp_block_op(const Tensor& x, const Tensor& w1, const Tensor& b1, const Tensor& w2,
                   const Tensor& b2, const Tensor& w3, const Tensor& b3, const OptTensor& w1_nk,
                   const OptTensor& w2_nk, const OptTensor& w3_nk, bool chain, int64_t h,
                   int64_t w) {
  on_card(x, "fp_block");
  dense("fp_block", x, w1, b1, w2, b2, w3, b3);
  // fp32 reads each weight's split (N, K) copy in its place.
  const bool f32 = x.scalar_type() == at::kFloat;
  const Tensor n1 = f32 ? checked_w_nk(w1, w1_nk) : Tensor();
  const Tensor n2 = f32 ? checked_w_nk(w2, w2_nk) : Tensor();
  const Tensor n3 = f32 ? checked_w_nk(w3, w3_nk) : Tensor();
  if (f32) dense("fp_block", n1, n2, n3);
  int64_t b, hp, wp;
  if (chain) {
    std::tie(hp, wp) = chain_meta(h, w);
    b = x.size(0) / (hp * wp);
  } else {
    b = x.size(0), hp = h + 2, wp = w + 2;
  }
  const int64_t c4 = w1.size(0), c = w1.size(1);
  Tensor z1 = empty({b * h * w, c}, x.scalar_type(), x), z2 = at::empty_like(z1);
  Tensor out = at::empty_like(x);
  const auto launch = LAUNCHER("fp_block", fp_block);
  check(launch(x.data_ptr(), w1.data_ptr(), f32 ? p<float>(n1) : nullptr, p<float>(b1),
        w2.data_ptr(), f32 ? p<float>(n2) : nullptr, p<float>(b2), w3.data_ptr(),
        f32 ? p<float>(n3) : nullptr, p<float>(b3), z1.data_ptr(), z2.data_ptr(), out.data_ptr(),
        kind_of(x), chain, i(b), i(h), i(w), i(hp), i(wp), i(c), i(c4), stream()), "fp_block");
  return out;
}

Tensor elementwise_op(int64_t op, const Tensor& a, const OptTensor& b) {
  on_card(a, "elementwise");
  dense("elementwise", a, b);
  // The output at a's offset mod 16 (the allocator's blocks are 16-byte
  // aligned), so that a view off the 16-byte grid takes the vector body too.
  const int64_t off =
      static_cast<int64_t>(reinterpret_cast<uintptr_t>(a.data_ptr()) % 16) / a.element_size();
  Tensor out = off == 0 ? at::empty_like(a)
                        : empty({a.numel() + off}, a.scalar_type(), a).narrow(0, off, a.numel())
                              .view(a.sizes());
  if (a.numel() == 0) return out;
  const auto launch = LAUNCHER("elementwise", elementwise);
  check(launch(i(op), kind_of(a), a.data_ptr(), b.has_value() ? b->data_ptr() : nullptr,
        out.data_ptr(), a.numel(), stream()), "elementwise");
  return out;
}

// The schemas of ops/cuda/_build.kernel_op's registrations.
void define_schemas(torch::Library& m) {
  m.def("chain_block_int8(Tensor x, Tensor w1_nk, Tensor sw1, Tensor b1, Tensor w2p_nk, "
        "Tensor sw2p, Tensor b2, Tensor w3_nk, Tensor sw3, Tensor b3, Tensor scales, "
        "Tensor? wd_nk, Tensor? swd, Tensor? bd, int h, int w, int out_kind, "
        "float inv_hw) -> Tensor");
  m.def("chain_run_int8(Tensor x, Tensor w1s_nk, Tensor? w10_nk, Tensor sw1s, Tensor b1s, "
        "Tensor w2ps_nk, Tensor sw2ps, Tensor b2s, Tensor w3s_nk, Tensor sw3s, Tensor b3s, "
        "Tensor scales_s, Tensor? wd_nk, Tensor? swd, Tensor? bd, int h, int w, "
        "bool last_bf16) -> Tensor");
  m.def("ds_block_s2_int8(Tensor x, Tensor w1_nk, Tensor sw1, Tensor b1, Tensor w2_nk, "
        "Tensor sw2, Tensor b2, Tensor w3_nk, Tensor sw3, Tensor b3, Tensor wd_nk, Tensor swd, "
        "Tensor bd, Tensor scales, int h, int w, int out_kind) -> Tensor");
  m.def("grouped_block_int8(Tensor x, Tensor w1_nk, Tensor sw1, Tensor b1, Tensor w2g_nk, "
        "Tensor sw2, Tensor b2, Tensor w3_nk, Tensor sw3, Tensor b3, Tensor scales, "
        "Tensor? wd_nk, Tensor? swd, Tensor? bd, int h, int w, int out_kind) -> Tensor");
  m.def("grouped_ds_block_s2_int8(Tensor x, Tensor w1_nk, Tensor sw1, Tensor b1, "
        "Tensor w2g_nk, Tensor sw2, Tensor b2, Tensor w3_nk, Tensor sw3, Tensor b3, "
        "Tensor wd_nk, Tensor swd, Tensor bd, Tensor scales, int h, int w, int out_kind) "
        "-> Tensor");
  m.def("basic_block_int8(Tensor x, Tensor w1_nk, Tensor sw1p, Tensor b1, Tensor w2_nk, "
        "Tensor sw2p, Tensor b2, Tensor scales, int h, int w, int out_kind) -> Tensor");
  m.def("basic_run_int8(Tensor x, Tensor w1s_nk, Tensor sw1ps, Tensor b1s, Tensor w2s_nk, "
        "Tensor sw2ps, Tensor b2s, Tensor scales_s, int h, int w, bool last_bf16) -> Tensor");
  m.def("basic_ds_block_s2_int8(Tensor x, Tensor w1_nk, Tensor sw1, Tensor b1, Tensor w2_nk, "
        "Tensor sw2p, Tensor b2, Tensor wd_nk, Tensor swd, Tensor bd, Tensor scales, int h, "
        "int w, int out_kind) -> Tensor");
  m.def("pp_block_int8(Tensor x, Tensor w1_nk, Tensor sw1, Tensor b1, Tensor w2_nk, Tensor sw2, "
        "Tensor b2, Tensor w3_nk, Tensor sw3, Tensor b3, Tensor scales, bool folded, "
        "Tensor? wd_nk, Tensor? swd, Tensor? bd, int h, int w, int out_kind) -> Tensor");
  m.def("pp_run_int8(Tensor x, Tensor w1s_nk, Tensor? w10_nk, Tensor sw1, Tensor b1, "
        "Tensor w2s_nk, Tensor sw2, Tensor b2, Tensor w3s_nk, Tensor sw3, Tensor b3, "
        "Tensor scales, bool folded, Tensor? wd_nk, Tensor? swd, Tensor? bd, int h, int w, "
        "bool last_bf16) -> Tensor");
  m.def("pp_basic_block_int8(Tensor x, Tensor w1_nk, Tensor a1, Tensor c1, Tensor w2_nk, "
        "Tensor a2, Tensor c2, Tensor s_res, int h, int w, int out_kind) -> Tensor");
  m.def("pp_basic_run_int8(Tensor x, Tensor w1s_nk, Tensor a1s, Tensor c1s, Tensor w2s_nk, "
        "Tensor a2s, Tensor c2s, Tensor s_res, int h, int w, bool last_bf16) -> Tensor");
  m.def("gemm_f32acc(Tensor x, Tensor w, Tensor? w_nk, Tensor? bias, Tensor? residual, "
        "bool relu, bool out_bf16) -> Tensor");
  m.def("int8_gemm(Tensor x, Tensor w_nk, Tensor scale_x, Tensor scale_w, Tensor? bias, "
        "Tensor? residual, bool relu, bool out_bf16) -> Tensor");
  m.def("conv_fused(Tensor x, Tensor w, Tensor? w_nk, Tensor? bias, Tensor? residual, "
        "int stride, bool relu, bool out_bf16) -> Tensor");
  m.def("max_pool2d_nhwc(Tensor x, int k, int s, int p) -> Tensor");
  m.def("avg_pool2d_nhwc(Tensor x, int k, int s, int p) -> Tensor");
  m.def("stem_pool_int8(Tensor y, Tensor bias, Tensor s_in) -> Tensor");
  m.def("fp_block(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, Tensor w3, Tensor b3, "
        "Tensor? w1_nk, Tensor? w2_nk, Tensor? w3_nk, bool chain, int h, int w) -> Tensor");
  m.def("elementwise(int op, Tensor a, Tensor? b) -> Tensor");
}

// Define the schemas unless the process has them: a Python process defined
// them when it imported the wrappers, the serving binary has not.
const bool schemas_defined_here = [] {
  if (c10::Dispatcher::singleton().findSchema({"resnetc::elementwise", ""}).has_value())
    return false;
  static torch::Library lib(torch::Library::DEF, "resnetc", std::nullopt, __FILE__, __LINE__);
  define_schemas(lib);
  return true;
}();

}  // namespace

TORCH_LIBRARY_IMPL(resnetc, CUDA, m) {
  m.impl("chain_block_int8", &chain_block_int8_op);
  m.impl("chain_run_int8", &chain_run_int8_op);
  m.impl("ds_block_s2_int8", &ds_block_s2_int8_op);
  m.impl("grouped_block_int8", &grouped_block_int8_op);
  m.impl("grouped_ds_block_s2_int8", &grouped_ds_block_s2_int8_op);
  m.impl("basic_block_int8", &basic_block_int8_op);
  m.impl("basic_run_int8", &basic_run_int8_op);
  m.impl("basic_ds_block_s2_int8", &basic_ds_block_s2_int8_op);
  m.impl("pp_block_int8", &pp_block_int8_op);
  m.impl("pp_run_int8", &pp_run_int8_op);
  m.impl("pp_basic_block_int8", &pp_basic_block_int8_op);
  m.impl("pp_basic_run_int8", &pp_basic_run_int8_op);
  m.impl("gemm_f32acc", &gemm_f32acc_op);
  m.impl("int8_gemm", &int8_gemm_op);
  m.impl("conv_fused", &conv_fused_op);
  m.impl("max_pool2d_nhwc", &max_pool2d_nhwc_op);
  m.impl("avg_pool2d_nhwc", &avg_pool2d_nhwc_op);
  m.impl("stem_pool_int8", &stem_pool_int8_op);
  m.impl("fp_block", &fp_block_op);
  m.impl("elementwise", &elementwise_op);
}
