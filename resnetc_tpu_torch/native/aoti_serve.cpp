// Standalone C++ serving binary: runs an AOTInductor package of the port's
// forward with no Python in the process.  Counterpart of the JAX package's
// PJRT shim (resnetc_tpu/native/pjrt_serve.cpp), with its input file, its
// output lines and its latency mode.
//
// Usage:
//   resnetc_torch_serve MODEL.pt2 INPUT.f32 [N H W C] [--loop K] [--latency K]
//       [--device cpu] [--ops LIB.so] [--out LOGITS.f32]
//
//   MODEL.pt2     python -m resnetc_tpu_torch.export (model.pt2 beside meta.json)
//   INPUT.f32     raw little-endian f32 NHWC tensor, N*H*W*C elements
//                 (default 1 224 224 3)
//   --loop K      run the request K times, then print the last (default 1)
//   --latency K   then K full requests, each wall-timed: upload, run, fetch
//                 the logits, argmax; prints their p50 / p99
//   --device cpu  the package was made for the CPU (default: the card)
//   --ops LIB.so  the kernel ops library (csrc/torch_ops.cpp), loaded before
//                 the package: a program that calls resnetc:: ops (the
//                 int8_chain export) needs it, an fp program does not
//   --out FILE    also write the logits, raw little-endian f32 (N, classes)
//
// The program takes ONE f32 NHWC input and returns ONE f32 output (logits);
// argmax is computed on the host per image.  Built at first use by
// resnetc_tpu_torch.native.build_runner().

#include <dlfcn.h>

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <string>
#include <vector>

#include <ATen/core/Tensor.h>
#include <ATen/ops/from_blob.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

namespace {

[[noreturn]] void die(const std::string& msg) {
  std::fprintf(stderr, "aoti_serve: %s\n", msg.c_str());
  std::exit(1);
}

long parse_long(const char* s, const char* what) {
  char* end = nullptr;
  const long v = std::strtol(s, &end, 10);
  if (end == s || *end != '\0' || v < 0) die(std::string("bad ") + what + ": " + s);
  return v;
}

std::vector<float> read_input(const std::string& path, size_t count) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) die("cannot open " + path);
  const auto bytes = static_cast<size_t>(f.tellg());
  if (bytes != count * sizeof(float))
    die(path + ": " + std::to_string(bytes) + " bytes, expected " +
        std::to_string(count * sizeof(float)) + " for the given N H W C");
  std::vector<float> data(count);
  f.seekg(0);
  f.read(reinterpret_cast<char*>(data.data()), static_cast<std::streamsize>(bytes));
  return data;
}

// One request: upload the host images, run the program, fetch the logits.
at::Tensor request(torch::inductor::AOTIModelPackageLoader& loader, std::vector<float>& host,
                   const std::vector<int64_t>& dims, const at::Device& device) {
  at::Tensor x = at::from_blob(host.data(), dims, at::kFloat).to(device, /*non_blocking=*/false,
                                                                 /*copy=*/true);
  std::vector<at::Tensor> out = loader.run({x});
  if (out.size() != 1) die("the program returned " + std::to_string(out.size()) + " outputs");
  return out[0].to(at::kCPU, at::kFloat).contiguous();
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage: %s MODEL.pt2 INPUT.f32 [N H W C] [--loop K] [--latency K] "
                 "[--device cpu] [--ops LIB.so] [--out LOGITS.f32]\n",
                 argv[0]);
    return 2;
  }
  const std::string model = argv[1], input = argv[2];
  std::vector<int64_t> dims = {1, 224, 224, 3};
  int loop = 1, latency = 0;
  bool cpu = false;
  std::string ops, out_path;
  int pos = 0;
  for (int a = 3; a < argc; ++a) {
    const std::string arg = argv[a];
    auto value = [&](const char* what) {
      if (a + 1 >= argc) die(std::string(what) + " needs a value");
      return argv[++a];
    };
    if (arg == "--loop") {
      loop = static_cast<int>(parse_long(value("--loop"), "--loop"));
    } else if (arg == "--latency") {
      latency = static_cast<int>(parse_long(value("--latency"), "--latency"));
    } else if (arg == "--device") {
      const std::string d = value("--device");
      if (d != "cpu") die("--device takes cpu (the card is the default), got " + d);
      cpu = true;
    } else if (arg == "--ops") {
      ops = value("--ops");
    } else if (arg == "--out") {
      out_path = value("--out");
    } else if (pos < 4) {
      dims[pos++] = parse_long(argv[a], "dimension");
    } else {
      die("unexpected argument " + arg);
    }
  }
  if (pos != 0 && pos != 4) die("give all four of N H W C, or none");
  if (loop < 1) die("--loop must be at least 1");

  // The ops must be in the dispatcher before the package's proxy executor
  // looks them up by name and schema.
  if (!ops.empty() && dlopen(ops.c_str(), RTLD_NOW | RTLD_GLOBAL) == nullptr)
    die(std::string("cannot load the ops library: ") + dlerror());

  const at::Device device = cpu ? at::Device(at::kCPU) : at::Device(at::kCUDA, 0);
  torch::inductor::AOTIModelPackageLoader loader(model);
  std::vector<float> host = read_input(input, dims[0] * dims[1] * dims[2] * dims[3]);

  at::Tensor logits;
  const auto t0 = std::chrono::steady_clock::now();
  for (int it = 0; it < loop; ++it) logits = request(loader, host, dims, device);
  const double run_s =
      std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();

  const int64_t n = logits.size(0), classes = logits.numel() / std::max<int64_t>(n, 1);
  const float* data = logits.data_ptr<float>();
  for (int64_t img = 0; img < n; ++img) {
    const float* row = data + img * classes;
    int64_t best = 0;
    for (int64_t j = 1; j < classes; ++j)
      if (row[j] > row[best]) best = j;
    std::printf("image %lld: class %lld (logit %.4f)\n", static_cast<long long>(img),
                static_cast<long long>(best), row[best]);
  }
  if (!out_path.empty()) {
    std::ofstream f(out_path, std::ios::binary);
    f.write(reinterpret_cast<const char*>(data),
            static_cast<std::streamsize>(logits.numel() * sizeof(float)));
    if (!f) die("cannot write " + out_path);
  }
  std::fprintf(stderr, "%d run(s), %.3f ms/run, upload and fetch included (the first loads "
               "the program onto the device)\n", loop, run_s / loop * 1e3);

  // Serving latency: K full requests (host upload, run, fetch, argmax), each
  // wall-timed, what a frontend pays per request through this binary.
  if (latency > 0) {
    std::vector<double> samples;
    samples.reserve(latency);
    for (int it = 0; it < latency; ++it) {
      const auto s0 = std::chrono::steady_clock::now();
      at::Tensor out = request(loader, host, dims, device);
      volatile int64_t best = out[0].argmax().item<int64_t>();
      (void)best;
      samples.push_back(
          std::chrono::duration<double>(std::chrono::steady_clock::now() - s0).count());
    }
    std::sort(samples.begin(), samples.end());
    const size_t i99 = std::min(samples.size() - 1, static_cast<size_t>(samples.size() * 0.99));
    std::printf("latency_ms {\"samples\": %d, \"p50\": %.3f, \"p99\": %.3f}\n", latency,
                samples[samples.size() / 2] * 1e3, samples[i99] * 1e3);
  }
  return 0;
}
