// Native raw-f32 tensor file IO — the checkpoint hot path.
//
// The reference reads ~467 weight files one ifstream at a time with a device
// sync per file (cuda/tensor.cuh:126-152, SURVEY.md §3.1).  Here the whole
// checkpoint directory is slurped by a thread pool into one caller-provided
// arena (offsets precomputed from the model's shape table), so the host side
// of a ResNet-152 load is a few hundred parallel preads instead of a serial
// read-copy-sync chain; the device side is a single device_put of the
// assembled pytree.
//
// C ABI via ctypes (resnetc_tpu_torch/native/__init__.py); 0 on success,
// negative on error.

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Read exactly `bytes` from path into dst. Returns 0 / negative error.
int read_file(const char *path, void *dst, int64_t bytes) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    int64_t off = 0;
    while (off < bytes) {
        ssize_t r = pread(fd, static_cast<char *>(dst) + off, bytes - off, off);
        if (r < 0) {
            close(fd);
            return -2;
        }
        if (r == 0) break;  // short file
        off += r;
    }
    close(fd);
    return off == bytes ? 0 : -3;
}

}  // namespace

extern "C" {

// Size in bytes of a file, or -1.
int64_t rn_file_size(const char *path) {
    struct stat st;
    if (stat(path, &st) != 0) return -1;
    return static_cast<int64_t>(st.st_size);
}

// Read a whole little-endian f32 file into out (capacity max_elems floats).
// Returns the number of floats read, or negative on error/overflow.
int64_t rn_read_f32(const char *path, float *out, int64_t max_elems) {
    const int64_t bytes = rn_file_size(path);
    if (bytes < 0) return -1;
    if (bytes % 4 != 0) return -4;
    if (bytes / 4 > max_elems) return -5;
    if (int rc = read_file(path, out, bytes); rc != 0) return rc;
    return bytes / 4;
}

// Write n floats as a raw little-endian f32 file (the reference's
// save_weights.py format). Returns 0 / negative.
int rn_write_f32(const char *path, const float *data, int64_t n) {
    FILE *f = fopen(path, "wb");
    if (!f) return -1;
    const size_t written = fwrite(data, 4, static_cast<size_t>(n), f);
    fclose(f);
    return written == static_cast<size_t>(n) ? 0 : -2;
}

// Parallel multi-file load into one arena.
// paths: n C strings; offsets/num_elems: per-file float offset into `arena`
// and expected element count. Returns 0, or the first per-file error
// (-3 = size mismatch with expectation).
int rn_read_f32_many(const char **paths, const int64_t *offsets,
                     const int64_t *num_elems, int n, float *arena,
                     int num_threads) {
    if (n <= 0) return 0;
    num_threads = std::max(1, std::min(num_threads, n));
    std::vector<int> codes(n, 0);
    std::atomic_int next{0};
    auto worker = [&]() {
        for (;;) {
            const int i = next.fetch_add(1);
            if (i >= n) break;
            const int64_t bytes = rn_file_size(paths[i]);
            if (bytes != num_elems[i] * 4) {
                codes[i] = -3;
                continue;
            }
            codes[i] = read_file(paths[i], arena + offsets[i], bytes);
        }
    };
    std::vector<std::thread> threads;
    threads.reserve(num_threads);
    for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
    for (auto &t : threads) t.join();
    for (int c : codes)
        if (c != 0) return c;
    return 0;
}

}  // extern "C"
