// Native ingest: JPEG decode + preprocessing for the serving/training path.
//
// The serving host's counterpart of the reference's offline Python
// preprocessing (convert_imgs_to_bin.py: PIL decode -> torchvision
// resize/crop/normalize -> .bin).  Runs in-process on the serving host
// instead: libjpeg decode, PIL-compatible antialiased bilinear resample
// (triangle filter whose support scales with the downsampling ratio —
// bit-for-bit the algorithm PIL uses, so numerics match the Python path),
// center crop, and mean/std normalisation straight into a caller-provided
// float32 NHWC buffer.  A std::thread pool fans out over a batch of files.
//
// Exposed as a C ABI consumed via ctypes
// (resnetc_tpu_torch/native/__init__.py); every function returns 0 on
// success or a negative errno-style code.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

// jpeglib.h requires size_t/FILE to be declared before inclusion.
#include <jpeglib.h>

namespace {

struct JpegErrorMgr {
    jpeg_error_mgr pub;
    jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
    auto *err = reinterpret_cast<JpegErrorMgr *>(cinfo->err);
    longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file to tightly-packed RGB8. Returns 0 on success.
int decode_jpeg(const char *path, std::vector<uint8_t> &rgb, int &w, int &h) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;

    jpeg_decompress_struct cinfo;
    JpegErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        fclose(f);
        return -2;  // corrupt / not a JPEG
    }

    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);

    w = static_cast<int>(cinfo.output_width);
    h = static_cast<int>(cinfo.output_height);
    rgb.resize(static_cast<size_t>(w) * h * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t *row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 0;
}

// One axis of PIL's antialiased resampling: precompute, for every output
// index, the input span [start, start+len) and normalised triangle-filter
// weights.  Matches PIL's ImagingResampleHorizontal coefficient math.
struct ResampleCoeffs {
    std::vector<int> start;
    std::vector<int> len;
    std::vector<std::vector<float>> weights;
};

ResampleCoeffs compute_coeffs(int in_size, int out_size) {
    ResampleCoeffs rc;
    rc.start.resize(out_size);
    rc.len.resize(out_size);
    rc.weights.resize(out_size);

    const double scale = static_cast<double>(in_size) / out_size;
    const double filterscale = std::max(scale, 1.0);
    const double support = 1.0 * filterscale;  // bilinear filter support = 1

    for (int xx = 0; xx < out_size; ++xx) {
        const double center = (xx + 0.5) * scale;
        int xmin = static_cast<int>(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = static_cast<int>(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;

        std::vector<float> w(xmax - xmin);
        double total = 0.0;
        for (int x = xmin; x < xmax; ++x) {
            double d = (x - center + 0.5) / filterscale;
            double v = (d < 0 ? -d : d) < 1.0 ? 1.0 - std::abs(d) : 0.0;
            w[x - xmin] = static_cast<float>(v);
            total += v;
        }
        if (total > 0) {
            for (auto &v : w) v = static_cast<float>(v / total);
        }
        rc.start[xx] = xmin;
        rc.len[xx] = xmax - xmin;
        rc.weights[xx] = std::move(w);
    }
    return rc;
}

// Full pipeline for one image into out[crop*crop*3] (HWC float32).
int preprocess_one(const char *path, int resize_short, int crop,
                   const float *mean, const float *stdv, float *out) {
    std::vector<uint8_t> rgb;
    int w, h;
    if (int rc = decode_jpeg(path, rgb, w, h); rc != 0) return rc;
    if (w <= 0 || h <= 0) return -3;

    // Short-side resize target.
    int nw, nh;
    if (w <= h) {
        nw = resize_short;
        nh = std::max(1, static_cast<int>(std::lround(
                 static_cast<double>(h) * resize_short / w)));
    } else {
        nh = resize_short;
        nw = std::max(1, static_cast<int>(std::lround(
                 static_cast<double>(w) * resize_short / h)));
    }
    if (crop > nw || crop > nh) return -4;

    // Horizontal pass: (h, w, 3) u8 -> (h, nw, 3) f32.
    ResampleCoeffs cx = compute_coeffs(w, nw);
    std::vector<float> tmp(static_cast<size_t>(h) * nw * 3);
    for (int y = 0; y < h; ++y) {
        const uint8_t *row = rgb.data() + static_cast<size_t>(y) * w * 3;
        float *orow = tmp.data() + static_cast<size_t>(y) * nw * 3;
        for (int x = 0; x < nw; ++x) {
            float acc0 = 0, acc1 = 0, acc2 = 0;
            const int s = cx.start[x];
            const auto &wt = cx.weights[x];
            for (int k = 0; k < cx.len[x]; ++k) {
                const uint8_t *px = row + static_cast<size_t>(s + k) * 3;
                acc0 += wt[k] * px[0];
                acc1 += wt[k] * px[1];
                acc2 += wt[k] * px[2];
            }
            // PIL's two-pass resample stores an 8-bit intermediate image;
            // round here too so the passes stay numerically aligned with it.
            auto q = [](float v) {
                return std::min(255.0f, std::max(0.0f, std::roundf(v)));
            };
            orow[x * 3 + 0] = q(acc0);
            orow[x * 3 + 1] = q(acc1);
            orow[x * 3 + 2] = q(acc2);
        }
    }

    // Vertical pass fused with center-crop + normalize:
    // only the crop window's rows/cols are computed.
    ResampleCoeffs cy = compute_coeffs(h, nh);
    const int x0 = (nw - crop) / 2;
    const int y0 = (nh - crop) / 2;
    const float inv255 = 1.0f / 255.0f;
    for (int yy = 0; yy < crop; ++yy) {
        const int oy = y0 + yy;
        const int s = cy.start[oy];
        const auto &wt = cy.weights[oy];
        float *orow = out + static_cast<size_t>(yy) * crop * 3;
        for (int xx = 0; xx < crop; ++xx) {
            const int ox = x0 + xx;
            float acc0 = 0, acc1 = 0, acc2 = 0;
            for (int k = 0; k < cy.len[oy]; ++k) {
                const float *px =
                    tmp.data() + (static_cast<size_t>(s + k) * nw + ox) * 3;
                acc0 += wt[k] * px[0];
                acc1 += wt[k] * px[1];
                acc2 += wt[k] * px[2];
            }
            // PIL clips + rounds to u8 between resize and ToTensor; match it.
            auto clip = [](float v) {
                return std::min(255.0f, std::max(0.0f, std::roundf(v)));
            };
            orow[xx * 3 + 0] = (clip(acc0) * inv255 - mean[0]) / stdv[0];
            orow[xx * 3 + 1] = (clip(acc1) * inv255 - mean[1]) / stdv[1];
            orow[xx * 3 + 2] = (clip(acc2) * inv255 - mean[2]) / stdv[2];
        }
    }
    return 0;
}

}  // namespace

extern "C" {

// Decode+preprocess one image file. out must hold crop*crop*3 floats (HWC).
int rn_preprocess_file(const char *path, int resize_short, int crop,
                       const float *mean, const float *stdv, float *out) {
    return preprocess_one(path, resize_short, crop, mean, stdv, out);
}

// Batch version with a thread pool. paths: array of n C strings; out must
// hold n*crop*crop*3 floats. Returns 0, or the first nonzero per-image code.
int rn_preprocess_batch(const char **paths, int n, int resize_short, int crop,
                        const float *mean, const float *stdv, float *out,
                        int num_threads) {
    if (n <= 0) return 0;
    num_threads = std::max(1, std::min(num_threads, n));
    std::vector<int> codes(n, 0);
    std::vector<std::thread> threads;
    const size_t stride = static_cast<size_t>(crop) * crop * 3;

    std::atomic_int next{0};
    auto worker = [&]() {
        for (;;) {
            const int i = next.fetch_add(1);
            if (i >= n) break;
            codes[i] = preprocess_one(paths[i], resize_short, crop, mean, stdv,
                                      out + stride * i);
        }
    };
    threads.reserve(num_threads);
    for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
    for (auto &t : threads) t.join();
    for (int c : codes)
        if (c != 0) return c;
    return 0;
}

}  // extern "C"
