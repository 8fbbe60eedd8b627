// Host-side data kernels of the HEM and DGM input pipelines: the dense
// flow of a homography and the normalized grayscale of an RGB image.  Each keeps the float64 arithmetic of its numpy twin
// (dmhomo_torch/geometry/host.py, dmhomo_torch/data/hem_data.py) and writes
// float32, without numpy's temporaries.
//
// Built at first use by dmhomo_torch/native/__init__.py:
//   c++ -O3 -shared -fPIC hemdata.cpp -o libhemdata_<hash>.so
// and bound with ctypes.

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

// gray = mean over c of (img_c - mean_c) / std_c in float64, float32 out;
// img (h, w, 3) of T, out (h, w).
template <typename T>
void normalize_gray(const T* img, int h, int w, const double* mean, const double* std,
                    float* out) {
    const double m0 = mean[0], m1 = mean[1], m2 = mean[2];
    const double i0 = 1.0 / std[0], i1 = 1.0 / std[1], i2 = 1.0 / std[2];
    const size_t n = (size_t)h * w;
    for (size_t p = 0; p < n; ++p) {
        const T* px = img + 3 * p;
        const double a = ((double)px[0] - m0) * i0;
        const double b = ((double)px[1] - m1) * i1;
        const double c = ((double)px[2] - m2) * i2;
        out[p] = (float)((a + b + c) / 3.0);
    }
}

}  // namespace

extern "C" {

// flow(x, y) = H(x, y) - (x, y) in float64 with the +eps divide guard,
// float32 out, (h, w, 2) as (u, v).
void homography_flow_f32(const double* H, int h, int w, double eps, float* out) {
    const double h00 = H[0], h01 = H[1], h02 = H[2];
    const double h10 = H[3], h11 = H[4], h12 = H[5];
    const double h20 = H[6], h21 = H[7], h22 = H[8];
    for (int y = 0; y < h; ++y) {
        const double fy = (double)y;
        float* row = out + (size_t)y * w * 2;
        for (int x = 0; x < w; ++x) {
            const double fx = (double)x;
            const double u = h00 * fx + h01 * fy + h02;
            const double v = h10 * fx + h11 * fy + h12;
            const double z = h20 * fx + h21 * fy + h22 + eps;
            row[2 * x + 0] = (float)(u / z - fx);
            row[2 * x + 1] = (float)(v / z - fy);
        }
    }
}

void normalize_gray_u8(const uint8_t* img, int h, int w, const double* mean, const double* std,
                       float* out) {
    normalize_gray(img, h, w, mean, std, out);
}

void normalize_gray_f32(const float* img, int h, int w, const double* mean, const double* std,
                        float* out) {
    normalize_gray(img, h, w, mean, std, out);
}

void normalize_gray_f64(const double* img, int h, int w, const double* mean, const double* std,
                        float* out) {
    normalize_gray(img, h, w, mean, std, out);
}

}  // extern "C"
