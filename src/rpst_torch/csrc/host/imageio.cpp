// Native image IO for the rpst input pipeline.
//
// The reference feeds training through torch.utils.data.DataLoader worker
// processes whose decode path is PIL (reference train.py:160-170,41-46);
// the framework's Python loader threads call into this library instead:
// libjpeg/libpng decode + a bit-exact reimplementation of PIL's fixed-point
// bilinear resample (the reference transform is
// transforms.Resize((img_size, img_size), BILINEAR) + ToTensor()).  ctypes
// releases the GIL for the call, so decode parallelism is real OS-thread
// parallelism with no fork/pickle overhead.
//
// Exact-parity notes: Pillow resamples uint8 images with INT32 fixed-point
// coefficients at PRECISION_BITS = 32-8-2 and a two-pass (horizontal then
// vertical) schedule with a uint8 intermediate; this file reproduces that
// arithmetic exactly, so np.asarray(Image.open(p).convert("RGB")
// .resize((s, s), BILINEAR)) and rpst_load_image_rgb(p, s, s) agree byte
// for byte on every JPEG/PNG the fast path accepts.  Anything else
// (CMYK/16-bit/interlaced/EXIF-rotated...) returns an error and the Python
// caller falls back to PIL.
//
// Build: rpst_torch.kernels.build.load("imageio") at first use, with $CXX
// (else g++) into build/rpst_torch/ (linked against the system libjpeg +
// libpng).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow's 8bpc fixed point

inline uint8_t clip8(int in) {
    if (in >= (1 << kPrecisionBits << 8)) return 255;
    if (in <= 0) return 0;
    return static_cast<uint8_t>(in >> kPrecisionBits);
}

// Pillow precompute_coeffs for the triangle (bilinear) filter, support=1.
// Returns ksize; fills bounds[2*out] (xmin, xcount) and kk[out*ksize].
int precompute_coeffs(int in_size, int out_size,
                      std::vector<int>& bounds, std::vector<double>& kk) {
    const double scale = static_cast<double>(in_size) / out_size;
    const double filterscale = scale < 1.0 ? 1.0 : scale;
    const double support = 1.0 * filterscale;
    const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
    bounds.assign(static_cast<size_t>(out_size) * 2, 0);
    kk.assign(static_cast<size_t>(out_size) * ksize, 0.0);
    const double ss = 1.0 / filterscale;
    for (int xx = 0; xx < out_size; ++xx) {
        const double center = (xx + 0.5) * scale;
        int xmin = static_cast<int>(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = static_cast<int>(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double* k = &kk[static_cast<size_t>(xx) * ksize];
        double ww = 0.0;
        for (int x = 0; x < xmax; ++x) {
            double arg = (x + xmin - center + 0.5) * ss;
            double w = arg < 0 ? -arg : arg;       // |x|
            w = w < 1.0 ? 1.0 - w : 0.0;           // triangle
            k[x] = w;
            ww += w;
        }
        for (int x = 0; x < xmax; ++x) {
            if (ww != 0.0) k[x] /= ww;
        }
        bounds[static_cast<size_t>(xx) * 2 + 0] = xmin;
        bounds[static_cast<size_t>(xx) * 2 + 1] = xmax;
    }
    return ksize;
}

void normalize_coeffs_8bpc(const std::vector<double>& kk,
                           std::vector<int>& kk_int) {
    kk_int.resize(kk.size());
    for (size_t i = 0; i < kk.size(); ++i) {
        kk_int[i] = kk[i] < 0
            ? static_cast<int>(-0.5 + kk[i] * (1 << kPrecisionBits))
            : static_cast<int>(0.5 + kk[i] * (1 << kPrecisionBits));
    }
}

// Two-pass uint8 RGB resample, bit-exact with Pillow BILINEAR.
void resample_bilinear_rgb(const uint8_t* in, int in_w, int in_h,
                           uint8_t* out, int out_w, int out_h) {
    if (in_w == out_w && in_h == out_h) {
        std::memcpy(out, in, static_cast<size_t>(in_w) * in_h * 3);
        return;
    }
    std::vector<int> bounds_h, bounds_v, kint;
    std::vector<double> kk;

    // horizontal pass: (in_h, in_w) -> (in_h, out_w)
    std::vector<uint8_t> tmp(static_cast<size_t>(in_h) * out_w * 3);
    {
        const int ksize = precompute_coeffs(in_w, out_w, bounds_h, kk);
        normalize_coeffs_8bpc(kk, kint);
        for (int y = 0; y < in_h; ++y) {
            const uint8_t* row = in + static_cast<size_t>(y) * in_w * 3;
            uint8_t* orow = tmp.data() + static_cast<size_t>(y) * out_w * 3;
            for (int xx = 0; xx < out_w; ++xx) {
                const int xmin = bounds_h[static_cast<size_t>(xx) * 2];
                const int xcnt = bounds_h[static_cast<size_t>(xx) * 2 + 1];
                const int* k = &kint[static_cast<size_t>(xx) * ksize];
                int s0 = 1 << (kPrecisionBits - 1);
                int s1 = s0, s2 = s0;
                for (int x = 0; x < xcnt; ++x) {
                    const uint8_t* p = row + static_cast<size_t>(xmin + x) * 3;
                    s0 += p[0] * k[x];
                    s1 += p[1] * k[x];
                    s2 += p[2] * k[x];
                }
                orow[xx * 3 + 0] = clip8(s0);
                orow[xx * 3 + 1] = clip8(s1);
                orow[xx * 3 + 2] = clip8(s2);
            }
        }
    }
    // vertical pass: (in_h, out_w) -> (out_h, out_w)
    {
        const int ksize = precompute_coeffs(in_h, out_h, bounds_v, kk);
        normalize_coeffs_8bpc(kk, kint);
        for (int yy = 0; yy < out_h; ++yy) {
            const int ymin = bounds_v[static_cast<size_t>(yy) * 2];
            const int ycnt = bounds_v[static_cast<size_t>(yy) * 2 + 1];
            const int* k = &kint[static_cast<size_t>(yy) * ksize];
            uint8_t* orow = out + static_cast<size_t>(yy) * out_w * 3;
            for (int xx = 0; xx < out_w * 3; ++xx) {
                int s = 1 << (kPrecisionBits - 1);
                for (int y = 0; y < ycnt; ++y) {
                    s += tmp[static_cast<size_t>(ymin + y) * out_w * 3 + xx]
                         * k[y];
                }
                orow[xx] = clip8(s);
            }
        }
    }
}

// ---------------- JPEG ----------------

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(e->jb, 1);
}

// decode to RGB8; returns 0 on success, caller owns *out (malloc'd)
int decode_jpeg(FILE* f, uint8_t** out, int* w, int* h) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    uint8_t* buf = nullptr;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        std::free(buf);
        return -2;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    if (cinfo.jpeg_color_space == JCS_CMYK ||
        cinfo.jpeg_color_space == JCS_YCCK) {
        jpeg_destroy_decompress(&cinfo);
        return -3;  // PIL fallback handles CMYK
    }
    cinfo.out_color_space = JCS_RGB;  // libjpeg converts gray/YCbCr
    jpeg_start_decompress(&cinfo);
    *w = static_cast<int>(cinfo.output_width);
    *h = static_cast<int>(cinfo.output_height);
    if (cinfo.output_components != 3) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return -3;
    }
    buf = static_cast<uint8_t*>(
        std::malloc(static_cast<size_t>(*w) * *h * 3));
    if (!buf) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return -4;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = buf + static_cast<size_t>(cinfo.output_scanline)
                              * *w * 3;
        JSAMPROW rows[1] = {row};
        jpeg_read_scanlines(&cinfo, rows, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    *out = buf;
    return 0;
}

// ---------------- PNG ----------------

int decode_png(FILE* f, uint8_t** out, int* w, int* h) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                             nullptr, nullptr, nullptr);
    if (!png) return -4;
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_read_struct(&png, nullptr, nullptr);
        return -4;
    }
    uint8_t* buf = nullptr;
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        std::free(buf);
        return -2;
    }
    png_init_io(png, f);
    png_read_info(png, info);
    const png_byte color = png_get_color_type(png, info);
    const png_byte depth = png_get_bit_depth(png, info);
    if (png_get_interlace_type(png, info) != PNG_INTERLACE_NONE) {
        png_destroy_read_struct(&png, &info, nullptr);
        return -3;  // rare; PIL fallback
    }
    if (depth == 16) png_set_strip_16(png);
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
        png_set_expand_gray_1_2_4_to_8(png);
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
        png_set_gray_to_rgb(png);
    // PIL convert("RGB") on RGBA drops alpha without compositing; ditto
    if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS))
        png_set_strip_alpha(png);   // after palette expand adds alpha
    png_read_update_info(png, info);
    *w = static_cast<int>(png_get_image_width(png, info));
    *h = static_cast<int>(png_get_image_height(png, info));
    if (png_get_channels(png, info) != 3) {
        png_destroy_read_struct(&png, &info, nullptr);
        return -3;
    }
    buf = static_cast<uint8_t*>(
        std::malloc(static_cast<size_t>(*w) * *h * 3));
    if (!buf) {
        png_destroy_read_struct(&png, &info, nullptr);
        return -4;
    }
    std::vector<png_bytep> rows(*h);
    for (int y = 0; y < *h; ++y)
        rows[y] = buf + static_cast<size_t>(y) * *w * 3;
    png_read_image(png, rows.data());
    png_read_end(png, nullptr);
    png_destroy_read_struct(&png, &info, nullptr);
    *out = buf;
    return 0;
}

int decode_file(const char* path, uint8_t** out, int* w, int* h) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    uint8_t magic[8] = {0};
    const size_t n = std::fread(magic, 1, 8, f);
    std::rewind(f);
    int rc = -3;
    if (n >= 3 && magic[0] == 0xFF && magic[1] == 0xD8 && magic[2] == 0xFF) {
        rc = decode_jpeg(f, out, w, h);
    } else if (n >= 8 && !png_sig_cmp(magic, 0, 8)) {
        rc = decode_png(f, out, w, h);
    }
    std::fclose(f);
    return rc;
}

}  // namespace

extern "C" {

// Decode path, convert to RGB, bilinear-squash to (out_h, out_w), write
// float32 HWC in [0,1].  out must hold out_h*out_w*3 floats.
// Returns 0 ok; -1 open failure; -2 corrupt; -3 unsupported format
// (caller should fall back to PIL); -4 OOM.
int rpst_load_image_rgb(const char* path, int out_w, int out_h, float* out) {
    uint8_t* rgb = nullptr;
    int w = 0, h = 0;
    const int rc = decode_file(path, &rgb, &w, &h);
    if (rc != 0) return rc;
    const size_t npx = static_cast<size_t>(out_w) * out_h * 3;
    if (w == out_w && h == out_h) {
        for (size_t i = 0; i < npx; ++i)
            out[i] = rgb[i] / 255.0f;
    } else {
        std::vector<uint8_t> resized(npx);
        resample_bilinear_rgb(rgb, w, h, resized.data(), out_w, out_h);
        for (size_t i = 0; i < npx; ++i)
            out[i] = resized[i] / 255.0f;
    }
    std::free(rgb);
    return 0;
}

// Native-size probe (header-only, no pixel decode) so callers can
// allocate for img_size=0 (no-resize) use.
int rpst_image_size(const char* path, int* w, int* h) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    uint8_t magic[8] = {0};
    const size_t n = std::fread(magic, 1, 8, f);
    std::rewind(f);
    int rc = -3;
    if (n >= 3 && magic[0] == 0xFF && magic[1] == 0xD8 && magic[2] == 0xFF) {
        jpeg_decompress_struct cinfo;
        JpegErr jerr;
        cinfo.err = jpeg_std_error(&jerr.mgr);
        jerr.mgr.error_exit = jpeg_err_exit;
        if (setjmp(jerr.jb)) {
            jpeg_destroy_decompress(&cinfo);
            std::fclose(f);
            return -2;
        }
        jpeg_create_decompress(&cinfo);
        jpeg_stdio_src(&cinfo, f);
        jpeg_read_header(&cinfo, TRUE);
        *w = static_cast<int>(cinfo.image_width);
        *h = static_cast<int>(cinfo.image_height);
        jpeg_destroy_decompress(&cinfo);
        rc = 0;
    } else if (n >= 8 && !png_sig_cmp(magic, 0, 8)) {
        png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                                 nullptr, nullptr, nullptr);
        png_infop info = png ? png_create_info_struct(png) : nullptr;
        if (png && info && !setjmp(png_jmpbuf(png))) {
            png_init_io(png, f);
            png_read_info(png, info);
            *w = static_cast<int>(png_get_image_width(png, info));
            *h = static_cast<int>(png_get_image_height(png, info));
            rc = 0;
        } else if (png) {
            rc = -2;
        }
        if (png) png_destroy_read_struct(&png, info ? &info : nullptr,
                                         nullptr);
    }
    std::fclose(f);
    return rc;
}

}  // extern "C"
