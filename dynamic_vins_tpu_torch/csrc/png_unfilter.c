/* PNG row un-filtering (PNG specification, section 9: filter method 0).
 *
 * Each of `rows` scanlines in `src` is one filter-type byte followed by
 * `stride` filtered bytes; `dst` receives the rows * stride raw bytes.
 * `bpp` is the number of bytes per complete pixel (at least 1), the
 * distance to the "left" byte of the Sub, Average and Paeth filters.
 * Average and Paeth depend on the byte just reconstructed to the left,
 * so each row is one sequential pass.
 *
 * Returns 0, or 1 + the index of the first row whose filter type is not
 * one of 0-4 (dst is then incomplete).
 *
 * Plain C, built with the host compiler at first use by
 * dynamic_vins_tpu_torch/ops/build.py; io/image_io.py calls it through
 * ctypes and keeps a numpy version of the same function.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline uint8_t paeth(int a, int b, int c)
{
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc)
        return (uint8_t)a;
    if (pb <= pc)
        return (uint8_t)b;
    return (uint8_t)c;
}

int png_unfilter(const uint8_t *src, uint8_t *dst, int64_t rows,
                 int64_t stride, int64_t bpp)
{
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t *in = src + r * (stride + 1) + 1;
        uint8_t *out = dst + r * stride;
        const uint8_t *up = r ? out - stride : NULL;
        int64_t i;
        switch (src[r * (stride + 1)]) {
        case 0:
            memcpy(out, in, (size_t)stride);
            break;
        case 1:
            for (i = 0; i < stride; ++i)
                out[i] = (uint8_t)(in[i] + (i >= bpp ? out[i - bpp] : 0));
            break;
        case 2:
            for (i = 0; i < stride; ++i)
                out[i] = (uint8_t)(in[i] + (up ? up[i] : 0));
            break;
        case 3:
            for (i = 0; i < stride; ++i) {
                int a = i >= bpp ? out[i - bpp] : 0;
                int b = up ? up[i] : 0;
                out[i] = (uint8_t)(in[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (i = 0; i < stride; ++i) {
                int a = i >= bpp ? out[i - bpp] : 0;
                int b = up ? up[i] : 0;
                int c = (up && i >= bpp) ? up[i - bpp] : 0;
                out[i] = (uint8_t)(in[i] + paeth(a, b, c));
            }
            break;
        default:
            return (int)(r + 1);
        }
    }
    return 0;
}
