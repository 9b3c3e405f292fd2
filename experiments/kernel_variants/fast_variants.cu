// Variants of photogrammetry_tpu_torch/csrc/fast_stencil.cu timed by run.py:
// the package's kernel template with and without the compass pre-test, at 4
// or 1 pixels a thread, at other tile heights, and with the scalar staging
// forced where the 16-byte one would serve; the package's own choice is
// variant 0.
#include "../../photogrammetry_tpu_torch/csrc/fast_stencil.cu"

// variant: 0 = 4 pixels, compass, 64 rows (the package's); 1 = no compass;
// 2 = 1 pixel; 3 = 1 pixel, no compass; 4 = 32 rows; 5 = 16 rows; 6 = the
// package's with scalar staging
extern "C" int exp_launch(int variant, const float* img, int32_t* out, int b,
                          int h, int w, float thr, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (variant == 6) return launch<4, true, 64, false>(img, out, b, h, w, thr, s);
  if (!rows_aligned(img, w)) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 0: return launch<4, true, 64, true>(img, out, b, h, w, thr, s);
    case 1: return launch<4, false, 64, true>(img, out, b, h, w, thr, s);
    case 2: return launch<1, true, 64, true>(img, out, b, h, w, thr, s);
    case 3: return launch<1, false, 64, true>(img, out, b, h, w, thr, s);
    case 4: return launch<4, true, 32, true>(img, out, b, h, w, thr, s);
    case 5: return launch<4, true, 16, true>(img, out, b, h, w, thr, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
