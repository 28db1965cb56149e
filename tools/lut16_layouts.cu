// K1 and K2 (src/repro_torch/csrc/lut16.cu) at other shapes of their LUT
// image, for tools/lut16_probe.py: QV queries per shared load, 1 (LDS.32),
// 2 (LDS.64) or 4 (LDS.128), and K1 at 16 queries per CTA, all on unpacked
// codes.  Built by the probe with the kernels' nvcc flags; nothing else
// uses it.

#include "../src/repro_torch/csrc/lut16.cu"

#define LAYOUT_CASE(BQ, QV)                                                \
  case BQ * 8 + QV:                                                        \
    return launch_adc<BQ, false, QV>(c, l, o, n, kc, q, kl, threads,       \
                                     rows_per_cta, kc, s);

extern "C" int lut16_adc_layout_launch(const void* codes, const void* lut,
                                       void* out, long long n, int kc, int q,
                                       int kl, int bq, int qv, int threads,
                                       int rows_per_cta, void* stream) {
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* l = static_cast<const float*>(lut);
  auto* o = static_cast<float*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  switch (bq * 8 + qv) {
    LAYOUT_CASE(8, 1)
    LAYOUT_CASE(8, 2)
    LAYOUT_CASE(8, 4)
    LAYOUT_CASE(16, 1)
    LAYOUT_CASE(16, 2)
    default: return (int)cudaErrorInvalidValue;
  }
}

// K2 with its query block's image at qv queries per load; arguments as
// lut16_topk_launch's (one chunk of K).
extern "C" int lut16_topk_layout_launch(
    const void* codes, const void* lut, const void* base,
    long long base_qstride, void* thresholds, void* scratch_a,
    void* scratch_b, void* out_s, void* out_i, long long n, int kc, int q,
    int kl, int bq, int qv, int rows_per_cta, int cbuf, void* stream) {
#define TOPK_ARGS                                                          \
  static_cast<const uint8_t*>(codes), static_cast<const float*>(lut),      \
      static_cast<const float*>(base), base_qstride,                       \
      static_cast<uint32_t*>(thresholds),                                  \
      static_cast<unsigned long long*>(scratch_a),                         \
      static_cast<unsigned long long*>(scratch_b),                         \
      static_cast<float*>(out_s), static_cast<int*>(out_i), n, kc, q, kl,  \
      rows_per_cta, cbuf, kc, static_cast<cudaStream_t>(stream)
  switch (bq * 8 + qv) {
    case 1 * 8 + 1: return launch_topk<1, false, 1>(TOPK_ARGS);
    case 4 * 8 + 1: return launch_topk<4, false, 1>(TOPK_ARGS);
    case 4 * 8 + 2: return launch_topk<4, false, 2>(TOPK_ARGS);
    case 4 * 8 + 4: return launch_topk<4, false, 4>(TOPK_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TOPK_ARGS
}
