// Known-bad fixture for the launch audit (never compiled): the entry the
// wrappers of kernels/bad_kernel/ops.py call, and one no wrapper reaches.

// q, out: (B, K, G, D); k_pages, v_pages: (P, ps, K, D); page_table:
// (B, MP) int32; seq_lens: (B,) int32.
extern "C" int bad_attention_f32(const float* q, const float* k_pages,
                                 const float* v_pages, const int* page_table,
                                 const int* seq_lens, float* out, int B,
                                 int K, int G, int D, int ps, int MP,
                                 int pages_start, int pages_end, int window,
                                 void* stream) {
  return 0;
}

/* no wrapper calls this one: kernel-uncovered */
extern "C" long long bad_unreached_bytes(int B) { return 4LL * B; }
