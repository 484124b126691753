// Host-side batch-construction kernels for embedding training.
//
// C++ replacements for the reference's two numba-JIT kernels
// (reference utils/embeddings/data.py:191-240 skipgram_lookup, :243-311
// cbow_lookup) plus the center-context pair generator that feeds them (the
// gluonnlp EmbeddingCenterContextBatchify hot loop). These run on the host while
// the device computes the previous batch; C ABI, bound via ctypes
// (tennis_torch/native/__init__.py, which builds it into tennis_torch/build/).
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// COO (data,row,col) for SkipGram center rows: each center word i contributes its
// word index plus all its subword indices, weighted 1/(1+n_subwords).
// Returns the number of entries written; call with out_* == nullptr (capacity 0)
// to query the required size.
int64_t skipgram_lookup(const int64_t* indices, int64_t n_indices,
                        const int64_t* subwordidxs,
                        const int64_t* subwordidxsptr, int64_t offset,
                        float* out_data, int64_t* out_row, int64_t* out_col,
                        int64_t capacity) {
  int64_t total = 0;
  for (int64_t i = 0; i < n_indices; ++i) {
    int64_t idx = indices[i];
    int64_t start = subwordidxsptr[idx];
    int64_t end = subwordidxsptr[idx + 1];
    total += 1 + (end - start);
  }
  if (out_data == nullptr || capacity < total) return total;

  int64_t k = 0;
  for (int64_t i = 0; i < n_indices; ++i) {
    int64_t idx = indices[i];
    int64_t start = subwordidxsptr[idx];
    int64_t end = subwordidxsptr[idx + 1];
    float w = 1.0f / static_cast<float>(1 + end - start);
    out_data[k] = w;
    out_row[k] = i;
    out_col[k] = idx;
    ++k;
    for (int64_t s = start; s < end; ++s) {
      out_data[k] = w;
      out_row[k] = i;
      out_col[k] = subwordidxs[s] + offset;
      ++k;
    }
  }
  return k;
}

// COO for CBOW context rows: same expansion keyed by (row, col) context pairs,
// with per-row normalization by the number of context words in the row.
int64_t cbow_lookup(const int64_t* context_row, const int64_t* context_col,
                    int64_t n_context, const int64_t* subwordidxs,
                    const int64_t* subwordidxsptr, int64_t offset,
                    float* out_data, int64_t* out_row, int64_t* out_col,
                    int64_t capacity) {
  int64_t total = 0;
  int64_t num_rows = 0;
  for (int64_t i = 0; i < n_context; ++i) {
    int64_t idx = context_col[i];
    total += 1 + (subwordidxsptr[idx + 1] - subwordidxsptr[idx]);
    if (context_row[i] + 1 > num_rows) num_rows = context_row[i] + 1;
  }
  if (out_data == nullptr || capacity < total) return total;

  std::vector<double> row_to_numwords(num_rows, 0.0);
  for (int64_t i = 0; i < n_context; ++i) row_to_numwords[context_row[i]] += 1.0;

  int64_t k = 0;
  for (int64_t i = 0; i < n_context; ++i) {
    int64_t idx = context_col[i];
    int64_t r = context_row[i];
    int64_t start = subwordidxsptr[idx];
    int64_t end = subwordidxsptr[idx + 1];
    float w = 1.0f / static_cast<float>(1 + end - start);
    w /= static_cast<float>(row_to_numwords[r]);
    out_data[k] = w;
    out_row[k] = r;
    out_col[k] = idx;
    ++k;
    for (int64_t s = start; s < end; ++s) {
      out_data[k] = w;
      out_row[k] = r;
      out_col[k] = subwordidxs[s] + offset;
      ++k;
    }
  }
  return k;
}

// Center-context pair generation over coded sentences (the batchify hot loop):
// for each position t, sample a reduced window r ~ U[1, window] and emit
// (center=s[t], context=s[t+d]) for 0 < |d| <= r. Sentences are passed flattened
// with offsets; pairs are written up to capacity (query size with nullptr).
int64_t center_context_pairs(const int64_t* tokens, const int64_t* sent_ptr,
                             int64_t n_sents, int64_t window, uint64_t seed,
                             int64_t* out_center, int64_t* out_context,
                             int64_t capacity) {
  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<int64_t> wdist(1, window);
  int64_t k = 0;
  for (int64_t s = 0; s < n_sents; ++s) {
    int64_t start = sent_ptr[s], end = sent_ptr[s + 1];
    for (int64_t t = start; t < end; ++t) {
      int64_t r = wdist(rng);
      int64_t lo = t - r < start ? start : t - r;
      int64_t hi = t + r + 1 > end ? end : t + r + 1;
      for (int64_t c = lo; c < hi; ++c) {
        if (c == t) continue;
        if (out_center != nullptr && k < capacity) {
          out_center[k] = tokens[t];
          out_context[k] = tokens[c];
        }
        ++k;
      }
    }
  }
  return k;
}

}  // extern "C"
