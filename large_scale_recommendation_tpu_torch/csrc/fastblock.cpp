// fastblock: native host-side ingest + blocking helpers (the PyTorch
// port's own copy of the JAX package's csrc/fastblock.cpp, same entry
// points and results).
//
// The host-side preprocessing in front of the DSGD kernels is NumPy
// everywhere else; these steps are the ones where NumPy's sorts and text
// readers dominate at ML-25M size:
//
//   fb_parse_ratings         stream-parse a delimited ratings file
//                            (user, item, rating[, timestamp]) into COO
//   fb_compact_ids           hash-map id compaction: unique ids in
//                            first-seen order + inverse indices +
//                            occurrence counts (the omegas) in one pass
//   fb_stable_bucket         stable counting sort by a small key
//   fb_minibatch_inv_counts  per-entry 1/(row occurrences in its chunk)
//   fb_free                  release buffers returned by the above
//
// Built by g++ at first use and bound with ctypes (ops/_build.py); the
// Python side and the NumPy plain versions are in data/native.py.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// Parse a delimited ratings file. Lines shorter than 3 fields are skipped.
// skip_header: number of leading lines to drop. Returns the number of
// parsed rows, or -1 on I/O error. Output arrays are malloc'd; free with
// fb_free.
int64_t fb_parse_ratings(const char* path, char delim, int skip_header,
                         int64_t** users_out, int64_t** items_out,
                         float** vals_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;

  std::vector<int64_t> users, items;
  std::vector<float> vals;
  users.reserve(1 << 20);
  items.reserve(1 << 20);
  vals.reserve(1 << 20);

  constexpr size_t BUF = 1 << 22;  // 4 MiB read buffer
  std::vector<char> buf(BUF);
  std::string carry;
  int to_skip = skip_header;

  auto parse_line = [&](const char* s, const char* end) {
    if (to_skip > 0) {
      --to_skip;
      return;
    }
    // field 1: user
    char* p = nullptr;
    long long u = std::strtoll(s, &p, 10);
    if (p == s || p >= end || *p != delim) return;
    const char* s2 = p + 1;
    long long i = std::strtoll(s2, &p, 10);
    if (p == s2 || p >= end || *p != delim) return;
    const char* s3 = p + 1;
    float r = std::strtof(s3, &p);
    if (p == s3) return;
    users.push_back((int64_t)u);
    items.push_back((int64_t)i);
    vals.push_back(r);
  };

  while (true) {
    size_t got = std::fread(buf.data(), 1, BUF, f);
    if (got == 0) break;
    size_t start = 0;
    for (size_t j = 0; j < got; ++j) {
      if (buf[j] == '\n') {
        if (!carry.empty()) {
          carry.append(buf.data() + start, j - start);
          parse_line(carry.data(), carry.data() + carry.size());
          carry.clear();
        } else {
          parse_line(buf.data() + start, buf.data() + j);
        }
        start = j + 1;
      }
    }
    if (start < got) carry.append(buf.data() + start, got - start);
  }
  if (!carry.empty())
    parse_line(carry.data(), carry.data() + carry.size());
  std::fclose(f);

  int64_t n = (int64_t)users.size();
  *users_out = (int64_t*)std::malloc(n * sizeof(int64_t));
  *items_out = (int64_t*)std::malloc(n * sizeof(int64_t));
  *vals_out = (float*)std::malloc(n * sizeof(float));
  if (n > 0) {
    std::memcpy(*users_out, users.data(), n * sizeof(int64_t));
    std::memcpy(*items_out, items.data(), n * sizeof(int64_t));
    std::memcpy(*vals_out, vals.data(), n * sizeof(float));
  }
  return n;
}

// One-pass id compaction: assigns dense indices in first-seen order.
// Writes inverse indices into idx_out (caller-allocated, length n).
// Returns the number of unique ids; uniq_out/counts_out are malloc'd
// (free with fb_free).
int64_t fb_compact_ids(const int64_t* ids, int64_t n, int64_t* idx_out,
                       int64_t** uniq_out, int64_t** counts_out) {
  std::unordered_map<int64_t, int64_t> row_of;
  row_of.reserve((size_t)(n / 2 + 16));
  std::vector<int64_t> uniq;
  std::vector<int64_t> counts;
  for (int64_t j = 0; j < n; ++j) {
    auto it = row_of.find(ids[j]);
    if (it == row_of.end()) {
      int64_t row = (int64_t)uniq.size();
      row_of.emplace(ids[j], row);
      uniq.push_back(ids[j]);
      counts.push_back(1);
      idx_out[j] = row;
    } else {
      ++counts[it->second];
      idx_out[j] = it->second;
    }
  }
  int64_t m = (int64_t)uniq.size();
  *uniq_out = (int64_t*)std::malloc(m * sizeof(int64_t));
  *counts_out = (int64_t*)std::malloc(m * sizeof(int64_t));
  if (m > 0) {
    std::memcpy(*uniq_out, uniq.data(), m * sizeof(int64_t));
    std::memcpy(*counts_out, counts.data(), m * sizeof(int64_t));
  }
  return m;
}

// Stable counting sort of a pre-permuted index sequence by small integer
// key: out[j] enumerates perm positions grouped by key (keys[perm[j]]),
// preserving perm's relative order within each key. The blocking hot path
// needs exactly "seeded shuffle, then stable sort by block id"
// (data/blocking.py); numpy's stable argsort is O(n log n) comparison
// sort — this is two O(n) passes.
void fb_stable_bucket(const int64_t* keys, const int64_t* perm, int64_t n,
                      int64_t num_keys, int64_t* out) {
  std::vector<int64_t> pos(num_keys + 1, 0);
  for (int64_t j = 0; j < n; ++j) ++pos[keys[perm[j]] + 1];
  for (int64_t k2 = 0; k2 < num_keys; ++k2) pos[k2 + 1] += pos[k2];
  for (int64_t j = 0; j < n; ++j) {
    int64_t p = perm[j];
    out[pos[keys[p]]++] = p;
  }
}

// Per-entry 1/(occurrences of rows[j] within its minibatch chunk), the
// "mean" collision scale (ops.sgd). weights==0 entries get 1.0 and do not
// count. One pass with a dense per-chunk counter keyed by row — numpy
// needs a 25M-element np.unique (sort) per side for the same result.
void fb_minibatch_inv_counts(const int32_t* rows, const float* weights,
                             int64_t n, int64_t minibatch, float* out) {
  std::unordered_map<int32_t, int32_t> cnt;
  cnt.reserve((size_t)minibatch * 2);
  for (int64_t a = 0; a < n; a += minibatch) {
    int64_t b = a + minibatch < n ? a + minibatch : n;
    cnt.clear();
    for (int64_t j = a; j < b; ++j)
      if (weights[j] > 0.0f) ++cnt[rows[j]];
    for (int64_t j = a; j < b; ++j)
      out[j] = weights[j] > 0.0f ? 1.0f / (float)cnt[rows[j]] : 1.0f;
  }
}

void fb_free(void* p) { std::free(p); }

}  // extern "C"
