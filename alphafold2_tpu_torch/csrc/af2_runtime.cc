// TPU-native host runtime: threaded prefetch batch loader + PDB codec.
//
// The reference's data path is Python-side sidechainnet iteration with
// dynamic shapes (reference train_pre.py:44-55) and its PDB I/O shells out
// to curl + mdtraj (reference utils.py:83-149). Here the host-side hot
// paths are native:
//
//   * a prefetching batch loader: worker threads shuffle, crop/pad to
//     static shapes, and assemble (seq, mask, coords) batches into a
//     bounded queue entirely outside the Python GIL, so the accelerator
//     never waits on host batch assembly;
//   * a fixed-column PDB ATOM-record codec (parse + write), the text
//     format's cost center when loading thousands of structures.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).

#include <atomic>
#include <charconv>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Prefetch loader
// ---------------------------------------------------------------------------

struct Af2Batch {
  // COMPACT layout at the batch's own length: (batch, bucket_len[, ...]).
  // bucket_len == max_len in single-shape mode; bucketed batches carry no
  // padding columns beyond their bucket, so queue memory and the next()
  // memcpy scale with the bucket, not the largest bucket.
  std::vector<int32_t> seq;    // (batch, bucket_len)
  std::vector<uint8_t> mask;   // (batch, bucket_len)
  std::vector<float> coords;   // (batch, bucket_len, atoms_per_res, 3)
  int bucket_len = 0;
};

struct Af2Loader {
  // dataset (borrowed copies — the loader owns its memory after create)
  std::vector<int32_t> seqs;      // concatenated residue tokens
  std::vector<int64_t> offsets;   // n_seqs+1 prefix offsets into seqs
  std::vector<float> coords;      // aligned with seqs: atoms_per_res*3 per residue
  int n_seqs = 0;
  int batch = 1;
  int max_len = 128;
  int atoms_per_res = 14;
  int pad_token = 20;
  // ascending static length buckets (empty = single-shape mode). A protein
  // goes to the smallest bucket holding it (random-cropped to the largest
  // otherwise); batches are emitted per bucket, with buffers laid out at
  // max_len (== buckets.back()) and bucket_len marking the valid columns.
  std::vector<int32_t> buckets;

  // queue
  size_t capacity = 4;
  std::deque<Af2Batch> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;
  uint64_t seed = 0;

  void fill_row(std::mt19937_64& rng, Af2Batch& b, int i, int idx) {
    const int row_len = b.bucket_len;
    int64_t beg = offsets[idx], end = offsets[idx + 1];
    int len = (int)(end - beg);
    int start = 0;
    if (len > row_len) {  // random crop
      std::uniform_int_distribution<int> off(0, len - row_len);
      start = off(rng);
      len = row_len;
    }
    std::memcpy(&b.seq[(size_t)i * row_len], &seqs[beg + start],
                sizeof(int32_t) * len);
    std::memset(&b.mask[(size_t)i * row_len], 1, len);
    std::memcpy(&b.coords[(size_t)i * row_len * atoms_per_res * 3],
                &coords[(beg + start) * atoms_per_res * 3],
                sizeof(float) * (size_t)len * atoms_per_res * 3);
  }

  Af2Batch fresh_batch(int bucket_len_) {
    Af2Batch b;
    b.seq.assign((size_t)batch * bucket_len_, pad_token);
    b.mask.assign((size_t)batch * bucket_len_, 0);
    b.coords.assign((size_t)batch * bucket_len_ * atoms_per_res * 3, 0.0f);
    b.bucket_len = bucket_len_;
    return b;
  }

  void push(Af2Batch&& b) {
    std::unique_lock<std::mutex> lk(mu);
    cv_push.wait(lk, [&] { return stop.load() || queue.size() < capacity; });
    if (stop.load()) return;
    queue.push_back(std::move(b));
    cv_pop.notify_one();
  }

  void worker(int wid) {
    std::mt19937_64 rng(seed ^ (0x9e3779b97f4a7c15ULL * (wid + 1)));
    std::uniform_int_distribution<int> pick(0, n_seqs - 1);
    if (buckets.empty()) {
      while (!stop.load()) {
        Af2Batch b = fresh_batch(max_len);
        for (int i = 0; i < batch; ++i) fill_row(rng, b, i, pick(rng));
        push(std::move(b));
      }
      return;
    }
    // bucketed mode: accumulate picked proteins per bucket (worker-local —
    // no cross-thread pending state), emit when a bucket fills
    std::vector<std::vector<int>> pending(buckets.size());
    while (!stop.load()) {
      int idx = pick(rng);
      int len = (int)(offsets[idx + 1] - offsets[idx]);
      size_t bi = buckets.size() - 1;
      for (size_t k = 0; k < buckets.size(); ++k)
        if (len <= buckets[k]) { bi = k; break; }
      pending[bi].push_back(idx);
      if ((int)pending[bi].size() < batch) continue;
      Af2Batch b = fresh_batch(buckets[bi]);
      for (int i = 0; i < batch; ++i)
        fill_row(rng, b, i, pending[bi][i]);
      pending[bi].clear();
      push(std::move(b));
    }
  }
};

// buckets: ascending static lengths, or n_buckets == 0 for single-shape
// mode; bucketed loaders require max_len == buckets[n_buckets-1] (buffers
// are laid out at max_len).
void* af2_loader_create2(const int32_t* seqs, const int64_t* offsets,
                         int n_seqs, const float* coords, int atoms_per_res,
                         int batch, int max_len, int pad_token, uint64_t seed,
                         int n_threads, int queue_capacity,
                         const int32_t* buckets, int n_buckets) {
  if (n_seqs <= 0 || batch <= 0 || max_len <= 0) return nullptr;
  if (n_buckets > 0) {
    for (int i = 1; i < n_buckets; ++i)
      if (buckets[i] <= buckets[i - 1]) return nullptr;  // must ascend
    if (buckets[n_buckets - 1] != max_len) return nullptr;
  }
  auto* L = new Af2Loader();
  int64_t total = offsets[n_seqs];
  L->seqs.assign(seqs, seqs + total);
  L->offsets.assign(offsets, offsets + n_seqs + 1);
  L->coords.assign(coords, coords + total * atoms_per_res * 3);
  L->n_seqs = n_seqs;
  L->batch = batch;
  L->max_len = max_len;
  L->atoms_per_res = atoms_per_res;
  L->pad_token = pad_token;
  L->seed = seed;
  L->capacity = queue_capacity > 0 ? queue_capacity : 4;
  if (n_buckets > 0) L->buckets.assign(buckets, buckets + n_buckets);
  int nt = n_threads > 0 ? n_threads : 1;
  for (int i = 0; i < nt; ++i)
    L->workers.emplace_back([L, i] { L->worker(i); });
  return L;
}

void* af2_loader_create(const int32_t* seqs, const int64_t* offsets,
                        int n_seqs, const float* coords, int atoms_per_res,
                        int batch, int max_len, int pad_token, uint64_t seed,
                        int n_threads, int queue_capacity) {
  return af2_loader_create2(seqs, offsets, n_seqs, coords, atoms_per_res,
                            batch, max_len, pad_token, seed, n_threads,
                            queue_capacity, nullptr, 0);
}

// Returns the batch's bucket length (== max_len in single-shape mode).
// Output is written COMPACT at the returned length — row i of seq/mask
// starts at i*bucket_len, coords at i*bucket_len*atoms*3 — so callers size
// buffers for max_len but reshape the filled prefix to (batch, bucket_len).
int af2_loader_next(void* handle, int32_t* seq_out, uint8_t* mask_out,
                    float* coords_out) {
  auto* L = static_cast<Af2Loader*>(handle);
  Af2Batch b;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_pop.wait(lk, [&] { return !L->queue.empty(); });
    b = std::move(L->queue.front());
    L->queue.pop_front();
    L->cv_push.notify_one();
  }
  std::memcpy(seq_out, b.seq.data(), b.seq.size() * sizeof(int32_t));
  std::memcpy(mask_out, b.mask.data(), b.mask.size());
  std::memcpy(coords_out, b.coords.data(), b.coords.size() * sizeof(float));
  return b.bucket_len;
}

void af2_loader_destroy(void* handle) {
  auto* L = static_cast<Af2Loader*>(handle);
  {
    // hold the mutex across the store+notify: a worker between its
    // predicate check and blocking would otherwise miss the wakeup and
    // join() would hang
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop.store(true);
    L->cv_push.notify_all();
  }
  for (auto& t : L->workers) t.join();
  delete L;
}

// ---------------------------------------------------------------------------
// PDB codec (fixed-column ATOM records)
// ---------------------------------------------------------------------------

static inline float field_f(const char* line, int beg, int len) {
  // std::from_chars: locale-INDEPENDENT ('.' decimal always) — atof would
  // silently truncate fractions under an LC_NUMERIC comma-decimal locale
  const char* b = line + beg;
  const char* e = b + len;
  while (b < e && *b == ' ') ++b;
  float v = 0.0f;
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
  std::from_chars(b, e, v);
#else
  // GCC 10's libstdc++ ships integer from_chars only (float overloads
  // landed in GCC 11). PDB float fields are plain fixed-point ("%8.3f",
  // no exponent, no locale formatting), so a hand-rolled parse is exact
  // enough and stays locale-independent.
  bool neg = false;
  if (b < e && (*b == '-' || *b == '+')) { neg = (*b == '-'); ++b; }
  double acc = 0.0;
  while (b < e && *b >= '0' && *b <= '9') { acc = acc * 10.0 + (*b - '0'); ++b; }
  if (b < e && *b == '.') {
    ++b;
    double scale = 0.1;
    while (b < e && *b >= '0' && *b <= '9') { acc += (*b - '0') * scale; scale *= 0.1; ++b; }
  }
  v = static_cast<float>(neg ? -acc : acc);
#endif
  return v;
}

static inline int field_i(const char* line, int beg, int len) {
  char buf[16];
  std::memcpy(buf, line + beg, len);
  buf[len] = 0;
  return atoi(buf);
}

// Parse ATOM records (first model). Per atom writes: xyz (3 floats),
// res_seq (int32), B-factor (1 float — carries per-residue confidence,
// geometry/pdb.py convention), and 4-char atom name + 3-char residue name +
// 1-char chain into the names buffer (8 bytes/atom: name[4], res3[3],
// chain[1]). Returns number of atoms parsed (capped at max_atoms).
int af2_parse_pdb(const char* text, int64_t text_len, int max_atoms,
                  float* xyz_out, int32_t* res_seq_out, float* bfactor_out,
                  char* names_out) {
  int n = 0;
  const char* p = text;
  const char* end = text + text_len;
  while (p < end && n < max_atoms) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    size_t linelen = nl ? (size_t)(nl - p) : (size_t)(end - p);
    if (linelen >= 6 && std::strncmp(p, "ENDMDL", 6) == 0) break;
    if (linelen >= 54 && std::strncmp(p, "ATOM", 4) == 0 &&
        (p[4] == ' ' || p[4] == '\t')) {
      xyz_out[n * 3 + 0] = field_f(p, 30, 8);
      xyz_out[n * 3 + 1] = field_f(p, 38, 8);
      xyz_out[n * 3 + 2] = field_f(p, 46, 8);
      res_seq_out[n] = field_i(p, 22, 4);
      bfactor_out[n] = linelen >= 66 ? field_f(p, 60, 6) : 0.0f;
      std::memcpy(names_out + n * 8 + 0, p + 12, 4);  // atom name
      std::memcpy(names_out + n * 8 + 4, p + 17, 3);  // res name
      names_out[n * 8 + 7] = p[21];                   // chain id
      ++n;
    }
    if (!nl) break;
    p = nl + 1;
  }
  return n;
}

// Write ATOM records into `out` (caller sizes it at >= 82*(n_atoms+1)).
// names layout as af2_parse_pdb; bfactor may be null (writes 0.00).
// Returns bytes written.
int64_t af2_write_pdb(const float* xyz, const int32_t* res_seq,
                      const float* bfactor, const char* names, int n_atoms,
                      char* out, int64_t out_cap) {
  int64_t w = 0;
  for (int i = 0; i < n_atoms; ++i) {
    if (w + 82 > out_cap) return -1;
    char name[5] = {0}, res3[4] = {0};
    std::memcpy(name, names + i * 8, 4);
    std::memcpy(res3, names + i * 8 + 4, 3);
    char chain = names[i * 8 + 7];
    // columns (1-based): serial 7-11, name 13-16, altLoc 17 (blank),
    // resName 18-20, chain 22, resSeq 23-26, x/y/z from 31 — matching the
    // fixed-column reads in af2_parse_pdb and geometry/pdb.py
    w += std::snprintf(
        out + w, out_cap - w,
        "ATOM  %5d %-4s %3s %c%4d    %8.3f%8.3f%8.3f%6.2f%6.2f\n",
        i + 1, name, res3, chain ? chain : 'A', res_seq[i],
        xyz[i * 3 + 0], xyz[i * 3 + 1], xyz[i * 3 + 2], 1.0,
        bfactor ? bfactor[i] : 0.0f);
  }
  if (w + 4 <= out_cap) w += std::snprintf(out + w, out_cap - w, "END\n");
  return w;
}

}  // extern "C"
