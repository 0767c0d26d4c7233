// Exact top-k by Hamming distance over packed binary codes on the host CPU
// (cmh_torch's copy of cmh_tpu/native/hash_ops.cpp, the same algorithm).
//
// RetrievalIndex.search scores queries on the card with kernel K4; a
// deployment host without a card needs the same exact top-k at CPU speed
// (RetrievalIndex.search_cpu). Codes arrive as the uint32 words of
// ops/hashing.pack_bits (bit j of word w = code[w*32+j] > 0, zero-padded, so
// padding cancels in XOR).
//
// Exact semantics (must match RetrievalIndex.search):
//   top-k by Hamming distance ascending, ties broken by LOWER gallery index.
//
// Built at first use by cmh_torch/native/_build.py (g++ -O3, a C ABI loaded
// with ctypes).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// W > 0: compile-time word count — the loop unrolls to straight-line
// xor+popcnt with no per-row loop machinery (~3× the rows/sec of the
// runtime-words version for 64-bit codes). W == 0: runtime `words`.
template <int W>
inline int row_hamming(const uint32_t* a, const uint32_t* b, int words) {
    const int n = W > 0 ? W : words;
    int d = 0;
    int w = 0;
    // pair 32-bit words into 64-bit popcounts; memcpy keeps loads
    // alignment-safe (rows of odd `words` leave later rows 4-byte aligned)
    for (; w + 2 <= n; w += 2) {
        uint64_t xa, xb;
        std::memcpy(&xa, a + w, 8);
        std::memcpy(&xb, b + w, 8);
        d += __builtin_popcountll(xa ^ xb);
    }
    if (w < n) d += __builtin_popcount(a[w] ^ b[w]);
    return d;
}

struct Cand {
    int32_t dist;
    int64_t idx;
    // max-heap orders the WORST candidate on top; worse = larger distance,
    // ties = larger index (so equal-distance later entries are evicted first,
    // preserving the lower-index-wins tie order)
    bool operator<(const Cand& o) const {
        return dist != o.dist ? dist < o.dist : idx < o.idx;
    }
};

template <int W>
std::vector<Cand> scan_topk_impl(const uint32_t* qrow,
                                 const uint32_t* gallery, int64_t idx_offset,
                                 int64_t count, int words, int k) {
    std::vector<Cand> heap;
    heap.reserve(k);
    for (int64_t g = 0; g < count; ++g) {
        int32_t d = row_hamming<W>(qrow, gallery + g * words, words);
        if ((int64_t)heap.size() < k) {
            heap.push_back({d, idx_offset + g});
            std::push_heap(heap.begin(), heap.end());
        } else if (d < heap.front().dist) {
            // scanning ascending g: an equal-distance candidate can never
            // displace the heap max (its index is larger), so strict <
            std::pop_heap(heap.begin(), heap.end());
            heap.back() = {d, idx_offset + g};
            std::push_heap(heap.begin(), heap.end());
        }
    }
    std::sort_heap(heap.begin(), heap.end());  // ascending (dist, idx)
    return heap;
}

// top-k of one query over gallery rows [idx_offset, idx_offset + count),
// returned ascending by (dist, global idx). Dispatches to a compile-time
// word-count specialization for the common code lengths (32–256 bits).
std::vector<Cand> scan_topk(const uint32_t* qrow, const uint32_t* gallery,
                            int64_t idx_offset, int64_t count, int words,
                            int k) {
    switch (words) {
        case 1: return scan_topk_impl<1>(qrow, gallery, idx_offset, count, words, k);
        case 2: return scan_topk_impl<2>(qrow, gallery, idx_offset, count, words, k);
        case 3: return scan_topk_impl<3>(qrow, gallery, idx_offset, count, words, k);
        case 4: return scan_topk_impl<4>(qrow, gallery, idx_offset, count, words, k);
        case 5: return scan_topk_impl<5>(qrow, gallery, idx_offset, count, words, k);
        case 6: return scan_topk_impl<6>(qrow, gallery, idx_offset, count, words, k);
        case 7: return scan_topk_impl<7>(qrow, gallery, idx_offset, count, words, k);
        case 8: return scan_topk_impl<8>(qrow, gallery, idx_offset, count, words, k);
        default: return scan_topk_impl<0>(qrow, gallery, idx_offset, count, words, k);
    }
}

void topk_query_range(const uint32_t* query, const uint32_t* gallery,
                      int64_t n_gallery, int words, int k, int64_t q_begin,
                      int64_t q_end, int32_t* out_dist, int64_t* out_idx) {
    for (int64_t q = q_begin; q < q_end; ++q) {
        std::vector<Cand> top = scan_topk(query + q * words, gallery, 0,
                                          n_gallery, words, k);
        for (int i = 0; i < k; ++i) {
            out_dist[q * k + i] = top[i].dist;
            out_idx[q * k + i] = top[i].idx;
        }
    }
}

// few queries, many threads (the online single-query case): split the
// GALLERY across threads per query and merge the per-range top-ks — the
// union of range top-ks contains the global top-k, and (dist, idx) keys are
// unique, so a final sort reproduces the exact lower-index tie order.
void topk_gallery_split(const uint32_t* query, int64_t n_query,
                        const uint32_t* gallery, int64_t n_gallery, int words,
                        int k, int n_threads, int32_t* out_dist,
                        int64_t* out_idx) {
    int64_t chunk = (n_gallery + n_threads - 1) / n_threads;
    for (int64_t q = 0; q < n_query; ++q) {
        const uint32_t* qrow = query + q * words;
        std::vector<std::vector<Cand>> parts(n_threads);
        std::vector<std::thread> workers;
        workers.reserve(n_threads);
        for (int t = 0; t < n_threads; ++t) {
            int64_t begin = t * chunk;
            int64_t end = std::min(begin + chunk, n_gallery);
            if (begin >= end) break;
            workers.emplace_back([&, t, begin, end] {
                parts[t] = scan_topk(qrow, gallery + begin * words, begin,
                                     end - begin, words, k);
            });
        }
        for (auto& w : workers) w.join();
        std::vector<Cand> all;
        all.reserve((size_t)n_threads * k);
        for (auto& p : parts) all.insert(all.end(), p.begin(), p.end());
        std::partial_sort(all.begin(), all.begin() + k, all.end());
        for (int i = 0; i < k; ++i) {
            out_dist[q * k + i] = all[i].dist;
            out_idx[q * k + i] = all[i].idx;
        }
    }
}

}  // namespace

extern "C" {

// query (n_query, words) and gallery (n_gallery, words) row-major uint32;
// writes out_dist (n_query, k) int32 and out_idx (n_query, k) int64.
// Requires 0 < k <= n_gallery (enforced by the python wrapper).
void hamming_topk(const uint32_t* query, int64_t n_query,
                  const uint32_t* gallery, int64_t n_gallery, int words,
                  int k, int32_t* out_dist, int64_t* out_idx, int n_threads) {
    if (n_threads <= 0) {
        n_threads = (int)std::thread::hardware_concurrency();
        if (n_threads <= 0) n_threads = 1;
    }
    if (n_threads <= 1) {
        topk_query_range(query, gallery, n_gallery, words, k, 0, n_query,
                         out_dist, out_idx);
        return;
    }
    if (n_query < (int64_t)n_threads) {
        // fewer queries than cores: parallelize inside each query instead
        topk_gallery_split(query, n_query, gallery, n_gallery, words, k,
                           n_threads, out_dist, out_idx);
        return;
    }
    std::vector<std::thread> workers;
    workers.reserve(n_threads);
    int64_t chunk = (n_query + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t begin = t * chunk;
        int64_t end = std::min(begin + chunk, n_query);
        if (begin >= end) break;
        workers.emplace_back(topk_query_range, query, gallery, n_gallery,
                             words, k, begin, end, out_dist, out_idx);
    }
    for (auto& w : workers) w.join();
}

}  // extern "C"
