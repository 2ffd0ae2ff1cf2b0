// tpu_llm native host library.
//
// Counterpart of the reference's compiled-language layer
// (SURVEY.md §2.2): where llm.f90 stubs C helpers for f16<->f32 conversion
// and 4-bit pack/unpack (load.f90:124-152) and calls a C SIMD dot on its
// optimize16 branch, this library does the HOST-side heavy lifting of the
// pipeline — checkpoint-load-time block repacking into the device
// layout, f16 widening, and the greedy score-merge BPE encoder. The
// device-side compute runs in JAX.
//
// Build: make native   (g++ -O3 -march=native -shared -fPIC)
// ABI: plain C, loaded via ctypes (tpu_llm/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ABI version; bumped on any signature change. The ctypes binding refuses
// to load a library whose version doesn't match (the .so is built locally,
// not committed, so a stale build must fail closed, not crash).
int64_t tpu_llm_abi_version() { return 2; }

// ---- f16 -> f32 (the reference's half_to_float, load.f90:128-133) ------

static inline float half_bits_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t man = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal: normalize
      int shift = 0;
      while (!(man & 0x400)) { man <<= 1; ++shift; }
      man &= 0x3FF;
      bits = sign | ((127 - 15 - shift + 1) << 23) | (man << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000 | (man << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

void f16_to_f32(const uint16_t* in, float* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = half_bits_to_float(in[i]);
}

// ---- GGML block repacking into the device QTensor layout ---------------
// q4_0 on disk: per (row, block): [f16 d][16 bytes, nibble pair (j, j+16)]
// device layout: q (row_len/2, rows) byte-transposed block-local pairs;
//                scales (row_len/32, rows) f32.

void repack_q4_0(const uint8_t* raw, int64_t rows, int64_t row_len,
                 uint8_t* q_out, float* scales_out) {
  const int64_t nb = row_len / 32;          // blocks per row
  const int64_t bb = 18;                    // block bytes
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* rp = raw + r * nb * bb;
    for (int64_t b = 0; b < nb; ++b) {
      uint16_t d16;
      std::memcpy(&d16, rp + b * bb, 2);
      scales_out[(b)*rows + r] = half_bits_to_float(d16);
      const uint8_t* qs = rp + b * bb + 2;
      for (int64_t j = 0; j < 16; ++j) {
        q_out[(b * 16 + j) * rows + r] = qs[j];
      }
    }
  }
}

// q4_1 on disk: per (row, block): [f16 d][f16 m][16 bytes nibble pair];
// device layout adds a mins plane alongside scales (value = d*q + m).
void repack_q4_1(const uint8_t* raw, int64_t rows, int64_t row_len,
                 uint8_t* q_out, float* scales_out, float* mins_out) {
  const int64_t nb = row_len / 32;
  const int64_t bb = 20;
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* rp = raw + r * nb * bb;
    for (int64_t b = 0; b < nb; ++b) {
      uint16_t d16, m16;
      std::memcpy(&d16, rp + b * bb, 2);
      std::memcpy(&m16, rp + b * bb + 2, 2);
      scales_out[b * rows + r] = half_bits_to_float(d16);
      mins_out[b * rows + r] = half_bits_to_float(m16);
      const uint8_t* qs = rp + b * bb + 4;
      for (int64_t j = 0; j < 16; ++j) {
        q_out[(b * 16 + j) * rows + r] = qs[j];
      }
    }
  }
}

void repack_q8_0(const uint8_t* raw, int64_t rows, int64_t row_len,
                 int8_t* q_out, float* scales_out) {
  const int64_t nb = row_len / 32;
  const int64_t bb = 34;
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* rp = raw + r * nb * bb;
    for (int64_t b = 0; b < nb; ++b) {
      uint16_t d16;
      std::memcpy(&d16, rp + b * bb, 2);
      scales_out[b * rows + r] = half_bits_to_float(d16);
      const int8_t* qs = (const int8_t*)(rp + b * bb + 2);
      for (int64_t j = 0; j < 32; ++j) {
        q_out[(b * 32 + j) * rows + r] = qs[j];
      }
    }
  }
}

// ---- transpose helpers (dense weight (out,in) -> (in,out)) -------------

void transpose_f32(const float* in, float* out, int64_t rows, int64_t cols) {
  // in: (rows, cols) row-major -> out: (cols, rows)
  const int64_t TB = 64;
  for (int64_t i0 = 0; i0 < rows; i0 += TB)
    for (int64_t j0 = 0; j0 < cols; j0 += TB) {
      int64_t imax = i0 + TB < rows ? i0 + TB : rows;
      int64_t jmax = j0 + TB < cols ? j0 + TB : cols;
      for (int64_t i = i0; i < imax; ++i)
        for (int64_t j = j0; j < jmax; ++j) out[j * rows + i] = in[i * cols + j];
    }
}

// ---- greedy score-merge BPE encoder ------------------------------------
// Same semantics as the reference's bpe_encode (llama2.f90:658-724):
// repeatedly merge the adjacent pair whose concatenation is in the vocab
// with the highest score. Heap-based O(n log n) instead of O(n^2 * V).

struct MergeCand {
  float score;
  int64_t left;   // node index
  int64_t stamp;  // generation of 'left' when pushed
  bool operator<(const MergeCand& o) const {
    if (score != o.score) return score < o.score;   // max-heap by score
    return left > o.left;                            // tie: leftmost first
  }
};

// vocab passed as concatenated bytes + offsets. Byte-fallback tokens are
// flagged in is_byte (from GGUF token_type==BYTE, or the <0xNN> surface
// form) and arrive with their RAW BYTE as content; they are excluded from
// the merge index (a regular single-char piece is preferred, like
// SentencePiece) and reachable only via byte_fb. Returns token count.
int64_t bpe_encode(const uint8_t* text, int64_t text_len,
                   const uint8_t* vocab_bytes, const int64_t* vocab_offsets,
                   const float* scores, const uint8_t* is_byte,
                   int64_t vocab_size, int32_t* out_tokens, int64_t max_out) {
  std::unordered_map<std::string, int32_t> index;
  index.reserve((size_t)vocab_size * 2);
  int32_t byte_fb[256];
  for (int b = 0; b < 256; ++b) byte_fb[b] = -1;
  for (int64_t i = 0; i < vocab_size; ++i) {
    std::string tok((const char*)vocab_bytes + vocab_offsets[i],
                    (size_t)(vocab_offsets[i + 1] - vocab_offsets[i]));
    if (is_byte && is_byte[i]) {
      if (tok.size() == 1 && byte_fb[(uint8_t)tok[0]] < 0)
        byte_fb[(uint8_t)tok[0]] = (int32_t)i;
      continue;
    }
    index.emplace(std::move(tok), (int32_t)i);  // first occurrence wins
  }
  if (!is_byte) {  // legacy caller: detect <0xNN> literals in the index
    for (int b = 0; b < 256; ++b) {
      char buf[8];
      std::snprintf(buf, sizeof buf, "<0x%02X>", b);
      auto it = index.find(buf);
      byte_fb[b] = it == index.end() ? -1 : it->second;
    }
  }

  // doubly-linked list of token nodes
  std::vector<int32_t> tok;
  std::vector<std::string> bytes;
  std::vector<int64_t> prev, next, stamp;
  tok.reserve(text_len);
  for (int64_t i = 0; i < text_len; ++i) {
    std::string one(1, (char)text[i]);
    auto it = index.find(one);
    int32_t id = it != index.end() ? it->second : byte_fb[text[i]];
    if (id < 0) continue;  // unknown byte: skip (reference yields -1)
    int64_t n = (int64_t)tok.size();
    tok.push_back(id);
    bytes.push_back(it != index.end() ? one : std::string(one));
    prev.push_back(n - 1);
    next.push_back(n + 1);
    stamp.push_back(0);
  }
  if (tok.empty()) return 0;
  next.back() = -1;

  std::priority_queue<MergeCand> heap;
  auto push_pair = [&](int64_t left) {
    int64_t r = next[left];
    if (r < 0) return;
    auto it = index.find(bytes[left] + bytes[r]);
    if (it == index.end()) return;
    // score <= -1e30: UNMERGEABLE sentinel (vocab entry no merge rule
    // produces — bpe.py:UNMERGEABLE); never a merge candidate
    if (scores[it->second] <= -1e30f) return;
    heap.push({scores[it->second], left, stamp[left]});
  };
  for (int64_t i = 0; i + 1 < (int64_t)tok.size(); ++i) push_pair(i);

  std::vector<char> alive(tok.size(), 1);
  while (!heap.empty()) {
    MergeCand c = heap.top();
    heap.pop();
    int64_t l = c.left;
    if (!alive[l] || stamp[l] != c.stamp) continue;
    int64_t r = next[l];
    if (r < 0 || !alive[r]) continue;
    auto it = index.find(bytes[l] + bytes[r]);
    if (it == index.end()) continue;
    // merge r into l
    tok[l] = it->second;
    bytes[l] = bytes[l] + bytes[r];
    alive[r] = 0;
    next[l] = next[r];
    if (next[l] >= 0) prev[next[l]] = l;
    stamp[l] += 1;
    push_pair(l);
    if (prev[l] >= 0) {
      stamp[prev[l]] += 1;  // invalidate stale candidate, re-push
      push_pair(prev[l]);
    }
  }

  int64_t count = 0;
  for (int64_t i = 0; i >= 0 && i < (int64_t)tok.size(); i = next[i]) {
    if (!alive[i]) continue;
    if (count < max_out) out_tokens[count] = tok[i];
    ++count;
  }
  return count;
}

}  // extern "C"
