// First-party C++ BPE encoder — the tokenization hot path.
//
// The reference delegates this to HF `tokenizers` (Rust,
// textprocessor.py:7,14-17). This is a from-scratch implementation of the
// same SentencePiece-BPE encode algorithm, exposed over a C ABI for ctypes:
// Metaspace pre-tokenization (space -> U+2581, prefix space), greedy
// lowest-rank-first merges, vocab lookup with per-char unk fallback (fuse_unk=false). NFKC
// normalization happens on the Python side (unicodedata) before the call.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libbpe.so bpe.cpp

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Bpe {
  std::unordered_map<std::string, int> vocab;
  std::unordered_map<std::string, int> ranks;  // key: a + '\x01' + b
  std::unordered_map<std::string, std::vector<int>> cache;
  int unk_id = -1;
};

const std::string kMetaspace = "\xe2\x96\x81";  // U+2581

inline std::string pair_key(const std::string& a, const std::string& b) {
  std::string k;
  k.reserve(a.size() + b.size() + 1);
  k += a;
  k += '\x01';
  k += b;
  return k;
}

// Split UTF-8 string into codepoint substrings.
void utf8_chars(const std::string& s, std::vector<std::string>* out) {
  size_t i = 0;
  while (i < s.size()) {
    unsigned char c = s[i];
    size_t len = 1;
    if ((c & 0x80) == 0) len = 1;
    else if ((c & 0xE0) == 0xC0) len = 2;
    else if ((c & 0xF0) == 0xE0) len = 3;
    else if ((c & 0xF8) == 0xF0) len = 4;
    if (i + len > s.size()) len = 1;  // malformed tail: byte-by-byte
    out->emplace_back(s.substr(i, len));
    i += len;
  }
}

// Greedy BPE merge: repeatedly apply the lowest-rank adjacent pair.
void merge_word(Bpe* bpe, const std::string& word,
                std::vector<std::string>* parts) {
  utf8_chars(word, parts);
  while (parts->size() > 1) {
    int best_rank = INT32_MAX;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < parts->size(); ++i) {
      auto it = bpe->ranks.find(pair_key((*parts)[i], (*parts)[i + 1]));
      if (it != bpe->ranks.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank == INT32_MAX) break;
    const std::string a = (*parts)[best_i];
    const std::string b = (*parts)[best_i + 1];
    const std::string merged = a + b;
    std::vector<std::string> out;
    out.reserve(parts->size());
    size_t i = 0;
    while (i < parts->size()) {
      if (i + 1 < parts->size() && (*parts)[i] == a && (*parts)[i + 1] == b) {
        out.push_back(merged);
        i += 2;
      } else {
        out.push_back((*parts)[i]);
        i += 1;
      }
    }
    parts->swap(out);
  }
}

void encode_word(Bpe* bpe, const std::string& word, std::vector<int>* ids) {
  auto cit = bpe->cache.find(word);
  if (cit != bpe->cache.end()) {
    ids->insert(ids->end(), cit->second.begin(), cit->second.end());
    return;
  }
  std::vector<std::string> parts;
  merge_word(bpe, word, &parts);
  std::vector<int> word_ids;
  for (const auto& tok : parts) {
    auto it = bpe->vocab.find(tok);
    if (it != bpe->vocab.end()) {
      word_ids.push_back(it->second);
    } else {
      // fuse_unk=false (the reference's SentencePieceBPETokenizer
      // default): one <unk> PER unknown character, never fused — a run
      // of N unknown chars is N <unk> tokens. Known chars inside an
      // unknown piece emit their own ids.
      std::vector<std::string> chars;
      utf8_chars(tok, &chars);
      for (const auto& ch : chars) {
        auto ct = bpe->vocab.find(ch);
        if (ct != bpe->vocab.end()) {
          word_ids.push_back(ct->second);
        } else if (bpe->unk_id >= 0) {
          word_ids.push_back(bpe->unk_id);
        }
      }
    }
  }
  if (bpe->cache.size() < 4000000) bpe->cache.emplace(word, word_ids);
  ids->insert(ids->end(), word_ids.begin(), word_ids.end());
}

}  // namespace

extern "C" {

void* bpe_new() { return new Bpe(); }

void bpe_free(void* h) { delete static_cast<Bpe*>(h); }

void bpe_add_token(void* h, const char* tok, int id) {
  static_cast<Bpe*>(h)->vocab.emplace(tok, id);
}

void bpe_add_merge(void* h, const char* a, const char* b, int rank) {
  static_cast<Bpe*>(h)->ranks.emplace(pair_key(a, b), rank);
}

void bpe_set_unk(void* h, int unk_id) {
  static_cast<Bpe*>(h)->unk_id = unk_id;
}

// text: NFKC-normalized UTF-8 (spaces intact). Writes up to max_out ids to
// out and returns the FULL id count — a return value > max_out signals the
// caller that the write was truncated and must retry with a larger buffer
// (silent truncation would drop sentence tails from binarized data).
int bpe_encode(void* h, const char* text, int32_t* out, int max_out) {
  Bpe* bpe = static_cast<Bpe*>(h);
  std::string s(text);
  // Metaspace: replace spaces; prefix one only if the text doesn't already
  // start with a space/metaspace (matches Python metaspace_split).
  std::string meta;
  meta.reserve(s.size() + 3);
  bool starts_meta = s.size() >= kMetaspace.size() &&
                     s.compare(0, kMetaspace.size(), kMetaspace) == 0;
  if (!(starts_meta || (!s.empty() && s[0] == ' '))) meta += kMetaspace;
  for (size_t i = 0; i < s.size(); ++i) {
    if (s[i] == ' ') {
      meta += kMetaspace;
    } else {
      meta += s[i];
    }
  }
  // Split into pieces starting at each metaspace.
  std::vector<int> ids;
  size_t start = 0;
  size_t i = kMetaspace.size();
  while (i < meta.size()) {
    if (meta.compare(i, kMetaspace.size(), kMetaspace) == 0) {
      encode_word(bpe, meta.substr(start, i - start), &ids);
      start = i;
      i += kMetaspace.size();
    } else {
      ++i;
    }
  }
  if (start < meta.size()) encode_word(bpe, meta.substr(start), &ids);
  int n = static_cast<int>(ids.size());
  int n_write = n > max_out ? max_out : n;
  std::memcpy(out, ids.data(), n_write * sizeof(int32_t));
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BPE trainer: classic pair-merge loop with incremental pair-count updates
// and per-pair postings, replacing HF tokenizers' Rust trainer for corpus-
// scale tokenizer training. Words arrive pre-tokenized (Metaspace+NFKC on
// the Python side) as '\n'-joined UTF-8 with per-word counts.

#include <algorithm>
#include <map>
#include <set>

namespace {

struct Trainer {
  std::vector<std::vector<std::string>> words;  // symbol sequences
  std::vector<int64_t> counts;
  std::map<std::pair<std::string, std::string>, int64_t> pair_counts;
  std::map<std::pair<std::string, std::string>, std::set<int>> where;
  std::vector<std::pair<std::string, std::string>> merges;
  std::vector<std::string> new_tokens;
};

}  // namespace

extern "C" {

void* bpe_trainer_new() { return new Trainer(); }
void bpe_trainer_free(void* h) { delete static_cast<Trainer*>(h); }

// words: '\n'-separated UTF-8 words; counts parallel array.
void bpe_trainer_add_words(void* h, const char* words_blob,
                           const int64_t* counts, int n_words) {
  Trainer* t = static_cast<Trainer*>(h);
  const char* p = words_blob;
  for (int i = 0; i < n_words; ++i) {
    const char* end = strchr(p, '\n');
    std::string word = end ? std::string(p, end - p) : std::string(p);
    std::vector<std::string> syms;
    utf8_chars(word, &syms);
    t->words.push_back(std::move(syms));
    t->counts.push_back(counts[i]);
    p = end ? end + 1 : p + word.size();
  }
}

// Learn up to max_merges merges with count >= min_frequency. Returns the
// number of merges learned.
int bpe_trainer_train(void* h, int max_merges, int64_t min_frequency) {
  Trainer* t = static_cast<Trainer*>(h);
  t->pair_counts.clear();
  t->where.clear();
  for (size_t wi = 0; wi < t->words.size(); ++wi) {
    const auto& syms = t->words[wi];
    for (size_t i = 0; i + 1 < syms.size(); ++i) {
      auto key = std::make_pair(syms[i], syms[i + 1]);
      t->pair_counts[key] += t->counts[wi];
      t->where[key].insert(static_cast<int>(wi));
    }
  }

  for (int m = 0; m < max_merges; ++m) {
    // Highest count; ties broken by lexicographic pair order for
    // determinism (count dominates in practice).
    const std::pair<std::string, std::string>* best = nullptr;
    int64_t best_count = 0;
    for (const auto& kv : t->pair_counts) {
      if (kv.second > best_count ||
          (kv.second == best_count && best && kv.first < *best)) {
        best = &kv.first;
        best_count = kv.second;
      }
    }
    if (!best || best_count < min_frequency) break;
    auto pair = *best;
    std::string merged = pair.first + pair.second;
    t->merges.push_back(pair);
    t->new_tokens.push_back(merged);

    auto postings = t->where[pair];  // copy: we mutate below
    for (int wi : postings) {
      auto& syms = t->words[wi];
      int64_t c = t->counts[wi];
      for (size_t i = 0; i + 1 < syms.size();) {
        if (syms[i] == pair.first && syms[i + 1] == pair.second) {
          if (i > 0) {
            auto left = std::make_pair(syms[i - 1], syms[i]);
            if ((t->pair_counts[left] -= c) <= 0) t->pair_counts.erase(left);
          }
          if (i + 2 < syms.size()) {
            auto right = std::make_pair(syms[i + 1], syms[i + 2]);
            if ((t->pair_counts[right] -= c) <= 0) t->pair_counts.erase(right);
          }
          syms[i] = merged;
          syms.erase(syms.begin() + i + 1);
          if (i > 0) {
            auto left = std::make_pair(syms[i - 1], syms[i]);
            t->pair_counts[left] += c;
            t->where[left].insert(wi);
          }
          if (i + 1 < syms.size()) {
            auto right = std::make_pair(syms[i], syms[i + 1]);
            t->pair_counts[right] += c;
            t->where[right].insert(wi);
          }
        } else {
          ++i;
        }
      }
    }
    t->pair_counts.erase(pair);
    t->where.erase(pair);
  }
  return static_cast<int>(t->merges.size());
}

// Read back merge i as "a\tb" into buf; returns length or -1.
int bpe_trainer_get_merge(void* h, int i, char* buf, int buf_len) {
  Trainer* t = static_cast<Trainer*>(h);
  if (i < 0 || i >= static_cast<int>(t->merges.size())) return -1;
  std::string s = t->merges[i].first + "\t" + t->merges[i].second;
  int n = static_cast<int>(s.size());
  if (n >= buf_len) return -1;
  std::memcpy(buf, s.data(), n);
  buf[n] = 0;
  return n;
}

}  // extern "C"
