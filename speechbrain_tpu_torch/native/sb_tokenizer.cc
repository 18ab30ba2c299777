// Native subword-tokenizer kernels (BPE + unigram-LM) for
// speechbrain_tpu.  The reference delegates tokenizer training and
// encoding to the sentencepiece C++ library
// (reference tokenizers/SentencePiece.py:279,395); this file is the
// framework's own native implementation of that role: corpus-scale
// training (incremental pair-count BPE; substring-seeded Viterbi-EM
// unigram) and the per-utterance encode hot path used by data loading.
//
// Interop with Python (ctypes) uses a line-oriented model blob:
//   TYPE <bpe|unigram>
//   SPECIAL <tok>
//   PIECE <piece> <score>
//   MERGE <a> <b>
// Pieces never contain whitespace (corpus is whitespace-split and
// words are prefixed with U+2581), so space-separated fields are safe.
//
// Build: g++ -O3 -shared -fPIC -o libsb_native.so sb_tokenizer.cc

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <set>
#include <sstream>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ---------- UTF-8 ----------------------------------------------------

// Split a UTF-8 string into codepoint-sized chunks (invalid bytes pass
// through as single-byte chunks).
std::vector<std::string> utf8_chars(const std::string& s) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < s.size()) {
    unsigned char c = s[i];
    size_t n = 1;
    if ((c & 0x80) == 0x00) n = 1;
    else if ((c & 0xE0) == 0xC0) n = 2;
    else if ((c & 0xF0) == 0xE0) n = 3;
    else if ((c & 0xF8) == 0xF0) n = 4;
    if (i + n > s.size()) n = 1;
    out.emplace_back(s, i, n);
    i += n;
  }
  return out;
}

const char* kBoundary = "\xE2\x96\x81";  // U+2581 lower one-eighth block

// ---------- corpus --------------------------------------------------

struct WordFreq {
  std::vector<std::string> words;  // boundary-prefixed unique words
  std::vector<int64_t> freqs;
};

WordFreq count_words(const char* corpus) {
  WordFreq wf;
  std::unordered_map<std::string, size_t> index;
  const char* p = corpus;
  std::string tok;
  auto flush = [&]() {
    if (tok.empty()) return;
    std::string w = std::string(kBoundary) + tok;
    auto it = index.find(w);
    if (it == index.end()) {
      index.emplace(std::move(w), wf.words.size());
      wf.words.push_back(std::string(kBoundary) + tok);
      wf.freqs.push_back(1);
    } else {
      wf.freqs[it->second] += 1;
    }
    tok.clear();
  };
  for (; *p; ++p) {
    if (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r') flush();
    else tok.push_back(*p);
  }
  flush();
  return wf;
}

// ---------- BPE training (incremental pair counts) -------------------

struct PairHash {
  size_t operator()(const std::pair<int, int>& p) const {
    return std::hash<int64_t>()((int64_t(p.first) << 32) | uint32_t(p.second));
  }
};

struct BpeTrainer {
  std::vector<std::string> id2sym;
  std::unordered_map<std::string, int> sym2id;

  int intern(const std::string& s) {
    auto it = sym2id.find(s);
    if (it != sym2id.end()) return it->second;
    int id = (int)id2sym.size();
    id2sym.push_back(s);
    sym2id.emplace(s, id);
    return id;
  }

  // words as symbol-id sequences
  std::vector<std::vector<int>> seqs;
  std::vector<int64_t> freqs;
  std::unordered_map<std::pair<int, int>, int64_t, PairHash> pair_freq;
  std::unordered_map<std::pair<int, int>, std::unordered_set<size_t>, PairHash>
      pair_words;

  void add_pair(size_t w, int a, int b, int64_t f) {
    auto key = std::make_pair(a, b);
    pair_freq[key] += f;
    pair_words[key].insert(w);
  }

  void init(const WordFreq& wf) {
    seqs.reserve(wf.words.size());
    freqs = wf.freqs;
    for (size_t w = 0; w < wf.words.size(); ++w) {
      std::vector<int> seq;
      for (auto& c : utf8_chars(wf.words[w])) seq.push_back(intern(c));
      for (size_t i = 0; i + 1 < seq.size(); ++i)
        add_pair(w, seq[i], seq[i + 1], wf.freqs[w]);
      seqs.push_back(std::move(seq));
    }
  }

  // Highest-frequency pair; ties broken by lexicographic symbols for
  // determinism.
  bool best_pair(std::pair<int, int>* out) {
    int64_t best = 1;  // require freq >= 2
    bool found = false;
    for (auto& kv : pair_freq) {
      if (kv.second < best) continue;
      if (kv.second > best) {
        best = kv.second;
        *out = kv.first;
        found = kv.second >= 2;
        continue;
      }
      // tie
      const std::string& a0 = id2sym[out->first];
      const std::string& b0 = id2sym[out->second];
      const std::string& a1 = id2sym[kv.first.first];
      const std::string& b1 = id2sym[kv.first.second];
      if (std::tie(a1, b1) < std::tie(a0, b0)) *out = kv.first;
    }
    return found;
  }

  void merge(std::pair<int, int> pr, int merged_id) {
    auto words_it = pair_words.find(pr);
    if (words_it == pair_words.end()) return;
    std::vector<size_t> touched(words_it->second.begin(),
                                words_it->second.end());
    for (size_t w : touched) {
      std::vector<int>& seq = seqs[w];
      int64_t f = freqs[w];
      // remove all old pair counts of this word
      for (size_t i = 0; i + 1 < seq.size(); ++i) {
        auto key = std::make_pair(seq[i], seq[i + 1]);
        auto it = pair_freq.find(key);
        if (it != pair_freq.end()) {
          it->second -= f;
          if (it->second <= 0) {
            pair_freq.erase(it);
            pair_words.erase(key);
          }
        }
        auto pw = pair_words.find(key);
        if (pw != pair_words.end()) pw->second.erase(w);
      }
      // rewrite
      std::vector<int> out;
      out.reserve(seq.size());
      size_t i = 0;
      while (i < seq.size()) {
        if (i + 1 < seq.size() && seq[i] == pr.first &&
            seq[i + 1] == pr.second) {
          out.push_back(merged_id);
          i += 2;
        } else {
          out.push_back(seq[i]);
          i += 1;
        }
      }
      seq = std::move(out);
      // re-add new pair counts
      for (size_t j = 0; j + 1 < seq.size(); ++j)
        add_pair(w, seq[j], seq[j + 1], f);
    }
  }
};

// ---------- unigram training (Viterbi-EM, mirrors the Python algo) ---

constexpr int kMaxPieceLen = 10;  // codepoints
constexpr int kSeedFactor = 4;
constexpr int kEmIters = 2;
constexpr double kShrink = 0.75;

// Viterbi segmentation of a codepoint sequence under piece log-probs.
void viterbi_split(const std::vector<std::string>& chars,
                   const std::unordered_map<std::string, double>& scores,
                   std::vector<std::string>* pieces) {
  int n = (int)chars.size();
  std::vector<double> best(n + 1, -1e30);
  std::vector<int> back(n + 1, -1);
  best[0] = 0.0;
  // prefix byte offsets for substring building
  std::vector<std::string> prefix(n + 1);
  for (int i = 0; i < n; ++i) prefix[i + 1] = prefix[i] + chars[i];
  for (int e = 1; e <= n; ++e) {
    for (int s = std::max(0, e - kMaxPieceLen); s < e; ++s) {
      if (best[s] <= -1e29) continue;
      std::string piece = prefix[e].substr(prefix[s].size());
      double sc;
      auto it = scores.find(piece);
      if (it != scores.end()) sc = it->second;
      else if (e - s == 1) sc = -20.0;  // unk char fallback
      else continue;
      double cand = best[s] + sc;
      if (cand > best[e]) {
        best[e] = cand;
        back[e] = s;
      }
    }
  }
  pieces->clear();
  int e = n;
  std::vector<std::string> rev;
  while (e > 0) {
    int s = back[e];
    if (s < 0) { s = e - 1; }  // unreachable guard
    rev.push_back(prefix[e].substr(prefix[s].size()));
    e = s;
  }
  pieces->assign(rev.rbegin(), rev.rend());
}

void em_pass(const std::vector<std::vector<std::string>>& word_chars,
             const std::vector<int64_t>& freqs,
             const std::unordered_set<std::string>& chars,
             std::unordered_map<std::string, double>* scores, int iters) {
  for (int it = 0; it < iters; ++it) {
    std::unordered_map<std::string, int64_t> counts;
    std::vector<std::string> pieces;
    for (size_t w = 0; w < word_chars.size(); ++w) {
      viterbi_split(word_chars[w], *scores, &pieces);
      for (auto& p : pieces) counts[p] += freqs[w];
    }
    int64_t tot = 0;
    for (auto& kv : counts) tot += kv.second;
    std::unordered_map<std::string, double> next;
    for (auto& kv : counts) {
      if (scores->count(kv.first))
        next[kv.first] = std::log((double)kv.second / (double)tot);
    }
    for (auto& c : chars) {
      if (!next.count(c))
        next[c] = std::log(0.5 / std::max<int64_t>(tot, 1));
    }
    *scores = std::move(next);
  }
}

// ---------- model + encode -------------------------------------------

struct Model {
  std::string type;  // "bpe" | "unigram"
  std::vector<std::string> specials;
  std::vector<std::string> pieces;             // full vocab incl specials
  std::unordered_map<std::string, int> piece2id;
  std::unordered_map<std::string, double> scores;                 // unigram
  std::unordered_map<std::string, int> merge_rank;                // bpe "a b"
  int unk_id = 0;

  void index() {
    piece2id.clear();
    for (size_t i = 0; i < pieces.size(); ++i) piece2id[pieces[i]] = (int)i;
  }

  void encode_word(const std::string& word, std::vector<int>* ids) const {
    if (type == "unigram") {
      std::vector<std::string> out;
      viterbi_split(utf8_chars(word), scores, &out);
      for (auto& p : out) {
        auto it = piece2id.find(p);
        ids->push_back(it == piece2id.end() ? unk_id : it->second);
      }
      return;
    }
    // bpe: repeatedly apply the lowest-rank merge
    std::vector<std::string> syms = utf8_chars(word);
    while (syms.size() > 1) {
      int best_rank = INT32_MAX;
      size_t best_i = SIZE_MAX;
      for (size_t i = 0; i + 1 < syms.size(); ++i) {
        auto it = merge_rank.find(syms[i] + " " + syms[i + 1]);
        if (it != merge_rank.end() && it->second < best_rank) {
          best_rank = it->second;
          best_i = i;
        }
      }
      if (best_i == SIZE_MAX) break;
      syms[best_i] = syms[best_i] + syms[best_i + 1];
      syms.erase(syms.begin() + best_i + 1);
    }
    for (auto& p : syms) {
      auto it = piece2id.find(p);
      ids->push_back(it == piece2id.end() ? unk_id : it->second);
    }
  }
};

std::string dump_model(const Model& m,
                       const std::vector<std::pair<std::string, std::string>>&
                           merges) {
  std::ostringstream os;
  os.precision(17);
  os << "TYPE " << m.type << "\n";
  for (auto& s : m.specials) os << "SPECIAL " << s << "\n";
  for (auto& p : m.pieces) {
    double sc = 0.0;
    auto it = m.scores.find(p);
    if (it != m.scores.end()) sc = it->second;
    os << "PIECE " << p << " " << sc << "\n";
  }
  for (auto& ab : merges) os << "MERGE " << ab.first << " " << ab.second << "\n";
  return os.str();
}

Model* parse_model(const char* blob) {
  Model* m = new Model();
  std::istringstream is(blob);
  std::string line;
  int rank = 0;
  while (std::getline(is, line)) {
    std::istringstream ls(line);
    std::string tag;
    ls >> tag;
    if (tag == "TYPE") {
      ls >> m->type;
    } else if (tag == "SPECIAL") {
      std::string s;
      ls >> s;
      m->specials.push_back(s);
    } else if (tag == "PIECE") {
      std::string p;
      double sc;
      ls >> p >> sc;
      m->pieces.push_back(p);
      m->scores[p] = sc;
    } else if (tag == "MERGE") {
      std::string a, b;
      ls >> a >> b;
      m->merge_rank[a + " " + b] = rank++;
    } else if (tag == "UNK") {
      ls >> m->unk_id;
    }
  }
  m->index();
  return m;
}

}  // namespace

extern "C" {

void sb_free(char* p) { free(p); }

// Train a tokenizer over a newline/space separated UTF-8 corpus.
// specials: space-separated special tokens placed at the head of the
// vocab.  Returns a malloc'd model blob (see header comment).
char* sb_tok_train(const char* corpus, int vocab_size,
                   const char* model_type, const char* specials) {
  WordFreq wf = count_words(corpus);
  Model m;
  m.type = model_type;
  {
    std::istringstream ss(specials);
    std::string s;
    while (ss >> s) m.specials.push_back(s);
  }
  // base character vocabulary, sorted for determinism
  std::set<std::string> charset;
  std::vector<std::vector<std::string>> word_chars;
  word_chars.reserve(wf.words.size());
  for (auto& w : wf.words) {
    word_chars.push_back(utf8_chars(w));
    for (auto& c : word_chars.back()) charset.insert(c);
  }
  std::vector<std::pair<std::string, std::string>> merges;

  if (m.type == "bpe") {
    BpeTrainer tr;
    tr.init(wf);
    int base = (int)m.specials.size() + (int)charset.size();
    while (base + (int)merges.size() < vocab_size) {
      std::pair<int, int> pr;
      if (!tr.best_pair(&pr)) break;
      const std::string a = tr.id2sym[pr.first];
      const std::string b = tr.id2sym[pr.second];
      int merged = tr.intern(a + b);
      tr.merge(pr, merged);
      merges.emplace_back(a, b);
    }
    for (auto& s : m.specials) m.pieces.push_back(s);
    for (auto& c : charset) m.pieces.push_back(c);
    for (auto& ab : merges) m.pieces.push_back(ab.first + ab.second);
  } else {  // unigram
    // substring seeding over unique words
    std::unordered_map<std::string, int64_t> sub_freq;
    for (size_t w = 0; w < word_chars.size(); ++w) {
      const auto& chars = word_chars[w];
      int L = (int)chars.size();
      std::string piece;
      for (int s = 0; s < L; ++s) {
        piece.clear();
        for (int e = s; e < std::min(L, s + kMaxPieceLen); ++e) {
          piece += chars[e];
          sub_freq[piece] += wf.freqs[w];
        }
      }
    }
    std::unordered_set<std::string> chars(charset.begin(), charset.end());
    int target = vocab_size - (int)m.specials.size();
    size_t n_seed =
        std::max<size_t>((size_t)vocab_size * kSeedFactor, chars.size() + 16);
    // top-n_seed substrings by (freq desc, piece asc) for determinism
    std::vector<std::pair<std::string, int64_t>> subs(sub_freq.begin(),
                                                      sub_freq.end());
    std::sort(subs.begin(), subs.end(), [](auto& x, auto& y) {
      if (x.second != y.second) return x.second > y.second;
      return x.first < y.first;
    });
    if (subs.size() > n_seed) subs.resize(n_seed);
    int64_t total = 0;
    for (auto& kv : subs) total += kv.second;
    std::unordered_map<std::string, double> scores;
    for (auto& kv : subs)
      scores[kv.first] = std::log((double)kv.second / (double)total);
    for (auto& c : chars) {
      if (!scores.count(c)) {
        auto it = sub_freq.find(c);
        int64_t f = it == sub_freq.end() ? 1 : it->second;
        scores[c] = std::log((double)f / (double)total);
      }
    }
    em_pass(word_chars, wf.freqs, chars, &scores, kEmIters);
    // prune multi-char pieces until target
    while ((int)scores.size() > target) {
      int keep = std::max((int)(scores.size() * kShrink), target);
      std::vector<std::pair<std::string, double>> multi;
      for (auto& kv : scores)
        if (utf8_chars(kv.first).size() > 1) multi.push_back(kv);
      std::sort(multi.begin(), multi.end(), [](auto& x, auto& y) {
        if (x.second != y.second) return x.second < y.second;
        return x.first < y.first;
      });
      int n_drop = (int)scores.size() - keep;
      for (int i = 0; i < n_drop && i < (int)multi.size(); ++i)
        scores.erase(multi[i].first);
      em_pass(word_chars, wf.freqs, chars, &scores, 1);
      if (multi.empty()) break;
    }
    std::vector<std::pair<std::string, double>> vocab(scores.begin(),
                                                      scores.end());
    std::sort(vocab.begin(), vocab.end(), [](auto& x, auto& y) {
      if (x.second != y.second) return x.second > y.second;
      return x.first < y.first;
    });
    if ((int)vocab.size() > target) vocab.resize(target);
    for (auto& s : m.specials) m.pieces.push_back(s);
    for (auto& kv : vocab) {
      m.pieces.push_back(kv.first);
      m.scores[kv.first] = kv.second;
    }
  }
  std::string blob = dump_model(m, merges);
  char* out = (char*)malloc(blob.size() + 1);
  memcpy(out, blob.c_str(), blob.size() + 1);
  return out;
}

void* sb_tok_load(const char* blob) { return parse_model(blob); }

void sb_tok_unload(void* h) { delete (Model*)h; }

// Encode whitespace-split text; writes up to cap ids, returns the
// total id count (call again with a larger buffer if > cap).
int sb_tok_encode(void* h, const char* text, int32_t* out, int cap) {
  Model* m = (Model*)h;
  std::vector<int> ids;
  const char* p = text;
  std::string tok;
  auto flush = [&]() {
    if (tok.empty()) return;
    m->encode_word(std::string(kBoundary) + tok, &ids);
    tok.clear();
  };
  for (; *p; ++p) {
    if (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r') flush();
    else tok.push_back(*p);
  }
  flush();
  int n = (int)ids.size();
  for (int i = 0; i < n && i < cap; ++i) out[i] = ids[i];
  return n;
}

}  // extern "C"
