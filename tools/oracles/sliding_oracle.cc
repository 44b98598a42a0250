// Test-oracle harness: drives the REFERENCE SlidingMap + get_minimizers with
// randomized operation streams and dumps state transitions, so the
// rewrite's Python port can be fixture-tested against exact reference
// semantics.  Built in /tmp only; never committed.  Boost-dependent
// relaxed_jaccard_estimate is stubbed below with the closed form (the
// reference's int-truncation makes the confidence loop degenerate).
#include <cstdio>
#include <memory>
#include <vector>
#include <string>
struct Minimizer;
std::vector<Minimizer> get_minimizers(const std::string &s, int kmer_size, const int window_size, bool separate_lowercase);
#include <cstdint>
#include <cmath>
#include <random>
#include <vector>
#include "sliding.h"
#include "hash.h"
#include "globals.h"

// ---- stubs for util.cc (boost-dependent) ----
#include <sys/stat.h>
mode_t stat_file(const std::string &path) { return 0; }
std::vector<std::string> split(const std::string &s, char delim) { return {}; }
std::string rc(const std::string &s) { return s; }
double tau(double edit_error, int kmer_size) {
  const double ERROR_RATIO =
      (Globals::Search::MAX_ERROR - Globals::Search::MAX_EDIT_ERROR) /
      Globals::Search::MAX_EDIT_ERROR;
  double gap_error = std::min(1.0, ERROR_RATIO * edit_error);
  double a = (1 - gap_error) / (1 + gap_error);
  double b = 1 / (2 * std::exp(kmer_size * edit_error) - 1);
  return a * b;
}
int relaxed_jaccard_estimate(int s, int kmer_size,
                             std::unordered_map<int, int> &mm) {
  auto it = mm.find(s);
  if (it != mm.end()) return it->second;
  int result;
  if (s <= 0) result = 0;
  else if (s == 1) result = 1;
  else result = (int)std::ceil(s * tau(Globals::Search::MAX_EDIT_ERROR, kmer_size)) + 1;
  mm[s] = result;
  return result;
}

int main(int argc, char **argv) {
  int mode = argc > 1 ? atoi(argv[1]) : 0;
  unsigned seed = argc > 2 ? (unsigned)atoi(argv[2]) : 42;
  std::mt19937 rng(seed);

  if (mode == 0) {
    // SlidingMap op-stream test: ops are (op_type, hash, status)
    const int K = 12;
    SlidingMap sm(K);
    std::vector<std::pair<int, Hash>> q_added, r_added;
    int nops = argc > 3 ? atoi(argv[3]) : 2000;
    std::uniform_int_distribution<int> opd(0, 3), hd(0, 200), sd(0, 9);
    for (int i = 0; i < nops; i++) {
      int op = opd(rng);
      uint32_t hv = hd(rng);
      int sroll = sd(rng);
      Hash::Status st = sroll < 7 ? Hash::Status::HAS_UPPERCASE
                      : (sroll < 9 ? Hash::Status::ALL_LOWERCASE
                                   : Hash::Status::HAS_N);
      Hash h{hv, st};
      if (op == 1 && !q_added.empty()) {
        std::uniform_int_distribution<size_t> pick(0, q_added.size() - 1);
        size_t j = pick(rng);
        h = q_added[j].second;
        printf("OP 1 %u %d\n", h.hash, (int)h.status);
        sm.remove_from_query(h);
        q_added.erase(q_added.begin() + j);
      }
      else if (op == 2) { printf("OP 2 %u %d\n", h.hash, (int)h.status); sm.add_to_reference(h); r_added.push_back({0, h}); }
      else if (op == 3 && !r_added.empty()) {
        std::uniform_int_distribution<size_t> pick(0, r_added.size() - 1);
        size_t j = pick(rng);
        h = r_added[j].second;
        printf("OP 3 %u %d\n", h.hash, (int)h.status);
        sm.remove_from_reference(h);
        r_added.erase(r_added.begin() + j);
      }
      else { printf("OP 0 %u %d\n", h.hash, (int)h.status); sm.add_to_query(h); q_added.push_back({0, h}); }
      printf("%d %d %d %d %d\n", i, sm.query_size, sm.intersection,
             (int)sm.limit, sm.jaccard());
    }
  } else if (mode == 1) {
    // get_minimizers test on a random soft-masked sequence with N runs
    int len = argc > 3 ? atoi(argv[3]) : 5000;
    int k = argc > 4 ? atoi(argv[4]) : 12;
    int w = argc > 5 ? atoi(argv[5]) : 16;
    std::string s;
    const char *U = "ACGT", *L = "acgt";
    std::uniform_int_distribution<int> bd(0, 3), cd(0, 99);
    for (int i = 0; i < len; i++) {
      int c = cd(rng);
      if (c < 2) s += 'N';
      else if (c < 3) s += 'n';
      else if (c < 40) s += L[bd(rng)];
      else s += U[bd(rng)];
    }
    auto mins = get_minimizers(s, k, w, true);
    // also print the sequence so python can replay it
    printf("SEQ %s\n", s.c_str());
    for (auto &m : mins)
      printf("%u %d %d\n", m.hash.hash, (int)m.hash.status, m.loc);
  }
  return 0;
}
