// graftlint fixture — a miniature ProfCounters struct for the
// prof-counter-wire rule. `new_counter_ns` is the seeded violation: it
// exists here but is missing from the fixture decoder's _PROF_SCALARS.
#include <cstdint>
#include <mutex>

constexpr int kProfMaxShards = 4;

struct ProfCounters {
  std::mutex mu;
  uint64_t parses = 0;
  uint64_t spans = 0;
  uint64_t fold_ns = 0;
  uint64_t new_counter_ns = 0;  // appended scalar the decoder never learned
  // per-shard arrays deliberately use aggregate init and must NOT match
  uint32_t shards_used = 0;
  uint64_t shard_parse_ns[kProfMaxShards] = {0};
};
