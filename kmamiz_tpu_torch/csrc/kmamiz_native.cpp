// Copy of native/kmamiz_native.cpp (the JAX package's native library), built for the port by kmamiz_tpu_torch/native.
// Native data-loader hot path: envoy log-line parsing.
//
// C++ equivalent of the reference's Rust data processor log parser
// (kmamiz_data_processor/src/http_client/log_matcher.rs) — the per-line
// work that dominates host-side ingestion when a pod log fetch returns
// thousands of lines per tick. (A km_explode_url twin of url_matcher.rs
// was measured slower than the Python regex through per-call ctypes
// overhead — single-URL calls don't batch — so only the batched log
// parser lives here.)
// Exposed as a plain C ABI for ctypes (the image has no pybind11); output
// is a flat buffer with 0x1F field / 0x1E record separators so one call
// parses one whole pod log with no per-record FFI overhead.
//
// Semantics mirror kmamiz_tpu/core/envoy.py (itself a parity port of
// KubernetesService.ts:201-242); tests/test_native.py asserts C++ ==
// Python on the captured fixtures.

#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <vector>

namespace {

constexpr char kFieldSep = '\x1f';
constexpr char kRecordSep = '\x1e';

bool is_word(char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_';
}

// [\w-]+ for request ids, \w+ for trace/span ids
bool all_word(std::string_view s, bool allow_dash) {
  if (s.empty()) return false;
  for (char c : s) {
    if (!is_word(c) && !(allow_dash && c == '-')) return false;
  }
  return true;
}

struct HeaderMatch {
  bool ok = false;
  std::string_view type, request_id, trace_id, span_id, parent_span_id;
};

// [(Request|Response) <reqId>/<traceId>/<spanId>/<parentSpanId>]
HeaderMatch find_header(std::string_view log) {
  for (size_t pos = 0; (pos = log.find('[', pos)) != std::string_view::npos;
       ++pos) {
    std::string_view rest = log.substr(pos + 1);
    std::string_view type;
    if (rest.rfind("Request ", 0) == 0) {
      type = rest.substr(0, 7);
    } else if (rest.rfind("Response ", 0) == 0) {
      type = rest.substr(0, 8);
    } else {
      continue;
    }
    std::string_view ids = rest.substr(type.size() + 1);
    size_t close = ids.find(']');
    if (close == std::string_view::npos) continue;
    ids = ids.substr(0, close);

    std::vector<std::string_view> parts;
    size_t start = 0;
    for (size_t i = 0; i <= ids.size(); ++i) {
      if (i == ids.size() || ids[i] == '/') {
        parts.push_back(ids.substr(start, i - start));
        start = i + 1;
      }
    }
    if (parts.size() != 4) continue;
    if (!all_word(parts[0], /*allow_dash=*/true) || !all_word(parts[1], false) ||
        !all_word(parts[2], false) || !all_word(parts[3], false)) {
      continue;
    }
    return {true, type, parts[0], parts[1], parts[2], parts[3]};
  }
  return {};
}

// [Status] <digits>
std::string_view find_status(std::string_view log) {
  size_t pos = log.find("[Status] ");
  if (pos == std::string_view::npos) return {};
  size_t start = pos + 9, end = start;
  while (end < log.size() && log[end] >= '0' && log[end] <= '9') ++end;
  return end > start ? log.substr(start, end - start) : std::string_view{};
}

constexpr std::string_view kMethods[] = {
    "GET", "POST", "PUT", "DELETE", "PATCH", "HEAD", "OPTIONS"};

struct MethodPath {
  std::string_view method, path;
};

// (GET|POST|...) <anything-up-to-]>
MethodPath find_method_path(std::string_view log) {
  size_t best = std::string_view::npos;
  std::string_view best_method;
  for (std::string_view m : kMethods) {
    for (size_t pos = 0; (pos = log.find(m, pos)) != std::string_view::npos;
         ++pos) {
      size_t after = pos + m.size();
      if (after < log.size() && log[after] == ' ') {
        if (pos < best) {
          best = pos;
          best_method = m;
        }
        break;
      }
    }
  }
  if (best == std::string_view::npos) return {};
  size_t start = best + best_method.size() + 1;
  size_t end = log.find(']', start);
  std::string_view path = log.substr(
      start, end == std::string_view::npos ? log.size() - start : end - start);
  return {best_method, path};
}

// [ContentType <up-to-]>]
std::string_view find_content_type(std::string_view log) {
  size_t pos = log.find("[ContentType ");
  if (pos == std::string_view::npos) return {};
  size_t start = pos + 13;
  size_t end = log.find(']', start);
  if (end == std::string_view::npos) return {};
  return log.substr(start, end - start);
}

// [Body] <rest-of-line>
std::string_view find_body(std::string_view log, bool* present) {
  size_t pos = log.find("[Body] ");
  *present = pos != std::string_view::npos;
  return *present ? log.substr(pos + 7) : std::string_view{};
}

void append_field(std::string* out, std::string_view value) {
  out->append(value.data(), value.size());
  out->push_back(kFieldSep);
}

char* to_c_buffer(const std::string& out, size_t* out_len) {
  char* buffer = static_cast<char*>(std::malloc(out.size() + 1));
  if (buffer == nullptr) {
    *out_len = 0;
    return nullptr;
  }
  std::memcpy(buffer, out.data(), out.size());
  buffer[out.size()] = '\0';
  *out_len = out.size();
  return buffer;
}

}  // namespace

extern "C" {

void km_free(char* p) { std::free(p); }

// Input: log lines joined by '\n', each "time\tpayload".
// Output records (RS-separated): time FS type FS requestId FS traceId FS
// spanId FS parentSpanId FS method FS path FS status FS contentType FS
// body FS bodyPresent("1"/"0"). Lines without a header are skipped, like
// the Python parser.
char* km_parse_envoy_lines(const char* input, size_t len, size_t* out_len) {
  std::string_view all(input, len);
  std::string out;
  out.reserve(len);

  size_t line_start = 0;
  while (line_start <= all.size()) {
    size_t line_end = all.find('\n', line_start);
    if (line_end == std::string_view::npos) line_end = all.size();
    std::string_view line = all.substr(line_start, line_end - line_start);
    line_start = line_end + 1;
    if (line_end == all.size() && line.empty()) break;

    size_t tab = line.find('\t');
    if (tab == std::string_view::npos) continue;
    std::string_view time = line.substr(0, tab);
    std::string_view log = line.substr(tab + 1);

    HeaderMatch header = find_header(log);
    if (!header.ok) continue;

    bool body_present = false;
    MethodPath mp = find_method_path(log);
    std::string_view body = find_body(log, &body_present);

    append_field(&out, time);
    append_field(&out, header.type);
    append_field(&out, header.request_id);
    append_field(&out, header.trace_id);
    append_field(&out, header.span_id);
    append_field(&out, header.parent_span_id);
    append_field(&out, mp.method);
    append_field(&out, mp.path);
    append_field(&out, find_status(log));
    append_field(&out, find_content_type(log));
    append_field(&out, body);
    out.append(body_present ? "1" : "0");
    out.push_back(kRecordSep);
  }
  return to_c_buffer(out, out_len);
}

namespace {

// One application of the Python prefix regex
// \t.*envoy (lua|wasm).*\t(script|wasm) log[^:]*:<space>
// -> [match_start, match_end) to be replaced with a single '\t', or no match.
bool find_proxy_prefix_span(std::string_view line, size_t* start, size_t* end) {
  size_t envoy = std::string_view::npos;
  size_t e1 = line.find("envoy lua");
  size_t e2 = line.find("envoy wasm");
  envoy = std::min(e1, e2);
  if (envoy == std::string_view::npos) return false;

  size_t first_tab = line.substr(0, envoy).find('\t');
  if (first_tab == std::string_view::npos) return false;

  // greedy .*: last "\t(script|wasm) log" after the envoy marker
  size_t marker = std::string_view::npos;
  size_t marker_log_end = 0;
  for (std::string_view candidate : {std::string_view("\tscript log"),
                                     std::string_view("\twasm log")}) {
    for (size_t pos = envoy;
         (pos = line.find(candidate, pos)) != std::string_view::npos; ++pos) {
      if (marker == std::string_view::npos || pos > marker) {
        marker = pos;
        marker_log_end = pos + candidate.size();
      }
    }
  }
  if (marker == std::string_view::npos) return false;

  // [^:]*: run to the first ':' after "log", which must be followed by ' '
  size_t colon = line.find(':', marker_log_end);
  if (colon == std::string_view::npos || colon + 1 >= line.size() ||
      line[colon + 1] != ' ') {
    return false;
  }
  *start = first_tab;
  *end = colon + 2;
  return true;
}

}  // namespace

// Istio-proxy container log -> "time\tpayload" lines: keep only lines with
// "script log: " / "wasm log "; when the full proxy-prefix pattern matches,
// replace it with a single tab, otherwise keep the line unchanged
// (KubernetesService.ts:188-197 / kmamiz_tpu.core.envoy.strip_istio_proxy_prefix).
char* km_strip_istio_prefix(const char* input, size_t len, size_t* out_len) {
  std::string_view all(input, len);
  std::string out;
  out.reserve(len / 2);

  size_t line_start = 0;
  while (line_start <= all.size()) {
    size_t line_end = all.find('\n', line_start);
    if (line_end == std::string_view::npos) line_end = all.size();
    std::string_view line = all.substr(line_start, line_end - line_start);
    bool last = line_end == all.size();
    line_start = line_end + 1;
    if (last && line.empty()) break;

    if (line.find("script log: ") == std::string_view::npos &&
        line.find("wasm log ") == std::string_view::npos) {
      continue;
    }
    size_t span_start = 0, span_end = 0;
    if (find_proxy_prefix_span(line, &span_start, &span_end)) {
      out.append(line.data(), span_start);
      out.push_back('\t');
      std::string_view rest = line.substr(span_end);
      out.append(rest.data(), rest.size());
    } else {
      out.append(line.data(), line.size());
    }
    out.push_back('\n');
  }
  return to_c_buffer(out, out_len);
}

}  // extern "C"
