// Copy of native/kmamiz_json.cpp (the JAX package's native library), built for the port by kmamiz_tpu_torch/native.
// Native JSON body pipeline: merge-fold + json-to-ts schema inference.
//
// C++ equivalent of the reference's Rust json_utils
// (kmamiz_data_processor/src/json_utils.rs: merge() + to_types()) — the
// per-(endpoint,status) body work that dominates host-side combining when
// a window carries thousands of JSON request/response bodies.
//
// Parity model is kmamiz_tpu/core/schema.py (itself a parity port of
// Utils.ts:14-75,279-309): merge_string_body folded left over a group's
// bodies, then object_to_interface_string on the merged result. Exposed as
// one batched C ABI call (km_process_body_groups) so a whole window's
// groups cross the FFI boundary once; tests/test_native.py asserts C++ ==
// Python on fixtures and randomized JSON.
//
// Known, deliberate deviations (both delegated or re-parse-equal):
//  - number tokens are echoed verbatim into merged output ("1e2" stays
//    "1e2" where Python would print "100.0"); consumers re-parse the
//    merged string, and re-parsing yields the identical value.
//  - groups whose interface emission would need Unicode-aware
//    capitalization, or whose nesting exceeds the parse depth cap, are
//    flagged back to the caller for the pure-Python path.

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <locale.h>
#include <optional>
#include <string>
#include <string_view>
#include <unordered_map>
#include <unordered_set>
#include <utility>
#include <vector>

namespace {

constexpr int kMaxDepth = 200;

// ---------------------------------------------------------------------------
// JSON value model
// ---------------------------------------------------------------------------

struct JValue {
  enum Type : uint8_t { Null, Bool, Num, Str, Arr, Obj } type = Null;
  bool b = false;
  // Num: the raw source token; Str: decoded UTF-8 (WTF-8 for lone
  // surrogates, mirroring Python's permissive \uDC00 handling)
  std::string text;
  std::vector<JValue> arr;
  std::vector<std::pair<std::string, JValue>> obj;  // insertion order
};

bool is_primitive(const JValue& v) {
  return v.type != JValue::Arr && v.type != JValue::Obj;
}

// typeof semantics: typeof null === "object"
std::string_view js_typeof(const JValue& v) {
  switch (v.type) {
    case JValue::Bool:
      return "boolean";
    case JValue::Num:
      return "number";
    case JValue::Str:
      return "string";
    default:
      return "object";
  }
}

bool js_truthy(const JValue& v) {
  switch (v.type) {
    case JValue::Null:
      return false;
    case JValue::Bool:
      return v.b;
    case JValue::Num: {
      // locale-independent (strtod honors LC_NUMERIC): from_chars accepts
      // our validated tokens including NaN/Infinity spellings
      const char* first = v.text.data();
      const char* last = first + v.text.size();
      if (*first == '-') ++first;
      double d = 0.0;
#if !defined(__cpp_lib_to_chars) || __cpp_lib_to_chars < 201611L
      // libstdc++ < 11 ships integer from_chars only: parse with strtod_l
      // under a pinned C locale instead. Its saturation already yields the
      // outcomes the out-of-range branch below reconstructs — overflow
      // gives +/-inf (truthy), underflow gives 0 or a denormal (falsy /
      // truthy), matching Python float().
      static const locale_t c_loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
      const std::string token(first, last);
      d = strtod_l(token.c_str(), nullptr, c_loc);
      return d != 0.0 && !std::isnan(d);
#else
      auto res = std::from_chars(first, last, d, std::chars_format::general);
      if (res.ec == std::errc::result_out_of_range) {
        // overflow (huge -> inf, truthy) vs underflow (tiny -> 0, falsy),
        // matching Python float(): decide by the token's EFFECTIVE decimal
        // exponent — the position of its first significant digit plus the
        // explicit exponent. from_chars only reports out-of-range beyond
        // ~1e±308, so the effective exponent's sign tells which side the
        // value fell off (a huge mantissa with a small negative exponent
        // is still overflow; a tiny fraction with a small positive
        // exponent is still underflow).
        std::string_view t(first, static_cast<size_t>(last - first));
        size_t epos = t.find_first_of("eE");
        std::string_view mant =
            epos == std::string_view::npos ? t : t.substr(0, epos);
        long long exp10 = 0;
        if (epos != std::string_view::npos) {
          const char* ef = t.data() + epos + 1;
          const char* el = t.data() + t.size();
          bool neg = ef < el && *ef == '-';
          if (ef < el && (*ef == '+' || *ef == '-')) ++ef;
          auto eres = std::from_chars(ef, el, exp10);
          if (neg && eres.ec == std::errc()) exp10 = -exp10;
          if (eres.ec == std::errc::result_out_of_range)
            exp10 = neg ? -(1LL << 62) : (1LL << 62);  // sign-clamped
        }
        size_t dot = mant.find('.');
        std::string_view ip =
            dot == std::string_view::npos ? mant : mant.substr(0, dot);
        size_t i = 0;
        while (i < ip.size() && ip[i] == '0') ++i;
        long long eff;
        if (i < ip.size()) {
          eff = static_cast<long long>(ip.size() - i) - 1;
        } else if (dot != std::string_view::npos) {
          std::string_view fp = mant.substr(dot + 1);
          size_t j = 0;
          while (j < fp.size() && fp[j] == '0') ++j;
          if (j == fp.size()) return false;  // 0.0e<huge>: exactly zero
          eff = -static_cast<long long>(j + 1);
        } else {
          return false;  // 0e<huge>: exactly zero
        }
        return eff + exp10 > 0;
      }
      if (res.ec != std::errc()) return true;  // unreachable for valid tokens
      return d != 0.0 && !std::isnan(d);
#endif
    }
    case JValue::Str:
      return !v.text.empty();
    default:
      return true;  // {} and [] are truthy
  }
}

// ---------------------------------------------------------------------------
// JSON parser (json.loads-compatible: strict strings, NaN/Infinity accepted)
// ---------------------------------------------------------------------------

enum class ParseStatus { Ok, Fail, TooDeep };

void encode_utf8(uint32_t cp, std::string* out) {
  if (cp < 0x80) {
    out->push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    // lone surrogates encode as WTF-8, like Python's decoded str
    out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out->push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

struct Parser {
  const char* p;
  const char* end;
  ParseStatus status = ParseStatus::Ok;

  explicit Parser(std::string_view s) : p(s.data()), end(s.data() + s.size()) {}

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }

  bool lit(std::string_view s) {
    if (static_cast<size_t>(end - p) >= s.size() &&
        std::memcmp(p, s.data(), s.size()) == 0) {
      p += s.size();
      return true;
    }
    return false;
  }

  JValue parse_document() {
    ws();
    JValue v = parse_value(0);
    if (status != ParseStatus::Ok) return v;
    ws();
    if (p != end) status = ParseStatus::Fail;
    return v;
  }

  JValue parse_value(int depth) {
    if (depth > kMaxDepth) {
      status = ParseStatus::TooDeep;
      return {};
    }
    if (p >= end) {
      status = ParseStatus::Fail;
      return {};
    }
    char c = *p;
    JValue v;
    switch (c) {
      case '{':
        return parse_object(depth);
      case '[':
        return parse_array(depth);
      case '"':
        return parse_string();
      case 't':
        if (lit("true")) {
          v.type = JValue::Bool;
          v.b = true;
          return v;
        }
        break;
      case 'f':
        if (lit("false")) {
          v.type = JValue::Bool;
          v.b = false;
          return v;
        }
        break;
      case 'n':
        if (lit("null")) return v;
        break;
      case 'N':
        if (lit("NaN")) {
          v.type = JValue::Num;
          v.text = "NaN";
          return v;
        }
        break;
      case 'I':
        if (lit("Infinity")) {
          v.type = JValue::Num;
          v.text = "Infinity";
          return v;
        }
        break;
      default:
        if (c == '-' || (c >= '0' && c <= '9')) return parse_number();
        break;
    }
    status = ParseStatus::Fail;
    return {};
  }

  JValue parse_number() {
    const char* start = p;
    if (p < end && *p == '-') ++p;
    if (lit("Infinity")) {  // json.loads accepts -Infinity
      JValue v;
      v.type = JValue::Num;
      v.text.assign(start, p);
      return v;
    }
    if (p >= end || *p < '0' || *p > '9') {
      status = ParseStatus::Fail;
      return {};
    }
    if (*p == '0') {
      ++p;  // no leading zeros
    } else {
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    if (p < end && *p == '.') {
      ++p;
      if (p >= end || *p < '0' || *p > '9') {
        status = ParseStatus::Fail;
        return {};
      }
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
      ++p;
      if (p < end && (*p == '+' || *p == '-')) ++p;
      if (p >= end || *p < '0' || *p > '9') {
        status = ParseStatus::Fail;
        return {};
      }
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    JValue v;
    v.type = JValue::Num;
    v.text.assign(start, p);
    return v;
  }

  int hex4() {
    if (end - p < 4) return -1;
    int out = 0;
    for (int i = 0; i < 4; ++i) {
      char c = p[i];
      int d;
      if (c >= '0' && c <= '9') d = c - '0';
      else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
      else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
      else return -1;
      out = out * 16 + d;
    }
    p += 4;
    return out;
  }

  JValue parse_string() {
    ++p;  // opening quote
    JValue v;
    v.type = JValue::Str;
    while (p < end) {
      unsigned char c = static_cast<unsigned char>(*p);
      if (c == '"') {
        ++p;
        return v;
      }
      if (c < 0x20) break;  // strict: raw control chars rejected
      if (c == '\\') {
        ++p;
        if (p >= end) break;
        char e = *p++;
        switch (e) {
          case '"': v.text.push_back('"'); break;
          case '\\': v.text.push_back('\\'); break;
          case '/': v.text.push_back('/'); break;
          case 'b': v.text.push_back('\b'); break;
          case 'f': v.text.push_back('\f'); break;
          case 'n': v.text.push_back('\n'); break;
          case 'r': v.text.push_back('\r'); break;
          case 't': v.text.push_back('\t'); break;
          case 'u': {
            int cp = hex4();
            if (cp < 0) {
              status = ParseStatus::Fail;
              return v;
            }
            if (cp >= 0xD800 && cp <= 0xDBFF && end - p >= 6 && p[0] == '\\' &&
                p[1] == 'u') {
              const char* save = p;
              p += 2;
              int lo = hex4();
              if (lo >= 0xDC00 && lo <= 0xDFFF) {
                encode_utf8(0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00),
                            &v.text);
                break;
              }
              p = save;  // not a pair: emit the lone surrogate (WTF-8)
            }
            encode_utf8(static_cast<uint32_t>(cp), &v.text);
            break;
          }
          default:
            status = ParseStatus::Fail;
            return v;
        }
      } else {
        v.text.push_back(static_cast<char>(c));
        ++p;
      }
    }
    status = ParseStatus::Fail;
    return v;
  }

  JValue parse_array(int depth) {
    ++p;
    JValue v;
    v.type = JValue::Arr;
    ws();
    if (p < end && *p == ']') {
      ++p;
      return v;
    }
    while (true) {
      ws();
      v.arr.push_back(parse_value(depth + 1));
      if (status != ParseStatus::Ok) return v;
      ws();
      if (p < end && *p == ',') {
        ++p;
        continue;
      }
      if (p < end && *p == ']') {
        ++p;
        return v;
      }
      status = ParseStatus::Fail;
      return v;
    }
  }

  JValue parse_object(int depth) {
    ++p;
    JValue v;
    v.type = JValue::Obj;
    ws();
    if (p < end && *p == '}') {
      ++p;
      return v;
    }
    std::unordered_map<std::string, size_t> index;
    while (true) {
      ws();
      if (p >= end || *p != '"') {
        status = ParseStatus::Fail;
        return v;
      }
      JValue key = parse_string();
      if (status != ParseStatus::Ok) return v;
      ws();
      if (p >= end || *p != ':') {
        status = ParseStatus::Fail;
        return v;
      }
      ++p;
      ws();
      JValue val = parse_value(depth + 1);
      if (status != ParseStatus::Ok) return v;
      // duplicate keys: first position, last value (dict semantics)
      auto it = index.find(key.text);
      if (it != index.end()) {
        v.obj[it->second].second = std::move(val);
      } else {
        index.emplace(key.text, v.obj.size());
        v.obj.emplace_back(std::move(key.text), std::move(val));
      }
      ws();
      if (p < end && *p == ',') {
        ++p;
        continue;
      }
      if (p < end && *p == '}') {
        ++p;
        return v;
      }
      status = ParseStatus::Fail;
      return v;
    }
  }
};

// ---------------------------------------------------------------------------
// json.dumps(separators=(",", ":"), ensure_ascii=False) serialization;
// number tokens echoed verbatim (re-parse-equal, see file header)
// ---------------------------------------------------------------------------

void stringify_string(const std::string& s, std::string* out) {
  out->push_back('"');
  for (unsigned char c : s) {
    switch (c) {
      case '"': out->append("\\\""); break;
      case '\\': out->append("\\\\"); break;
      case '\b': out->append("\\b"); break;
      case '\f': out->append("\\f"); break;
      case '\n': out->append("\\n"); break;
      case '\r': out->append("\\r"); break;
      case '\t': out->append("\\t"); break;
      default:
        if (c < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", c);
          out->append(buf);
        } else {
          out->push_back(static_cast<char>(c));
        }
    }
  }
  out->push_back('"');
}

void stringify(const JValue& v, std::string* out) {
  switch (v.type) {
    case JValue::Null:
      out->append("null");
      break;
    case JValue::Bool:
      out->append(v.b ? "true" : "false");
      break;
    case JValue::Num:
      out->append(v.text);
      break;
    case JValue::Str:
      stringify_string(v.text, out);
      break;
    case JValue::Arr: {
      out->push_back('[');
      bool first = true;
      for (const JValue& item : v.arr) {
        if (!first) out->push_back(',');
        first = false;
        stringify(item, out);
      }
      out->push_back(']');
      break;
    }
    case JValue::Obj: {
      out->push_back('{');
      bool first = true;
      for (const auto& kv : v.obj) {
        if (!first) out->push_back(',');
        first = false;
        stringify_string(kv.first, out);
        out->push_back(':');
        stringify(kv.second, out);
      }
      out->push_back('}');
      break;
    }
  }
}

// ---------------------------------------------------------------------------
// merge (Utils.ts:279-309 semantics via kmamiz_tpu.core.schema.merge):
// shallow object spread, array limit 10, string spread by codepoint
// ---------------------------------------------------------------------------

size_t utf8_char_len(unsigned char lead) {
  if (lead < 0x80) return 1;
  if ((lead >> 5) == 0x6) return 2;
  if ((lead >> 4) == 0xE) return 3;
  if ((lead >> 3) == 0x1E) return 4;
  return 1;  // invalid lead byte: advance one to stay terminating
}

std::vector<std::pair<std::string, JValue>> spread(const JValue& v) {
  if (v.type == JValue::Obj) return v.obj;
  std::vector<std::pair<std::string, JValue>> out;
  if (v.type == JValue::Str) {
    size_t i = 0;
    int idx = 0;
    while (i < v.text.size()) {
      size_t n = utf8_char_len(static_cast<unsigned char>(v.text[i]));
      n = std::min(n, v.text.size() - i);
      JValue ch;
      ch.type = JValue::Str;
      ch.text = v.text.substr(i, n);
      out.emplace_back(std::to_string(idx++), std::move(ch));
      i += n;
    }
  }
  return out;  // null / number / bool spread to nothing
}

JValue merge(const JValue& a, const JValue& b);

JValue merge_object(const JValue& a, const JValue& b) {
  JValue out;
  out.type = JValue::Obj;
  out.obj = spread(a);
  std::unordered_map<std::string, size_t> index;
  for (size_t i = 0; i < out.obj.size(); ++i) index.emplace(out.obj[i].first, i);
  for (auto& kv : spread(b)) {
    auto it = index.find(kv.first);
    if (it != index.end()) {
      out.obj[it->second].second = std::move(kv.second);
    } else {
      index.emplace(kv.first, out.obj.size());
      out.obj.emplace_back(std::move(kv));
    }
  }
  return out;
}

JValue merge(const JValue& a, const JValue& b) {
  if (a.type == JValue::Arr && b.type == JValue::Arr) {
    JValue out;
    out.type = JValue::Arr;
    constexpr size_t kLimit = 10;
    for (size_t i = 0; i < a.arr.size() && i < kLimit; ++i)
      out.arr.push_back(a.arr[i]);
    for (size_t i = 0; i < b.arr.size() && i < kLimit; ++i)
      out.arr.push_back(b.arr[i]);
    return out;
  }
  if (a.type != JValue::Arr && b.type != JValue::Arr) return merge_object(a, b);
  return js_truthy(a) ? a : b;
}

// ---------------------------------------------------------------------------
// merge_string_body fold (RealtimeDataList.ts:120-156 semantics)
// ---------------------------------------------------------------------------

struct OptStr {
  bool present = false;
  std::string s;
};

struct FoldResult {
  OptStr merged;
  bool too_deep = false;
};

std::optional<JValue> try_parse(std::string_view body, bool* too_deep) {
  Parser parser(body);
  JValue v = parser.parse_document();
  if (parser.status == ParseStatus::TooDeep) {
    *too_deep = true;
    return std::nullopt;
  }
  if (parser.status != ParseStatus::Ok) return std::nullopt;
  return v;
}

OptStr merge_string_body(const OptStr& a, const OptStr& b, bool* too_deep) {
  bool a_nonempty = a.present && !a.s.empty();
  bool b_nonempty = b.present && !b.s.empty();
  if (a_nonempty && b_nonempty) {
    std::optional<JValue> pa = try_parse(a.s, too_deep);
    std::optional<JValue> pb = try_parse(b.s, too_deep);
    if (*too_deep) return {};
    bool at = pa.has_value() && js_truthy(*pa);
    bool bt = pb.has_value() && js_truthy(*pb);
    OptStr out;
    if (at && bt) {
      out.present = true;
      stringify(merge(*pa, *pb), &out.s);
      return out;
    }
    const std::optional<JValue>& chosen = at ? pa : pb;
    if (!chosen.has_value()) return {};  // JSON.stringify(undefined) -> None
    out.present = true;
    stringify(*chosen, &out.s);
    return out;
  }
  return a_nonempty ? a : b;  // `a or b`
}

FoldResult fold_bodies(const std::vector<OptStr>& bodies) {
  FoldResult result;
  if (bodies.empty()) return result;
  result.merged = bodies[0];
  for (size_t i = 1; i < bodies.size(); ++i) {
    result.merged = merge_string_body(result.merged, bodies[i], &result.too_deep);
    if (result.too_deep) return result;
  }
  return result;
}

// ---------------------------------------------------------------------------
// sort_object (Utils.sortObject semantics via schema.sort_object)
// ---------------------------------------------------------------------------

JValue sort_object(const JValue& v) {
  if (v.type == JValue::Arr) {
    bool all_prim = true;
    for (const JValue& item : v.arr)
      if (!is_primitive(item)) all_prim = false;
    if (all_prim) return v;
    JValue out;
    out.type = JValue::Arr;
    for (const JValue& item : v.arr)
      if (!is_primitive(item)) out.arr.push_back(sort_object(item));
    return out;
  }
  if (v.type != JValue::Obj) return v;
  JValue out;
  out.type = JValue::Obj;
  std::vector<size_t> order(v.obj.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = i;
  // bytewise UTF-8 compare == codepoint order == Python sorted()
  std::sort(order.begin(), order.end(), [&](size_t x, size_t y) {
    return v.obj[x].first < v.obj[y].first;
  });
  for (size_t i : order) {
    const std::string& k = v.obj[i].first;
    const JValue& o = v.obj[i].second;
    if (o.type == JValue::Arr) {
      bool all_dict = !o.arr.empty();
      for (const JValue& item : o.arr)
        if (item.type != JValue::Obj) all_dict = false;
      if (all_dict) {
        JValue sorted_list;
        sorted_list.type = JValue::Arr;
        for (const JValue& item : o.arr)
          sorted_list.arr.push_back(sort_object(item));
        out.obj.emplace_back(k, std::move(sorted_list));
        continue;
      }
      out.obj.emplace_back(k, o);
    } else if (o.type == JValue::Obj) {
      out.obj.emplace_back(k, sort_object(o));
    } else {
      out.obj.emplace_back(k, o);
    }
  }
  return out;
}

// ---------------------------------------------------------------------------
// json-to-ts interface emission (schema._InterfaceEmitter parity)
// ---------------------------------------------------------------------------

struct FieldInfo {
  const std::string* key;
  std::vector<const JValue*> values;  // nulls excluded
  bool optional;
};

struct Emitter {
  std::unordered_map<std::string, std::string> sig_to_name;
  std::unordered_set<std::string> used_names;
  std::vector<std::pair<std::string, std::vector<std::string>>> out;
  bool need_python = false;  // Unicode capitalization or non-dict samples

  static std::vector<FieldInfo> merge_fields(
      const std::vector<const JValue*>& samples) {
    std::vector<const std::string*> keys;
    std::unordered_set<std::string_view> seen;
    for (const JValue* s : samples)
      for (const auto& kv : s->obj)
        if (seen.insert(kv.first).second) keys.push_back(&kv.first);
    std::vector<FieldInfo> fields;
    fields.reserve(keys.size());
    for (const std::string* k : keys) {
      FieldInfo f;
      f.key = k;
      size_t present = 0;
      bool any_null = false;
      for (const JValue* s : samples) {
        for (const auto& kv : s->obj) {
          if (kv.first == *k) {
            ++present;
            if (kv.second.type == JValue::Null) any_null = true;
            else f.values.push_back(&kv.second);
            break;
          }
        }
      }
      f.optional = present < samples.size() || any_null;
      fields.push_back(std::move(f));
    }
    return fields;
  }

  // -- structural signatures (shared-subtype dedup) --

  static void append_key(const std::string& k, std::string* sig) {
    sig->push_back('K');
    sig->append(std::to_string(k.size()));
    sig->push_back(':');
    sig->append(k);
  }

  std::string value_sig(const std::vector<const JValue*>& values) {
    if (values.empty()) return "A";
    bool all_obj = true, all_arr = true, all_prim = true;
    for (const JValue* v : values) {
      if (v->type != JValue::Obj) all_obj = false;
      if (v->type != JValue::Arr) all_arr = false;
      if (!is_primitive(*v)) all_prim = false;
    }
    if (all_obj) return "O{" + shape_sig(values) + "}";
    if (all_arr) {
      std::vector<const JValue*> items;
      for (const JValue* v : values)
        for (const JValue& i : v->arr) items.push_back(&i);
      if (items.empty()) return "R[A]";
      bool items_prim = true, items_obj = true;
      for (const JValue* i : items) {
        if (!is_primitive(*i)) items_prim = false;
        if (i->type != JValue::Obj) items_obj = false;
      }
      if (items_prim) {
        std::unordered_set<std::string_view> types;
        std::string_view only;
        for (const JValue* i : items)
          if (i->type != JValue::Null) {
            only = js_typeof(*i);
            types.insert(only);
          }
        if (types.size() == 1) return "R[P:" + std::string(only) + "]";
        return "R[A]";
      }
      if (items_obj) return "R[O{" + shape_sig(items) + "}]";
      return "R[A]";
    }
    if (all_prim) {
      std::unordered_set<std::string_view> types;
      std::string_view only;
      for (const JValue* v : values) {
        only = js_typeof(*v);
        types.insert(only);
      }
      if (types.size() == 1) return "P:" + std::string(only);
      return "A";
    }
    return "A";
  }

  std::string shape_sig(const std::vector<const JValue*>& samples) {
    std::string sig;
    for (const FieldInfo& f : merge_fields(samples)) {
      append_key(*f.key, &sig);
      sig.push_back(f.optional ? '?' : '!');
      sig.append(value_sig(f.values));
      sig.push_back(';');
    }
    return sig;
  }

  // -- emission --

  std::string capitalize(const std::string& word) {
    if (word.empty()) return word;
    unsigned char c = static_cast<unsigned char>(word[0]);
    if (c >= 0x80) {  // Unicode uppercase: delegate to Python
      need_python = true;
      return word;
    }
    std::string out = word;
    if (c >= 'a' && c <= 'z') out[0] = static_cast<char>(c - 'a' + 'A');
    return out;
  }

  static std::string singular(const std::string& word) {
    size_t n = word.size();
    auto ends = [&](std::string_view suffix) {
      return n >= suffix.size() &&
             word.compare(n - suffix.size(), suffix.size(), suffix) == 0;
    };
    if (ends("ies") && n > 3) return word.substr(0, n - 3) + "y";
    if (ends("ses") && n > 3) return word.substr(0, n - 2);
    if (ends("s") && !ends("ss") && n > 1) return word.substr(0, n - 1);
    return word;
  }

  std::string unique_name(const std::string& hint) {
    std::string name = capitalize(hint);
    if (name.empty()) name = "Root";
    if (used_names.insert(name).second) return name;
    int i = 2;
    while (!used_names.insert(name + std::to_string(i)).second) ++i;
    return name + std::to_string(i);
  }

  std::string process_shape(const std::string& name_hint,
                            const std::vector<const JValue*>& all_samples) {
    // only dict samples contribute fields (mirrors schema.process_shape)
    std::vector<const JValue*> samples;
    samples.reserve(all_samples.size());
    for (const JValue* s : all_samples)
      if (s->type == JValue::Obj) samples.push_back(s);
    std::string sig = shape_sig(samples);
    auto it = sig_to_name.find(sig);
    if (it != sig_to_name.end()) return it->second;
    std::string name = unique_name(name_hint);
    if (need_python) return name;
    sig_to_name.emplace(std::move(sig), name);
    size_t slot = out.size();
    out.emplace_back(name, std::vector<std::string>{});
    for (const FieldInfo& f : merge_fields(samples)) {
      std::string rendered = render_type(*f.key, f.values);
      if (need_python) return name;
      std::string line = "  " + *f.key + (f.optional ? "?" : "") + ": " +
                         rendered + ";";
      out[slot].second.push_back(std::move(line));
    }
    return name;
  }

  std::string render_type(const std::string& key,
                          const std::vector<const JValue*>& values) {
    if (values.empty()) return "any";
    bool all_obj = true, all_arr = true, all_prim = true;
    for (const JValue* v : values) {
      if (v->type != JValue::Obj) all_obj = false;
      if (v->type != JValue::Arr) all_arr = false;
      if (!is_primitive(*v)) all_prim = false;
    }
    if (all_obj) return process_shape(key, values);
    if (all_arr) {
      std::vector<const JValue*> items;
      for (const JValue* v : values)
        for (const JValue& i : v->arr) items.push_back(&i);
      if (items.empty()) return "any[]";
      bool items_prim = true, items_obj = true;
      for (const JValue* i : items) {
        if (!is_primitive(*i)) items_prim = false;
        if (i->type != JValue::Obj) items_obj = false;
      }
      if (items_prim) {
        std::unordered_set<std::string_view> types;
        std::string_view only;
        for (const JValue* i : items)
          if (i->type != JValue::Null) {
            only = js_typeof(*i);
            types.insert(only);
          }
        return (types.size() == 1 ? std::string(only) : std::string("any")) +
               "[]";
      }
      if (items_obj) return process_shape(singular(key), items) + "[]";
      return "any[]";
    }
    if (all_prim) {
      std::unordered_set<std::string_view> types;
      std::string_view only;
      for (const JValue* v : values) {
        only = js_typeof(*v);
        types.insert(only);
      }
      return types.size() == 1 ? std::string(only) : "any";
    }
    return "any";
  }

  std::string render() const {
    std::string result;
    bool first = true;
    for (const auto& decl : out) {
      if (!first) result.push_back('\n');
      first = false;
      result.append("interface ").append(decl.first).append(" {\n");
      bool first_line = true;
      for (const std::string& line : decl.second) {
        if (!first_line) result.push_back('\n');
        first_line = false;
        result.append(line);
      }
      if (!decl.second.empty()) result.push_back('\n');
      result.push_back('}');
    }
    return result;
  }
};

std::string json_to_ts(const JValue& sorted, const std::string& root_name,
                       bool* need_python) {
  Emitter emitter;
  std::vector<const JValue*> samples;
  if (sorted.type == JValue::Arr) {
    for (const JValue& item : sorted.arr) samples.push_back(&item);
  } else {
    samples.push_back(&sorted);
  }
  emitter.process_shape(root_name, samples);
  if (emitter.need_python) {
    *need_python = true;
    return "";
  }
  return emitter.render();
}

// object_to_interface_string (schema.py:205-222) on an already-parsed value
std::string object_to_interface_string(const JValue& v, bool* need_python) {
  if (is_primitive(v)) return std::string(js_typeof(v));
  JValue sorted = sort_object(v);
  if (sorted.type == JValue::Arr) {
    std::string array_type = "Array<any>{}";
    std::string appending;
    if (!v.arr.empty()) {
      if (is_primitive(v.arr[0])) {
        array_type = "Array<" + std::string(js_typeof(v.arr[0])) + ">{}";
      } else {
        array_type = "Array<ArrayItem>{}\n";
        appending = json_to_ts(sorted, "ArrayItem", need_python);
        if (*need_python) return "";
      }
    }
    return "interface Root extends " + array_type + appending;
  }
  return json_to_ts(sorted, "Root", need_python);
}

// ---------------------------------------------------------------------------
// batched C ABI: [u32 n_groups][per group: u8 want_interface, u32 n_bodies,
// per body: u8 present(0/1) + (u32 len + bytes if present)]
// -> [u32 n_groups][per group: u8 status(0 ok / 1 python-fallback); if ok:
//    u8 merged_present (+ u32 len + bytes), u8 iface(0 none / 1 str /
//    2 python-fallback) (+ u32 len + bytes if 1)]
// ---------------------------------------------------------------------------

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  bool need(size_t n) {
    if (static_cast<size_t>(end - p) < n) {
      ok = false;
      return false;
    }
    return true;
  }
  uint8_t u8() {
    if (!need(1)) return 0;
    return *p++;
  }
  uint32_t u32() {
    if (!need(4)) return 0;
    uint32_t v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
  }
  std::string_view bytes(uint32_t n) {
    if (!need(n)) return {};
    std::string_view out(reinterpret_cast<const char*>(p), n);
    p += n;
    return out;
  }
};

void put_u32(std::string* out, uint32_t v) {
  out->append(reinterpret_cast<const char*>(&v), 4);
}

void put_str(std::string* out, const std::string& s) {
  put_u32(out, static_cast<uint32_t>(s.size()));
  out->append(s);
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

char* km_process_body_groups(const char* input, size_t len, size_t* out_len) {
  Reader reader{reinterpret_cast<const uint8_t*>(input),
                reinterpret_cast<const uint8_t*>(input) + len};
  uint32_t n_groups = reader.u32();
  std::string out;
  out.reserve(len);
  put_u32(&out, n_groups);

  for (uint32_t g = 0; g < n_groups && reader.ok; ++g) {
    uint8_t want_interface = reader.u8();
    uint32_t n_bodies = reader.u32();
    std::vector<OptStr> bodies;
    bodies.reserve(n_bodies);
    for (uint32_t i = 0; i < n_bodies && reader.ok; ++i) {
      OptStr body;
      body.present = reader.u8() != 0;
      if (body.present) {
        uint32_t blen = reader.u32();
        body.s = std::string(reader.bytes(blen));
      }
      bodies.push_back(std::move(body));
    }
    if (!reader.ok) break;

    FoldResult fold = fold_bodies(bodies);
    if (fold.too_deep) {
      out.push_back('\x01');  // python-fallback
      continue;
    }

    std::string iface;
    uint8_t iface_flag = 0;
    if (want_interface && fold.merged.present) {
      bool too_deep = false;
      std::optional<JValue> parsed = try_parse(fold.merged.s, &too_deep);
      if (too_deep) {
        out.push_back('\x01');
        continue;
      }
      if (parsed.has_value()) {
        bool need_python = false;
        iface = object_to_interface_string(*parsed, &need_python);
        iface_flag = need_python ? 2 : 1;
      }
    }

    out.push_back('\x00');  // ok
    out.push_back(fold.merged.present ? '\x01' : '\x00');
    if (fold.merged.present) put_str(&out, fold.merged.s);
    out.push_back(static_cast<char>(iface_flag));
    if (iface_flag == 1) put_str(&out, iface);
  }

  if (!reader.ok) {
    *out_len = 0;
    return nullptr;
  }
  return to_c_buffer(out, out_len);
}

}  // extern "C"
