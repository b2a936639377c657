// RESP2 wire codec of redisson_tpu_torch: the C ABI the RESP front-end
// (`wire/`) calls through ctypes (`redisson_tpu_torch/native.py`).
//
// The port's own copy of the RESP half of `native/redisson_native.cpp`,
// bit-identical in what it writes and parses:
//   * a pipeline encoder: *N\r\n then $len\r\n<arg>\r\n per argument, one
//     malloc'd buffer per call (freed with hf_free);
//   * an incremental, reentrant RESP2 parser that serializes completed
//     frames into a flat little-endian stream ([u8 type][i64 payload], then
//     the bytes of + - $ frames; arrays pre-order), poisoned for good by a
//     bad header or nesting deeper than 64 (one error frame is surfaced).
// RESP3 type bytes (%, _, , ...) are protocol errors here, as there.
//
// Built into the host fold library (`native.build()`, g++ -O3 -std=c++17
// -fPIC -shared), in the package's git-ignored build/ directory.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

#define HF_EXPORT extern "C" __attribute__((visibility("default")))

// ---------------------------------------------------------------------------
// RESP2 pipeline encoder.
//
// Input: nargs byte strings (concatenated + offsets) per command, ncmds
// commands delimited by cmd_arg_counts. Output: a single malloc'd buffer the
// caller frees with hf_free. Layout mirrors the reference CommandEncoder
// (*N\r\n then $len\r\n<arg>\r\n per arg) and CommandBatchEncoder
// (concatenation).
// ---------------------------------------------------------------------------

HF_EXPORT void hf_free(void* p) { std::free(p); }

HF_EXPORT uint8_t* hf_resp_encode_pipeline(const uint8_t* args,
                                               const int64_t* offsets,
                                               const int32_t* cmd_arg_counts,
                                               int64_t ncmds,
                                               int64_t* out_len) {
  std::string out;
  out.reserve(256 * (size_t)ncmds);
  char head[32];
  int64_t a = 0;
  for (int64_t c = 0; c < ncmds; c++) {
    int n = std::snprintf(head, sizeof(head), "*%d\r\n", cmd_arg_counts[c]);
    out.append(head, n);
    for (int32_t k = 0; k < cmd_arg_counts[c]; k++, a++) {
      int64_t len = offsets[a + 1] - offsets[a];
      n = std::snprintf(head, sizeof(head), "$%lld\r\n", (long long)len);
      out.append(head, n);
      out.append((const char*)(args + offsets[a]), (size_t)len);
      out.append("\r\n", 2);
    }
  }
  uint8_t* buf = (uint8_t*)std::malloc(out.size() ? out.size() : 1);
  std::memcpy(buf, out.data(), out.size());
  *out_len = (int64_t)out.size();
  return buf;
}

// ---------------------------------------------------------------------------
// RESP2 incremental parser.
//
// Streaming, reentrant across partial reads — the C++ analogue of the
// reference's ReplayingDecoder checkpoint machine
// (client/handler/CommandDecoder.java State/StateLevel). Completed replies
// are serialized into a flat little-endian stream Python unpacks:
//   [u8 type][i64 payload]
//     type '+' / '-' / '$': payload = byte length, followed by the bytes
//                           ($ with length -1 = null bulk, no bytes)
//     type ':'            : payload = integer value, no bytes
//     type '*'            : payload = element count (-1 = null array);
//                           elements follow recursively, pre-order
// ---------------------------------------------------------------------------

struct RespParser {
  std::string buf;      // unconsumed wire bytes
  size_t pos = 0;       // parse cursor into buf
  std::string out;      // flattened completed replies
  int64_t nready = 0;   // completed top-level replies in `out`
  bool poisoned = false;  // unrecoverable protocol violation seen
};

HF_EXPORT RespParser* hf_resp_parser_new() { return new RespParser(); }
HF_EXPORT void hf_resp_parser_free(RespParser* p) { delete p; }

static void emit_header(std::string& out, uint8_t type, int64_t payload) {
  out.push_back((char)type);
  out.append((const char*)&payload, 8);
}

// RESP arrays nest one C-stack frame per level; real replies nest a
// handful deep. Cap to keep hostile/corrupt streams from overflowing the
// stack (the error path below tears the stream down).
static const int kMaxRespDepth = 64;

// Try to parse one reply at `pos`; append flattened form to `out`.
// Returns true and advances pos past the reply on success; false (pos
// untouched, out possibly partially longer — caller rolls back) if the
// buffer holds only a prefix.
static bool parse_one(RespParser* p, size_t& pos, std::string& out,
                      int depth = 0) {
  const std::string& b = p->buf;
  if (pos >= b.size()) return false;
  char t = b[pos];
  size_t eol = b.find("\r\n", pos + 1);
  if (eol == std::string::npos) return false;
  std::string line = b.substr(pos + 1, eol - pos - 1);
  size_t after = eol + 2;
  switch (t) {
    case '+': case '-': {
      emit_header(out, (uint8_t)t, (int64_t)line.size());
      out.append(line);
      pos = after;
      return true;
    }
    case ':': {
      emit_header(out, ':', std::strtoll(line.c_str(), nullptr, 10));
      pos = after;
      return true;
    }
    case '$': {
      int64_t len = std::strtoll(line.c_str(), nullptr, 10);
      if (len < 0) {  // null bulk
        emit_header(out, '$', -1);
        pos = after;
        return true;
      }
      if (b.size() < after + (size_t)len + 2) return false;
      emit_header(out, '$', len);
      out.append(b, after, (size_t)len);
      pos = after + (size_t)len + 2;
      return true;
    }
    case '*': {
      if (depth >= kMaxRespDepth) {
        // Unrecoverable: request/response framing is lost. Poison the
        // parser; feed() surfaces one top-level error reply and the
        // client tears the connection down.
        p->poisoned = true;
        return false;
      }
      int64_t count = std::strtoll(line.c_str(), nullptr, 10);
      emit_header(out, '*', count);
      pos = after;
      for (int64_t i = 0; i < count; i++) {
        if (!parse_one(p, pos, out, depth + 1)) return false;
      }
      return true;
    }
    default:
      // Protocol violation: framing is lost for good — poison.
      p->poisoned = true;
      return false;
  }
}

// Feed wire bytes; returns the number of COMPLETE top-level replies now
// buffered (cumulative, decremented by take).
HF_EXPORT int64_t hf_resp_parser_feed(RespParser* p, const uint8_t* data,
                                          int64_t len) {
  if (p->poisoned) {
    // One error reply was already surfaced; drop everything after it.
    return p->nready;
  }
  p->buf.append((const char*)data, (size_t)len);
  for (;;) {
    size_t pos = p->pos;
    std::string piece;
    if (!parse_one(p, pos, piece)) break;
    p->out.append(piece);
    p->pos = pos;
    p->nready++;
  }
  if (p->poisoned) {
    static const char kMsg[] = "ERR protocol violation (bad header or nesting)";
    emit_header(p->out, '-', (int64_t)(sizeof(kMsg) - 1));
    p->out.append(kMsg, sizeof(kMsg) - 1);
    p->nready++;
    p->buf.clear();
    p->pos = 0;
    return p->nready;
  }
  // Compact consumed prefix occasionally to bound memory.
  if (p->pos > (1u << 16) && p->pos * 2 > p->buf.size()) {
    p->buf.erase(0, p->pos);
    p->pos = 0;
  }
  return p->nready;
}

// Size of the pending flattened-reply stream (bytes).
HF_EXPORT int64_t hf_resp_parser_pending(RespParser* p) {
  return (int64_t)p->out.size();
}

// Copy out the flattened stream of all completed replies and reset it.
// Returns bytes written; caller sizes the buffer via _pending first.
HF_EXPORT int64_t hf_resp_parser_take(RespParser* p, uint8_t* dst,
                                          int64_t cap) {
  int64_t n = (int64_t)p->out.size();
  if (n > cap) return -1;
  std::memcpy(dst, p->out.data(), (size_t)n);
  p->out.clear();
  p->nready = 0;
  return n;
}
