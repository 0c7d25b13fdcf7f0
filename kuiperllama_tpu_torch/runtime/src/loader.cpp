// Native checkpoint loader: mmap + header parse + layout validation.
//
// TPU-native counterpart of the reference's RawModelData / read_model_file
// (kuiper/include/model/raw_model_data.h:6-22, kuiper/source/model/
// model.cpp:41-123): the weight file is mapped PROT_READ|MAP_PRIVATE and
// exposed zero-copy to Python (numpy views via ctypes); the 7/8-int32
// llama2.c header is parsed and the v0/v3 body size is validated against
// the file length before any tensor is touched. madvise(WILLNEED) warms
// the page cache for the sequential weight upload that follows.
//
// C ABI only — consumed through ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

struct KtHeader {
  int32_t dim;
  int32_t hidden_dim;
  int32_t n_layers;
  int32_t n_heads;
  int32_t n_kv_heads;
  int32_t vocab_size;   // absolute value; sign -> tied flag below
  int32_t seq_len;
  int32_t group_size;   // 0 when not quantized
  int32_t tied;         // 1 = lm_head shares tok_emb
  int32_t quantized;    // 1 = v3 int8 body
  int32_t qkv_bias;     // 1 = v0 body carries q/k/v biases (Qwen2 flavor)
  int64_t body_offset;  // first weight byte
  int64_t file_size;
};

struct KtFile {
  void* base;
  int64_t size;
  int fd;
};

static int64_t v0_body_bytes(const KtHeader* h) {
  int64_t d = h->dim, hid = h->hidden_dim, L = h->n_layers;
  int64_t head_dim = d / h->n_heads;
  int64_t kv_dim = (int64_t)h->n_kv_heads * head_dim;
  int64_t v = h->vocab_size;
  int64_t body = v * d;                          // tok_emb
  body += L * d;                                 // attn norms
  body += L * (d * d + 2 * kv_dim * d + d * d);  // wq wk wv wo
  if (h->qkv_bias) body += L * (d + 2 * kv_dim); // qwen2 q/k/v biases
  body += L * d;                                 // ffn norms
  body += 3 * L * (int64_t)hid * d;              // w1 w2 w3
  body += d;                                     // final norm
  body += 2 * (int64_t)h->seq_len * (head_dim / 2);  // freqs cos+sin
  if (!h->tied) body += v * d;                   // wcls
  return body * 4;
}

static int64_t v3_body_bytes(const KtHeader* h) {
  int64_t d = h->dim, hid = h->hidden_dim, L = h->n_layers;
  int64_t head_dim = d / h->n_heads;
  int64_t kv_dim = (int64_t)h->n_kv_heads * head_dim;
  int64_t v = h->vocab_size;
  int64_t qelems = L * (2 * d * d + 2 * kv_dim * d + 3 * (int64_t)hid * d);
  if (!h->tied) qelems += v * d;
  int64_t fp = v * d + (2 * L + 1) * d;
  return qelems + (qelems / h->group_size) * 4 + fp * 4;
}

// Parse the header and validate the body length. Returns 0 on success,
// negative error codes otherwise. `quant_hint`: 1 force v3, 0 force v0,
// -1 autodetect by exact body-size match (mirrors our Python loader).
int kt_parse_header(const char* path, int quant_hint, KtHeader* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -2; }
  int32_t raw[8];
  if (read(fd, raw, sizeof(raw)) < (ssize_t)(7 * sizeof(int32_t))) {
    close(fd);
    return -3;
  }
  close(fd);

  KtHeader h;
  std::memset(&h, 0, sizeof(h));
  h.dim = raw[0];
  h.hidden_dim = raw[1];
  h.n_layers = raw[2];
  h.n_heads = raw[3];
  h.n_kv_heads = raw[4];
  h.tied = raw[5] > 0;
  h.vocab_size = raw[5] > 0 ? raw[5] : -raw[5];
  h.seq_len = raw[6];
  h.file_size = st.st_size;
  if (h.dim <= 0 || h.n_heads <= 0 || h.n_layers <= 0 || h.vocab_size <= 0 ||
      h.dim % h.n_heads != 0)
    return -4;

  KtHeader hq = h;
  hq.group_size = raw[7];
  hq.quantized = 1;
  hq.body_offset = 32;
  bool v3_ok = hq.group_size >= 1 && hq.group_size <= 4096 &&
               h.dim % hq.group_size == 0 &&
               st.st_size == 32 + v3_body_bytes(&hq);
  h.body_offset = 28;
  bool v0_ok = st.st_size == 28 + v0_body_bytes(&h);
  if (!v0_ok) {  // try the Qwen2 flavor (q/k/v biases after each weight)
    h.qkv_bias = 1;
    v0_ok = st.st_size == 28 + v0_body_bytes(&h);
    if (!v0_ok) h.qkv_bias = 0;
  }

  if (quant_hint == 1 || (quant_hint == -1 && v3_ok)) {
    if (!v3_ok) return -5;
    *out = hq;
    return 0;
  }
  if (!v0_ok) return -6;
  *out = h;
  return 0;
}

// mmap the checkpoint read-only (the reference mmaps PROT_READ MAP_PRIVATE,
// model.cpp:103-116). Returns a handle or null.
KtFile* kt_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) { close(fd); return nullptr; }
  madvise(base, st.st_size, MADV_WILLNEED);
  KtFile* f = new KtFile{base, (int64_t)st.st_size, fd};
  return f;
}

const void* kt_data(KtFile* f) { return f ? f->base : nullptr; }
int64_t kt_size(KtFile* f) { return f ? f->size : 0; }

void kt_close(KtFile* f) {
  if (!f) return;
  munmap(f->base, f->size);
  close(f->fd);
  delete f;
}

}  // extern "C"
