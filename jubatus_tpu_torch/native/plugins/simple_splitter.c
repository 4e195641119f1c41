/* Sample C string_feature plugin: whitespace tokenizer.
 *
 * Implements the C splitter convention consumed by
 * jubatus_tpu_torch/fv/plugin.py (_CSplitter): export
 *   int create(const char* text, int* begins, int* lengths, int max)
 * returning the number of (byte-offset, byte-length) token spans.
 * The role of the reference's shipped splitter plugins
 * (plugin/src/fv_converter/mecab_splitter.cpp, ux_splitter.cpp there)
 * as dlopen'd shared objects.
 *
 * Build: jubatus_tpu_torch/native/plugins/__init__.py builds it at first
 * use (cc -shared -fPIC -O2 into build/torch_plugins/).
 */

static int is_space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

int create(const char* text, int* begins, int* lengths, int max_tokens) {
  int n = 0;
  int i = 0;
  while (text[i] != '\0' && n < max_tokens) {
    while (text[i] != '\0' && is_space(text[i])) i++;
    if (text[i] == '\0') break;
    int start = i;
    while (text[i] != '\0' && !is_space(text[i])) i++;
    begins[n] = start;
    lengths[n] = i - start;
    n++;
  }
  return n;
}
