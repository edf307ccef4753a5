"""A reader of Hugging Face `tokenizer.json` files for the forms the
repository holds, with no `tokenizers` or `transformers` import: the
tokenizer counterpart of `utils/hf_import`'s numpy safetensors reader
(the card's host has neither package).

Supported, exactly as the `tokenizers` library computes them:
  * model BPE (merges or none; no dropout, unk token, subword prefix or
    suffix, byte fallback);
  * no normalizer; the ByteLevel pre-tokenizer with `use_regex` and no
    prefix space (GPT-2's split pattern, written out below with Unicode
    categories because Python's `re` has no `\\p{L}`); the ByteLevel
    decoder; no post-processor;
  * added tokens (special or not) without lstrip / rstrip / single-word,
    split out of the text before pre-tokenization (leftmost, longest first);
  * the ChatML chat template (`tokenizer_config.json`'s `chat_template` or
    a `chat_template.jinja` beside it).
Any other form raises `NotImplementedError` naming the field, rather than
tokenizing otherwise.

`JsonTokenizer` has what `GenerationEngine`, `data.tokenizer_utils`, the
datasets and collators and `entry.save` call: `__call__(text).input_ids`,
`decode`, `batch_decode`, `convert_tokens_to_ids`, `add_tokens`,
`apply_chat_template`, `eos_token` / `pad_token_id`, `vocab_size`, `len()`
and `save_pretrained` (the grammar's vocab table,
`inference/constrained._token_texts`, reads `vocab_size`, `len()` and
`batch_decode`).
"""

from __future__ import annotations

import json
import os
import re
import types
import unicodedata
from typing import Dict, List, Optional, Sequence

# the ChatML template both committed tokenizers carry (the quant probe's
# chat_template.jinja and tests/helpers.make_tiny_tokenizer)
CHATML_TEMPLATE = (
    "{% for message in messages %}"
    "{{ '<|im_start|>' + message['role'] + '\n' + message['content'] "
    "+ '<|im_end|>' + '\n' }}"
    "{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|im_start|>assistant\n' }}"
    "{% endif %}"
)

# Unicode White_Space (what `\s` means in the `tokenizers` regex)
_WHITE_SPACE = frozenset(
    [chr(c) for c in range(0x09, 0x0E)] + [" ", "\x85", "\xa0", "\u1680"]
    + [chr(c) for c in range(0x2000, 0x200B)]
    + ["\u2028", "\u2029", "\u202f", "\u205f", "\u3000"])
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _is_letter(c: str) -> bool:  # \p{L}
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:  # \p{N}
    return unicodedata.category(c)[0] == "N"


def _is_other(c: str) -> bool:  # [^\s\p{L}\p{N}]
    return not (c in _WHITE_SPACE or _is_letter(c) or _is_number(c))


def split_gpt2(text: str) -> List[str]:
    """GPT-2's pre-tokenizer split,
    `'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`,
    matched as the regex engine does: at each position the first
    alternative that matches, each greedy."""
    out, i, n = [], 0, len(text)
    while i < n:
        if text[i] == "'":
            hit = next((c for c in _CONTRACTIONS if text.startswith(c, i + 1)), None)
            if hit is not None:
                out.append(text[i:i + 1 + len(hit)])
                i += 1 + len(hit)
                continue
        j = i + 1 if text[i] == " " else i
        matched = False
        for cls in (_is_letter, _is_number, _is_other):
            if j < n and cls(text[j]):
                k = j
                while k < n and cls(text[k]):
                    k += 1
                out.append(text[i:k])
                i, matched = k, True
                break
        if matched:
            continue
        k = i  # a run of white space (text[i] is one: every other char matched above)
        while k < n and text[k] in _WHITE_SPACE:
            k += 1
        if k < n and k - i >= 2:
            k -= 1  # \s+(?!\S): leave the last space to the word after it
        out.append(text[i:k])
        i = k
    return out


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character map of the ByteLevel pre-tokenizer."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


_BYTE_CHAR = _bytes_to_unicode()
_CHAR_BYTE = {c: b for b, c in _BYTE_CHAR.items()}


def _require(cond: bool, field: str, value) -> None:
    if not cond:
        raise NotImplementedError(f"tokenizer.json: {field}={value!r} is not supported")


def _token_content(tok) -> Optional[str]:
    return tok.get("content") if isinstance(tok, dict) else tok


class JsonTokenizer:
    """A byte-level BPE tokenizer read from an HF tokenizer directory."""

    def __init__(self, spec: dict, config: Optional[dict] = None,
                 chat_template: Optional[str] = None, special_map: Optional[dict] = None):
        config = dict(config or {})
        self._spec, self._config, self._special_map = spec, config, special_map or {}
        model = spec.get("model") or {}
        _require(model.get("type") == "BPE", "model.type", model.get("type"))
        for field in ("dropout", "unk_token", "continuing_subword_prefix",
                      "end_of_word_suffix"):
            _require(model.get(field) is None, f"model.{field}", model.get(field))
        _require(not model.get("byte_fallback"), "model.byte_fallback", model.get("byte_fallback"))
        _require(spec.get("normalizer") is None, "normalizer", spec.get("normalizer"))
        pre = spec.get("pre_tokenizer") or {}
        _require(pre.get("type") == "ByteLevel", "pre_tokenizer.type", pre.get("type"))
        _require(pre.get("use_regex", True), "pre_tokenizer.use_regex", pre.get("use_regex"))
        _require(not pre.get("add_prefix_space"), "pre_tokenizer.add_prefix_space",
                 pre.get("add_prefix_space"))
        dec = spec.get("decoder") or {}
        _require(dec.get("type") == "ByteLevel", "decoder.type", dec.get("type"))
        _require(spec.get("post_processor") is None, "post_processor", spec.get("post_processor"))

        self.vocab: Dict[str, int] = dict(model["vocab"])
        self._ignore_merges = bool(model.get("ignore_merges"))
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in model.get("merges", [])]
        self._ranks = {pair: r for r, pair in enumerate(merges)}
        self._added: Dict[str, int] = {}
        self._special: set = set()
        for tok in spec.get("added_tokens", []):
            for flag in ("lstrip", "rstrip", "single_word"):
                _require(not tok.get(flag), f"added_tokens[{tok['content']!r}].{flag}",
                         tok.get(flag))
            self._register(tok["content"], tok["id"], tok.get("special", False))
        self._id_to_token = {i: t for t, i in self.vocab.items()}
        self._id_to_token.update({i: t for t, i in self._added.items()})
        self._cache: Dict[str, List[int]] = {}

        template = chat_template if chat_template is not None else config.get("chat_template")
        if template is not None and template != CHATML_TEMPLATE:
            raise NotImplementedError(
                f"chat_template {template[:60]!r}...: only the ChatML template is supported")
        self.chat_template = template
        self.clean_up_tokenization_spaces = bool(config.get("clean_up_tokenization_spaces",
                                                            False))
        self.eos_token, self.pad_token = (
            _token_content(config.get(name, self._special_map.get(name)))
            for name in ("eos_token", "pad_token"))
        additional = [_token_content(t) for t in config.get(
            "additional_special_tokens", self._special_map.get("additional_special_tokens", []))]
        self.add_tokens([t for t in [self.eos_token, self.pad_token] + additional
                         if t is not None], special_tokens=True)
        self._split_re = None

    # ---- vocabulary -------------------------------------------------------

    def _register(self, content: str, idx: int, special: bool) -> None:
        self._added[content] = idx
        if special:
            self._special.add(content)
        self._split_re = None

    def __len__(self) -> int:
        return len(set(self.vocab.values()) | set(self._added.values()))

    @property
    def vocab_size(self) -> int:
        """The model's vocabulary without the added tokens (HF's meaning;
        `len()` counts them)."""
        return len(self.vocab)

    @property
    def eos_token_id(self) -> Optional[int]:
        return self.convert_tokens_to_ids(self.eos_token) if self.eos_token else None

    @property
    def pad_token_id(self) -> Optional[int]:
        return self.convert_tokens_to_ids(self.pad_token) if self.pad_token else None

    def add_tokens(self, tokens, special_tokens: bool = False) -> int:
        """New tokens take the next ids (`len(self)` on); known ones are
        left as they are. Returns the number added."""
        if isinstance(tokens, str):
            tokens = [tokens]
        added = 0
        for tok in tokens:
            tok = _token_content(tok)
            if tok in self._added or tok in self.vocab:
                continue
            self._register(tok, len(self), special_tokens)
            self._id_to_token[self._added[tok]] = tok
            added += 1
        return added

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self._added.get(tokens, self.vocab.get(tokens))
        return [self.convert_tokens_to_ids(t) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        if isinstance(ids, int):
            return self._id_to_token.get(ids)
        return [self._id_to_token.get(int(i)) for i in ids]

    # ---- encoding ---------------------------------------------------------

    def _bpe(self, word: str) -> List[int]:
        """The ids of one pre-tokenized piece (its byte-level characters)."""
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        if self._ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            parts = list(word)
            while len(parts) > 1:
                pairs = [(self._ranks.get((a, b)), i)
                         for i, (a, b) in enumerate(zip(parts, parts[1:]))
                         if (a, b) in self._ranks]
                if not pairs:
                    break
                pos = min(pairs)[1]  # the pair of the lowest rank
                first, second = parts[pos], parts[pos + 1]
                merged, i = [], 0
                while i < len(parts):  # every occurrence, left to right
                    if i + 1 < len(parts) and parts[i] == first and parts[i + 1] == second:
                        merged.append(first + second)
                        i += 2
                    else:
                        merged.append(parts[i])
                        i += 1
                parts = merged
            missing = [p for p in parts if p not in self.vocab]
            if missing:
                raise ValueError(f"BPE symbols {missing!r} are not in the vocabulary")
            ids = [self.vocab[p] for p in parts]
        self._cache[word] = ids
        return ids

    def _segments(self, text: str):
        """(piece, added-token id or None): the text split on added tokens,
        leftmost match first, the longest of those starting there."""
        if not self._added:
            yield text, None
            return
        if self._split_re is None:
            alts = sorted(self._added, key=len, reverse=True)
            self._split_re = re.compile("|".join(re.escape(t) for t in alts))
        pos = 0
        for mo in self._split_re.finditer(text):
            if mo.start() > pos:
                yield text[pos:mo.start()], None
            yield mo.group(0), self._added[mo.group(0)]
            pos = mo.end()
        if pos < len(text):
            yield text[pos:], None

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece, added in self._segments(text):
            if added is not None:
                ids.append(added)
                continue
            for word in split_gpt2(piece):
                ids.extend(self._bpe("".join(_BYTE_CHAR[b] for b in word.encode("utf-8"))))
        return ids

    def __call__(self, text: str, add_special_tokens: bool = False):
        """`.input_ids` of `text` (no post-processor: the special-token flag
        changes nothing)."""
        return types.SimpleNamespace(input_ids=self.encode(text))

    # ---- decoding ---------------------------------------------------------

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        """The ByteLevel decoder over the tokens of `ids` (special added
        tokens dropped with `skip_special_tokens`); bytes that do not form
        UTF-8 become U+FFFD, as the `tokenizers` library decodes them."""
        if isinstance(ids, int) or not hasattr(ids, "__iter__"):
            ids = [ids]
        buf = bytearray()
        for i in ids:
            tok = self._id_to_token.get(int(i))
            if tok is None or (skip_special_tokens and tok in self._special):
                continue
            for c in tok:
                b = _CHAR_BYTE.get(c)
                if b is None:
                    buf.extend(c.encode("utf-8"))
                else:
                    buf.append(b)
        text = buf.decode("utf-8", errors="replace")
        if self.clean_up_tokenization_spaces:
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                         (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                         (" 're", "'re")):
                text = text.replace(a, b)
        return text

    def batch_decode(self, sequences, skip_special_tokens: bool = False) -> List[str]:
        """`decode` of each id sequence."""
        return [self.decode(seq, skip_special_tokens=skip_special_tokens) for seq in sequences]

    # ---- chat -------------------------------------------------------------

    def apply_chat_template(self, conversation: Sequence[dict], add_generation_prompt=False,
                            tokenize: bool = True, **kwargs):
        """The ChatML rendering of the messages (the only template read)."""
        if self.chat_template is None:
            raise ValueError("this tokenizer has no chat_template")
        if kwargs:
            raise NotImplementedError(f"apply_chat_template options {sorted(kwargs)}")
        text = "".join(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
                       for m in conversation)
        if add_generation_prompt:
            text += "<|im_start|>assistant\n"
        return self.encode(text) if tokenize else text

    # ---- files ------------------------------------------------------------

    def save_pretrained(self, out_dir: str) -> None:
        """tokenizer.json (added tokens included), tokenizer_config.json,
        special_tokens_map.json and chat_template.jinja."""
        os.makedirs(out_dir, exist_ok=True)
        spec = dict(self._spec)
        spec["added_tokens"] = [
            {"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
             "normalized": False, "special": t in self._special}
            for t, i in sorted(self._added.items(), key=lambda kv: kv[1])]
        with open(os.path.join(out_dir, "tokenizer.json"), "w") as f:
            json.dump(spec, f, ensure_ascii=False, indent=2)
        config = {k: v for k, v in self._config.items() if k != "chat_template"}
        with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
            json.dump(config, f, ensure_ascii=False, indent=2)
        with open(os.path.join(out_dir, "special_tokens_map.json"), "w") as f:
            json.dump(self._special_map, f, ensure_ascii=False, indent=2)
        if self.chat_template is not None:
            with open(os.path.join(out_dir, "chat_template.jinja"), "w") as f:
                f.write(self.chat_template)

    @classmethod
    def from_pretrained(cls, path: str) -> "JsonTokenizer":
        """The tokenizer of an HF tokenizer directory (tokenizer.json, with
        tokenizer_config.json, special_tokens_map.json and
        chat_template.jinja where present)."""
        def read(name):
            p = os.path.join(path, name)
            if not os.path.exists(p):
                return None
            with open(p, encoding="utf-8") as f:
                return f.read() if name.endswith(".jinja") else json.load(f)

        spec = read("tokenizer.json")
        if spec is None:
            raise FileNotFoundError(f"no tokenizer.json in {path}")
        return cls(spec, read("tokenizer_config.json"), read("chat_template.jinja"),
                   read("special_tokens_map.json"))
