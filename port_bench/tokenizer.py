"""A byte-level tokenizer with the ChatML template, the stand-in for
Qwen2's BPE (no tokenizer files are in the repository): ids 0-255 are
UTF-8 bytes, special tokens follow. It carries what the program's engine,
batcher and training data path call (`media_token_ids`, the chat template,
`add_tokens`, `decode`), so a prompt's length in tokens is its length in
bytes plus its special tokens. The reference builds prompt ids from the
same class.
"""

from __future__ import annotations

import types
from typing import Dict, List

SPECIAL = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")
MEDIA_TOKENS = {"image": "<image>", "video": "<vila/video>"}


class ByteTokenizer:
    def __init__(self):
        self.vocab: Dict[str, int] = {}
        self.add_tokens(list(SPECIAL), special_tokens=True)
        self.eos_token = "<|im_end|>"
        self.pad_token_id = self.vocab["<|endoftext|>"]
        self.add_tokens(list(MEDIA_TOKENS.values()), special_tokens=True)
        self.media_tokens = dict(MEDIA_TOKENS)
        self.media_token_ids = {k: self.vocab[v] for k, v in MEDIA_TOKENS.items()}

    def __len__(self):
        return 256 + len(self.vocab)

    @property
    def vocab_size(self):
        """The byte vocabulary, the added tokens not counted (HF's meaning)."""
        return 256

    def add_tokens(self, tokens, special_tokens=True):
        for t in tokens:
            if t not in self.vocab:
                self.vocab[t] = 256 + len(self.vocab)
        self._inv = {i: t for t, i in self.vocab.items()}

    def convert_tokens_to_ids(self, token):
        return self.vocab.get(token)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        specials = sorted(self.vocab, key=len, reverse=True)
        i = 0
        while i < len(text):
            for s in specials:
                if text.startswith(s, i):
                    ids.append(self.vocab[s])
                    i += len(s)
                    break
            else:
                j = i + 1
                while j < len(text) and not any(text.startswith(s, j) for s in specials):
                    j += 1
                ids.extend(text[i:j].encode("utf-8"))
                i = j
        return ids

    def __call__(self, text, add_special_tokens=False):
        return types.SimpleNamespace(input_ids=self.encode(text))

    def apply_chat_template(self, chat, add_generation_prompt=False, tokenize=False):
        text = "".join(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in chat)
        if add_generation_prompt:
            text += "<|im_start|>assistant\n"
        return text

    def decode(self, ids, skip_special_tokens=False):
        if not hasattr(ids, "__iter__"):
            ids = [ids]
        out, buf = [], bytearray()
        for i in (int(x) for x in ids):
            if i < 256:
                buf.append(i)
                continue
            out.append(buf.decode("utf-8", errors="replace"))
            buf = bytearray()
            if not skip_special_tokens:
                out.append(self._inv.get(i, ""))
        out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)

    def batch_decode(self, sequences, skip_special_tokens=False):
        return [self.decode(s, skip_special_tokens=skip_special_tokens) for s in sequences]


def chat_prompt_ids(tok: ByteTokenizer, question: str, image_tokens: int) -> List[int]:
    """The ids of a one-image user turn and the assistant's generation
    prompt, the image marker expanded into `image_tokens` placeholders and
    a newline (NVILA's end token for an image): what a served request's
    prompt is."""
    text = tok.apply_chat_template(
        [{"role": "user", "content": MEDIA_TOKENS["image"] + question}],
        add_generation_prompt=True)
    image_id = tok.media_token_ids["image"]
    out: List[int] = []
    for t in tok.encode(text):
        if t == image_id:
            out.extend([image_id] * image_tokens)
            out.extend(tok.encode("\n"))
        else:
            out.append(t)
    return out
