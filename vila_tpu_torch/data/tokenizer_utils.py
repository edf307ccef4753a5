"""Tokenization: chat templates, media tokens, sentinel label masking.

Capability parity: llava/utils/tokenizer.py (tokenize_conversation,
preprocess_conversation sentinel-diff masking, infer_stop_tokens) and
llava/mm_utils.py `tokenizer_image_token`. Pure host-side numpy.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from vila_tpu_torch import conversation as conversation_lib
from vila_tpu_torch.constants import IGNORE_INDEX, MEDIA_TOKENS, SENTINEL_TOKEN

DUMMY_CONVERSATION = [
    {"from": "human", "value": "question"},
    {"from": "gpt", "value": "answer"},
] * 10


def add_media_tokens(tokenizer) -> Dict[str, int]:
    """Register media special tokens (reference: language_model/builder.py:206-211)."""
    tokenizer.add_tokens(list(MEDIA_TOKENS.values()), special_tokens=True)
    ids = {
        name: tokenizer.convert_tokens_to_ids(tok)
        for name, tok in MEDIA_TOKENS.items()
    }
    tokenizer.media_token_ids = ids
    tokenizer.media_tokens = MEDIA_TOKENS
    return ids


def _maybe_add_sentinel_token(tokenizer) -> None:
    if not hasattr(tokenizer, "sentinel_token"):
        tokenizer.add_tokens([SENTINEL_TOKEN], special_tokens=True)
        tokenizer.sentinel_token = SENTINEL_TOKEN
        tokenizer.sentinel_token_id = tokenizer.convert_tokens_to_ids(
            SENTINEL_TOKEN
        )


def tokenize_with_media(text: str, tokenizer) -> np.ndarray:
    """Tokenize text containing `<image>`/`<vila/video>` markers, splicing in
    the media token ids (reference: mm_utils.py `tokenizer_image_token`,
    generalized to all media types)."""
    media_strs = sorted(MEDIA_TOKENS.values(), key=len, reverse=True)
    segments = [(text, None)]
    for ms in media_strs:
        new_segments = []
        for seg, tok in segments:
            if tok is not None:
                new_segments.append((seg, tok))
                continue
            parts = seg.split(ms)
            for i, part in enumerate(parts):
                if i > 0:
                    new_segments.append((ms, ms))
                new_segments.append((part, None))
        segments = new_segments

    ids: List[int] = []
    for seg, tok in segments:
        if tok is not None:
            ids.append(tokenizer.convert_tokens_to_ids(tok))
        elif seg:
            ids.extend(tokenizer(seg, add_special_tokens=False).input_ids)
    return np.asarray(ids, dtype=np.int32)


def tokenize_conversation(
    messages: Sequence[Dict[str, str]],
    tokenizer,
    add_generation_prompt: bool = False,
    overrides: Optional[Dict[str, str]] = None,
    no_system_prompt: bool = False,
) -> np.ndarray:
    """Render a [{'from': 'human'|'gpt', 'value': ...}] conversation and
    tokenize it with media splicing (llava/utils/tokenizer.py:72-121)."""
    messages = [dict(m) for m in messages]
    for m in messages:
        m["value"] = (m["value"] or "").strip()

    conv_tmpl = conversation_lib.default_conversation
    if conv_tmpl.sep_style != conversation_lib.SeparatorStyle.AUTO:
        conv = conv_tmpl.copy()
        roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
        if no_system_prompt:
            conv.system = ""
        if messages and messages[0]["from"] != "human":
            messages = messages[1:]
        if add_generation_prompt:
            messages.append({"from": "gpt", "value": None})
        conv.messages = []
        for turn, message in enumerate(messages):
            role = roles[message["from"]]
            value = message["value"]
            if overrides is not None and message["from"] in overrides:
                value = overrides[message["from"]]
            conv.append_message(role, value)
        return tokenize_with_media(conv.get_prompt(), tokenizer)

    chat = []
    for m in messages:
        role = {"human": "user", "gpt": "assistant"}.get(m["from"])
        if role is None:
            raise ValueError(f"Unexpected sender '{m['from']}'")
        content = m["value"]
        if overrides is not None and m["from"] in overrides:
            content = overrides[m["from"]]
        chat.append({"role": role, "content": content})
    if no_system_prompt:
        chat = [{"role": "system", "content": ""}] + chat
    text = tokenizer.apply_chat_template(
        chat, add_generation_prompt=add_generation_prompt, tokenize=False
    )
    return tokenize_with_media(text, tokenizer)


def preprocess_conversation(
    conversation: Sequence[Dict[str, str]],
    tokenizer,
    no_system_prompt: bool = False,
    retried: bool = False,
) -> Dict[str, Any]:
    """Produce input_ids + labels with assistant-only supervision via the
    sentinel-replacement diff (llava/utils/tokenizer.py:125-171)."""
    inputs = tokenize_conversation(
        conversation, tokenizer, no_system_prompt=no_system_prompt
    )
    labels = np.full_like(inputs, IGNORE_INDEX)

    _maybe_add_sentinel_token(tokenizer)
    template = tokenize_conversation(
        conversation,
        tokenizer,
        overrides={"gpt": SENTINEL_TOKEN},
        no_system_prompt=no_system_prompt,
    )

    # Drop sentinel tokens (and the token after them) from the template.
    mask = np.ones_like(template, dtype=bool)
    for k in range(template.size - 1):
        if template[k] == tokenizer.sentinel_token_id:
            mask[k : k + 2] = False
            if k > 0 and retried:
                mask[k - 1] = False
    template = template[mask]

    # Greedy match: unmatched tokens are trainable.
    p = 0
    for k in range(inputs.size):
        if p < template.size and inputs[k] == template[p]:
            p += 1
        else:
            labels[k] = inputs[k]

    if p < template.size:
        if not retried:
            return preprocess_conversation(
                conversation, tokenizer,
                no_system_prompt=no_system_prompt, retried=True,
            )
        labels[:] = IGNORE_INDEX

    return {"input_ids": inputs, "labels": labels}


def infer_stop_tokens(tokenizer) -> List[str]:
    """Infer generation stop tokens by sentinel probing
    (llava/utils/tokenizer.py:174-183)."""
    _maybe_add_sentinel_token(tokenizer)
    template = tokenize_conversation(
        DUMMY_CONVERSATION, tokenizer, overrides={"gpt": SENTINEL_TOKEN}
    )
    stop_tokens = {tokenizer.eos_token}
    for k in range(template.size - 1):
        if template[k] == tokenizer.sentinel_token_id:
            stop_tokens.add(tokenizer.decode(template[k + 1]))
    return list(stop_tokens)
