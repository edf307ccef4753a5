"""Constrained decoding: JSON / JSON-schema structured output, the port's
own copy of `vila_tpu/inference/constrained.py` (numpy only, no torch).

Capability parity: the reference's XGrammar-compiled logits processor for
`response_format` (get_xgr_logits_processor, llava/model/llava_arch.py:
802-821; `ResponseFormat` pydantic config, configuration_llava.py:119).

The grammar is sequential, so it lives on the host next to detokenization,
XGrammar's way: the JSON pushdown automaton is compiled lazily into per-
state full-vocab token masks (cached per abstract automaton state and per
tokenizer, keyed by `id(tokenizer)`). Each step the state's mask drops the
tokens that definitely break the grammar, and candidates are walked
best-first over the whole masked vocab (a window of `top_k`, then the full
`argsort`) with an exact prefix validator, so a schema-legal token ranked
arbitrarily low is still found. A schema subset (object properties with
string / number / boolean / enum types, required key order) narrows the key
text further. The engine's decode loop sends one (V,) f32 logits row to the
host a step (`GenerationEngine._constrained_loop`).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


class JsonPrefixValidator:
    """Checks whether a string is a prefix of some valid JSON value."""

    def is_valid_prefix(self, text: str) -> bool:
        ok, _ = self._scan(text)
        return ok

    def is_complete(self, text: str) -> bool:
        ok, depth = self._scan(text)
        if not ok or depth is None:
            return False
        stripped = text.strip()
        if not stripped:
            return False
        return depth == 0 and not self._in_string(text)

    # -- internals --------------------------------------------------------

    def _in_string(self, text: str) -> bool:
        in_str = False
        esc = False
        for ch in text:
            if esc:
                esc = False
                continue
            if in_str:
                if ch == "\\":
                    esc = True
                elif ch == '"':
                    in_str = False
            elif ch == '"':
                in_str = True
        return in_str

    def _scan(self, text: str) -> Tuple[bool, Optional[int]]:
        """Single pass pushdown scan. Returns (valid_prefix, depth)."""
        stack: List[str] = []
        in_str = False
        esc = False
        # expect: 'value' | 'key' | 'colon' | 'comma_or_close' | 'done'
        expect = "value"
        i = 0
        n = len(text)
        while i < n:
            ch = text[i]
            if in_str:
                if esc:
                    esc = False
                elif ch == "\\":
                    esc = True
                elif ch == '"':
                    in_str = False
                    if expect == "key_body":
                        expect = "colon"
                    else:
                        expect = "comma_or_close" if stack else "done"
                i += 1
                continue
            if ch in " \t\n\r":
                i += 1
                continue
            if expect in ("value", "element"):
                if ch == "{":
                    stack.append("}")
                    expect = "first_key"
                elif ch == "[":
                    stack.append("]")
                    expect = "first_element"
                elif ch == '"':
                    in_str = True
                    expect = "str_body"
                elif ch in "-0123456789":
                    j = i
                    while j < n and text[j] in "-+.eE0123456789":
                        j += 1
                    if j == n:
                        return True, len(stack)  # number may continue
                    expect = "comma_or_close" if stack else "done"
                    i = j
                    continue
                elif ch in "tfn":  # true/false/null
                    for lit in ("true", "false", "null"):
                        if lit.startswith(text[i : i + len(lit)]):
                            rest = text[i : i + len(lit)]
                            if lit.startswith(rest):
                                if i + len(lit) > n:
                                    return True, len(stack)
                                if text[i : i + len(lit)] == lit:
                                    expect = (
                                        "comma_or_close" if stack else "done"
                                    )
                                    i += len(lit)
                                    break
                    else:
                        return False, None
                    continue
                else:
                    return False, None
                i += 1
            elif expect == "first_key":
                if ch == '"':
                    in_str = True
                    expect = "key_body"
                elif ch == "}":
                    if not stack or stack.pop() != "}":
                        return False, None
                    expect = "comma_or_close" if stack else "done"
                else:
                    return False, None
                i += 1
            elif expect == "key":
                if ch == '"':
                    in_str = True
                    expect = "key_body"
                else:
                    return False, None
                i += 1
            elif expect == "first_element":
                if ch == "]":
                    if not stack or stack.pop() != "]":
                        return False, None
                    expect = "comma_or_close" if stack else "done"
                    i += 1
                else:
                    expect = "value"
            elif expect == "colon":
                if ch != ":":
                    return False, None
                expect = "value"
                i += 1
            elif expect == "comma_or_close":
                if ch == ",":
                    top = stack[-1] if stack else None
                    expect = "key" if top == "}" else "value"
                    i += 1
                elif ch in "}]":
                    if not stack or stack.pop() != ch:
                        return False, None
                    expect = "comma_or_close" if stack else "done"
                    i += 1
                else:
                    return False, None
            elif expect == "done":
                return False, None  # trailing garbage
            elif expect in ("str_body", "key_body"):
                # unreachable: handled by in_str
                i += 1
            else:
                return False, None
        if in_str or expect in ("str_body", "key_body"):
            return True, len(stack)
        return True, len(stack)


class SchemaGuide:
    """Narrow subset of JSON-schema: top-level object, `properties` with
    {string, number, integer, boolean} or `enum`, keys in declaration
    order when `required`. Guides the key text; values fall back to the
    generic JSON automaton."""

    def __init__(self, schema: Dict[str, Any]) -> None:
        self.schema = schema
        self.properties: List[Tuple[str, Dict[str, Any]]] = list(
            (schema.get("properties") or {}).items()
        )

    def expected_keys(self, text: str) -> Optional[List[str]]:
        """Which object keys may start at the current prefix, if the prefix
        ends inside/at a top-level key position."""
        # count completed top-level keys = number of '"key":' at depth 1
        try:
            done = _count_top_level_keys(text)
        except ValueError:
            return None
        remaining = [k for k, _ in self.properties[done:]]
        return remaining


def _count_top_level_keys(text: str) -> int:
    """Number of COMPLETED top-level object keys: a key counts once its
    ':' arrives (counting at the opening quote made the key being typed
    eliminate itself from SchemaGuide.expected_keys)."""
    depth = 0
    in_str = False
    esc = False
    keys = 0
    for ch in text:
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
        elif ch == '"':
            in_str = True
        elif ch in "{[":
            depth += 1
        elif ch in "}]":
            depth -= 1
        elif ch == ":" and depth == 1:
            keys += 1
    return keys


# --------------------------------------------------------------------------
# Full-vocab grammar masking (XGrammar-style precompiled token masks)
# --------------------------------------------------------------------------


class JsonAutomaton:
    """Incremental character automaton for JSON prefixes.

    Equivalent to JsonPrefixValidator._scan but advanced one char at a
    time with explicit state, so the grammar-mask compiler can classify
    every vocab token from an ABSTRACT state (stack truncated to its top
    two symbols + a depth class). The tests fuzz it against the batch
    validator.

    `advance` returns "ok" | "reject" | "uncertain" — "uncertain" means
    the outcome depends on stack levels below the known prefix (abstract
    states only); the mask keeps such tokens and the exact validator
    re-checks them at runtime, so the mask is SOUND on rejects.
    """

    UNKNOWN = "?"  # sentinel: stack continues below with unknown symbols

    def __init__(self, expect="value", esc=False, stack=(), lit=None,
                 lit_pos=0):
        self.expect = expect
        self.esc = esc
        self.stack = list(stack)
        self.lit = lit  # pending literal ("true"/"false"/"null")
        self.lit_pos = lit_pos

    # -- helpers -----------------------------------------------------------

    def _top(self):
        return self.stack[-1] if self.stack else None

    def _pop(self, ch):
        if not self.stack:
            return "reject"
        top = self.stack.pop()
        if top == self.UNKNOWN:
            return "uncertain"
        if top != ch:
            return "reject"
        nxt = self._top()
        if nxt == self.UNKNOWN:
            self.expect = "comma_or_close"
            return "ok"  # deeper symbols unknown but SOME parent exists
        self.expect = "comma_or_close" if self.stack else "done"
        return "ok"

    def _after_value(self):
        nxt = self._top()
        if nxt == self.UNKNOWN:
            self.expect = "comma_or_close"
        else:
            self.expect = "comma_or_close" if self.stack else "done"

    # -- one character ------------------------------------------------------

    def advance(self, ch: str) -> str:
        e = self.expect
        if e == "str_body" or e == "key_body":
            if self.esc:
                self.esc = False
                return "ok"
            if ch == "\\":
                self.esc = True
                return "ok"
            if ch == '"':
                if e == "key_body":
                    self.expect = "colon"
                else:
                    self._after_value()
                return "ok"
            return "ok"
        if self.lit is not None:  # inside true/false/null
            if self.lit_pos < len(self.lit) and ch == self.lit[self.lit_pos]:
                self.lit_pos += 1
                if self.lit_pos == len(self.lit):
                    self.lit = None
                    self.lit_pos = 0
                    self._after_value()
                return "ok"
            return "reject"
        if e == "number":
            if ch in "-+.eE0123456789":
                return "ok"
            # number terminates; re-process ch in comma_or_close context
            self._after_value()
            e = self.expect
            # falls through to the generic handling below
        if ch in " \t\n\r":
            return "ok" if e != "number" else "ok"
        if e in ("value", "first_element"):
            if e == "first_element" and ch == "]":
                return self._pop("]")
            if ch == "{":
                self.stack.append("}")
                self.expect = "first_key"
                return "ok"
            if ch == "[":
                self.stack.append("]")
                self.expect = "first_element"
                return "ok"
            if ch == '"':
                self.expect = "str_body"
                return "ok"
            if ch in "-0123456789":
                self.expect = "number"
                return "ok"
            for lit in ("true", "false", "null"):
                if lit[0] == ch:
                    self.lit = lit
                    self.lit_pos = 1
                    return "ok"
            return "reject"
        if e == "first_key":
            if ch == '"':
                self.expect = "key_body"
                return "ok"
            if ch == "}":
                return self._pop("}")
            return "reject"
        if e == "key":
            if ch == '"':
                self.expect = "key_body"
                return "ok"
            return "reject"
        if e == "colon":
            if ch == ":":
                self.expect = "value"
                return "ok"
            return "reject"
        if e == "comma_or_close":
            if ch == ",":
                top = self._top()
                if top == self.UNKNOWN:
                    return "uncertain"
                self.expect = "key" if top == "}" else "value"
                return "ok"
            if ch in "}]":
                return self._pop(ch)
            return "reject"
        if e == "done":
            return "reject"
        return "reject"

    def run(self, text: str) -> str:
        for ch in text:
            r = self.advance(ch)
            if r != "ok":
                return r
        return "ok"

    # -- abstraction ---------------------------------------------------------

    def state_key(self):
        """Hashable abstract key: exact shallow stacks, truncated deep ones."""
        if len(self.stack) <= 2:
            st = tuple(self.stack)
        else:
            st = (self.UNKNOWN,) + tuple(self.stack[-2:])
        return (self.expect, self.esc, self.lit, self.lit_pos, st)

    @classmethod
    def from_key(cls, key):
        expect, esc, lit, lit_pos, st = key
        return cls(expect=expect, esc=esc, stack=st, lit=lit,
                   lit_pos=lit_pos)

    def is_complete_state(self) -> bool:
        return self.expect == "done" or (
            self.expect == "number" and not self.stack
        )


_TOKEN_TABLE_CACHE: Dict[int, List[str]] = {}
_MASK_CACHE: Dict[Tuple[int, Any], np.ndarray] = {}


def _token_texts(tokenizer) -> List[str]:
    """Per-token decoded text for the whole vocab (cached per tokenizer).

    Single-token decode of byte-level BPE may yield U+FFFD for partial
    UTF-8 — such chars only ever occur INSIDE strings, where the grammar
    accepts any character, so text-level classification stays sound."""
    key = id(tokenizer)
    if key not in _TOKEN_TABLE_CACHE:
        v = getattr(tokenizer, "vocab_size", None) or len(tokenizer)
        v = max(v, len(tokenizer))
        texts = tokenizer.batch_decode(
            [[i] for i in range(v)], skip_special_tokens=True
        )
        _TOKEN_TABLE_CACHE[key] = texts
    return _TOKEN_TABLE_CACHE[key]


def grammar_token_mask(tokenizer, automaton: JsonAutomaton) -> np.ndarray:
    """(V,) bool mask: False ONLY for tokens that definitely break the JSON
    grammar from the given state (XGrammar's per-state token bitmask,
    llava_arch.py:802-821; computed lazily per abstract state and cached
    per tokenizer — the adaptive token-mask cache).

    Sound on rejects: tokens whose validity depends on unknown deeper
    stack levels, empty-text tokens, and specials stay True and are
    settled by the exact validator in JsonConstrainedSampler.pick."""
    key = (id(tokenizer), automaton.state_key())
    cached = _MASK_CACHE.get(key)
    if cached is not None:
        return cached
    texts = _token_texts(tokenizer)
    mask = np.zeros((len(texts),), bool)
    for tid, piece in enumerate(texts):
        if not piece:
            mask[tid] = True  # no text progress: exact check drops it
            continue
        sim = JsonAutomaton.from_key(automaton.state_key())
        mask[tid] = sim.run(piece) != "reject"
    _MASK_CACHE[key] = mask
    return mask


class JsonConstrainedSampler:
    """Pick the best token that keeps the output a valid JSON prefix.

    Used by GenerationEngine when generation_config.response_format is set
    (reference: generate_content's response_format, llava_arch.py:912-917).

    Full-vocab: a precompiled grammar mask (grammar_token_mask) zeroes the
    definitely-invalid tokens, then candidates are walked best-first over
    the ENTIRE masked vocab with the exact prefix validator — there is no
    top-K escape hatch and no forced-continuation fallback (one appended
    id always matches one returned id)."""

    def __init__(
        self,
        tokenizer,
        schema: Optional[Dict[str, Any]] = None,
        top_k: int = 64,  # retained for API compat: initial fast window
    ) -> None:
        self.tokenizer = tokenizer
        self.validator = JsonPrefixValidator()
        self.guide = SchemaGuide(schema) if schema else None
        self.top_k = top_k
        self.text = ""
        self._ids: List[int] = []

    def done(self) -> bool:
        return self.validator.is_complete(self.text)

    def _state(self) -> JsonAutomaton:
        a = JsonAutomaton()
        r = a.run(self.text)
        assert r == "ok", (r, self.text)
        return a

    def _accept(self, tid: int) -> Optional[int]:
        piece = self.tokenizer.decode(
            self._ids + [tid], skip_special_tokens=True
        )
        if not piece.startswith(self.text):
            return None  # token retro-edits text (special); skip
        if len(piece) <= len(self.text):
            return None  # no text progress (special/byte tokens)
        if not self.validator.is_valid_prefix(piece):
            return None
        if self.guide is not None and not self._schema_ok(piece):
            return None
        self._ids.append(tid)
        self.text = piece
        return tid

    def pick(self, logits: np.ndarray) -> Optional[int]:
        """logits: (V,) host array. Returns chosen token id or None when the
        JSON value is complete (or cannot legally continue)."""
        if self.done():
            return None
        mask = grammar_token_mask(self.tokenizer, self._state())
        n = min(len(logits), len(mask))
        masked = np.where(mask[:n], logits[:n], -np.inf)
        # fast window first (sorting 150k floats per step is wasteful when
        # the winner is almost always in the top few), then the full vocab
        k = min(self.top_k, n)
        window = np.argpartition(masked, -k)[-k:]
        for tid in window[np.argsort(masked[window])[::-1]]:
            if not np.isfinite(masked[tid]):
                break
            got = self._accept(int(tid))
            if got is not None:
                return got
        rest = np.argsort(masked)[::-1]
        skip = set(int(t) for t in window)
        for tid in rest:
            if not np.isfinite(masked[tid]):
                break
            if int(tid) in skip:
                continue
            got = self._accept(int(tid))
            if got is not None:
                return got
        return None

    def _schema_ok(self, cand: str) -> bool:
        keys = self.guide.expected_keys(cand)
        if keys is None:
            return True
        # If we are mid-key at depth 1, the partial key must prefix an
        # expected key.
        partial = _current_partial_key(cand)
        if partial is None:
            return True
        return any(k.startswith(partial) for k in keys)


def _current_partial_key(text: str) -> Optional[str]:
    """If the prefix ends inside a top-level object key, return its partial
    text, else None."""
    depth = 0
    in_str = False
    esc = False
    expecting_key = False
    buf: Optional[List[str]] = None
    for ch in text:
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
                buf = None
            elif buf is not None:
                buf.append(ch)
        elif ch == '"':
            in_str = True
            if depth == 1 and expecting_key:
                buf = []
                expecting_key = False
        elif ch == "{":
            depth += 1
            if depth == 1:
                expecting_key = True
        elif ch == "}":
            depth -= 1
        elif ch == "," and depth == 1:
            expecting_key = True
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
    if in_str and buf is not None:
        return "".join(buf)
    return None
