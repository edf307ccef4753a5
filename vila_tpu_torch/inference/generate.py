"""Generation engine: prompt assembly, bucketed prefill, chunked decode, as
`vila_tpu/inference/generate.py` on its plain-image path.

Prompt and token layouts are computed on the host; each media token expands
into a fixed placeholder run (plus the encoder's "\\n" end-token ids). The
prompt is padded to the JAX engine's length buckets, so the same prompt
takes the same kernels (a padded prompt of more than 32 rows prefills
through the W4 GEMM) and yields the same tokens. Decode runs in chunks of
`decode_chunk` steps with one host read-back per chunk.

Not ported yet: dynamic tiling, S2, TSP video, PS3, speculative and
JSON-constrained decoding.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vila_tpu_torch.constants import MEDIA_TOKENS
from vila_tpu_torch.data import preprocess
from vila_tpu_torch.data.tokenizer_utils import infer_stop_tokens, tokenize_conversation
from vila_tpu_torch.media import Video
from vila_tpu_torch.models import qwen2, vlm
from vila_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class GenerationConfig:
    """Mirrors the knobs of `default_generation_config` (llava_arch.py:950)."""

    max_new_tokens: int = 256
    do_sample: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    seed: int = 0
    stop_token_ids: Tuple[int, ...] = ()
    response_format: Optional[Any] = None  # not ported: must stay None
    lookup_gamma: int = 0  # not ported: must stay 0


def _bucket(n: int, sizes: Sequence[int]) -> int:
    for s in sizes:
        if n <= s:
            return s
    return sizes[-1]


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


PROMPT_BUCKETS = (128, 192, 256, 288, 320, 384, 448, 512, 640, 768, 1024,
                  1536, 2048, 3072, 4096, 8192, 16384, 32768)


def expand_media_tokens(
    ids: np.ndarray,
    marker_id: int,
    tokens_per_marker: List[int],
    end_ids: Sequence[int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Expand each media marker into a placeholder run (+ end-token ids).

    Returns (expanded_ids, media_positions) where media_positions are the
    flat indices of every placeholder slot, in media order."""
    out: List[int] = []
    positions: List[int] = []
    m = 0
    for tok in ids.tolist():
        if tok == marker_id:
            n = tokens_per_marker[m]
            m += 1
            positions.extend(range(len(out), len(out) + n))
            out.extend([marker_id] * n)
            out.extend(end_ids)
        else:
            out.append(tok)
    if m != len(tokens_per_marker):
        raise ValueError(
            f"media count mismatch: {len(tokens_per_marker)} media objects "
            f"but {m} markers in the prompt"
        )
    return np.asarray(out, dtype=np.int32), np.asarray(positions, dtype=np.int32)


def extract_media(conversation: List[Dict[str, Any]]) -> Dict[str, List[Any]]:
    """Flatten prompt parts into text + an image list (utils/media.py:93)."""
    media: Dict[str, List[Any]] = {"image": []}
    for message in conversation:
        parts = message["value"]
        if not isinstance(parts, (list, tuple)):
            parts = [parts]
        text = ""
        for part in parts:
            if isinstance(part, str):
                for token in MEDIA_TOKENS.values():
                    part = part.replace(token, "").strip() if token in part else part
                text += part
            elif isinstance(part, Video):
                raise NotImplementedError("video prompts are not ported yet")
            else:  # Image / PIL / ndarray
                media["image"].append(preprocess.load_image(part))
                text += MEDIA_TOKENS["image"]
        message["value"] = text
    return media


class GenerationEngine:
    """Multimodal generation over a fixed parameter set on one device."""

    def __init__(
        self,
        params: Dict[str, Any],
        cfg: vlm.VLMConfig,
        tokenizer,
        decode_chunk: int = 8,
        max_cache_len: int = 8192,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.decode_chunk = decode_chunk
        self.max_cache_len = max_cache_len
        self._newline_ids = tuple(tokenizer("\n", add_special_tokens=False).input_ids)
        self.image_token_id = tokenizer.media_token_ids["image"]
        self.stop_token_ids = tuple(
            tokenizer.convert_tokens_to_ids(t)
            for t in infer_stop_tokens(tokenizer)
            if tokenizer.convert_tokens_to_ids(t) is not None
        )

    # ------------------------------------------------------------------
    # Prompt assembly (host)
    # ------------------------------------------------------------------

    def prepare_inputs(self, prompt: Union[str, List[Any]]) -> Dict[str, Any]:
        """prompt -> {"input_ids", "media_pos", "media": [entries]}; each
        entry is {"kind": "plain", "tiles": uint8 (1, S, S, 3)}."""
        cfg = self.cfg
        if cfg.image_aspect_ratio not in ("resize", "pad", None):
            raise NotImplementedError(
                f"image_aspect_ratio={cfg.image_aspect_ratio!r} is not ported yet")
        conversation = [{"from": "human", "value": prompt}]
        media = extract_media(conversation)
        entries: List[Dict[str, Any]] = []
        for img in media["image"]:
            tiles, _ = preprocess.process_image(
                img, image_size=cfg.vision.image_size,
                image_aspect_ratio=cfg.image_aspect_ratio or "resize",
            )
            entries.append({"kind": "plain", "tiles": tiles})
        ids = tokenize_conversation(conversation, self.tokenizer, add_generation_prompt=True)
        expanded, media_pos = expand_media_tokens(
            ids, self.image_token_id, [cfg.tokens_per_image] * len(entries),
            self._newline_ids,
        )
        return {"input_ids": expanded, "media_pos": media_pos, "media": entries}

    def encode_media(self, entries: List[Dict[str, Any]]) -> Optional[torch.Tensor]:
        """Encode plain-image entries to a flat (M, D) embedding matrix."""
        if not entries:
            return None
        if any(e["kind"] != "plain" for e in entries):
            raise NotImplementedError("only plain image entries are ported")
        tiles = np.concatenate([e["tiles"] for e in entries])
        feats = vlm.encode_images(
            self.params, self.cfg, torch.as_tensor(tiles, device=self.device))
        return feats.reshape(-1, feats.shape[-1])

    # ------------------------------------------------------------------
    # Generation
    # ------------------------------------------------------------------

    def _prefill(self, ids, valid, media_embeds, media_pos, cache, prompt_len):
        cfg = self.cfg
        embeds = qwen2.embed_tokens(self.params["llm"], cfg.llm, ids)
        if media_embeds is not None:
            embeds = vlm.splice_media(embeds, media_embeds, media_pos)
        logits, cache = qwen2.forward(
            self.params["llm"], cfg.llm, inputs_embeds=embeds, token_valid=valid,
            cache=cache,
            gather_position=torch.tensor([prompt_len - 1], device=self.device),
        )
        # rewind the cursor from the padded to the real prompt length: pad
        # rows are invalid, and decode overwrites them
        cache["fill"] = prompt_len
        return logits[:, 0], cache

    def _decode(self, tok, cache, pos, gen, steps, gc):
        """`steps` decode steps from token `tok` (1,) at position `pos`;
        returns the (steps,) new tokens on the device and the cache."""
        toks = []
        for i in range(steps):
            logits, cache = qwen2.forward(
                self.params["llm"], self.cfg.llm, input_ids=tok[:, None],
                positions=torch.full((1, 1), pos + i, dtype=torch.int32,
                                     device=self.device),
                cache=cache,
            )
            tok = sample_token(logits[:, 0], gen, gc.do_sample, gc.temperature,
                               gc.top_p, gc.top_k)
            toks.append(tok)
        return torch.cat(toks), tok, cache

    def generate_ids(self, inputs: Dict[str, Any],
                     generation_config: Optional[GenerationConfig] = None) -> List[int]:
        out: List[int] = []
        for chunk in self.stream_ids(inputs, generation_config):
            out.extend(chunk)
        return out

    def stream_ids(self, inputs: Dict[str, Any],
                   generation_config: Optional[GenerationConfig] = None):
        """Yield lists of token ids as they decode (chunk granularity)."""
        gc = generation_config or GenerationConfig()
        if gc.response_format is not None or gc.lookup_gamma > 0:
            raise NotImplementedError(
                "constrained and speculative decoding are not ported yet")
        stop_ids = set(gc.stop_token_ids or self.stop_token_ids)
        cfg, dev = self.cfg, self.device

        expanded_ids = inputs["input_ids"]
        prompt_len = int(expanded_ids.shape[0])
        s_pad = _bucket(prompt_len, PROMPT_BUCKETS)
        cache_len = min(self.max_cache_len, _round_up(s_pad + gc.max_new_tokens, 256))
        ids = torch.zeros((1, s_pad), dtype=torch.long)
        ids[0, :prompt_len] = torch.as_tensor(expanded_ids)
        valid = torch.zeros((1, s_pad), dtype=torch.bool)
        valid[0, :prompt_len] = True

        media_embeds = self.encode_media(inputs["media"])
        media_pos = torch.as_tensor(inputs["media_pos"], device=dev)
        cache = qwen2.init_cache(cfg.llm, batch=1, max_len=cache_len, device=dev)
        logits, cache = self._prefill(ids.to(dev), valid.to(dev), media_embeds,
                                      media_pos, cache, prompt_len)
        gen = torch.Generator(device=dev).manual_seed(gc.seed)
        tok = sample_token(logits, gen, gc.do_sample, gc.temperature, gc.top_p, gc.top_k)
        first = int(tok[0])
        if first in stop_ids:
            return
        yield [first]

        steps_left = gc.max_new_tokens - 1
        pos = prompt_len
        while steps_left > 0:
            # every step writes one cache row: stop at the cache's capacity
            steps = min(self.decode_chunk, steps_left, cache_len - pos)
            if steps <= 0:
                return
            toks, tok, cache = self._decode(tok, cache, pos, gen, steps, gc)
            accepted = []
            for t in toks.tolist():
                if t in stop_ids:
                    if accepted:
                        yield accepted
                    return
                accepted.append(t)
            if accepted:
                yield accepted
            steps_left -= steps
            pos += steps

    def generate_content(self, prompt: Union[str, List[Any]],
                         generation_config: Optional[GenerationConfig] = None) -> str:
        """Public API mirroring `generate_content` (llava_arch.py:836)."""
        inputs = self.prepare_inputs(prompt)
        out_ids = self.generate_ids(inputs, generation_config)
        return self.tokenizer.decode(out_ids, skip_special_tokens=True).strip()


# Width of the top-k slice used by filtered sampling (top-p / top-k are
# evaluated over the top-TOPK_SLICE logits, as in the JAX engine).
TOPK_SLICE = 128


def sample_token(
    logits: torch.Tensor,  # (B, V) float32
    generator: torch.Generator,
    do_sample: bool,
    temperature: float,
    top_p: float,
    top_k: int,
) -> torch.Tensor:
    """Greedy or temperature / top-k / top-p sampling; returns (B,) int64.
    temperature <= 0 is greedy. The random stream is torch's, so a sampled
    transcript differs from the JAX engine's for the same seed."""
    greedy = logits.argmax(-1)
    if not do_sample or temperature <= 0.0:
        return greedy
    l = logits.float() / max(temperature, 1e-6)
    if top_p >= 1.0 and top_k <= 0:
        probs = torch.softmax(l, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    kmax = min(TOPK_SLICE, l.shape[-1])
    vals, idx = torch.topk(l, kmax, dim=-1)
    ranks = torch.arange(kmax, device=l.device)
    if top_k > 0:
        vals = vals.masked_fill(ranks >= top_k, float("-inf"))
    probs = torch.softmax(vals, dim=-1)
    keep = (probs.cumsum(-1) - probs) < top_p
    keep[..., 0] = True
    probs = torch.softmax(vals.masked_fill(~keep, float("-inf")), dim=-1)
    choice = torch.multinomial(probs, 1, generator=generator)
    return idx.gather(-1, choice)[:, 0]
