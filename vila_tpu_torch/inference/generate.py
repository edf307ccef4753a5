"""Generation engine: prompt assembly, bucketed prefill, chunked decode, as
`vila_tpu/inference/generate.py` (capability parity: `generate` /
`generate_content`, llava_arch.py:823-948, and `extract_media`,
llava/utils/media.py:93).

Prompt and token layouts are computed on the host; each media token expands
into a fixed placeholder run (plus the encoder's "\\n" end-token ids). Media
are plain images (resize, pad), dynamic tiles (a marker and "\\n" per tile),
dynamic-S2 images (one entry of every scale's tiles, encoded by
`models/s2.py`), and videos: every frame an image ("basic") or one
temporal-spatial pooled entry ("tsp", `models/encoders.py`) whose frames
are resized by the native library (`utils/imageproc.py`). The prompt is
padded to the JAX engine's length buckets, so the same prompt takes the
same kernels (a padded prompt of more than 32 rows prefills through the W4
GEMM) and yields the same tokens. Decode runs in chunks of `decode_chunk`
steps with one host read-back per chunk.

Not ported yet: PS3, speculative and JSON-constrained decoding.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vila_tpu_torch.constants import MEDIA_TOKENS
from vila_tpu_torch.data import preprocess
from vila_tpu_torch.data.tokenizer_utils import infer_stop_tokens, tokenize_conversation
from vila_tpu_torch.media import Video
from vila_tpu_torch.models import encoders, qwen2, s2, vlm
from vila_tpu_torch.utils.device import host_to_device, resolve_device
from vila_tpu_torch.utils.imageproc import resize_pil_batch
from vila_tpu_torch.utils.media_loader import load_video_frames


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


def padded_prompt(inputs: Dict[str, Any], s_pad: int, device: torch.device):
    """(ids (1, s_pad) int64, valid (1, s_pad) bool, media positions) of a
    prepared prompt right-padded to its bucket, on `device` (asynchronous
    copies: nothing waits for the work already queued on the card)."""
    expanded = np.asarray(inputs["input_ids"])
    ids = np.zeros((1, s_pad), np.int64)
    ids[0, :expanded.shape[0]] = expanded
    valid = np.arange(s_pad)[None] < expanded.shape[0]
    return (host_to_device(ids, device), host_to_device(valid, device),
            host_to_device(np.asarray(inputs["media_pos"], np.int64), device))


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


def extract_media(conversation: List[Dict[str, Any]], num_video_frames: int = 8,
                  fps: float = 0.0, group_videos: bool = False) -> Dict[str, List[Any]]:
    """Flatten prompt parts into text + media lists (utils/media.py:93-130).

    Videos expand to `num_video_frames` image markers and frames (the basic
    video encoder), or with `group_videos` stay one `<vila/video>` marker
    and a frame list (TSP pools the frames jointly)."""
    media: Dict[str, List[Any]] = {"image": [], "video": []}
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
                frames = load_video_frames(part, num_frames=num_video_frames, fps=fps)
                if group_videos:
                    media["video"].append(frames)
                    text += MEDIA_TOKENS["video"]
                else:
                    media["image"].extend(frames)
                    text += MEDIA_TOKENS["image"] * len(frames)
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
        """prompt -> {"input_ids", "media_pos", "media": [entries]}.

        Each media entry is {"kind": "plain", "tiles": uint8 (N, S, S, 3)},
        {"kind": "s2", "tiles", "block_size": (rows, cols)} or {"kind":
        "tsp", "tiles": the resized frames, "pool_sizes"}, in prompt-marker
        order."""
        cfg = self.cfg
        conversation = [{"from": "human", "value": prompt}]
        media = extract_media(conversation, cfg.num_video_frames, cfg.fps,
                              group_videos=cfg.video_encoder == "tsp")
        entries: List[Dict[str, Any]] = []
        tokens_per_marker: List[int] = []
        size = cfg.vision.image_size
        aspect = cfg.image_aspect_ratio
        # the reference tiles dynamically only for a single image
        # (llava_arch.py:856-880); several images (or a basic video's
        # frames) are resized
        use_dynamic = aspect in ("dynamic", "dynamic_s2") and len(media["image"]) <= 1

        def process_image(img) -> str:
            """Appends the entry and its token counts; returns the marker text."""
            if use_dynamic and aspect == "dynamic":
                tiles, _ = preprocess.process_image(
                    img, image_size=size, image_aspect_ratio="dynamic",
                    min_tiles=cfg.min_tiles, max_tiles=cfg.max_tiles)
                tokens_per_marker.extend([cfg.tokens_per_image] * tiles.shape[0])
                entries.append({"kind": "plain", "tiles": tiles})
                return f"{MEDIA_TOKENS['image']}\n" * tiles.shape[0]
            if aspect == "dynamic_s2":
                # several images under dynamic-S2 are not tiled, but the tower
                # stays multi-scale (VisionTowerDynamicS2 runs every scale on
                # the resized image): a 1x1-block S2 entry, the same math
                tiles, block_size = preprocess.process_image(
                    img, image_size=size, image_aspect_ratio="dynamic_s2",
                    max_tiles=cfg.max_tiles if use_dynamic else 1,
                    s2_scales=cfg.s2_scales)
                tokens_per_marker.append(s2.tokens_for_block_size(cfg, block_size))
                entries.append({"kind": "s2", "tiles": tiles, "block_size": block_size})
                return MEDIA_TOKENS["image"]
            tiles, _ = preprocess.process_image(
                img, image_size=size,
                image_aspect_ratio="resize" if aspect in ("dynamic", None) else aspect)
            tokens_per_marker.append(cfg.tokens_per_image)
            entries.append({"kind": "plain", "tiles": tiles})
            return MEDIA_TOKENS["image"]

        def process_video(frames) -> str:
            """TSP: one entry a video and one image marker per pooled row
            (its end "\\n" added by the expansion), as TSPVideoEncoder's
            concatenation over pool sizes (encoders/video/tsp.py:36-52)."""
            # one native resize over the whole frame stack
            tiles = resize_pil_batch(frames, size)
            nl = int(round(cfg.tokens_per_image ** 0.5))
            marker = ""
            for pt, ph, pw in cfg.tsp_pool_sizes:
                rows = tiles.shape[0] // pt
                tokens_per_marker.extend([(nl // ph) * (nl // pw)] * rows)
                marker += MEDIA_TOKENS["image"] * rows
            entries.append({"kind": "tsp", "tiles": tiles,
                            "pool_sizes": tuple(cfg.tsp_pool_sizes)})
            return marker

        text = conversation[0]["value"]
        if media["image"] or media["video"]:
            images, videos = iter(media["image"]), iter(media["video"])
            pattern = "|".join(re.escape(MEDIA_TOKENS[k]) for k in ("image", "video"))
            text = re.sub(pattern, lambda mo: process_image(next(images))
                          if mo.group(0) == MEDIA_TOKENS["image"]
                          else process_video(next(videos)), text)
        conversation[0]["value"] = text
        ids = tokenize_conversation(conversation, self.tokenizer, add_generation_prompt=True)
        expanded, media_pos = expand_media_tokens(
            ids, self.image_token_id, tokens_per_marker, self._newline_ids)
        return {"input_ids": expanded, "media_pos": media_pos, "media": entries}

    def encode_media(self, entries: List[Dict[str, Any]]) -> Optional[torch.Tensor]:
        """Encode media entries to a flat (M, D) embedding matrix, in entry
        order: plain tiles through the tower and projector, S2 entries
        through `s2.encode_image_s2`, TSP entries through
        `encoders.tsp_encode_video`."""
        if not entries:
            return None
        dev = self.device
        if all(e["kind"] == "plain" for e in entries):
            entries = [{"kind": "plain",
                        "tiles": np.concatenate([e["tiles"] for e in entries])}]
        parts = []
        for e in entries:
            tiles = host_to_device(e["tiles"], dev)
            if e["kind"] == "s2":
                parts.append(s2.encode_image_s2(self.params, self.cfg, tiles,
                                                tuple(e["block_size"])))
            elif e["kind"] == "tsp":
                parts.append(encoders.tsp_encode_video(self.params, self.cfg, tiles,
                                                       e["pool_sizes"]))
            else:
                feats = vlm.encode_images(self.params, self.cfg, tiles)
                parts.append(feats.reshape(-1, feats.shape[-1]))
        return parts[0] if len(parts) == 1 else torch.cat(parts)

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
            gather_position=host_to_device([prompt_len - 1], self.device),
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
        ids, valid, media_pos = padded_prompt(inputs, s_pad, dev)
        media_embeds = self.encode_media(inputs["media"])
        cache = qwen2.init_cache(cfg.llm, batch=1, max_len=cache_len, device=dev)
        logits, cache = self._prefill(ids, valid, media_embeds, media_pos, cache,
                                      prompt_len)
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

    def generate_content_stream(self, prompt: Union[str, List[Any]],
                                generation_config: Optional[GenerationConfig] = None):
        """Streaming variant: yields text deltas (server.py:251-280 parity)."""
        inputs = self.prepare_inputs(prompt)
        yield from stream_text_deltas(
            self.tokenizer, self.stream_ids(inputs, generation_config))


def stream_text_deltas(tokenizer, id_chunks):
    """Turn a stream of token-id chunks into text deltas: re-decode the
    full produced sequence each chunk (token boundaries do not align with
    character boundaries) and emit only the new suffix. Shared by the serial
    engine and the continuous batcher."""
    produced: List[int] = []
    prev = ""
    for chunk in id_chunks:
        produced.extend(chunk)
        text = tokenizer.decode(produced, skip_special_tokens=True)
        if len(text) > len(prev):
            yield text[len(prev):]
            prev = text


# Width of the top-k slice used by filtered sampling (top-p / top-k are
# evaluated over the top-TOPK_SLICE logits, as in the JAX engine).
TOPK_SLICE = 128


def _col(x, dtype, device) -> torch.Tensor:
    """A scalar or a (B,) vector of sampling parameters as a (1, 1) or
    (B, 1) column on `device`."""
    t = x.to(device, dtype) if torch.is_tensor(x) else host_to_device(
        np.asarray(x), device).to(dtype)
    return t[:, None] if t.ndim == 1 else t.reshape(1, 1)


def sample_token(
    logits: torch.Tensor,  # (B, V) float32
    generator: torch.Generator,
    do_sample: bool,
    temperature,
    top_p,
    top_k,
) -> torch.Tensor:
    """Greedy or temperature / top-k / top-p sampling; returns (B,) int64.

    `temperature`, `top_p` and `top_k` are each a scalar or a per-row
    `(B,)` vector (host values or tensors), so the continuous batcher
    decodes rows with different sampling configs in one call; a row with
    temperature <= 0 is greedy, exactly the argmax. Filtered rows (top_p <
    1 or top_k > 0) sample over the top-`TOPK_SLICE` logits, the others
    over the full vocabulary. The random stream is torch's (`generator`),
    so a sampled transcript differs from the JAX engine's for the same
    seed. When every parameter is a host value and no row samples, no
    random number is drawn."""
    greedy = logits.argmax(-1)
    if not do_sample:
        return greedy
    need_full = need_slice = True
    if not any(torch.is_tensor(x) for x in (temperature, top_p, top_k)):
        if bool(np.all(np.asarray(temperature) <= 0.0)):
            return greedy
        filt = (np.asarray(top_p) < 1.0) | (np.asarray(top_k) > 0)
        need_full, need_slice = not bool(np.all(filt)), bool(np.any(filt))
    dev = logits.device
    temp = _col(temperature, torch.float32, dev)
    tp = _col(top_p, torch.float32, dev)
    v = logits.shape[-1]
    tk = _col(top_k, torch.int64, dev).clamp(0, v)
    l = logits.float() / temp.clamp_min(1e-6)
    sampled = None
    if need_full:
        sampled = torch.multinomial(torch.softmax(l, dim=-1), 1, generator=generator)[:, 0]
    if need_slice:
        kmax = min(TOPK_SLICE, v)
        vals, idx = torch.topk(l, kmax, dim=-1)
        ranks = torch.arange(kmax, device=dev)
        vals = vals.masked_fill((tk > 0) & (ranks >= tk), float("-inf"))
        probs = torch.softmax(vals, dim=-1)
        keep = (probs.cumsum(-1) - probs) < tp
        keep[..., 0] = True
        probs = torch.softmax(vals.masked_fill(~keep, float("-inf")), dim=-1)
        choice = torch.multinomial(probs, 1, generator=generator)
        sampled_slice = idx.gather(-1, choice)[:, 0]
        filtered = ((tp < 1.0) | (tk > 0))[:, 0]
        sampled = sampled_slice if sampled is None else torch.where(
            filtered, sampled_slice, sampled)
    return torch.where(temp[:, 0] <= 0.0, greedy, sampled)
