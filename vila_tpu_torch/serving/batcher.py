"""Continuous-batching decode scheduler, as `vila_tpu/serving/batcher.py`.

Decode on the card is bound by the weight bytes each step streams (about
3.7 GB of W4 weights at NVILA-8B), and that cost barely changes with the
number of rows riding the products, so decoding many requests together is
nearly free throughput:

  * one decode step over a fixed `max_batch` of cache rows, every slot
    decoded each step, so the route (`qwen2.forward`: K6 for
    2 <= max_batch <= 16, K4/K5 up to 32) never changes as requests come
    and go;
  * per-slot write cursors (`init_cache(per_slot_fill=True)`): each row
    writes its KV at its own depth, and writes past the cache drop;
  * per-slot sampling parameters as (B,) vectors (`sample_token`), so
    greedy and sampled requests share a step;
  * admission on a worker thread: media encoding and the bucketed prefill
    into a bs=1 cache of the same `max_len` (long prompts in chunks), then
    an in-place copy of its rows into a free slot between two steps.

Inactive slots decode garbage tokens into masked (token_valid=False) cache
rows; their cursors are reset on the next insert, and their writes drop
once past the cache, so idle slots cost compute but never correctness.

The admission thread and the decode loop launch on the same CUDA stream
(the device's current stream), which the kernels' shared arrival counters
and workspaces require, and take turns to issue (`_issue`): each issues a
whole step, prefill or chunk, then waits for the device without the lock.
The decode loop reads the device once per step: the sampled tokens.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Union

import numpy as np
import torch

from vila_tpu_torch.inference.generate import (
    PROMPT_BUCKETS,
    GenerationConfig,
    _bucket,
    padded_prompt,
    sample_token,
    stream_text_deltas,
)
from vila_tpu_torch.models import qwen2, vlm
from vila_tpu_torch.utils.device import host_to_device


@dataclasses.dataclass
class _Slot:
    request: Optional["_Request"] = None
    position: int = 0  # sequence index of the next token to emit
    remaining: int = 0
    emitted: int = 0

    @property
    def active(self) -> bool:
        return self.request is not None


@dataclasses.dataclass
class _Request:
    inputs: Dict[str, Any]
    gen: GenerationConfig
    out: "queue.Queue"
    stop_ids: frozenset


class ContinuousBatcher:
    """Schedules many generate requests onto one batched decode loop.

    Duck-types the `GenerationEngine` surface the server uses
    (`generate_content` / `generate_content_stream`), so
    `serving/server.py` serves through it unchanged. `steps` counts the
    decode steps run so far (each one forward over every slot) and
    `step_seconds` keeps the host wall time of the latest 4096, from the
    inputs' copy to the device to the read of the sampled tokens."""

    def __init__(
        self,
        engine,
        max_batch: int = 4,
        max_len: int = 2048,
        prefill_chunk: int = 2048,
    ):
        self.engine = engine
        self.cfg = engine.cfg
        self.tokenizer = engine.tokenizer
        self.device = engine.device
        self.max_batch = max_batch
        self.max_len = max_len
        # long prompts prefill in chunks of this many tokens, so the decode
        # steps of active slots interleave with them on the card
        self.prefill_chunk = prefill_chunk
        self.cache = qwen2.init_cache(
            self.cfg.llm, max_batch, max_len, device=self.device, per_slot_fill=True
        )
        self.slots = [_Slot() for _ in range(max_batch)]
        self.tokens = np.zeros((max_batch,), np.int64)
        self.temps = np.zeros((max_batch,), np.float32)
        self.top_ps = np.ones((max_batch,), np.float32)
        self.top_ks = np.zeros((max_batch,), np.int64)
        self.steps = 0
        self.step_seconds: Deque[float] = collections.deque(maxlen=4096)
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self._pending: "queue.Queue[_Request]" = queue.Queue()
        # Admissions prepared off-loop, awaiting a free slot. Bounded: each
        # holds a whole bs=1 KV cache on the card, and more than a couple
        # buys nothing (the worker blocks until a slot frees).
        self._ready: "queue.Queue" = queue.Queue(maxsize=2)
        self._wake = threading.Event()
        self._stop = False
        self._failed: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._admit_thread: Optional[threading.Thread] = None
        # One thread at a time issues work to the card (a decode step, an
        # admission's prefill or chunk, an insert) and each waits for the
        # device outside it: two threads issuing small ops at once stall
        # each other on the interpreter lock. It also guards the generator.
        self._issue = threading.Lock()

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------

    def _insert(self, slot: int, cache1) -> None:
        """Copy a bs=1 prefilled cache (same max_len) into batch row `slot`,
        in place, and set the row's cursor on the card and on the host."""
        c = self.cache
        with self._issue:
            c["k"][:, slot].copy_(cache1["k"][:, 0])
            c["v"][:, slot].copy_(cache1["v"][:, 0])
            c["valid"][slot].copy_(cache1["valid"][0])
            c["fill"][slot] = int(cache1["fill"])
        c["fill_host"][slot] = int(cache1["fill"])

    def _step(self, active: np.ndarray) -> List[int]:
        """One decode step over every slot; returns the next token of each
        (0 for idle slots) with the step's one read of the device."""
        # the token fed to a slot is its last emitted one, at position - 1
        # (the JAX batcher feeds it at `position`, one past it: its greedy
        # transcripts can then differ from the serial engine's)
        positions = np.asarray(
            [s.position - 1 if s.active else 0 for s in self.slots], np.int64)
        with self._issue:
            ints = host_to_device(np.stack([self.tokens, positions, active]), self.device)
            valid = ints[2].bool()
            logits, self.cache = qwen2.forward(
                self.engine.params["llm"], self.cfg.llm,
                input_ids=ints[0][:, None], positions=ints[1][:, None].int(),
                token_valid=valid[:, None], cache=self.cache,
            )
            nxt = sample_token(logits[:, 0].float(), self._gen, True,
                               self.temps, self.top_ps, self.top_ks)
            nxt = torch.where(valid, nxt, 0)
        self.steps += 1
        return nxt.tolist()

    def _prepare(self, req: _Request):
        """Admission work, on the worker thread: encode media, prefill a
        bs=1 cache and sample the first token. Long prompts prefill in
        `prefill_chunk` segments."""
        eng, cfg, dev = self.engine, self.cfg, self.device
        inputs, gc = req.inputs, req.gen
        prompt_len = int(inputs["input_ids"].shape[0])
        s_pad = _bucket(prompt_len, PROMPT_BUCKETS)
        if s_pad > self.max_len:
            raise ValueError(
                f"prompt ({prompt_len} tokens) exceeds batcher max_len {self.max_len}")
        chunk = self.prefill_chunk
        chunked = chunk and s_pad > chunk and s_pad % chunk == 0
        with self._issue:
            ids, valid, media_pos = padded_prompt(inputs, s_pad, dev)
            media_embeds = eng.encode_media(inputs["media"])
            cache1 = qwen2.init_cache(cfg.llm, batch=1, max_len=self.max_len, device=dev)
            if chunked:
                embeds = qwen2.embed_tokens(eng.params["llm"], cfg.llm, ids)
                if media_embeds is not None:
                    embeds = vlm.splice_media(embeds, media_embeds, media_pos)
            else:
                first_logits, cache1 = eng._prefill(
                    ids, valid, media_embeds, media_pos, cache1, prompt_len)
        if chunked:
            for a in range(0, s_pad, chunk):  # decode steps interleave here
                seg = slice(a, a + chunk)
                in_seg = max(0, min(prompt_len - 1 - a, chunk - 1))
                with self._issue:
                    lg, cache1 = qwen2.forward(
                        eng.params["llm"], cfg.llm, inputs_embeds=embeds[:, seg],
                        token_valid=valid[:, seg], cache=cache1,
                        gather_position=host_to_device([in_seg], dev),
                    )
                if a <= prompt_len - 1 < a + chunk:
                    first_logits = lg[:, 0]  # the chunk with the last real token
            # the chunks advanced the cursor by the padded length: rewind it
            # to the real one (pad rows are invalid and decode overwrites them)
            cache1["fill"] = prompt_len

        with self._issue:
            tok = sample_token(
                first_logits.float(), self._gen, True,
                gc.temperature if gc.do_sample else 0.0, gc.top_p, gc.top_k,
            )
        return req, cache1, int(tok[0]), prompt_len

    # ------------------------------------------------------------------
    # scheduler
    # ------------------------------------------------------------------

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        if self._admit_thread is None:
            self._admit_thread = threading.Thread(
                target=self._admission_loop, daemon=True)
            self._admit_thread.start()

    def shutdown(self) -> None:
        self._stop = True
        self._wake.set()
        for t in (self._thread, self._admit_thread):
            if t is not None:
                t.join(timeout=10)
        self._thread = None
        self._admit_thread = None

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if not s.active:
                return i
        return None

    def _install(self, slot_idx: int, prepared) -> None:
        """Loop-side admission: an in-place row copy, no prefill."""
        req, cache1, tok, prompt_len = prepared
        gc = req.gen
        slot = self.slots[slot_idx]
        slot.request = req
        slot.position = prompt_len
        slot.remaining = gc.max_new_tokens
        slot.emitted = 0
        self.tokens[slot_idx] = tok
        self.temps[slot_idx] = gc.temperature if gc.do_sample else 0.0
        self.top_ps[slot_idx] = gc.top_p
        self.top_ks[slot_idx] = gc.top_k
        self._insert(slot_idx, cache1)
        self._emit(slot_idx, tok)

    @staticmethod
    def _fail(req: _Request, err: BaseException) -> None:
        req.out.put(err)
        req.out.put(None)

    def _admission_loop(self) -> None:
        """Worker: drain pending requests into prepared admissions."""
        while not self._stop:
            try:
                req = self._pending.get(timeout=0.05)
            except queue.Empty:
                continue
            if self._failed is not None:
                self._fail(req, self._failed)
                continue
            try:
                prepared = self._prepare(req)
            except Exception as e:  # noqa: BLE001 - reported to the request
                self._fail(req, e)
                continue
            if self._failed is not None:
                self._fail(req, self._failed)
                continue
            while not self._stop:  # bounded queue: block, but stay stoppable
                try:
                    self._ready.put(prepared, timeout=0.1)
                    self._wake.set()
                    break
                except queue.Full:
                    continue

    def _emit(self, slot_idx: int, tok: int) -> None:
        slot = self.slots[slot_idx]
        req = slot.request
        slot.remaining -= 1
        finished = False
        if tok in req.stop_ids:
            finished = True
        else:
            req.out.put([tok])
            slot.emitted += 1
            slot.position += 1
            if slot.remaining <= 0 or slot.position >= self.max_len:
                finished = True
        if finished:
            req.out.put(None)  # end-of-stream sentinel
            slot.request = None

    def _loop(self) -> None:
        while not self._stop:
            try:
                self._loop_once()
            except Exception as e:  # noqa: BLE001 - the loop must report
                # a failed step leaves the cache in an unknown state: fail
                # every request in flight and every later one
                self._failed = e
                for s in self.slots:
                    if s.active:
                        self._fail(s.request, e)
                        s.request = None
                while True:
                    try:
                        self._fail(self._ready.get_nowait()[0], e)
                    except queue.Empty:
                        break
                return

    def _loop_once(self) -> None:
        # admission: install every prepared request into a free slot (the
        # prefill already ran on the worker)
        admitted = False
        while True:
            idx = self._free_slot()
            if idx is None:
                break
            try:
                prepared = self._ready.get_nowait()
            except queue.Empty:
                break
            self._install(idx, prepared)
            admitted = True

        active_idx = [i for i, s in enumerate(self.slots) if s.active]
        if not active_idx:
            if not admitted:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
            return
        active = np.zeros((self.max_batch,), np.int64)
        active[active_idx] = 1
        t0 = time.perf_counter()
        toks = self._step(active)
        self.step_seconds.append(time.perf_counter() - t0)
        self.tokens[:] = toks
        for i in active_idx:
            self._emit(i, toks[i])

    # ------------------------------------------------------------------
    # public api (GenerationEngine duck type)
    # ------------------------------------------------------------------

    def submit(
        self,
        prompt: Union[str, List[Any]],
        generation_config: Optional[GenerationConfig] = None,
    ) -> "queue.Queue":
        """Queue a request; returns its output queue of token-id chunks
        (a None sentinel ends it; an Exception reports a failure)."""
        if self._failed is not None:
            raise RuntimeError("the batcher's decode loop failed") from self._failed
        self.start()
        gc = generation_config or GenerationConfig()
        if gc.response_format is not None:
            raise ValueError(
                "constrained decoding is host-guided per request; use the "
                "serial engine path (stream_ids falls back automatically)")
        stop = frozenset(gc.stop_token_ids or self.engine.stop_token_ids)
        inputs = self.engine.prepare_inputs(prompt)
        req = _Request(inputs=inputs, gen=gc, out=queue.Queue(), stop_ids=stop)
        self._pending.put(req)
        self._wake.set()
        return req.out

    def stream_ids(self, prompt, generation_config=None):
        gc = generation_config or GenerationConfig()
        if gc.response_format is not None:
            # constrained decoding needs the host-guided serial loop
            inputs = self.engine.prepare_inputs(prompt)
            yield from self.engine.stream_ids(inputs, gc)
            return
        out = self.submit(prompt, generation_config)
        while True:
            item = out.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def generate_content(self, prompt, generation_config=None) -> str:
        ids: List[int] = []
        for chunk in self.stream_ids(prompt, generation_config):
            ids.extend(chunk)
        return self.tokenizer.decode(ids, skip_special_tokens=True).strip()

    def generate_content_stream(self, prompt, generation_config=None):
        yield from stream_text_deltas(
            self.tokenizer, self.stream_ids(prompt, generation_config))
