"""Batched generation engines (prefill + greedy decode) on one card: the
PyTorch counterpart of ``repro.posttrain.engine``, with the same
admission, retirement, stop and version-pinning semantics.

``GenerationEngine``
    wave-at-a-time: one fixed batch prefilled together, decoded in
    lockstep to the longest request; ``generate(stop_lengths=...)``
    truncates each request at its own total length, and
    ``generate(batch_extras=...)`` adds entries (the vision stub's
    ``vision_embeds``, the audio stub's ``encoder_embeds``) to the
    prefill batch.  Every family; each step carries on with the cache the
    step returns (the moe family's router tallies among it, the audio
    family's encoder output, which the prefill computes and the decode
    steps read).

``ContinuousGenerationEngine``
    continuous (in-flight) batching: a request queue feeds ``slots``
    decode lanes through a :class:`BlockAllocator`; a finished request
    retires its slot and frees its KV blocks at once, and the next queued
    request prefills into the vacated slot mid-decode.  Decoding is per
    slot position (a (B,) cache index).  ``publish`` installs a new
    versioned parameter set between decode steps; a request decodes every
    token under the version it was admitted with.  A weight push lands
    through ``publish(..., barrier=, push_time=)``: a barrier push (the
    ``collective`` backend's) stalls every slot for the push's measured
    time (``push_stall_s``), a p2p push lands on the push lane only.

Telemetry, as the JAX engine's: with ``trace=`` (a ``sim.trace.
TraceRecorder``) the continuous engine places its prefills, decode steps
and pushes on a scheduled clock (each advances it by its measured wall
time, the device synchronised), one lane per slot plus the push lane;
with an ``obs.metrics`` registry active it counts ``engine.admissions``,
``engine.retirements`` and ``engine.decode_steps`` and sets the gauges
``engine.queue_depth``, ``engine.active_slots`` and
``engine.kv_free_blocks`` every round.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.serve_steps import (
    make_continuous_decode_step, make_decode_step, make_prefill_step,
)
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.obs import metrics as obs_metrics


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class GenerationResult:
    """One generation wave: per-request full sequences + bookkeeping."""

    sequences: List[np.ndarray]   # prompt + generated, truncated per request
    lengths: np.ndarray           # len(sequences[i]), int64
    generated: np.ndarray         # (B, gen_steps) raw greedy token grid
    prefill_s: float
    decode_s: float

    @property
    def decode_tokens_per_s(self) -> float:
        n = int(self.generated.shape[0] * (self.generated.shape[1] - 1))
        return n / self.decode_s if self.decode_s > 0 else 0.0


class GenerationEngine:
    """Batched prefill/decode with a decode cache on ``device``."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 dtype=torch.float32):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        self._prefill = make_prefill_step(cfg)
        self._decode = make_decode_step(cfg)

    def init_cache(self, batch_size: int, max_len: int, *,
                   enc_len: int = 0):
        """Fresh decode cache; the audio family's callers pass ``enc_len``
        (the encoder's sequence length: ``generate`` uses the prompt
        length, as the serve driver draws its frames)."""
        return T.init_cache(self.cfg, batch_size, max_len, self.dtype,
                            self.device, enc_len=enc_len)

    def prompt_batch(self, prompt_tokens):
        """{tokens, positions} for a (B, S) prompt batch."""
        tokens = torch.as_tensor(prompt_tokens, device=self.device)
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device).expand(B, S)
        return {"tokens": tokens, "positions": positions}

    def prefill(self, params, batch: Dict, cache):
        """(last-position logits, warmed cache) for a prompt batch."""
        return self._prefill(params, batch, cache)

    def decode(self, params, cache, tokens, index: int):
        return self._decode(params, cache, tokens, index)

    def generate(self, params, prompt_tokens, gen_steps: int, *,
                 batch_extras: Optional[Dict] = None,
                 stop_lengths: Optional[Sequence[int]] = None
                 ) -> GenerationResult:
        """Greedy-decode ``gen_steps`` tokens for a (B, S) prompt batch.

        batch_extras  entries merged into the prefill batch (the stub
                      frontend's ``vision_embeds``, (B, n, d), or
                      ``encoder_embeds``, (B, S, d)).
        stop_lengths  per-request TOTAL sequence length (prompt included);
                      request i's sequence is truncated there.  None =
                      every request runs to S + gen_steps.
        """
        batch = self.prompt_batch(prompt_tokens)
        if batch_extras:
            batch.update(batch_extras)
        B, S = batch["tokens"].shape
        max_len = S + gen_steps
        enc_len = S if self.cfg.family == "audio" else 0
        cache = self.init_cache(B, max_len, enc_len=enc_len)

        _sync(self.device)
        t0 = time.perf_counter()
        logits, cache = self.prefill(params, batch, cache)
        next_tok = logits[:, -1].argmax(dim=-1)[:, None]
        _sync(self.device)
        prefill_s = time.perf_counter() - t0

        generated = [next_tok]
        t0 = time.perf_counter()
        for i in range(gen_steps - 1):
            logits, cache = self.decode(params, cache, next_tok, S + i)
            next_tok = logits[:, -1].argmax(dim=-1)[:, None]
            generated.append(next_tok)
        _sync(self.device)
        decode_s = time.perf_counter() - t0

        grid = torch.cat(generated, dim=1).cpu().numpy()
        prompts = batch["tokens"].cpu().numpy()
        if stop_lengths is None:
            stops = np.full((B,), max_len, np.int64)
        else:
            stops = np.clip(np.asarray(stop_lengths, np.int64), S + 1,
                            max_len)
        seqs = [np.concatenate([prompts[b], grid[b, : stops[b] - S]])
                .astype(np.int32) for b in range(B)]
        return GenerationResult(
            sequences=seqs,
            lengths=np.asarray([len(s) for s in seqs], np.int64),
            generated=grid, prefill_s=prefill_s, decode_s=decode_s,
        )


# ===========================================================================
# continuous (in-flight) batching
# ===========================================================================
class BlockAllocatorError(RuntimeError):
    """A KV-block accounting invariant was violated (double-assign,
    double-free, foreign block, or over-allocation)."""


class BlockAllocator:
    """Explicit free-list accounting for a paged KV cache.

    The cache is divided into ``num_blocks`` blocks of ``block_size``
    token positions each; a request reserves ``blocks_for(total_len)``
    blocks at admission and frees them all at retirement.  The allocator
    is the engine's admission-control authority and enforces its own
    invariants: every block is owned by at most one request, frees must
    come from the recorded owner, and free + assigned always partitions
    the block set exactly (``check()``).  The physical cache stays
    slot-dense (one contiguous ``max_len`` row per slot).
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError(
                f"need positive num_blocks/block_size, got "
                f"{num_blocks}/{block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._owner: Dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def assigned_blocks(self) -> int:
        return len(self._owner)

    def blocks_for(self, tokens: int) -> int:
        """Blocks one request of ``tokens`` total positions reserves."""
        return max(1, math.ceil(tokens / self.block_size))

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int, owner: int) -> List[int]:
        """Reserve ``n`` blocks for request ``owner``; the returned block
        ids are the request's block table."""
        if n <= 0:
            raise BlockAllocatorError(f"request {owner}: non-positive "
                                      f"reservation {n}")
        if n > len(self._free):
            raise BlockAllocatorError(
                f"request {owner}: {n} blocks requested, "
                f"{len(self._free)} free")
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            if b in self._owner:
                raise BlockAllocatorError(
                    f"block {b} double-assigned (owner {self._owner[b]} "
                    f"-> {owner})")
            self._owner[b] = owner
        return blocks

    def free(self, blocks: Sequence[int], owner: int):
        """Return a retired request's whole block table."""
        for b in blocks:
            own = self._owner.get(b)
            if own is None:
                raise BlockAllocatorError(
                    f"block {b} freed but not assigned (double free?)")
            if own != owner:
                raise BlockAllocatorError(
                    f"block {b} freed by request {owner} but owned by "
                    f"request {own}")
            del self._owner[b]
            self._free.append(b)

    def check(self):
        """Free + assigned partitions [0, num_blocks) exactly."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise BlockAllocatorError("free list holds duplicates")
        if free & set(self._owner):
            raise BlockAllocatorError("block both free and assigned")
        if len(free) + len(self._owner) != self.num_blocks:
            raise BlockAllocatorError(
                f"{len(free)} free + {len(self._owner)} assigned != "
                f"{self.num_blocks} blocks (leak)")


@dataclasses.dataclass
class Request:
    """One generation request queued into the continuous engine."""

    tokens: np.ndarray                 # prompt, (S,) int32
    max_new: int                       # generated-token budget
    stop_length: Optional[int] = None  # total-length cap (prompt included)
    eos_id: Optional[int] = None       # stop on first emission of this id
    rid: int = -1                      # assigned by submit()

    @property
    def prompt_len(self) -> int:
        return int(len(self.tokens))

    @property
    def budget(self) -> int:
        """Generated tokens this request can maximally produce."""
        n = self.max_new
        if self.stop_length is not None:
            n = min(n, max(1, self.stop_length - self.prompt_len))
        return int(n)


@dataclasses.dataclass
class CompletedRequest:
    """A retired request: its output plus its scheduling facts."""

    rid: int
    sequence: np.ndarray        # prompt + generated (truncated at stop)
    generated: np.ndarray       # generated tokens only
    weight_version: int         # the ONE version every token came from
    slot: int
    admitted_step: int          # engine step count at admission
    finished_step: int
    finish_reason: str          # 'eos' | 'stop_length' | 'max_new'
    blocks: int                 # KV blocks the request had reserved


@dataclasses.dataclass
class _SlotState:
    request: Request
    version: int
    position: int               # cache index the NEXT token is written at
    last_token: int
    generated: List[int]
    block_table: List[int]
    admitted_step: int


class ContinuousGenerationEngine:
    """In-flight batched greedy decoding with live versioned weights.

    slots       decode lanes (the fixed batch width of the decode step)
    max_len     per-slot KV capacity; requests need prompt+budget <= max_len
    block_size  KV-block granularity for the admission-control allocator

    trace       optional ``sim.trace.TraceRecorder``: events on the
                scheduled clock (decode steps advance it by their measured
                time, barrier pushes by the push's), one lane per slot and
                the push lane

    The weight-version contract: ``publish(params, version, ...)``
    installs a new parameter set between decode steps; a request pins the
    newest version at admission and decodes EVERY token (prefill
    included) under it.  While slots pinned to different versions are in
    flight, the engine runs the decode step once per live version, each
    on its own copy of the cache, and takes each slot's row from its own
    version's pass.  Versions no slot pins anymore are dropped at
    retirement.
    """

    def __init__(self, cfg: ModelConfig, *, slots: int, max_len: int,
                 block_size: int = 16, device="cuda", dtype=torch.float32,
                 trace=None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"continuous batching needs per-row attention-KV caches; "
                f"family {cfg.family!r} is served by GenerationEngine (the "
                f"continuous engine runs the dense family only, as the JAX "
                f"one does: ROADMAP.md queue 1 item 2)")
        if slots <= 0 or max_len <= 0:
            raise ValueError("slots and max_len must be positive")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.trace = trace
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.allocator = BlockAllocator(
            num_blocks=self.slots * math.ceil(max_len / block_size),
            block_size=block_size)
        self._prefill = make_prefill_step(cfg)
        self._decode = make_continuous_decode_step(cfg)
        self._cache = T.init_cache(cfg, self.slots, self.max_len, dtype,
                                   self.device)
        self._slots: List[Optional[_SlotState]] = [None] * self.slots
        self._queue: Deque[Request] = collections.deque()
        self._params: Dict[int, object] = {}
        self.version = -1
        self.steps = 0              # decode steps taken
        self.prefills = 0           # prefill calls made
        self.prefill_s = 0.0        # host time in prefill calls
        self.decode_s = 0.0         # host time in decode steps
        self.decoded_tokens = 0     # tokens produced by decode steps
        self.completed: List[CompletedRequest] = []
        self._next_rid = 0
        self._clock = 0.0           # scheduled trace clock (seconds)
        self.push_stall_s = 0.0     # scheduled decode stall charged by pushes

    # -- weights ------------------------------------------------------------
    def publish(self, params, version: int, *, barrier: bool = False,
                push_time: float = 0.0):
        """Install params as ``version`` for all FUTURE admissions.

        In-flight requests keep decoding under the version they pinned.
        ``barrier`` (a collective push: ``push_blocks_trainer``) charges
        ``push_time`` to every slot lane on the scheduled clock, the
        fleet-wide stall a broadcast implies, while a p2p push lands on
        the push lane only, overlapping the decode steps after it.
        """
        if version <= self.version:
            raise ValueError(
                f"publish({version}) but engine already holds "
                f"v{self.version}: versions must increase")
        self._params[version] = params
        self.version = version
        if self.trace is not None and push_time > 0.0:
            self.trace.event("push", "push", self._clock, push_time,
                             f"weights v{version}")
        if barrier and push_time > 0.0:
            if self.trace is not None:
                for s in range(self.slots):
                    self.trace.event(f"slot{s}", "push", self._clock,
                                     push_time,
                                     f"push barrier v{version}")
            self.push_stall_s += push_time * self.slots
            self._clock += push_time
        self._gc_versions()

    def _gc_versions(self):
        live = {st.version for st in self._slots if st is not None}
        live.add(self.version)
        for v in [v for v in self._params if v not in live]:
            del self._params[v]

    # -- queue --------------------------------------------------------------
    def submit(self, tokens, max_new: int, *,
               stop_length: Optional[int] = None,
               eos_id: Optional[int] = None) -> int:
        """Queue one request; returns its id.  Admission happens inside
        ``step()`` when a slot AND the KV-block reservation are free."""
        if self.version < 0:
            raise RuntimeError("publish() params before submitting")
        req = Request(tokens=np.asarray(tokens, np.int32).reshape(-1),
                      max_new=int(max_new), stop_length=stop_length,
                      eos_id=eos_id, rid=self._next_rid)
        total = req.prompt_len + req.budget
        if total > self.max_len:
            raise ValueError(
                f"request needs {total} positions, engine max_len is "
                f"{self.max_len}")
        self._next_rid += 1
        self._queue.append(req)
        return req.rid

    @property
    def active(self) -> int:
        return sum(1 for st in self._slots if st is not None)

    @property
    def queued(self) -> int:
        return len(self._queue)

    # -- admission / retirement ---------------------------------------------
    def _admit(self):
        for s in range(self.slots):
            if not self._queue:
                return
            if self._slots[s] is not None:
                continue
            req = self._queue[0]
            need = self.allocator.blocks_for(req.prompt_len + req.budget)
            if not self.allocator.can_alloc(need):
                return  # FIFO: do not let a small request starve the head
            self._queue.popleft()
            table = self.allocator.alloc(need, req.rid)
            first = self._prefill_into_slot(s, req)
            self._slots[s] = _SlotState(
                request=req, version=self.version,
                position=req.prompt_len, last_token=first,
                generated=[first], block_table=table,
                admitted_step=self.steps)
            reg = obs_metrics.active()
            if reg is not None:
                reg.counter("engine.admissions").inc(1.0)

    def _prefill_into_slot(self, s: int, req: Request) -> int:
        """B=1 prefill under the CURRENT version's params, copied into
        slot ``s``'s cache row; returns the first generated token."""
        S = req.prompt_len
        params = self._params[self.version]
        row_cache = T.init_cache(self.cfg, 1, self.max_len, self.dtype,
                                 self.device)
        batch = {"tokens": torch.as_tensor(req.tokens,
                                           device=self.device)[None],
                 "positions": torch.arange(S, dtype=torch.int32,
                                           device=self.device)[None]}
        t0 = time.perf_counter()
        logits, row_cache = self._prefill(params, batch, row_cache)
        for name, big in self._cache.items():
            big[:, s] = row_cache[name][:, 0]
        first = int(logits[0, -1].argmax())  # waits for the device
        dt = time.perf_counter() - t0
        self.prefill_s += dt
        self.prefills += 1
        if self.trace is not None:
            self.trace.event(f"slot{s}", "compute", self._clock, dt,
                             f"prefill req {req.rid}")
        self._clock += dt
        return first

    def _finish_reason(self, st: _SlotState) -> Optional[str]:
        req = st.request
        if req.eos_id is not None and st.generated[-1] == req.eos_id:
            return "eos"
        if (req.stop_length is not None
                and req.prompt_len + len(st.generated) >= req.stop_length):
            return "stop_length"
        if len(st.generated) >= req.max_new:
            return "max_new"
        return None

    def _retire(self):
        for s, st in enumerate(self._slots):
            if st is None:
                continue
            reason = self._finish_reason(st)
            if reason is None:
                continue
            req = st.request
            gen = np.asarray(st.generated, np.int32)
            self.completed.append(CompletedRequest(
                rid=req.rid,
                sequence=np.concatenate([req.tokens, gen]).astype(np.int32),
                generated=gen, weight_version=st.version, slot=s,
                admitted_step=st.admitted_step, finished_step=self.steps,
                finish_reason=reason, blocks=len(st.block_table)))
            self.allocator.free(st.block_table, req.rid)
            self._slots[s] = None
            reg = obs_metrics.active()
            if reg is not None:
                reg.counter("engine.retirements").inc(1.0)
        self._gc_versions()

    # -- the decode loop ----------------------------------------------------
    def step(self) -> bool:
        """One engine round: retire finished slots (freeing their blocks),
        admit from the queue, then one decode step over all active slots.
        Returns False once the queue and all slots are empty."""
        self._retire()
        self._admit()
        if self.trace is not None:
            self.trace.count("queue depth", float(len(self._queue)),
                             at=self._clock)
        reg = obs_metrics.active()
        if reg is not None:
            reg.gauge("engine.queue_depth").set(float(len(self._queue)))
            reg.gauge("engine.active_slots").set(float(self.active))
            reg.gauge("engine.kv_free_blocks").set(
                float(self.allocator.free_blocks))
        # a freshly admitted request whose prefill token already met its
        # budget (or hit eos) must not decode: it retires next round
        states = [(s, st) for s, st in enumerate(self._slots)
                  if st is not None and self._finish_reason(st) is None]
        if not states:
            if any(st is not None for st in self._slots):
                return True  # only finished slots remain; next round retires
            if self._queue:  # all slots free yet nothing admitted
                raise RuntimeError(
                    f"queue stuck: {len(self._queue)} requests waiting "
                    f"with every slot free")
            return False
        tokens = np.zeros((self.slots, 1), np.int64)
        index = np.zeros((self.slots,), np.int32)
        for s, st in states:
            tokens[s, 0] = st.last_token
            index[s] = st.position
        t0 = time.perf_counter()
        out = self._decode_all_versions(
            torch.as_tensor(tokens, device=self.device),
            torch.as_tensor(index, device=self.device), states)
        dt = time.perf_counter() - t0  # out is on the host
        self.decode_s += dt
        self.decoded_tokens += len(states)
        for s, st in states:
            st.generated.append(int(out[s]))
            st.last_token = int(out[s])
            st.position += 1
            if self.trace is not None:
                self.trace.event(
                    f"slot{s}", "decode", self._clock, dt,
                    f"req {st.request.rid} v{st.version}")
        self._clock += dt
        self.steps += 1
        if reg is not None:
            reg.counter("engine.decode_steps").inc(1.0)
        return True

    def _decode_all_versions(self, tokens, index, states):
        """One decode step per live weight version, each slot's logits and
        cache row taken from its own version's pass."""
        versions = sorted({st.version for _, st in states})
        if len(versions) == 1:
            logits, self._cache = self._decode(self._params[versions[0]],
                                               self._cache, tokens, index)
            return logits[:, -1].argmax(dim=-1).cpu().numpy()
        merged_logits = None
        merged_cache = None
        for v in versions:
            mask = np.zeros((self.slots,), bool)
            for s, st in states:
                if st.version == v:
                    mask[s] = True
            m = torch.as_tensor(mask, device=self.device)
            # the step writes its cache in place: each version decodes
            # from its own copy of the step's input cache
            cache_v = {k: t.clone() for k, t in self._cache.items()}
            logits, cache_v = self._decode(self._params[v], cache_v, tokens,
                                           index)
            if merged_logits is None:
                merged_logits, merged_cache = logits, cache_v
            else:
                merged_logits = torch.where(m[:, None, None], logits,
                                            merged_logits)
                merged_cache = {
                    k: torch.where(m.reshape(1, -1, 1, 1, 1), cache_v[k],
                                   merged_cache[k])
                    for k in cache_v}
        self._cache = merged_cache
        return merged_logits[:, -1].argmax(dim=-1).cpu().numpy()

    def run(self) -> List[CompletedRequest]:
        """Drive steps until queue and slots drain; returns completions
        in retirement order (``CompletedRequest.rid`` maps them back)."""
        while self.step():
            pass
        self._retire()  # requests that finished on the last step
        self.allocator.check()
        return self.completed
